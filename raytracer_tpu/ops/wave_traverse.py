"""Binned-wavefront mesh traversal — the production path (exact).

The third-generation mesh traversal engine.  Its predecessor, the per-ray
jnp cluster path (`cluster_traverse.py`), is exact but gathers one 2.6 KB
cluster row PER RAY per step; this engine amortises each cluster's geometry
fetch over a block of rays instead.

Design (all pure jnp/XLA — runs and is CI-tested on CPU):

- **Phase 1 — per-RAY candidates, dense, zero gathers.**  Every ray is
  slab-tested against every cluster AABB in one dense (rays × C) elementwise
  pass (chunked over rays) and `top_k` selects the ``kc`` nearest
  overlapped clusters.  Per-ray overlap counts on a 200k-tri surface mesh
  are small (tens of clusters, even for incoherent rays), so small ``kc``
  covers almost all rays in one round.  `lax.top_k` breaks ties by lowest
  index, so candidates are ordered lexicographically by (entry distance,
  cluster id) — the resume key.

- **Phase 2 — cluster-binned execution.**  The (ray, cluster) candidate
  pairs are sorted by cluster id, cut into blocks of ``BLOCK`` pairs that
  all share ONE cluster (runs are padded to block boundaries positionally,
  not physically), and each block gathers its rays (32 B/ray) plus a single
  shared (K×9) triangle row — far less gather traffic than per-ray cluster
  fetches.  Möller-Trumbore runs dense over (blocks, BLOCK, K); per-ray
  reduction is a pair of scatter-mins.  This is a re-expression of the
  reference's packet traversal idea (many rays amortize one node's geometry
  fetch, `Core/Traversal/Traversal_Packet.cpp:111-162`) with the binning
  done by a device-wide sort instead of a per-node active list.

- **Rounds — exactness without caps.**  Rays whose kc-th candidate was
  still closer than their best hit re-enter phase 1 with a lexicographic
  resume cursor (strictly increasing per round), so every overlapped cluster
  is processed exactly once and nothing is ever silently dropped.  The round
  loop is a `lax.while_loop`; `overflow` reports only rays still unresolved
  after ``max_rounds`` (practically never — that would need a ray stabbing
  ``max_rounds × kc`` clusters before its first hit).

Traversal is AD-detached (hit selection is a discrete sampling decision,
SURVEY §7); the integrator re-derives smooth quantities from the ids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..math.vec import Vec3
from ..scene.clusters import ClusterSet
from .intersect import BIG

TRI_EPS = 1e-7
HIT_EPS = 1e-4

BLOCK = 128  # pairs per execution block
_PHASE1_ELEMS = 32 * 1024 * 1024  # (rays × clusters) f32 budget per scan step


def _phase1_round(cs: ClusterSet, ox, oy, oz, ix, iy, iz, best_t, res_e, res_c, kc: int):
    """One candidate round: per-ray ``kc`` nearest unprocessed clusters.

    Dense (chunk × C) slab test + masked top_k; the resume cursor
    (``res_e``, ``res_c``) excludes candidates processed in earlier rounds
    ((entry, cid) must be lexicographically greater).  Returns
    (cand (N, kc) int32 — C = sentinel for empty slots, entry (N, kc) f32
    (+inf on empty)).
    """
    n = ox.shape[0]
    c = cs.num_clusters
    ch = max(1, min(n, _PHASE1_ELEMS // max(c, 1)))
    pad = (-n) % ch
    num_chunks = (n + pad) // ch

    def shp(x, fill):
        if pad:
            x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
        return x.reshape(num_chunks, ch, 1)

    chunks = (
        shp(ox, 0.0), shp(oy, 0.0), shp(oz, 0.0),
        shp(ix, 1.0), shp(iy, 1.0), shp(iz, 1.0),
        shp(best_t, 0.0), shp(res_e, jnp.float32(jnp.inf)), shp(res_c, 0),
    )

    bx0 = cs.box_min_x[None, :]
    by0 = cs.box_min_y[None, :]
    bz0 = cs.box_min_z[None, :]
    bx1 = cs.box_max_x[None, :]
    by1 = cs.box_max_y[None, :]
    bz1 = cs.box_max_z[None, :]
    cid_row = jnp.arange(c, dtype=jnp.int32)[None, :]

    def body(_, chunk):
        cox, coy, coz, cix, ciy, ciz, ctm, cre, crc = chunk
        t1x = (bx0 - cox) * cix
        t2x = (bx1 - cox) * cix
        t1y = (by0 - coy) * ciy
        t2y = (by1 - coy) * ciy
        t1z = (bz0 - coz) * ciz
        t2z = (bz1 - coz) * ciz
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z),
        )
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        ent = jnp.maximum(tmin, 0.0)
        ok = (tmax >= ent) & (ent < ctm)
        # lexicographic resume: (entry, cid) strictly after the cursor
        after = (ent > cre) | ((ent == cre) & (cid_row > crc))
        key = jnp.where(ok & after, ent, jnp.float32(jnp.inf))
        # barrier: top_k is multi-pass — fusing the slab into it would
        # recompute the whole test per pass
        key = jax.lax.optimization_barrier(key)
        neg_top, idx = jax.lax.top_k(-key, kc)  # ties -> lowest cid first
        ent_k = -neg_top
        cand = jnp.where(jnp.isfinite(ent_k), idx.astype(jnp.int32), c)
        return None, (cand, ent_k)

    _, (cand, entry) = jax.lax.scan(body, None, chunks)
    return cand.reshape(-1, kc)[:n], entry.reshape(-1, kc)[:n]


def _mt_blocks(tri_rows, orig, direction):
    """Dense Möller-Trumbore: (B, K, 9) cluster rows × (B, BLOCK) rays.

    ``orig``/``direction``: tuples of (B, BLOCK) components.  Returns
    per-lane best (t, slot, u, v) over the K triangles ((B, BLOCK) each);
    degenerate padding rows (all zero) miss via det == 0.
    """
    ox, oy, oz = (a[:, :, None] for a in orig)
    dx, dy, dz = (a[:, :, None] for a in direction)
    v0x, v0y, v0z = (tri_rows[:, None, :, i] for i in range(3))
    e1x, e1y, e1z = (tri_rows[:, None, :, i] for i in range(3, 6))
    e2x, e2y, e2z = (tri_rows[:, None, :, i] for i in range(6, 9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
    tkey = jnp.where(hit, t, jnp.float32(BIG))
    slot = jnp.argmin(tkey, axis=-1)
    b_idx = jnp.arange(tkey.shape[0])[:, None]
    l_idx = jnp.arange(tkey.shape[1])[None, :]
    return (
        tkey[b_idx, l_idx, slot],
        slot.astype(jnp.int32),
        u[b_idx, l_idx, slot],
        v[b_idx, l_idx, slot],
    )


def _phase2_binned(cs: ClusterSet, cand, entry, ox, oy, oz, dx, dy, dz, best_t, limit, any_hit):
    """Cluster-binned pair execution.  Returns per-ray round-best
    (t, tri, u, v) — t = +inf where the round found nothing.

    For ``any_hit`` the MT accepts any t below the ray's ``limit`` and the
    reported t is parked at 0 (the caller ORs occlusion across rounds).
    """
    n, kc = cand.shape
    c = cs.num_clusters
    k = cs.tris_per_cluster
    p = n * kc

    valid = jnp.isfinite(entry) & (entry < best_t[:, None])
    pair_key = jnp.where(valid, cand, c).reshape(p)
    pair_idx = jnp.arange(p, dtype=jnp.int32)
    sk, sv = jax.lax.sort([pair_key, pair_idx], num_keys=1)  # stable

    # block structure over runs of equal cluster id: lane = position within
    # run mod BLOCK; a new block starts at every run start and every BLOCK
    # pairs within a run
    pos = jnp.arange(p, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
    run_pos = pos - run_start
    lane = jax.lax.rem(run_pos, BLOCK)
    new_block = lane == 0
    blk = jnp.cumsum(new_block.astype(jnp.int32)) - 1  # nondecreasing

    b_cap = p // BLOCK + c + 1  # every run adds ≤1 partial block
    block_start = jnp.searchsorted(blk, jnp.arange(b_cap, dtype=jnp.int32))
    has_pairs = block_start < p
    bs = jnp.minimum(block_start, p - 1)
    block_cluster = jnp.where(has_pairs, sk[bs], c)
    block_live = has_pairs & (block_cluster < c)

    # per-(block, lane) pair slot; lanes past the block's run are masked
    pair_pos = jnp.minimum(block_start[:, None] + jnp.arange(BLOCK, dtype=jnp.int32)[None, :], p - 1)
    lane_ok = (blk[pair_pos] == jnp.arange(b_cap, dtype=jnp.int32)[:, None]) & block_live[:, None]
    ray = sv[pair_pos] // kc  # (b_cap, BLOCK) ray of each lane

    gath = lambda a: a[ray]
    orig = (gath(ox), gath(oy), gath(oz))
    dirn = (gath(dx), gath(dy), gath(dz))
    cl = jnp.minimum(block_cluster, c - 1)
    tri_rows = cs.tri_block[cl].reshape(b_cap, k, 9)
    tid_rows = cs.tri_id[cl]  # (b_cap, k)

    t, slot, u, v = _mt_blocks(tri_rows, orig, dirn)
    tid = tid_rows[jnp.arange(b_cap)[:, None], slot]
    lim = limit[ray]
    hit = lane_ok & (tid >= 0) & (t < lim)
    if any_hit:
        t = jnp.where(hit, 0.0, jnp.float32(jnp.inf))
    else:
        t = jnp.where(hit, t, jnp.float32(jnp.inf))

    # per-ray reduction by scatter-min: (1) min t, (2) min tri id among the
    # t-winners (deterministic tie-break), (3) unique winner writes u/v
    ray_f = ray.reshape(-1)
    t_f = t.reshape(-1)
    inf = jnp.float32(jnp.inf)
    rt = jnp.full(n, inf, jnp.float32).at[ray_f].min(t_f)
    win = (t_f == rt[ray_f]) & jnp.isfinite(t_f)
    tid_f = jnp.where(win, tid.reshape(-1), jnp.int32(2**31 - 1))
    rtri = jnp.full(n, 2**31 - 1, jnp.int32).at[ray_f].min(tid_f)
    final = win & (tid_f == rtri[ray_f])
    w_idx = jnp.where(final, ray_f, n)  # out-of-range -> dropped
    ru = jnp.zeros(n, jnp.float32).at[w_idx].set(u.reshape(-1), mode="drop")
    rv = jnp.zeros(n, jnp.float32).at[w_idx].set(v.reshape(-1), mode="drop")
    rtri = jnp.where(jnp.isfinite(rt), rtri, -1)
    return rt, rtri, ru, rv


def _safe_inv(x):
    tiny = 1e-12
    return 1.0 / jnp.where(jnp.abs(x) > tiny, x, jnp.where(x >= 0, tiny, -tiny))


@functools.partial(jax.jit, static_argnames=("kc", "max_rounds", "any_hit"))
def _wave_trace(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kc: int, max_rounds: int, any_hit: bool):
    n = ox.shape[0]
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)

    init = (
        jnp.int32(0),
        tm,  # best_t (closest) / occlusion park (any-hit: 0 once occluded)
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
        jnp.full(n, -1.0, jnp.float32),  # resume entry
        jnp.full(n, -1, jnp.int32),  # resume cid
        jnp.ones(n, bool),  # live: may still have unprocessed candidates
    )

    def cond(st):
        r = st[0]
        live = st[7]
        return (r < max_rounds) & jnp.any(live)

    def body(st):
        r, best_t, best_tri, best_u, best_v, res_e, res_c, live = st
        # dead rays scan with best_t = 0 -> zero candidates
        scan_t = jnp.where(live, best_t, 0.0)
        # named scopes: a device trace attributes its kernels to the phases
        with jax.named_scope("wave_phase1"):
            cand, entry = _phase1_round(cs, ox, oy, oz, ix, iy, iz, scan_t, res_e, res_c, kc)
        with jax.named_scope("wave_phase2"):
            rt, rtri, ru, rv = _phase2_binned(
                cs, cand, entry, ox, oy, oz, dx, dy, dz, best_t, tm if any_hit else best_t, any_hit
            )
        closer = rt < best_t
        best_t = jnp.where(closer, rt, best_t)
        best_tri = jnp.where(closer, rtri, best_tri)
        best_u = jnp.where(closer, ru, best_u)
        best_v = jnp.where(closer, rv, best_v)
        # advance the resume cursor to the last candidate processed
        got = jnp.sum(jnp.isfinite(entry), axis=1)
        full_round = got == kc
        last = jnp.maximum(got - 1, 0)
        rows = jnp.arange(n)
        res_e = jnp.where(full_round, entry[rows, last], res_e)
        res_c = jnp.where(full_round, cand[rows, last], res_c)
        # a ray may have more candidates only if this round filled all kc
        # slots and the last one was still closer than its (updated) best
        live = full_round & (entry[rows, last] < best_t)
        return (r + 1, best_t, best_tri, best_u, best_v, res_e, res_c, live)

    _, best_t, best_tri, best_u, best_v, _, _, live = jax.lax.while_loop(cond, body, init)
    return best_t, best_tri, best_u, best_v, live


def wave_closest_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kc: int = 16, max_rounds: int = 16):
    """Closest hit over the cluster set. Returns (t, tri_id, u, v, overflow).

    t == BIG and tri_id == -1 on miss; ``overflow`` marks rays unresolved
    after ``max_rounds`` (needs max_rounds × kc clusters before first hit —
    practically unreachable; surfaced via Counters regardless).
    """
    cs, origin, direction, t_max = jax.lax.stop_gradient((cs, origin, direction, t_max))
    tm = jnp.asarray(t_max) * jnp.ones(origin.x.shape, jnp.float32)
    t, tri, u, v, overflow = _wave_trace(
        cs, origin.x, origin.y, origin.z, direction.x, direction.y, direction.z,
        tm, min(kc, cs.num_clusters), max_rounds, False,
    )
    missed = tri < 0
    return jnp.where(missed, BIG, t), tri, u, v, overflow


def wave_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kc: int = 16, max_rounds: int = 16):
    """Any-hit occlusion query. Returns (occluded, overflow).

    Occluded rays park at t = 0, which prunes their remaining candidates in
    the next round's phase 1 (the wavefront analogue of the reference's
    shadow-ray early-out, `Traversal_Single.h:99-179`).
    """
    cs, origin, direction, t_max = jax.lax.stop_gradient((cs, origin, direction, t_max))
    tm = jnp.asarray(t_max) * jnp.ones(origin.x.shape, jnp.float32)
    t, tri, _, _, overflow = _wave_trace(
        cs, origin.x, origin.y, origin.z, direction.x, direction.y, direction.z,
        tm, min(kc, cs.num_clusters), max_rounds, True,
    )
    return tri >= 0, overflow


def interp_tri_attr(cs: ClusterSet, tri, u, v):
    """Winner shading frame from the (T, 16) input-order attribute table:
    one row-gather + barycentric interpolation (`MeshShape.cpp:283-328`
    semantics).  Returns (nx, ny, nz, tex_u, tex_v, material_id_f32), or
    None when the cluster set carries no attribute table; miss lanes
    (tri < 0) return zeros."""
    if cs.tri_attr is None:
        return None
    a = cs.tri_attr[jnp.clip(tri, 0, cs.tri_attr.shape[0] - 1)]  # (N, 16)
    w = 1.0 - u - v
    nx = a[:, 0] * w + a[:, 3] * u + a[:, 6] * v
    ny = a[:, 1] * w + a[:, 4] * u + a[:, 7] * v
    nz = a[:, 2] * w + a[:, 5] * u + a[:, 8] * v
    tu = a[:, 9] * w + a[:, 11] * u + a[:, 13] * v
    tv = a[:, 10] * w + a[:, 12] * u + a[:, 14] * v
    hit = (tri >= 0).astype(jnp.float32)
    return (nx * hit, ny * hit, nz * hit, tu * hit, tv * hit, a[:, 15] * hit)

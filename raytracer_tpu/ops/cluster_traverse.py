"""Dense two-phase ray traversal over triangle clusters (see scene/clusters.py).

Phase 1 (dense, zero gathers): slab-test each ray against every cluster AABB
— an (n, C) elementwise computation chunked over rays and scanned (the scan
body is gather-free) — then `top_k` the nearest
``kmax`` overlapped clusters per ray.

Phase 2 (few big gathers): a STATIC python loop over the kmax candidates;
each step gathers the (K*9) triangle block of one cluster per ray in a single
row-gather and runs a dense vectorized Möller-Trumbore over all K triangles.
Early termination is by masking: once a ray's best hit is closer than the
candidate cluster's entry distance, the step contributes nothing.

Correctness bound: a ray overlapping more than ``kmax`` clusters closer than
its final hit could miss geometry; `overflow_mask` reports such rays (the
"no silent caps" rule).  kmax=32 with 64-tri clusters covers the test-scene
suite exactly (validated against brute force).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..math.vec import Vec3, cross, dot
from ..scene.clusters import ClusterSet
from .intersect import BIG

TRI_EPS = 1e-7
HIT_EPS = 1e-4
_CHUNK_ELEMS = 32 * 1024 * 1024  # phase-1 (n_chunk x C) matrix budget (floats)


def _phase1_candidates(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kmax: int):
    """(N, kmax) nearest-first candidate cluster ids + entry distances."""
    n = origin.x.shape[0]
    c = cs.num_clusters
    n_chunk = max(1, min(n, _CHUNK_ELEMS // max(c, 1)))
    # pad N to a multiple of the chunk
    pad = (-n) % n_chunk
    num_chunks = (n + pad) // n_chunk

    def padded(x, fill=0.0):
        return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)]) if pad else x

    ox = padded(origin.x).reshape(num_chunks, n_chunk, 1)
    oy = padded(origin.y).reshape(num_chunks, n_chunk, 1)
    oz = padded(origin.z).reshape(num_chunks, n_chunk, 1)
    tiny = 1e-12
    inv = lambda d: 1.0 / jnp.where(jnp.abs(d) > tiny, d, jnp.where(d >= 0, tiny, -tiny))
    ix = padded(inv(direction.x), 1.0).reshape(num_chunks, n_chunk, 1)
    iy = padded(inv(direction.y), 1.0).reshape(num_chunks, n_chunk, 1)
    iz = padded(inv(direction.z), 1.0).reshape(num_chunks, n_chunk, 1)
    tm = padded(jnp.asarray(t_max) * jnp.ones(n, jnp.float32)).reshape(num_chunks, n_chunk, 1)

    bx0 = cs.box_min_x[None, :]
    by0 = cs.box_min_y[None, :]
    bz0 = cs.box_min_z[None, :]
    bx1 = cs.box_max_x[None, :]
    by1 = cs.box_max_y[None, :]
    bz1 = cs.box_max_z[None, :]

    def chunk_body(_, chunk):
        cox, coy, coz, cix, ciy, ciz, ctm = chunk
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
        tmax_ = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        hit = (tmax_ >= jnp.maximum(tmin, 0.0)) & (tmin < ctm)
        key = jnp.where(hit, tmin, jnp.float32(jnp.inf))
        neg_top, idx = jax.lax.top_k(-key, kmax)  # nearest-first
        return None, (idx.astype(jnp.int32), -neg_top)

    chunks = (ox, oy, oz, ix, iy, iz, tm)
    _, (ids, tmins) = jax.lax.scan(chunk_body, None, chunks)
    ids = ids.reshape(-1, kmax)[:n]
    tmins = tmins.reshape(-1, kmax)[:n]
    return ids, tmins


def _mt_block(block, origin: Vec3, direction: Vec3, k: int):
    """Vectorized Möller-Trumbore over a (N, K*9) gathered block.

    Returns per-ray best (t, slot, u, v) within the block (dense (N, K) math).
    """
    nb = block.reshape(block.shape[0], k, 9)
    ox, oy, oz = origin.x[:, None], origin.y[:, None], origin.z[:, None]
    dx, dy, dz = direction.x[:, None], direction.y[:, None], direction.z[:, None]
    v0x, v0y, v0z = nb[..., 0], nb[..., 1], nb[..., 2]
    e1x, e1y, e1z = nb[..., 3], nb[..., 4], nb[..., 5]
    e2x, e2y, e2z = nb[..., 6], nb[..., 7], nb[..., 8]
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
    tkey = jnp.where(hit, t, jnp.float32(BIG))
    slot = jnp.argmin(tkey, axis=-1)
    rows = jnp.arange(tkey.shape[0])
    return tkey[rows, slot], slot.astype(jnp.int32), u[rows, slot], v[rows, slot]


def cluster_closest_hit(
    cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kmax: int = 32
):
    """Closest hit. Returns (t, tri_id, u, v, overflow_mask)."""
    k = cs.tris_per_cluster
    kmax = min(kmax, cs.num_clusters)
    ids, tmins = _phase1_candidates(cs, origin, direction, t_max, kmax)

    best_t = jnp.asarray(t_max) * jnp.ones(origin.x.shape, jnp.float32)
    best_id = jnp.full(origin.x.shape, -1, jnp.int32)
    best_u = jnp.zeros(origin.x.shape, jnp.float32)
    best_v = jnp.zeros(origin.x.shape, jnp.float32)
    for j in range(kmax):
        cid = ids[:, j]
        entry = tmins[:, j]
        live = jnp.isfinite(entry) & (entry < best_t)
        block = cs.tri_block[cid]  # (N, K*9) row gather
        tid_row = cs.tri_id[cid]  # (N, K)
        t, slot, u, v = _mt_block(block, origin, direction, k)
        tid = tid_row[jnp.arange(t.shape[0]), slot]
        closer = live & (tid >= 0) & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_id = jnp.where(closer, tid, best_id)
        best_u = jnp.where(closer, u, best_u)
        best_v = jnp.where(closer, v, best_v)

    # diagnosable truncation: the farthest candidate was still closer than the
    # final hit => clusters beyond kmax might have mattered
    overflow = jnp.isfinite(tmins[:, kmax - 1]) & (tmins[:, kmax - 1] < best_t)
    missed = best_id < 0
    t_out = jnp.where(missed, BIG, best_t)
    return t_out, best_id, best_u, best_v, overflow


def cluster_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kmax: int = 32):
    """Any-hit occlusion query. Returns (occluded, overflow): ``overflow``
    marks unoccluded rays that still had >= kmax candidate clusters — an
    occluder could hide beyond the truncation ("no silent caps")."""
    k = cs.tris_per_cluster
    kmax = min(kmax, cs.num_clusters)
    ids, tmins = _phase1_candidates(cs, origin, direction, t_max, kmax)
    limit = jnp.asarray(t_max) * jnp.ones(origin.x.shape, jnp.float32)
    occluded = jnp.zeros(origin.x.shape, bool)
    for j in range(kmax):
        cid = ids[:, j]
        live = jnp.isfinite(tmins[:, j]) & (~occluded)
        block = cs.tri_block[cid]
        tid_row = cs.tri_id[cid]
        t, slot, _, _ = _mt_block(block, origin, direction, k)
        tid = tid_row[jnp.arange(t.shape[0]), slot]
        occluded = occluded | (live & (tid >= 0) & (t < limit))
    overflow = jnp.isfinite(tmins[:, kmax - 1]) & (~occluded)
    return occluded, overflow

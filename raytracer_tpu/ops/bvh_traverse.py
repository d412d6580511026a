"""Wavefront BVH traversal — a re-expression of the reference's
single-ray / packet traversal stack (`Core/Traversal/Traversal_Single.h`,
`Traversal_Packet.*`).

Design (see `scene/bvh.py` and `types.BVHFlat`):

- The tree is pre-threaded per ray-direction octant with ``hit``/``miss``
  skip links, so per-ray traversal state is ONE int32 (current node).  This
  replaces both the reference's per-thread stack and its near-child-first
  ordering heuristic (`Traversal_Single.h:65-75`) — ordering is baked into
  the octant's links.
- The whole wavefront steps in lock-step inside a `lax.fori_loop` with a
  STATIC step budget; rays that finished park on node == -1 and are masked.
  This is the SIMT analogue of the reference's packet compaction
  (`Traversal_Packet.cpp:8-56`).  The loop runs in chunks of ``WALK_CHUNK``
  fori steps inside a while_loop that exits once every lane has parked;
  the step budget is the node count (exact worst case), so results are
  bit-identical to an unbounded walk.
- Leaves have a static LEAF_SIZE triangle slots (padded with degenerate
  triangles), so every loop iteration does: one node-row gather, one
  ray-box slab test, LEAF_SIZE Möller-Trumbore tests (masked), two link
  gathers.  All elementwise over the wavefront => pure VPU work + gathers.

Differentiability: traversal returns discrete ids and distances; the
integrator re-derives smooth quantities (positions, normals) from ids, and
gradients flow through those — hit selection itself is detached, matching
the convention in SURVEY §7.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.vec import Vec3, cross, dot, normalize
from ..scene.bvh import LEAF_SIZE
from ..scene.types import BVHFlat, Triangles
from .intersect import BIG, Hits

TRI_EPS = 1e-7  # python float: inlines into jaxprs (jnp consts would be hoisted as executable args and break the jit fastpath, see renderer.py note)
HIT_EPS = 1e-4


def _octant(direction: Vec3) -> jnp.ndarray:
    """Per-ray octant id from direction sign bits (x | y<<1 | z<<2)."""
    return (
        (direction.x < 0).astype(jnp.int32)
        + 2 * (direction.y < 0).astype(jnp.int32)
        + 4 * (direction.z < 0).astype(jnp.int32)
    )


def _slab_test(node_row, origin: Vec3, inv_dir: Vec3, t_max):
    """Ray-AABB slab test (`Geometry.h:57-130` semantics); node_row (N, 8)."""
    t1x = (node_row[:, 0] - origin.x) * inv_dir.x
    t2x = (node_row[:, 3] - origin.x) * inv_dir.x
    t1y = (node_row[:, 1] - origin.y) * inv_dir.y
    t2y = (node_row[:, 4] - origin.y) * inv_dir.y
    t1z = (node_row[:, 2] - origin.z) * inv_dir.z
    t2z = (node_row[:, 5] - origin.z) * inv_dir.z
    tmin = jnp.maximum(
        jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
        jnp.minimum(t1z, t2z),
    )
    tmax = jnp.minimum(
        jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
        jnp.maximum(t1z, t2z),
    )
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_max)


def _moller_trumbore(geom_row, origin: Vec3, direction: Vec3):
    """Möller-Trumbore over gathered (N, 9) v0/e1/e2 rows (`Geometry.h:132-189`).

    Degenerate (all-zero) padding rows produce det == 0 => miss.
    Returns (t, u, v, hit_mask).
    """
    v0 = Vec3(geom_row[:, 0], geom_row[:, 1], geom_row[:, 2])
    e1 = Vec3(geom_row[:, 3], geom_row[:, 4], geom_row[:, 5])
    e2 = Vec3(geom_row[:, 6], geom_row[:, 7], geom_row[:, 8])
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
    return t, u, v, hit


class _WalkState(NamedTuple):
    node: jnp.ndarray  # (N,) int32, -1 = done
    t: jnp.ndarray  # (N,) best distance so far
    tri: jnp.ndarray  # (N,) int32 best (reordered) triangle id, -1 = miss
    u: jnp.ndarray
    v: jnp.ndarray


# hard cap on traversal steps for very deep trees; per-scene budget is
# min(num_nodes, cap).  Node counts above the cap could in principle truncate
# pathological rays — raise via env/config when that ever matters.
MAX_TRAVERSAL_STEPS = 8192

# walk steps per while_loop iteration: the loop runs chunks of this many
# lock-step node visits and exits as soon as EVERY lane has parked (node ==
# -1).  A bare fori_loop over the full budget would execute num_nodes steps
# for every wavefront; the chunked shell keeps ONE compiled body (two
# gathers) and cuts executed steps to the worst lane's need, rounded up to
# the chunk, while amortising the loop-exit test over the chunk.
WALK_CHUNK = 16


def _safe_inv(d: Vec3) -> Vec3:
    tiny = jnp.float32(1e-20)
    return Vec3(
        1.0 / jnp.where(jnp.abs(d.x) > tiny, d.x, jnp.where(d.x >= 0, tiny, -tiny)),
        1.0 / jnp.where(jnp.abs(d.y) > tiny, d.y, jnp.where(d.y >= 0, tiny, -tiny)),
        1.0 / jnp.where(jnp.abs(d.z) > tiny, d.z, jnp.where(d.z >= 0, tiny, -tiny)),
    )


def _bvh_closest_hit_impl(
    bvh: BVHFlat, tris: Triangles, origin: Vec3, direction: Vec3, t_max
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit over the triangle BVH. Returns (t, tri_id, u, v).

    Packed-table walk: per step ONE (N, 9) node-row gather (box + leaf row +
    hit/miss links, int lanes bitcast) and, on leaves, ONE (N, 40) gather of
    the 4-triangle leaf block — the gather count per step is the
    perf-critical quantity.
    """
    n = origin.x.shape
    num_nodes = bvh.num_nodes
    octant = _octant(direction)
    oct_base = octant * num_nodes
    inv_dir = _safe_inv(direction)

    init = _WalkState(
        node=jnp.zeros(n, jnp.int32),
        t=jnp.asarray(t_max) * jnp.ones(n, jnp.float32),
        tri=jnp.full(n, -1, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
    )

    def body(_step, s: _WalkState) -> _WalkState:
        active = s.node >= 0
        node = jnp.maximum(s.node, 0)
        row = bvh.packed_nodes[oct_base + node]  # (N, 9): THE node gather
        leaf_row = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        hit_nxt = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
        miss_nxt = jax.lax.bitcast_convert_type(row[:, 8], jnp.int32)
        hit_box = active & _slab_test(row, origin, inv_dir, s.t)
        is_leaf = leaf_row >= 0

        do_tris = hit_box & is_leaf
        leaf = bvh.leaf_geom[jnp.maximum(leaf_row, 0)]  # (N, 40): THE leaf gather
        t_best, tri_best, u_best, v_best = s.t, s.tri, s.u, s.v
        for j in range(LEAF_SIZE):
            geom = leaf[:, 9 * j : 9 * j + 9]
            tid = jax.lax.bitcast_convert_type(leaf[:, 36 + j], jnp.int32)
            tt, uu, vv, th = _moller_trumbore(geom, origin, direction)
            closer = do_tris & th & (tid >= 0) & (tt < t_best)
            t_best = jnp.where(closer, tt, t_best)
            tri_best = jnp.where(closer, tid, tri_best)
            u_best = jnp.where(closer, uu, u_best)
            v_best = jnp.where(closer, vv, v_best)

        nxt = jnp.where(hit_box, hit_nxt, miss_nxt)
        return _WalkState(
            node=jnp.where(active, nxt, s.node),
            t=t_best,
            tri=tri_best,
            u=u_best,
            v=v_best,
        )

    budget = min(num_nodes, MAX_TRAVERSAL_STEPS)
    chunks = (budget + WALK_CHUNK - 1) // WALK_CHUNK

    def cond(carry):
        i, s = carry
        return (i < chunks) & jnp.any(s.node >= 0)

    def chunk_body(carry):
        i, s = carry
        s = jax.lax.fori_loop(0, WALK_CHUNK, body, s)
        return (i + 1, s)

    _, final = jax.lax.while_loop(cond, chunk_body, (jnp.int32(0), init))
    missed = final.tri < 0
    t_out = jnp.where(missed, BIG, final.t)
    return t_out, final.tri, final.u, final.v


# Hit *selection* is a discrete sampling decision: detached from AD (SURVEY §7
# convention).  stop_gradient on every input keeps reverse-mode AD from ever
# touching the while_loop (no transpose rule exists); the integrator
# re-derives smooth quantities (positions, normals, uvs) from the returned
# ids, and gradients to scene parameters flow through those instead.
# (jax.custom_vjp was the obvious alternative but triggers a stale
# executable-cache collision in jax 0.9 when two same-aval scenes compile
# through the same wrapped callable — see renderer.py note.)
def bvh_closest_hit(bvh, tris, origin, direction, t_max):
    args = jax.lax.stop_gradient((bvh, tris, origin, direction, t_max))
    return _bvh_closest_hit_impl(*args)


def _bvh_any_hit_impl(
    bvh: BVHFlat, tris: Triangles, origin: Vec3, direction: Vec3, t_max
) -> jnp.ndarray:
    """Any-hit occlusion query (`Traversal_Single.h:99-179` semantics):
    occluded rays park immediately (early-out in the masked sense)."""
    n = origin.x.shape
    num_nodes = bvh.num_nodes
    octant = _octant(direction)
    oct_base = octant * num_nodes
    inv_dir = _safe_inv(direction)
    limit = jnp.asarray(t_max) * jnp.ones(n, jnp.float32)

    def body(_step, state):
        node_s, occluded = state
        active = node_s >= 0
        node = jnp.maximum(node_s, 0)
        row = bvh.packed_nodes[oct_base + node]
        leaf_row = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        hit_nxt = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
        miss_nxt = jax.lax.bitcast_convert_type(row[:, 8], jnp.int32)
        hit_box = active & _slab_test(row, origin, inv_dir, limit)
        is_leaf = leaf_row >= 0
        do_tris = hit_box & is_leaf
        leaf = bvh.leaf_geom[jnp.maximum(leaf_row, 0)]
        found = occluded
        for j in range(LEAF_SIZE):
            geom = leaf[:, 9 * j : 9 * j + 9]
            tid = jax.lax.bitcast_convert_type(leaf[:, 36 + j], jnp.int32)
            tt, _, _, th = _moller_trumbore(geom, origin, direction)
            found = found | (do_tris & th & (tid >= 0) & (tt < limit))

        nxt = jnp.where(hit_box, hit_nxt, miss_nxt)
        nxt = jnp.where(found, -1, nxt)  # occluded rays park
        return (jnp.where(active, nxt, node_s), found)

    budget = min(num_nodes, MAX_TRAVERSAL_STEPS)
    chunks = (budget + WALK_CHUNK - 1) // WALK_CHUNK

    def cond(carry):
        i, (node_s, _occ) = carry
        return (i < chunks) & jnp.any(node_s >= 0)

    def chunk_body(carry):
        i, state = carry
        state = jax.lax.fori_loop(0, WALK_CHUNK, body, state)
        return (i + 1, state)

    _, (_, occluded) = jax.lax.while_loop(
        cond, chunk_body, (jnp.int32(0), (jnp.zeros(n, jnp.int32), jnp.zeros(n, bool)))
    )
    return occluded


def bvh_any_hit(bvh, tris, origin, direction, t_max):
    """Any-hit occlusion query — boolean output, AD-detached like closest-hit."""
    args = jax.lax.stop_gradient((bvh, tris, origin, direction, t_max))
    return _bvh_any_hit_impl(*args)


def eval_tri_frame(tris: Triangles, hits: Hits, origin: Vec3, direction: Vec3):
    """Shading frame at a triangle hit — `MeshShape::EvaluateIntersection`
    (`MeshShape.cpp:283-328`) + `Scene::EvaluateIntersection` orthogonalization
    (`Scene.cpp:338-350`)."""
    from ..math.sampling import build_onb
    from .intersect import PrimFrame

    idx = jnp.maximum(hits.tri_id, 0)
    u, v = hits.u, hits.v
    w = 1.0 - u - v

    def g3(vec: Vec3) -> Vec3:
        return Vec3(vec.x[idx], vec.y[idx], vec.z[idx])

    # clamp miss-lane t (= BIG): masked lanes must stay finite for AD
    position = origin + direction * jnp.clip(hits.t, 0.0, 1e12)
    n0, n1, n2 = g3(tris.n0), g3(tris.n1), g3(tris.n2)
    normal = normalize(n0 * w + n1 * u + n2 * v, eps=1e-20)
    tex_u = tris.uv0_u[idx] * w + tris.uv1_u[idx] * u + tris.uv2_u[idx] * v
    tex_v = tris.uv0_v[idx] * w + tris.uv1_v[idx] * u + tris.uv2_v[idx] * v

    # tangent frame from the shading normal (uv-aligned tangents arrive with
    # the mesh pipeline; ONB is the fallback the reference also uses when
    # tangents degenerate)
    tangent, bitangent = build_onb(normal)
    return PrimFrame(
        position=position,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        tex_u=tex_u,
        tex_v=tex_v,
        material_id=tris.material_id[idx],
        light_id=jnp.full_like(idx, -1),
    )

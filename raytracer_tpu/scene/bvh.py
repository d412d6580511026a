"""Host-side BVH construction: full-sweep SAH + octant skip-link threading.

Fresh implementation of the algorithm family used by the reference builder
(`Core/BVH/BVHBuilder.cpp:117-276`): per node, leaf AABBs are kept sorted
along all three axes; prefix/suffix box sweeps evaluate the exact SAH cost
``SA_L·N_L + SA_R·N_R`` at every split position; the cheapest axis/position
wins.  Differences driven by the wavefront traversal design (see
`types.BVHFlat`):

- every leaf owns exactly ``LEAF_SIZE`` padded triangle slots (degenerate
  padding triangles cannot be hit), so device-side leaf processing has a
  static shape;
- after the tree is built we thread **skip links per ray octant**: for each
  of the 8 direction-sign combinations, a DFS that visits the near child
  first (w.r.t. the node's split axis) records ``hit`` (descend) and ``miss``
  (skip subtree) successors.  This turns the reference's stackful near-first
  traversal (`Traversal_Single.h:16-96`) into a stackless one-int32-per-ray
  walk.

Build runs in NumPy at scene-load time (setup cost, exactly like
`MeshShape::Initialize`, `MeshShape.cpp:34-112`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..math.vec import Vec3
from .types import BVHFlat, Triangles

LEAF_SIZE = 4  # triangles per (padded) leaf
_INVALID = np.int32(-1)


class _BuildNode(NamedTuple):
    box_min: np.ndarray  # (3,)
    box_max: np.ndarray
    left: int  # child index or -1
    right: int
    first: int  # first item in permutation (leaves)
    count: int  # number of items (leaves); 0 for inner
    axis: int  # split axis (inner)


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_sah_tree(box_min: np.ndarray, box_max: np.ndarray, max_leaf: int = LEAF_SIZE):
    """Sweep-SAH binary tree over item AABBs.

    Returns (nodes: list[_BuildNode], permutation: (T,) item order).
    Algorithm mirrors `BVHBuilder::BuildNode` (`BVHBuilder.cpp:117-245`):
    exact sweep over every split position on all three axes.
    """
    n_items = box_min.shape[0]
    centers = 0.5 * (box_min + box_max)
    # per-axis globally sorted item orders; partitions preserve sortedness
    sorted_axes = [np.argsort(centers[:, a], kind="stable").astype(np.int64) for a in range(3)]

    nodes: list[_BuildNode] = []
    perm: list[np.ndarray] = []
    in_left = np.zeros(n_items, bool)  # scratch membership mask

    # explicit stack: (node_index, [sorted_idx_axis0, .._axis1, .._axis2])
    nodes.append(None)  # root placeholder
    stack = [(0, sorted_axes)]
    while stack:
        node_idx, idx_by_axis = stack.pop()
        idx = idx_by_axis[0]
        cnt = idx.shape[0]
        bmin = box_min[idx].min(0)
        bmax = box_max[idx].max(0)

        make_leaf = cnt <= max_leaf
        best = None  # (cost, axis, k)
        if not make_leaf:
            parent_sa = max(_surface_area(bmin, bmax), 1e-30)
            leaf_cost = parent_sa * cnt
            for axis in range(3):
                ids = idx_by_axis[axis]
                lo = box_min[ids]
                hi = box_max[ids]
                # prefix box sweep from the left
                pre_min = np.minimum.accumulate(lo, 0)
                pre_max = np.maximum.accumulate(hi, 0)
                # suffix box sweep from the right
                suf_min = np.minimum.accumulate(lo[::-1], 0)[::-1]
                suf_max = np.maximum.accumulate(hi[::-1], 0)[::-1]
                ks = np.arange(1, cnt)
                cost = (
                    _surface_area(pre_min[:-1], pre_max[:-1]) * ks
                    + _surface_area(suf_min[1:], suf_max[1:]) * (cnt - ks)
                )
                k = int(np.argmin(cost))
                if best is None or cost[k] < best[0]:
                    best = (float(cost[k]), axis, k + 1)
            # no beneficial split and small enough -> leaf (the reference's
            # "leaf if cost not improved" rule, with a hard cap for padding)
            if best[0] >= leaf_cost and cnt <= 2 * max_leaf:
                make_leaf = True

        if make_leaf:
            first = sum(p.shape[0] for p in perm)
            perm.append(idx)
            nodes[node_idx] = _BuildNode(bmin, bmax, -1, -1, first, cnt, 0)
            continue

        _, axis, k = best
        left_ids = idx_by_axis[axis][:k]
        in_left[left_ids] = True
        left_by_axis, right_by_axis = [], []
        for a in range(3):
            ids = idx_by_axis[a]
            m = in_left[ids]
            left_by_axis.append(ids[m])
            right_by_axis.append(ids[~m])
        in_left[left_ids] = False

        li = len(nodes)
        nodes.append(None)
        ri = len(nodes)
        nodes.append(None)
        nodes[node_idx] = _BuildNode(bmin, bmax, li, ri, -1, 0, axis)
        # push right first so left is processed first (stable perm order)
        stack.append((ri, right_by_axis))
        stack.append((li, left_by_axis))

    return nodes, np.concatenate(perm) if perm else np.zeros((0,), np.int64)


def _thread_links(nodes: list[_BuildNode]) -> tuple[np.ndarray, np.ndarray]:
    """Per-octant skip links: hit (descend near-first) and miss (skip)."""
    m = len(nodes)
    hit = np.full((8, m), _INVALID, np.int32)
    miss = np.full((8, m), _INVALID, np.int32)
    for octant in range(8):
        neg = [(octant >> a) & 1 for a in range(3)]  # 1 = ray dir negative on axis
        # iterative DFS threading: (node, continuation)
        stack = [(0, -1)]
        while stack:
            node_idx, cont = stack.pop()
            nd = nodes[node_idx]
            miss[octant, node_idx] = cont
            if nd.left < 0:  # leaf: process tris then continue
                hit[octant, node_idx] = cont
                continue
            near, far = nd.left, nd.right
            if neg[nd.axis]:
                near, far = far, near
            hit[octant, node_idx] = near
            stack.append((far, cont))
            stack.append((near, far))
    return hit, miss


def _build_arrays_python(box_min, box_max):
    """Pure-python build -> flat arrays (fallback when no C++ toolchain)."""
    nodes, perm = build_sah_tree(box_min, box_max)
    hit, miss = _thread_links(nodes)
    m = len(nodes)
    nodes_box = np.zeros((m, 8), np.float32)
    padded_ids = []
    node_first = np.full(m, -1, np.int32)
    cursor = 0
    for i, nd in enumerate(nodes):
        nodes_box[i, 0:3] = nd.box_min
        nodes_box[i, 3:6] = nd.box_max
        if nd.left < 0:
            node_first[i] = cursor
            for j in range(LEAF_SIZE):
                padded_ids.append(nd.first + j if j < nd.count else -1)
            cursor += LEAF_SIZE
    return nodes_box, node_first, hit, miss, perm, np.asarray(padded_ids, np.int32)


def _build_arrays_native(box_min, box_max):
    """C++ sweep-SAH build via ctypes (`native/bvh_builder.cpp`); None if the
    native library is unavailable."""
    import ctypes

    from ..native import load_library

    lib = load_library("bvh_builder")
    if lib is None:
        return None
    n = box_min.shape[0]
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    bmin = np.ascontiguousarray(box_min, np.float32)
    bmax = np.ascontiguousarray(box_max, np.float32)
    nodes_box = np.zeros((2 * n, 8), np.float32)
    node_first = np.zeros(2 * n, np.int32)
    perm = np.zeros(n, np.int32)
    padded_ids = np.zeros(4 * n, np.int32)
    num_padded = np.zeros(1, np.int32)

    def P(a, ty):
        return a.ctypes.data_as(ty)

    m = lib.bvh_build(
        P(bmin, f32p), P(bmax, f32p), ctypes.c_int(n), ctypes.c_int(LEAF_SIZE),
        P(nodes_box, f32p), P(node_first, i32p), P(perm, i32p),
        P(padded_ids, i32p), P(num_padded, i32p),
    )
    if m <= 0:
        return None
    hit = np.zeros((8, m), np.int32)
    miss = np.zeros((8, m), np.int32)
    nodes_box = np.ascontiguousarray(nodes_box[:m])
    lib.bvh_thread_links(P(nodes_box, f32p), ctypes.c_int(m), P(hit, i32p), P(miss, i32p))
    return (
        nodes_box,
        node_first[:m],
        hit,
        miss,
        perm.astype(np.int64),
        padded_ids[: int(num_padded[0])],
    )


def build_bvh_over_triangles(
    tri_v: np.ndarray,  # (T, 3, 3) world-space vertices
    tri_n: np.ndarray,  # (T, 3, 3) vertex normals
    tri_uv: np.ndarray,  # (T, 3, 2)
    tri_mat: np.ndarray,  # (T,) int32
) -> tuple[Triangles, BVHFlat]:
    """Build BVH + reorder triangles to leaf order (cf. `MeshShape.cpp:84-99`).

    Returns (Triangles SoA in leaf order, BVHFlat device arrays).  The padded
    leaf slots in ``BVHFlat.tri_geom`` reference reordered triangle ids so the
    traversal's best-hit ``tri_id`` indexes the returned Triangles directly.
    Uses the native C++ builder when available (~100x for large meshes).
    """
    t = tri_v.shape[0]
    box_min = tri_v.min(1)
    box_max = tri_v.max(1)
    arrays = _build_arrays_native(box_min, box_max)
    if arrays is None:
        arrays = _build_arrays_python(box_min, box_max)
    nodes_box, node_first, hit, miss, perm, padded_ids = arrays

    # reorder triangle data to BVH leaf order
    v = tri_v[perm].astype(np.float32)
    n = tri_n[perm].astype(np.float32)
    uv = tri_uv[perm].astype(np.float32)
    mat = tri_mat[perm].astype(np.int32)
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]

    # padded leaf slots reference reordered triangle rows; pads are
    # degenerate all-zero triangles (can never be hit)
    safe_ids = np.maximum(padded_ids, 0)
    padded_geom = np.concatenate(
        [v0[safe_ids], e1[safe_ids], e2[safe_ids]], axis=1
    ).astype(np.float32)
    padded_geom[padded_ids < 0] = 0.0

    tris = Triangles(
        v0=Vec3(jnp.asarray(v0[:, 0]), jnp.asarray(v0[:, 1]), jnp.asarray(v0[:, 2])),
        e1=Vec3(jnp.asarray(e1[:, 0]), jnp.asarray(e1[:, 1]), jnp.asarray(e1[:, 2])),
        e2=Vec3(jnp.asarray(e2[:, 0]), jnp.asarray(e2[:, 1]), jnp.asarray(e2[:, 2])),
        n0=Vec3(jnp.asarray(n[:, 0, 0]), jnp.asarray(n[:, 0, 1]), jnp.asarray(n[:, 0, 2])),
        n1=Vec3(jnp.asarray(n[:, 1, 0]), jnp.asarray(n[:, 1, 1]), jnp.asarray(n[:, 1, 2])),
        n2=Vec3(jnp.asarray(n[:, 2, 0]), jnp.asarray(n[:, 2, 1]), jnp.asarray(n[:, 2, 2])),
        uv0_u=jnp.asarray(uv[:, 0, 0]), uv0_v=jnp.asarray(uv[:, 0, 1]),
        uv1_u=jnp.asarray(uv[:, 1, 0]), uv1_v=jnp.asarray(uv[:, 1, 1]),
        uv2_u=jnp.asarray(uv[:, 2, 0]), uv2_v=jnp.asarray(uv[:, 2, 1]),
        material_id=jnp.asarray(mat),
    )
    # packed traversal tables: one (9,) row per (octant, node) and one (40,)
    # row per leaf -> the traversal step is 2 gathers instead of 12
    m = nodes_box.shape[0]
    leaf_rows = padded_ids.shape[0] // LEAF_SIZE
    packed = np.zeros((8, m, 9), np.float32)
    packed[:, :, 0:6] = nodes_box[None, :, 0:6]
    leaf_row_of_node = np.where(node_first >= 0, node_first // LEAF_SIZE, -1).astype(np.int32)
    packed[:, :, 6] = leaf_row_of_node[None, :].view(np.float32)
    packed[:, :, 7] = hit.astype(np.int32).view(np.float32)
    packed[:, :, 8] = miss.astype(np.int32).view(np.float32)

    leaf_geom = np.zeros((max(leaf_rows, 1), 40), np.float32)
    if leaf_rows:
        leaf_geom[:, 0:36] = padded_geom.reshape(leaf_rows, LEAF_SIZE * 9)
        leaf_geom[:, 36:40] = (
            np.asarray(padded_ids, np.int32).reshape(leaf_rows, LEAF_SIZE).view(np.float32)
        )

    bvh = BVHFlat(
        nodes_box=jnp.asarray(nodes_box),
        node_first_tri=jnp.asarray(node_first),
        hit_link=jnp.asarray(hit),
        miss_link=jnp.asarray(miss),
        tri_geom=jnp.asarray(padded_geom),
        tri_id=jnp.asarray(np.asarray(padded_ids, np.int32)),
        packed_nodes=jnp.asarray(packed.reshape(8 * m, 9)),
        leaf_geom=jnp.asarray(leaf_geom),
    )
    return tris, bvh


def bvh_stats(bvh: BVHFlat) -> dict:
    """Logging stats like `BVH::CalculateStats` (`BVH.h:85-88`)."""
    nf = np.asarray(bvh.node_first_tri)
    leaves = (nf >= 0).sum()
    return {
        "num_nodes": int(nf.shape[0]),
        "num_leaves": int(leaves),
        "padded_tris": int(bvh.tri_id.shape[0]),
        "real_tris": int((np.asarray(bvh.tri_id) >= 0).sum()),
    }


def save_bvh(path: str, bvh: BVHFlat) -> None:
    """Persist a flattened BVH to disk (`BVH::SaveToFile`, `BVH.h:87`).

    BVH build is the dominant scene-load cost for big meshes; caching the
    flattened arrays lets repeat renders skip it entirely.
    """
    import os

    tmp = path + ".tmp"
    np.savez_compressed(tmp, **{k: np.asarray(v) for k, v in bvh._asdict().items()})
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_bvh(path: str) -> BVHFlat:
    """Load a flattened BVH written by :func:`save_bvh` (`BVH::LoadFromFile`)."""
    with np.load(path, allow_pickle=False) as z:
        return BVHFlat(**{k: jnp.asarray(z[k]) for k in BVHFlat._fields})

"""Cluster acceleration structure for the wavefront traversal engines.

A per-lane pointer-chasing BVH walk runs as many lock-step loop steps as its
deepest ray needs, each a handful of small gathers; this structure trades
that for a few steps of DENSE work:

- triangles are sorted by the Morton code of their centroid and cut into
  fixed-size clusters of ``K`` consecutive triangles (spatially coherent,
  LBVH-style);
- phase 1 tests every ray against every cluster AABB **densely** — an
  (n_rays, C) elementwise slab test with zero gathers — and
  `top_k`-selects the nearest overlapped clusters per ray;
- phase 2 gathers each candidate cluster's (K, 9) triangle block in ONE
  row-gather and runs a dense vectorized Möller-Trumbore over the block.

The reference's closest analogue is packet traversal (`Traversal_Packet.*`):
test many rays against one node at a time; here it's all rays against all
clusters at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class ClusterSet(NamedTuple):
    """Device arrays: C clusters of K padded triangle slots."""

    box_min_x: jnp.ndarray  # (C,)
    box_min_y: jnp.ndarray
    box_min_z: jnp.ndarray
    box_max_x: jnp.ndarray
    box_max_y: jnp.ndarray
    box_max_z: jnp.ndarray
    tri_block: jnp.ndarray  # (C, K*9) f32: K x (v0, e1, e2); degenerate pads
    tri_id: jnp.ndarray  # (C, K) int32 reordered-triangle ids, -1 = pad
    # (T, 16) f32 per-triangle shading attributes in INPUT tri-id order:
    # [n0.xyz, n1.xyz, n2.xyz, u0, v0, u1, v1, u2, v2, material_id, pad].
    # The winner's shading frame is ONE row-gather + barycentric lerp from
    # this table after traversal, rather than riding 6 interpolated channels
    # through the traversal's pair sorts.
    tri_attr: jnp.ndarray = None

    @property
    def num_clusters(self) -> int:
        return self.tri_id.shape[0]

    @property
    def tris_per_cluster(self) -> int:
        return self.tri_id.shape[1]


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """30-bit Morton code from 10-bit quantized coords (standard bit spread)."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def build_clusters(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, k: int = 64,
    normals: np.ndarray = None, uvs: np.ndarray = None,
    material_ids: np.ndarray = None,
) -> ClusterSet:
    """Cluster triangle arrays by centroid Morton code.

    ``tri_id`` stores indices into the INPUT order, so the shading arrays the
    caller already holds need no further permutation.

    ``normals`` (T,3,3) / ``uvs`` (T,3,2) / ``material_ids`` (T,): optional
    per-vertex shading attributes, packed into the input-order ``tri_attr``
    table — the winner's interpolated shading frame is reconstructed
    post-trace with ONE row-gather + barycentric lerp.
    """
    t = v0.shape[0]
    centroid = v0 + (e1 + e2) / 3.0
    lo = centroid.min(0)
    hi = centroid.max(0)
    scale = 1023.0 / np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroid - lo) * scale), 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")

    v0o, e1o, e2o = v0[order], e1[order], e2[order]
    c = (t + k - 1) // k
    pad = c * k - t
    geom = np.concatenate([v0o, e1o, e2o], axis=1).astype(np.float32)  # (t, 9)
    if pad:
        geom = np.concatenate([geom, np.zeros((pad, 9), np.float32)], 0)
    ids = np.concatenate([order.astype(np.int32), np.full(pad, -1, np.int32)])

    blocks = geom.reshape(c, k, 9)
    # cluster bounds from member triangle AABBs (pads contribute nothing)
    verts = np.stack(
        [blocks[..., 0:3], blocks[..., 0:3] + blocks[..., 3:6], blocks[..., 0:3] + blocks[..., 6:9]],
        axis=2,
    )  # (c, k, 3, 3)
    valid = (ids.reshape(c, k) >= 0)[..., None, None]
    vmin = np.where(valid, verts, np.inf).min(axis=(1, 2))
    vmax = np.where(valid, verts, -np.inf).max(axis=(1, 2))

    return ClusterSet(
        box_min_x=jnp.asarray(vmin[:, 0]), box_min_y=jnp.asarray(vmin[:, 1]),
        box_min_z=jnp.asarray(vmin[:, 2]),
        box_max_x=jnp.asarray(vmax[:, 0]), box_max_y=jnp.asarray(vmax[:, 1]),
        box_max_z=jnp.asarray(vmax[:, 2]),
        tri_block=jnp.asarray(blocks.reshape(c, k * 9)),
        tri_id=jnp.asarray(ids.reshape(c, k)),
        tri_attr=(lambda a: jnp.asarray(a) if a is not None else None)(
            _pack_tri_attr(t, normals, uvs, material_ids)
        ),
    )


def _pack_tri_attr(t, normals, uvs, material_ids):
    """(T, 16) input-order shading attribute table (see ClusterSet.tri_attr),
    or None when no attributes were supplied — so `scene_hit_frame` falls
    back to the `eval_tri_frame` gather path instead of normalizing a zero
    normal from an all-zero table."""
    if normals is None and uvs is None and material_ids is None:
        return None
    out = np.zeros((max(t, 1), 16), np.float32)
    if normals is not None:
        out[:t, 0:9] = np.asarray(normals, np.float32).reshape(t, 9)
    if uvs is not None:
        out[:t, 9:15] = np.asarray(uvs, np.float32).reshape(t, 6)
    if material_ids is not None:
        out[:t, 15] = np.asarray(material_ids, np.float32)
    return out

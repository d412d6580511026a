"""Piecewise-constant probability distributions (1-D and 2-D).

Re-expression of `Core/Math/Distribution.{h,cpp}`: the reference builds a
CDF from arbitrary non-negative values (`Distribution::Initialize`,
`Distribution.cpp:27`) and samples it with a binary search
(`Distribution::SampleDiscrete`, `Distribution.cpp:85`); `BitmapTexture::
MakeSamplable` (`BitmapTexture.cpp:122-152`) builds one over texel luminances
for importance sampling.  Here the binary search is a vectorized
``jnp.searchsorted`` over a whole wavefront at once, and a 2-D product
distribution (row marginal × per-row conditional) is added for lat-long
environment maps — upgrading the reference's uniform-hemisphere
`BackgroundLight::Illuminate` (`BackgroundLight.cpp:63-74`, importance
sampling left TODO there) to true env-map importance sampling.

Distributions are built host-side at scene load (NumPy) and stored as device
arrays; sampling runs inside jit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class Distribution(NamedTuple):
    """Discrete distribution over N bins of equal width on [0, 1)."""

    prob: jnp.ndarray  # (N,) probability of each bin (sums to 1)
    cdf: jnp.ndarray  # (N+1,) cdf[0]=0, cdf[N]=1


def make_distribution(values: np.ndarray) -> Distribution:
    """Normalize non-negative ``values`` into a sampleable distribution
    (`Distribution::Initialize`). Zero-total input becomes uniform."""
    v = np.asarray(values, np.float64).reshape(-1)
    if (v < 0).any():
        raise ValueError("distribution values must be non-negative")
    total = v.sum()
    if total <= 0.0:
        v = np.ones_like(v)
        total = v.sum()
    prob = v / total
    cdf = np.concatenate([[0.0], np.cumsum(prob)])
    cdf[-1] = 1.0
    return Distribution(
        prob=jnp.asarray(prob, jnp.float32), cdf=jnp.asarray(cdf, jnp.float32)
    )


def sample_discrete(dist: Distribution, u) -> tuple[jnp.ndarray, jnp.ndarray]:
    """u in [0,1) -> (bin index, bin probability) (`Distribution::SampleDiscrete`).

    Vectorized over ``u`` — one searchsorted for the whole wavefront."""
    n = dist.prob.shape[0]
    idx = jnp.clip(jnp.searchsorted(dist.cdf, u, side="right") - 1, 0, n - 1)
    return idx.astype(jnp.int32), dist.prob[idx]


def sample_continuous(dist: Distribution, u) -> tuple[jnp.ndarray, jnp.ndarray]:
    """u in [0,1) -> (x in [0,1), density at x).  Piecewise-constant density:
    density = prob * N inside a bin."""
    n = dist.prob.shape[0]
    idx, prob = sample_discrete(dist, u)
    lo = dist.cdf[idx]
    hi = dist.cdf[idx + 1]
    frac = jnp.clip((u - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0)
    x = (idx.astype(jnp.float32) + frac) / n
    return x, prob * n


class Distribution2D(NamedTuple):
    """2-D piecewise-constant distribution over the unit square (H×W bins):
    marginal over rows (v axis) × conditional over columns (u axis)."""

    marginal_cdf: jnp.ndarray  # (H+1,)
    cond_cdf: jnp.ndarray  # (H, W+1)
    density: jnp.ndarray  # (H, W) joint density over the unit square (integrates to 1)

    @property
    def height(self) -> int:
        return self.density.shape[0]

    @property
    def width(self) -> int:
        return self.density.shape[1]


def make_distribution_2d(values: np.ndarray) -> Distribution2D:
    """(H, W) non-negative weights -> samplable 2-D distribution."""
    v = np.asarray(values, np.float64)
    if v.ndim != 2:
        raise ValueError("expected a 2-D weight array")
    if (v < 0).any():
        raise ValueError("distribution values must be non-negative")
    h, w = v.shape
    total = v.sum()
    if total <= 0.0:
        v = np.ones_like(v)
        total = v.sum()
    row_sums = v.sum(axis=1)  # (H,)
    marg = row_sums / total
    marginal_cdf = np.concatenate([[0.0], np.cumsum(marg)])
    marginal_cdf[-1] = 1.0
    # conditional per row; uniform for empty rows (never sampled anyway)
    safe_rows = np.where(row_sums > 0.0, row_sums, 1.0)[:, None]
    cond = np.where(row_sums[:, None] > 0.0, v / safe_rows, 1.0 / w)
    cond_cdf = np.concatenate([np.zeros((h, 1)), np.cumsum(cond, axis=1)], axis=1)
    cond_cdf[:, -1] = 1.0
    density = (v / total) * (h * w)  # joint density on the unit square
    return Distribution2D(
        marginal_cdf=jnp.asarray(marginal_cdf, jnp.float32),
        cond_cdf=jnp.asarray(cond_cdf, jnp.float32),
        density=jnp.asarray(density, jnp.float32),
    )


def sample_2d(dist: Distribution2D, u1, u2):
    """(u1, u2) -> (u, v, density) with (u, v) in [0,1)² distributed by the
    2-D density (u = column axis, v = row axis).

    The per-row column search is a hand-unrolled binary search over the
    (H, W+1) conditional CDF with one N-point 2-D gather per step — it never
    materializes per-lane rows (gathering (N, W+1) rows would move GBs of
    device memory for a 2k env map)."""
    h, w = dist.density.shape
    # row from the marginal
    iy = jnp.clip(jnp.searchsorted(dist.marginal_cdf, u2, side="right") - 1, 0, h - 1)
    lo_y = dist.marginal_cdf[iy]
    hi_y = dist.marginal_cdf[iy + 1]
    fy = jnp.clip((u2 - lo_y) / jnp.maximum(hi_y - lo_y, 1e-12), 0.0, 1.0)
    v = (iy.astype(jnp.float32) + fy) / h
    # column: binary search of cond_cdf[iy, :] via point gathers
    lo = jnp.zeros(u1.shape, jnp.int32)
    hi = jnp.full(u1.shape, w + 1, jnp.int32)
    for _ in range(max(1, w.bit_length())):
        mid = (lo + hi) >> 1
        val = dist.cond_cdf[iy, mid]
        go_right = val <= u1
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    ix = jnp.clip(lo - 1, 0, w - 1)
    lo_x = dist.cond_cdf[iy, ix]
    hi_x = dist.cond_cdf[iy, ix + 1]
    fx = jnp.clip((u1 - lo_x) / jnp.maximum(hi_x - lo_x, 1e-12), 0.0, 1.0)
    u = (ix.astype(jnp.float32) + fx) / w
    return u, v, dist.density[iy, ix]


def jax_searchsorted_rows(cdf_rows: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Per-row searchsorted: cdf_rows (..., K) sorted along the last axis,
    u (...) -> rightmost insertion index (count of entries <= u).

    Hand-unrolled vectorized binary search — ceil(log2 K) whole-wavefront
    gather steps, the analogue of the reference's scalar binary search
    (`Distribution.cpp:85-113`).  (A vmapped ``jnp.searchsorted`` lowers to a
    per-lane while_loop instead.)"""
    k = cdf_rows.shape[-1]
    lo = jnp.zeros(u.shape, jnp.int32)
    hi = jnp.full(u.shape, k, jnp.int32)
    steps = max(1, (k - 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) >> 1
        val = jnp.take_along_axis(cdf_rows, mid[..., None], axis=-1)[..., 0]
        go_right = val <= u
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def pdf_2d(dist: Distribution2D, u, v) -> jnp.ndarray:
    """Joint density at (u, v) — the MIS counterpart of :func:`sample_2d`."""
    h, w = dist.density.shape
    ix = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return dist.density[iy, ix]

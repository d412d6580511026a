"""Film: HDR accumulation buffers.

Re-expression of `Core/Rendering/Film.{h,cpp}`: a primary HDR sum image
plus an optional secondary sum fed every 2nd pass, used by adaptive rendering
to estimate per-block error (`Viewport.cpp:245,303`, `Film.cpp:31-39`).

The film is a plain pytree of (H, W, 3) float32 arrays so it can be donated
through jit steps, sharded over a device mesh (rows = pixel-tile axis), and
checkpointed (render state = film + pass counter + seed: naturally resumable,
cf. SURVEY §5 checkpoint/resume).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..math.vec import Vec3


class Film(NamedTuple):
    sum: jnp.ndarray  # (H, W, 3) float32 — accumulated radiance
    secondary_sum: jnp.ndarray  # (H, W, 3) float32 — every-2nd-pass sum
    num_passes: jnp.ndarray  # () int32
    num_secondary_passes: jnp.ndarray  # () int32

    @property
    def height(self) -> int:
        return self.sum.shape[0]

    @property
    def width(self) -> int:
        return self.sum.shape[1]


def make_film(width: int, height: int) -> Film:
    # distinct buffers: the film is donated through jit steps and XLA rejects
    # donating one buffer twice
    return Film(
        sum=jnp.zeros((height, width, 3), jnp.float32),
        secondary_sum=jnp.zeros((height, width, 3), jnp.float32),
        num_passes=jnp.int32(0),
        num_secondary_passes=jnp.int32(0),
    )


def accumulate_frame(film: Film, radiance: Vec3, use_secondary) -> Film:
    """Accumulate a full-frame wavefront result (pixel-ordered, flattened).

    ``use_secondary`` mirrors `Film::Film(sum, secondarySum if pass even)`:
    even passes also feed the secondary buffer so ``sum/N - 2*sec/N`` estimates
    per-pixel error (`Viewport.cpp:552-581`).
    """
    h, w = film.sum.shape[:2]
    frame = jnp.stack(
        [
            radiance.x.reshape(h, w),
            radiance.y.reshape(h, w),
            radiance.z.reshape(h, w),
        ],
        axis=-1,
    )
    sec = jnp.where(use_secondary, film.secondary_sum + frame, film.secondary_sum)
    return Film(
        sum=film.sum + frame,
        secondary_sum=sec,
        num_passes=film.num_passes + 1,
        num_secondary_passes=film.num_secondary_passes + use_secondary.astype(jnp.int32),
    )


def splat(film: Film, px: jnp.ndarray, py: jnp.ndarray, color: Vec3, mask) -> Film:
    """Scatter-add a batch of film-space samples (light tracer / VCM camera
    connections, `Film.cpp:42-77`).  ``px``/``py`` are integer pixel coords.

    Uses jnp scatter-add — XLA lowers this efficiently; the stochastic
    box-filter jitter of the reference is folded into how (px, py) were
    computed by the caller.
    """
    h, w = film.sum.shape[:2]
    inb = mask & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    fx = jnp.clip(px, 0, w - 1)
    fy = jnp.clip(py, 0, h - 1)
    m = inb.astype(jnp.float32)
    vals = jnp.stack([color.x * m, color.y * m, color.z * m], axis=-1)
    new_sum = film.sum.at[fy, fx].add(vals)
    return film._replace(sum=new_sum)


def average_radiance(film: Film) -> jnp.ndarray:
    """(H, W, 3) mean radiance — the input to postprocess."""
    n = jnp.maximum(film.num_passes, 1).astype(jnp.float32)
    return film.sum / n


def error_estimate(film: Film) -> jnp.ndarray:
    """Per-pixel relative error vs the secondary buffer — the adaptive
    rendering metric (`Viewport.cpp:552-581`): |sum/N - sec/M| / (luma + eps).
    """
    n = jnp.maximum(film.num_passes, 1).astype(jnp.float32)
    m = jnp.maximum(film.num_secondary_passes, 1).astype(jnp.float32)
    a = film.sum / n
    b = film.secondary_sum / m
    diff = jnp.sum(jnp.abs(a - b), axis=-1)
    denom = jnp.sum(a, axis=-1) + 0.0001
    return diff / denom

"""Adaptive rendering: per-block error estimation + block subdivision.

Re-expression of the reference's adaptive pipeline (`Viewport.cpp:
644-732` UpdateBlocksList, `:552-581` per-block error): the film keeps a
secondary every-2nd-pass accumulation buffer; every adaptation period the
per-block relative error between the two estimates is measured, converged
blocks are dropped from the active list, and noisy blocks are split in half
so sampling concentrates where the variance is.

Device mapping: blocks live on the host (tiny metadata, like the reference's
block list); each pass traces ONE padded wavefront of the active blocks'
pixel ids via ``trace_pixels`` (the analogue of tiles-from-blocks,
`Viewport.cpp:227-230`), scatter-adding into per-pixel sum/weight buffers.
The wavefront is padded to power-of-two buckets so XLA compiles O(log N)
kernel variants, not one per block-list change.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..integrators.path_tracer import RenderParams
from ..sampler.sampler import halton_frame_vector
from ..scene.camera import Camera
from ..scene.types import SceneData, SceneMeta
from .postprocess import PostprocessParams, postprocess, to_u8
from .renderer import ViewportParams, trace_pixels


@dataclass(frozen=True)
class AdaptiveSettings:
    """AdaptiveRenderingSettings (`Context.h:77-90`)."""

    num_initial_passes: int = 4  # full-frame passes before adapting
    adaptation_period: int = 2  # adapt every N passes (secondary buffer cadence)
    convergence_threshold: float = 0.005  # drop blocks below this error
    subdivision_threshold: float = 0.02  # split blocks below this (but not converged)
    min_block_size: int = 8
    max_block_size: int = 64


@dataclass
class Block:
    y0: int
    x0: int
    h: int
    w: int
    error: float = float("inf")


def _pad_to_bucket(n: int) -> int:
    """Next power of two >= n (bounds the number of jit specializations)."""
    if n <= 256:
        return 256
    return 1 << (n - 1).bit_length()


def _trace_scatter(scene, meta, cam, pixel_ids, valid, pass_idx, halton, vp, params,
                   sum_img, sec_img, weight, sec_weight):
    """Trace a padded pixel-id wavefront and scatter-add into the buffers."""
    radiance, counters = trace_pixels(
        scene, meta, cam, pixel_ids, pass_idx, halton, vp, params
    )
    v = valid.astype(jnp.float32)
    rgb = jnp.stack([radiance.x * v, radiance.y * v, radiance.z * v], axis=-1)
    ys = pixel_ids // vp.width
    xs = pixel_ids % vp.width
    sum_img = sum_img.at[ys, xs].add(rgb, mode="drop")
    weight = weight.at[ys, xs].add(v, mode="drop")
    use_sec = (pass_idx % 2) == 0
    sec_img = sec_img.at[ys, xs].add(jnp.where(use_sec, 1.0, 0.0) * rgb, mode="drop")
    sec_weight = sec_weight.at[ys, xs].add(jnp.where(use_sec, v, 0.0), mode="drop")
    return sum_img, sec_img, weight, sec_weight, counters


_jitted_trace_scatter = jax.jit(
    _trace_scatter, static_argnames=("meta", "vp", "params")
)


class AdaptiveViewport:
    """Viewport variant that focuses samples on unconverged blocks.

    Unlike the uniform :class:`~raytracer_tpu.render.renderer.Viewport`, the
    per-pixel pass count varies, so the film here is (sum, weight) with
    ``radiance = sum / weight`` — converged pixels keep their last estimate
    exactly (the reference freezes them by dropping their blocks).
    """

    def __init__(
        self,
        scene: SceneData,
        meta: SceneMeta,
        cam: Camera,
        vp_params: ViewportParams = ViewportParams(),
        render_params: RenderParams = RenderParams(),
        adaptive: AdaptiveSettings = AdaptiveSettings(),
        post_params: PostprocessParams = PostprocessParams(),
    ):
        self.scene = scene
        self.meta = meta
        self.cam = cam
        self.vp_params = vp_params
        self.render_params = render_params
        self.adaptive = adaptive
        self.post_params = post_params
        h, w = vp_params.height, vp_params.width
        self.sum = jnp.zeros((h, w, 3), jnp.float32)
        self.sec = jnp.zeros((h, w, 3), jnp.float32)
        self.weight = jnp.zeros((h, w), jnp.float32)
        self.sec_weight = jnp.zeros((h, w), jnp.float32)
        self.passes = 0
        self.total_rays = 0.0
        self.converged_fraction = 0.0
        self.average_error = float("inf")
        # initial block grid (`Viewport::Resize` builds the initial list)
        bs = adaptive.max_block_size
        self.blocks: list[Block] = [
            Block(y, x, min(bs, h - y), min(bs, w - x))
            for y in range(0, h, bs)
            for x in range(0, w, bs)
        ]
        self._ids_cache: tuple[jnp.ndarray, jnp.ndarray] | None = None

    # --- active pixel set ------------------------------------------------------
    def _active_ids(self) -> tuple[jnp.ndarray, jnp.ndarray]:
        if self._ids_cache is not None:
            return self._ids_cache
        w = self.vp_params.width
        ids = [
            (np.arange(b.y0, b.y0 + b.h)[:, None] * w
             + np.arange(b.x0, b.x0 + b.w)[None, :]).reshape(-1)
            for b in self.blocks
        ]
        flat = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        n = len(flat)
        padded = np.zeros(_pad_to_bucket(max(n, 1)), np.int32)
        padded[:n] = flat
        valid = np.zeros(len(padded), bool)
        valid[:n] = True
        self._ids_cache = (jnp.asarray(padded), jnp.asarray(valid))
        return self._ids_cache

    # --- error + block update ---------------------------------------------------
    def _error_map(self) -> np.ndarray:
        n = np.maximum(np.asarray(self.weight), 1.0)
        m = np.maximum(np.asarray(self.sec_weight), 1.0)
        a = np.asarray(self.sum) / n[..., None]
        b = np.asarray(self.sec) / m[..., None]
        return np.abs(a - b).sum(-1) / (a.sum(-1) + 1e-4)

    def _update_blocks(self):
        """UpdateBlocksList (`Viewport.cpp:644-732`): drop converged blocks,
        split semi-converged ones in half along their longer side."""
        err = self._error_map()
        s = self.adaptive
        new_blocks: list[Block] = []
        total_err = 0.0
        for b in self.blocks:
            e = float(err[b.y0:b.y0 + b.h, b.x0:b.x0 + b.w].mean())
            b.error = e
            total_err += e * b.h * b.w
            if e < s.convergence_threshold:
                continue  # converged: dropped from rendering
            if e < s.subdivision_threshold and max(b.h, b.w) >= 2 * s.min_block_size:
                if b.h >= b.w:
                    h0 = b.h // 2
                    new_blocks.append(Block(b.y0, b.x0, h0, b.w, e))
                    new_blocks.append(Block(b.y0 + h0, b.x0, b.h - h0, b.w, e))
                else:
                    w0 = b.w // 2
                    new_blocks.append(Block(b.y0, b.x0, b.h, w0, e))
                    new_blocks.append(Block(b.y0, b.x0 + w0, b.h, b.w - w0, e))
            else:
                new_blocks.append(b)
        area = self.vp_params.width * self.vp_params.height
        active_area = sum(b.h * b.w for b in new_blocks)
        self.converged_fraction = 1.0 - active_area / area
        self.average_error = total_err / area
        self.blocks = new_blocks
        self._ids_cache = None

    # --- main loop ---------------------------------------------------------------
    def render(self, n_passes: int = 1):
        s = self.adaptive
        for _ in range(n_passes):
            if not self.blocks:
                self.passes += 1
                continue  # fully converged
            ids, valid = self._active_ids()
            halton = None
            if self.vp_params.use_low_discrepancy:
                halton = jnp.asarray(halton_frame_vector(self.passes))
            self.sum, self.sec, self.weight, self.sec_weight, counters = (
                _jitted_trace_scatter(
                    self.scene, self.meta, self.cam, ids, valid,
                    jnp.int32(self.passes), halton, self.vp_params,
                    self.render_params, self.sum, self.sec, self.weight,
                    self.sec_weight,
                )
            )
            self.total_rays += float(counters.num_rays)
            self.passes += 1
            if (
                self.passes >= s.num_initial_passes
                and self.passes % s.adaptation_period == 0
            ):
                self._update_blocks()
        return self

    # --- outputs -------------------------------------------------------------------
    def radiance(self) -> np.ndarray:
        w = jnp.maximum(self.weight, 1.0)[..., None]
        return np.asarray(self.sum / w)

    def image(self) -> np.ndarray:
        srgb = postprocess(jnp.asarray(self.radiance()), self.post_params,
                           dither_seed=self.passes)
        return np.asarray(to_u8(srgb))

    def progress(self) -> dict:
        """RenderingProgress (`Viewport.h:25-32`): passes, active blocks,
        converged %, average error (also in dB like the UI)."""
        return {
            "passes_finished": self.passes,
            "active_blocks": len(self.blocks),
            "active_pixels": sum(b.h * b.w for b in self.blocks),
            "converged_fraction": self.converged_fraction,
            "average_error": self.average_error,
            "error_db": (10.0 * np.log10(self.average_error)
                         if np.isfinite(self.average_error) and self.average_error > 0
                         else float("-inf")),
            "total_rays": self.total_rays,
        }

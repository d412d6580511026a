"""Frame-loop driver — the `Viewport` (`Core/Rendering/Viewport.cpp`).

One render pass = one jit-compiled program over the full pixel wavefront:

    pixel grid -> per-pass AA jitter -> camera rays -> integrator wavefront
    -> film accumulation (donated buffers)

The reference's tile/thread decomposition (`Viewport::RenderTile` over a
ThreadPool, `Viewport.cpp:227-261`) becomes a single SPMD program;
multi-chip data parallelism shards the pixel-row axis over a device mesh
(see `parallel/mesh.py`), which is the analogue of tiles-over-threads (P3 in
SURVEY §2.9).

Determinism: every sample is a pure function of (pixel_id, pass, dim, seed)
via the counter-based sampler, so renders are reproducible for any device
count and any pass interleaving — the property that makes accumulation state
checkpointable/resumable (SURVEY §5).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..integrators.path_tracer import Counters, RenderParams, trace_radiance
from ..math.sampling import sample_gaussian2
from ..sampler.sampler import hash_u32, halton_frame_vector, make_stream, next_1d, u32_to_unit_float
from ..scene.camera import Camera, Rays, generate_rays
from ..scene.types import SceneData, SceneMeta
from .film import Film, accumulate_frame, average_radiance, make_film
from .postprocess import PostprocessParams, postprocess, to_u8


@dataclass(frozen=True)
class ViewportParams:
    """Frame-level knobs (subset of RenderingParams, `Context.h:55-90`)."""

    width: int = 256
    height: int = 256
    anti_aliasing_spread: float = 0.5
    use_low_discrepancy: bool = True  # SamplingParams.dimensions > 0
    # blue-noise Cranley-Patterson rotation of the first 4 sample dims
    # (SamplingParams::useBlueNoiseDithering, `GenericSampler.cpp:83-112`);
    # only meaningful with low discrepancy on
    use_blue_noise: bool = True
    seed: int = 0
    # shutter-open fraction: per-pixel ray time = u * strength
    # (RenderingParams::motionBlurStrength, `Context.h:64-66`; sampled per
    # pixel at `Viewport.cpp:309`)
    motion_blur_strength: float = 0.0


def pixel_grid(width: int, height: int, rows: int | None = None, row0=0):
    """Flattened pixel centers (film coords x right, y up) and global pixel
    ids for a ``rows``-row horizontal band starting at (traced or static)
    ``row0``.  Bands are the DP sharding unit over the device mesh — the
    analogue of the reference's tiles-over-threads (`Viewport.cpp:227-261`)."""
    rows = height if rows is None else rows
    ys = jax.lax.broadcasted_iota(jnp.int32, (rows, width), 0) + row0
    xs = jax.lax.broadcasted_iota(jnp.int32, (rows, width), 1)
    pixel_ids = (ys * width + xs).reshape(-1)
    # film y is up; image row 0 is the top row (matches bitmap save order)
    cx = (xs.reshape(-1).astype(jnp.float32) + 0.5) / width
    cy = 1.0 - (ys.reshape(-1).astype(jnp.float32) + 0.5) / height
    return cx, cy, pixel_ids


def trace_rows(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    pass_idx: jnp.ndarray,
    halton: jnp.ndarray | None,
    vp: ViewportParams,
    params: RenderParams,
    rows: int | None = None,
    row0=0,
):
    """Camera rays + integrator for one band of pixel rows.

    The shared core of the single-chip pass and the shard_map'd multi-chip
    pass.  Determinism: samples depend only on *global* pixel id + pass +
    seed, so any row partitioning yields identical radiance."""
    cx, cy, pixel_ids = pixel_grid(vp.width, vp.height, rows, row0)
    return _trace_at(scene, meta, cam, cx, cy, pixel_ids, pass_idx, halton, vp, params)


def trace_pixels(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    pixel_ids: jnp.ndarray,
    pass_idx: jnp.ndarray,
    halton: jnp.ndarray | None,
    vp: ViewportParams,
    params: RenderParams,
):
    """Camera rays + integrator for an arbitrary (padded) set of pixel ids —
    the adaptive-rendering work unit: only non-converged blocks' pixels are
    traced (`Viewport::UpdateBlocksList`, `Viewport.cpp:644-732`).  Samples
    are keyed by global pixel id, so results are identical to full-frame
    tracing of the same pixels."""
    xs = pixel_ids % vp.width
    ys = pixel_ids // vp.width
    cx = (xs.astype(jnp.float32) + 0.5) / vp.width
    cy = 1.0 - (ys.astype(jnp.float32) + 0.5) / vp.height
    return _trace_at(scene, meta, cam, cx, cy, pixel_ids, pass_idx, halton, vp, params)


def _trace_at(scene, meta, cam, cx, cy, pixel_ids, pass_idx, halton, vp, params):
    # per-pass Gaussian AA jitter shared by all pixels (`Viewport.cpp:235-241`)
    u1 = u32_to_unit_float(hash_u32(pass_idx.astype(jnp.uint32) * jnp.uint32(2654435761) + jnp.uint32(vp.seed)))
    u2 = u32_to_unit_float(hash_u32(pass_idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B9) + jnp.uint32(vp.seed + 7)))
    jx, jy = sample_gaussian2(jnp.maximum(u1, 1e-6), u2)
    spread = vp.anti_aliasing_spread
    cx = cx + jx * (spread / vp.width)
    cy = cy + jy * (spread / vp.height)

    blue = None
    if halton is not None and vp.use_blue_noise:
        from ..sampler.sampler import blue_noise_for_pixels

        blue = blue_noise_for_pixels(pixel_ids, vp.width)
    stream = make_stream(pixel_ids, pass_idx, seed=vp.seed, halton=halton, blue=blue)
    time = None
    if vp.motion_blur_strength > 0.0:
        u_t, stream = next_1d(stream)
        time = u_t * vp.motion_blur_strength
    rays, stream = generate_rays(cam, cx, cy, stream, time=time)
    return trace_radiance(scene, meta, rays, stream, params, time=time, pass_idx=pass_idx)


def render_pass(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    film: Film,
    pass_idx: jnp.ndarray,
    halton: jnp.ndarray | None,
    vp: ViewportParams,
    params: RenderParams,
) -> tuple[Film, Counters]:
    """One full-frame accumulation pass (jit this with static meta/vp/params)."""
    radiance, counters = trace_rows(scene, meta, cam, pass_idx, halton, vp, params)
    film = accumulate_frame(film, radiance, use_secondary=(pass_idx % 2 == 0))
    return film, counters


# Single module-level jit wrapper shared by all Viewports: the static config
# (meta / vp / params are hashable frozen dataclasses) is part of the cache
# key, so different scenes/configs compile separately but identical ones share
# the executable.  NOTE: no donate_argnames — donation triggers a stale
# executable-cache collision in jax 0.9's C++ fast path when two configs share
# input avals (observed: "supplied 101 buffers but expected 106"); the film
# copy it would save is negligible next to the render itself.
_jitted_render_pass = jax.jit(
    render_pass,
    static_argnames=("meta", "vp", "params"),
)


def render_passes(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    film: Film,
    pass0: jnp.ndarray,
    haltons: jnp.ndarray | None,
    vp: ViewportParams,
    params: RenderParams,
    n_passes: int,
) -> tuple[Film, Counters]:
    """``n_passes`` accumulation passes chained in ONE jitted `lax.scan`.

    One host dispatch per BATCH instead of per pass, so the per-launch host
    overhead is paid once per batch.  The scan body is exactly
    :func:`render_pass`, so results are bit-identical to the per-pass loop.

    ``haltons``: (n_passes, dims) stacked per-pass Halton vectors, or None.
    Returned counters are summed over the batch.
    """
    def body(carry, halton):
        film, pidx = carry
        film, counters = render_pass(scene, meta, cam, film, pidx, halton, vp, params)
        return (film, pidx + 1), counters

    xs = haltons
    if xs is None:
        xs = jnp.zeros((n_passes, 0), jnp.float32)

    def body_opt(carry, xs_row):
        return body(carry, xs_row if haltons is not None else None)

    (film, _), counters = jax.lax.scan(body_opt, (film, pass0), xs)
    summed = jax.tree.map(lambda a: jnp.sum(a, axis=0), counters)
    return film, summed


_jitted_render_passes = jax.jit(
    render_passes,
    static_argnames=("meta", "vp", "params", "n_passes"),
)


class Viewport:
    """Stateful orchestration: film + pass counter + compiled pass fn.

    Usage:
        vp = Viewport(scene, meta, cam, ViewportParams(512, 512))
        vp.render(n_passes=16)
        img = vp.image()            # postprocessed sRGB uint8
        hdr = vp.radiance()         # (H, W, 3) float32 mean radiance
    """

    def __init__(
        self,
        scene: SceneData,
        meta: SceneMeta,
        cam: Camera,
        vp_params: ViewportParams = ViewportParams(),
        render_params: RenderParams = RenderParams(),
        post_params: PostprocessParams = PostprocessParams(),
    ):
        self.scene = scene
        self.meta = meta
        self.cam = cam
        self.vp_params = vp_params
        self.render_params = render_params
        self.post_params = post_params
        self.film = make_film(vp_params.width, vp_params.height)
        self.total_rays = 0.0
        self.total_shadow_rays = 0.0
        self.total_overflow = 0.0
        self.total_box_tests = 0.0
        self.total_tri_tests = 0.0

        self._pass_fn = _jitted_render_pass

    def reset(self):
        """Restart accumulation (`Viewport::Reset`)."""
        self.film = make_film(self.vp_params.width, self.vp_params.height)
        self.total_rays = 0.0
        self.total_shadow_rays = 0.0
        self.total_overflow = 0.0
        self.total_box_tests = 0.0
        self.total_tri_tests = 0.0

    def render(self, n_passes: int = 1):
        """Run ``n_passes`` accumulation passes (`Viewport::Render`).

        All passes run in ONE jitted scan (`render_passes`) — one host
        dispatch per batch, bit-identical to per-pass dispatching."""
        pass_idx = int(self.film.num_passes)
        halton = None
        if self.vp_params.use_low_discrepancy:
            halton = jnp.asarray(
                np.stack([halton_frame_vector(pass_idx + i) for i in range(n_passes)])
            )
        self.film, counters = _jitted_render_passes(
            self.scene, self.meta, self.cam, self.film, jnp.int32(pass_idx),
            halton, self.vp_params, self.render_params, n_passes,
        )
        self.total_rays += float(counters.num_rays)
        self.total_shadow_rays += float(counters.num_shadow_rays)
        if getattr(counters, "num_box_tests", None) is not None:
            self.total_box_tests += float(counters.num_box_tests)
            self.total_tri_tests += float(counters.num_tri_tests)
        if counters.num_overflow is not None:
            self.total_overflow += float(counters.num_overflow)
        return self

    def radiance(self) -> np.ndarray:
        return np.asarray(average_radiance(self.film))

    def image(self) -> np.ndarray:
        srgb = postprocess(average_radiance(self.film), self.post_params,
                           dither_seed=int(self.film.num_passes))
        return np.asarray(to_u8(srgb))

    def progress(self) -> dict:
        """RenderingProgress analogue (`Viewport.h:25-32`)."""
        return {
            "passes_finished": int(self.film.num_passes),
            "total_rays": self.total_rays,
            "total_shadow_rays": self.total_shadow_rays,
            # truncation diagnostics from budgeted traversal backends
            # (ops/traverse.py) — nonzero means raise the candidate budget
            "total_traversal_overflow": self.total_overflow,
            # opt-in intersection-test totals (RenderParams.count_traversal;
            # the reference's `Counters.h:43-48` analogue) — 0 when disabled
            "total_box_tests": self.total_box_tests,
            "total_tri_tests": self.total_tri_tests,
        }

    def save_checkpoint(self, path: str):
        """Persist render state; resumable via :meth:`load_checkpoint`.

        State = film + pass counter + seed (SURVEY §5): sample streams are
        keyed by (pixel, pass, dim), so resuming continues bit-exactly.
        """
        from .checkpoint import save_checkpoint

        save_checkpoint(
            path, self.film, self.vp_params.seed,
            extra={"total_rays": self.total_rays,
                   "total_shadow_rays": self.total_shadow_rays},
        )
        return self

    def load_checkpoint(self, path: str):
        """Restore render state saved by :meth:`save_checkpoint`."""
        from .checkpoint import load_checkpoint

        film, seed, meta = load_checkpoint(path)
        if film.sum.shape != (self.vp_params.height, self.vp_params.width, 3):
            raise ValueError(
                f"checkpoint film {film.sum.shape[:2]} does not match viewport "
                f"{(self.vp_params.height, self.vp_params.width)}"
            )
        if seed != self.vp_params.seed:
            raise ValueError(
                f"checkpoint seed {seed} != viewport seed {self.vp_params.seed}; "
                "resuming would change the sample streams"
            )
        self.film = film
        self.total_rays = float(meta.get("total_rays", 0.0))
        self.total_shadow_rays = float(meta.get("total_shadow_rays", 0.0))
        return self

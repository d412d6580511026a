"""Wavefront light tracer — reverse path tracing with camera splats.

Re-expression of `Core/Rendering/LightTracer.cpp:26-183`: light paths are
emitted from randomly picked lights (`ILight::Emit`), walked through the
scene, and at every vertex connected to the camera: BSDF toward the camera ×
visibility × camera importance factor `PdfW(-dirToCamera)/d²`, splatted onto
the film at `WorldToFilm(position)` (`:121-158`).

The per-pixel loop becomes a wavefront of N light paths (N = pixel count, so
film normalization `sum/passes` matches the reference); the bounce loop is a
`lax.scan` whose stacked per-depth outputs are scatter-added into the film in
one shot — the wavefront version of `Film::AccumulateColor` position splats
(`Film.cpp:42-77`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.sampling import world_to_local
from ..math.vec import Vec3, dot, max_component, where as vwhere
from ..ops import bsdf as bsdf_ops
from ..ops.intersect import BIG
from ..ops.lights import emit, gather_light
from ..ops.materials import resolve_material
from ..ops.traverse import scene_occluded, scene_traverse
from ..sampler.sampler import SampleStream, next_1d, next_2d, next_3d
from ..scene.camera import Camera, camera_pdf_w, world_to_film
from ..scene.types import SceneData, SceneMeta
from .path_tracer import RAY_OFFSET, SHADOW_OFFSET, Counters, RenderParams

EMIT_OFFSET = 5e-4  # `LightTracer.cpp:62`


class _LtState(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3
    alive: jnp.ndarray
    stream: SampleStream
    num_rays: jnp.ndarray


class SplatBatch(NamedTuple):
    """Per-depth camera-connection splats (stacked over the scan)."""

    u: jnp.ndarray  # film coords in [0,1)
    v: jnp.ndarray
    color: Vec3
    mask: jnp.ndarray


def trace_light_wavefront(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    stream: SampleStream,
    params: RenderParams,
    n_paths: int,
) -> tuple[SplatBatch, Counters]:
    """Trace ``n_paths`` light paths; returns stacked splats (D, N) + counters."""
    n = (n_paths,)
    n_lights = max(meta.n_lights, 1)
    pick_prob = 1.0 / n_lights

    # --- pick a light per path + emit (`LightTracer.cpp:37-68`)
    u_pick, stream = next_1d(stream)
    light_idx = jnp.clip((u_pick * n_lights).astype(jnp.int32), 0, n_lights - 1)
    l = gather_light(scene.lights, light_idx)
    u1, u2, stream = next_2d(stream)
    u3, u4, u5, stream = next_3d(stream)
    em = emit(l, u1, u2, u3, u4, u5, scene_radius=meta.scene_radius)

    emission_pdf = em.emission_pdf_w * pick_prob
    throughput = em.radiance * (1.0 / emission_pdf)
    alive = (max_component(throughput) > 1e-9) & jnp.ones(n, bool)
    if meta.n_lights == 0:
        alive = jnp.zeros(n, bool)

    init = _LtState(
        origin=em.position + em.direction * EMIT_OFFSET,
        direction=em.direction,
        throughput=throughput,
        alive=alive,
        stream=stream,
        num_rays=jnp.zeros((), jnp.float32),
    )

    def bounce(state: _LtState, depth):
        num_rays = state.num_rays + jnp.sum(state.alive.astype(jnp.float32))
        hits = scene_traverse(scene, state.origin, state.direction)
        miss = hits.t >= BIG * 0.5
        hits = hits._replace(t=jnp.clip(hits.t, 0.0, 1e12))

        from ..ops.intersect import eval_prim_frame

        from ..ops.materials import apply_normal_map
        from ..ops.traverse import scene_hit_frame

        frame = scene_hit_frame(scene, hits, state.origin, state.direction)
        frame = apply_normal_map(scene, frame)

        # stop on miss or on hitting a light (`LightTracer.cpp:79-87`)
        hit_surface = state.alive & (~miss) & (frame.light_id < 0)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v)
        wo_local = world_to_local(
            -state.direction, frame.tangent, frame.bitangent, frame.normal
        )

        # --- camera connection (`LightTracer.cpp:121-158`)
        to_cam = Vec3(
            cam.origin.x - frame.position.x,
            cam.origin.y - frame.position.y,
            cam.origin.z - frame.position.z,
        )
        d2 = dot(to_cam, to_cam)
        dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
        dir_to_cam = to_cam * (1.0 / dist)
        wi_local = world_to_local(dir_to_cam, frame.tangent, frame.bitangent, frame.normal)
        f_cam, _pdf = bsdf_ops.evaluate(mp, wo_local, wi_local)
        fu, fv, on_film = world_to_film(cam, frame.position)
        shadow_origin = frame.position + frame.normal * SHADOW_OFFSET
        visible = ~scene_occluded(scene, shadow_origin, dir_to_cam, dist * 0.999)[0]
        cam_pdf_a = camera_pdf_w(cam, -dir_to_cam) / jnp.maximum(d2, 1e-12)
        contrib = f_cam * state.throughput * cam_pdf_a
        splat_mask = hit_surface & on_film & visible & (max_component(f_cam) > 0.0)
        splat = SplatBatch(u=fu, v=fv, color=contrib, mask=splat_mask)

        # --- BSDF sampling to continue the walk (`LightTracer.cpp:160-175`)
        stream = state.stream
        s1, s2, s3, stream = next_3d(stream)
        smp = bsdf_ops.sample(mp, wo_local, s1, s2, s3)
        from ..math.sampling import local_to_world

        wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
        survive = hit_surface & smp.valid & (depth < params.max_depth)
        new_throughput = state.throughput * smp.weight
        survive = survive & (max_component(new_throughput) > 1e-9)

        new_state = _LtState(
            origin=vwhere(survive, frame.position + wi_world * RAY_OFFSET, state.origin),
            direction=vwhere(survive, wi_world, state.direction),
            throughput=vwhere(survive, new_throughput, state.throughput),
            alive=survive,
            stream=stream,
            num_rays=num_rays,
        )
        return new_state, splat

    depths = jnp.arange(params.max_depth + 1)
    state, splats = jax.lax.scan(bounce, init, depths)
    return splats, Counters(state.num_rays, jnp.zeros((), jnp.float32))


def splat_to_film(film, splats: SplatBatch, width: int, height: int):
    """Scatter-add stacked splats into the film sum with the stochastic
    box-filter jitter folded into rounding (`Film.cpp:42-77` uses jittered
    rounding; here film coords are continuous and we round to nearest)."""
    from ..render.film import splat as film_splat

    u = splats.u.reshape(-1)
    v = splats.v.reshape(-1)
    color = Vec3(
        splats.color.x.reshape(-1), splats.color.y.reshape(-1), splats.color.z.reshape(-1)
    )
    mask = splats.mask.reshape(-1)
    px = jnp.floor(u * width).astype(jnp.int32)
    # film v is up; image row 0 is top
    py = jnp.floor((1.0 - v) * height).astype(jnp.int32)
    return film_splat(film, px, py, color, mask)


def render_pass_light_tracer(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    film,
    pass_idx: jnp.ndarray,
    halton,
    vp,
    params: RenderParams,
):
    """One light-tracing accumulation pass over W*H light paths."""
    from ..sampler.sampler import make_stream

    n_paths = vp.width * vp.height
    path_ids = jnp.arange(n_paths, dtype=jnp.uint32)
    stream = make_stream(path_ids, pass_idx, seed=vp.seed + 0x517, halton=halton)
    splats, counters = trace_light_wavefront(scene, meta, cam, stream, params, n_paths)
    film = splat_to_film(film, splats, vp.width, vp.height)
    film = film._replace(num_passes=film.num_passes + 1)
    return film, counters

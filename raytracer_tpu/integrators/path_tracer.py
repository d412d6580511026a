"""Wavefront path tracer (naive + MIS), differentiable, jit-compiled.

Re-expression of the reference integrators:
- naive BSDF-sampling PT (`Core/Rendering/PathTracer.cpp:74-172`)
- PT with next-event estimation and balance-heuristic MIS
  (`Core/Rendering/PathTracerMIS.cpp:254-415`)

The per-pixel ``for(;;)`` bounce loop becomes a `lax.scan` over bounce index
with per-lane alive masks — the analogue of the reference's packet compaction
(P2 in SURVEY §2.9), but compiler-friendly and reverse-mode differentiable
(scan supports AD where while_loop does not).  All discrete sampling decisions
(hit ids, lobe choice, RR) are non-differentiated; radiance stays smooth in
material/light/camera parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.sampling import local_to_world, pdf_area_to_solid_angle, world_to_local
from ..math.vec import Vec3, dot, max_component, where as vwhere
from ..ops import bsdf as bsdf_ops
from ..ops.intersect import BIG, PrimFrame, eval_prim_frame
from ..ops.lights import gather_light, illuminate
from ..ops.materials import resolve_material
from ..ops.traverse import scene_occluded, scene_traverse
from ..sampler.sampler import SampleStream, next_1d, next_3d
from ..scene.camera import Rays
from ..scene.types import (
    LIGHT_AREA,
    LIGHT_BACKGROUND,
    LIGHT_DIRECTIONAL,
    SHAPE_SPHERE,
    SceneData,
    SceneMeta,
)

RAY_OFFSET = 1e-3  # secondary ray epsilon (`PathTracerMIS.cpp:392`)
SHADOW_OFFSET = 1e-4  # shadow ray epsilon (`PathTracerMIS.cpp:90-92`)


@dataclass(frozen=True)
class RenderParams:
    """Static integrator config (RenderingParams, `Context.h:55-90`)."""

    max_depth: int = 20
    min_rr_depth: int = 1
    mis: bool = True  # False => naive PathTracer semantics
    light_strategy: str = "single"  # "single" | "all" (`Context.h:28-33`)
    # hero-wavelength spectral rendering (`RT_ENABLE_SPECTRAL_RENDERING`):
    # each path samples one wavelength; dispersive dielectrics get a Cauchy
    # wavelength-dependent IoR and collapse the path to that wavelength
    spectral: bool = False
    # opt-in per-ray traversal-work counters (the analogue of the
    # reference's compile-gated `RT_ENABLE_INTERSECTION_COUNTERS`,
    # `Config.h:4`, `Counters.h:43-48`) — extra slab passes when enabled
    count_traversal: bool = False
    # unroll the bounce loop instead of lax.scan: larger program/compile time,
    # but lets XLA optimize across bounces.  Purely a performance knob — AD is
    # safe on both paths (the historical "scan-linearization NaN" was really a
    # masked-lane 0*inf in the sphere-cone MIS pdf, fixed in ops/lights.py
    # sphere_cone_cos_max / math/sampling.py sample_cone)
    unroll: bool = False


class Counters(NamedTuple):
    """Per-wavefront ray counters (`Core/Rendering/Counters.h:10-48`)."""

    num_rays: jnp.ndarray  # primary+secondary rays actually traced
    num_shadow_rays: jnp.ndarray
    # rays whose mesh traversal may have been truncated by the candidate
    # budget (ops/traverse.py "no silent caps"); 0 on exact backends
    num_overflow: jnp.ndarray = None
    # opt-in (RenderParams.count_traversal) ray-box / ray-triangle test
    # totals (`Counters.h:43-48`)
    num_box_tests: jnp.ndarray = None
    num_tri_tests: jnp.ndarray = None


def _combine_mis(sample_pdf, other_pdf):
    """Balance heuristic (`PathTracerMIS.cpp:16-24`)."""
    return sample_pdf / jnp.maximum(sample_pdf + other_pdf, 1e-12)


class _PathState(NamedTuple):
    origin: Vec3
    direction: Vec3
    # closest-hit record for the CURRENT segment (origin, direction) — traced
    # at the END of the previous bounce (fused with its shadow query), so a
    # bounce starts with its geometry already known
    hits: object
    throughput: Vec3
    result: Vec3
    alive: jnp.ndarray
    last_pdf: jnp.ndarray
    last_specular: jnp.ndarray
    stream: SampleStream
    num_rays: jnp.ndarray
    num_shadow_rays: jnp.ndarray
    num_overflow: jnp.ndarray
    num_box_tests: jnp.ndarray
    num_tri_tests: jnp.ndarray
    # spectral mode: True once the path's hero wavelength collapsed at a
    # dispersive event (`RoughDielectricBSDF.cpp:29-44`); the resolve weight
    # is applied exactly once
    dispersed: jnp.ndarray = None


def _light_pick_probability(meta: SceneMeta, params: RenderParams) -> float:
    """GetLightPickingProbability (`PathTracerMIS.cpp:157-172`)."""
    if params.light_strategy == "all":
        return 1.0
    return 1.0 / max(meta.n_lights, 1)


def _env_radiance(scene: SceneData, li: int, direction: Vec3) -> Vec3:
    """Background color along a direction, with optional env texture
    (`BackgroundLight.cpp:45-61`)."""
    lights = scene.lights
    color = Vec3(lights.color.x[li], lights.color.y[li], lights.color.z[li])
    if scene.textures is not None:
        from ..math.sampling import cartesian_to_spherical_uv
        from ..ops.textures import sample_texture_many

        tex_id = lights.env_tex[li]
        u, v = cartesian_to_spherical_uv(direction)
        ids = jnp.full_like(direction.x.astype(jnp.int32), 0) + tex_id
        tex = sample_texture_many(scene.textures, ids, u, v)
        color = color * tex
    return color


def _eval_global_lights(
    scene: SceneData, meta: SceneMeta, direction: Vec3, last_pdf, last_specular,
    depth, pick_prob, use_mis_weights: bool,
) -> Vec3:
    """Radiance from infinite lights on ray miss, MIS-weighted
    (`PathTracerMIS.cpp:215-252`). Static unroll over lights (kinds are static
    metadata, so only the relevant branches are emitted)."""
    lights = scene.lights
    total = Vec3.full(jnp.zeros_like(direction.x))
    use_mis = (depth > 0) & (~last_specular) if use_mis_weights else jnp.zeros((), bool)
    for li, kind in enumerate(meta.light_kinds):
        if kind == LIGHT_BACKGROUND:
            radiance = _env_radiance(scene, li, direction)
            if scene.env_dist is not None:
                # must match the pdf NEE sampled with (env importance sampling)
                from ..ops.lights import env_direction_pdf

                direct_pdf_w = env_direction_pdf(scene.env_dist, direction)
            else:
                direct_pdf_w = 1.0 / (2.0 * jnp.pi)  # UniformHemispherePdf
            visible = jnp.ones_like(direction.x, bool)
        elif kind == LIGHT_DIRECTIONAL and not meta.light_is_delta[li]:
            cos_angle = lights.cos_angle[li]
            axis = Vec3(lights.rot.r2.x[li], lights.rot.r2.y[li], lights.rot.r2.z[li])
            visible = dot(direction, axis) < -cos_angle
            radiance = Vec3(lights.color.x[li], lights.color.y[li], lights.color.z[li])
            direct_pdf_w = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_angle), 1e-20)
        else:
            continue
        w = jnp.where(use_mis, _combine_mis(last_pdf, direct_pdf_w * pick_prob), 1.0)
        total = total + radiance * (w * visible.astype(jnp.float32))
    return total


def _merge_frames(is_tri, a: PrimFrame, b: PrimFrame) -> PrimFrame:
    return PrimFrame(
        position=vwhere(is_tri, a.position, b.position),
        normal=vwhere(is_tri, a.normal, b.normal),
        tangent=vwhere(is_tri, a.tangent, b.tangent),
        bitangent=vwhere(is_tri, a.bitangent, b.bitangent),
        tex_u=jnp.where(is_tri, a.tex_u, b.tex_u),
        tex_v=jnp.where(is_tri, a.tex_v, b.tex_v),
        material_id=jnp.where(is_tri, a.material_id, b.material_id),
        light_id=jnp.where(is_tri, a.light_id, b.light_id),
    )


def _sample_lights_nee(
    scene: SceneData, meta: SceneMeta, params: RenderParams, frame: PrimFrame,
    mp, wo_local, pick_prob, is_last, stream: SampleStream, time=None,
    active=None, defer=False,
):
    """NEE (`PathTracerMIS.cpp:43-155`): 'single' picks one light uniformly,
    'all' loops every light.

    ``defer=False``: traces the shadow ray here; returns
    (contribution, n_shadow_rays, n_shadow_overflow, stream).

    ``defer=True`` (single shadow ray per lane only): skips the occlusion
    query and returns (unoccluded contribution, shadow Rays spec, needed
    mask, n_shadow_rays, stream) so the caller can FUSE the shadow query
    with the next bounce's closest-hit traversal — one wavefront dispatch
    per bounce instead of two.
    """
    n_lights = max(meta.n_lights, 1)
    u_pick, stream = next_1d(stream)
    if params.light_strategy == "all" and n_lights > 1:
        light_indices = [jnp.full_like(frame.material_id, i) for i in range(n_lights)]
    elif n_lights == 1:
        light_indices = [jnp.zeros_like(frame.material_id)]
    else:
        light_indices = [jnp.clip((u_pick * n_lights).astype(jnp.int32), 0, n_lights - 1)]
    assert not (defer and len(light_indices) > 1), "defer needs one shadow ray"

    total = Vec3.full(jnp.zeros_like(wo_local.x))
    n_shadow = jnp.zeros((), jnp.float32)
    n_overflow = jnp.zeros((), jnp.float32)
    for light_idx in light_indices:
        l = gather_light(scene.lights, light_idx)
        u1, u2, u3, stream = next_3d(stream)
        ill = illuminate(l, frame.position, frame.normal, u1, u2, u3,
                         env=scene.env_dist, sphere_cone=True,
                         scene_radius=meta.scene_radius)

        radiance = ill.radiance
        if meta.background_light_index >= 0 and scene.textures is not None:
            bg_rad = _env_radiance(scene, meta.background_light_index, ill.dir_to_light)
            radiance = vwhere(l.kind == LIGHT_BACKGROUND, bg_rad, radiance)

        wi_local = world_to_local(ill.dir_to_light, frame.tangent, frame.bitangent, frame.normal)
        f, bsdf_pdf = bsdf_ops.evaluate(mp, wo_local, wi_local)
        f_nonzero = max_component(f) > 0.0

        shadow_origin = frame.position + ill.dir_to_light * SHADOW_OFFSET
        max_t = jnp.minimum(ill.distance * 0.999, BIG)
        # lanes whose NEE contribution is already zero (dead paths, invalid
        # light samples, black BSDF) shadow-trace with t_max = 0 — free in
        # the wavefront engines (zero candidates emitted)
        needed = ill.valid & f_nonzero
        if active is not None:
            needed = needed & active
        n_shadow = n_shadow + jnp.sum((ill.valid & f_nonzero).astype(jnp.float32))

        w = jnp.where(
            (~l.is_delta) & (~is_last),
            _combine_mis(ill.direct_pdf_w * pick_prob, bsdf_pdf),
            1.0,
        )
        scale = (
            w
            / jnp.maximum(pick_prob * ill.direct_pdf_w, 1e-12)
            * (ill.valid & f_nonzero).astype(jnp.float32)
        )
        contrib = radiance * f * scale

        if defer:
            return (
                contrib,
                Rays(origin=shadow_origin, dir=ill.dir_to_light),
                jnp.where(needed, max_t, 0.0),
                needed,
                n_shadow,
                stream,
            )

        occluded, sh_ovf = scene_occluded(
            scene, shadow_origin, ill.dir_to_light, jnp.where(needed, max_t, 0.0),
            time=time,
        )
        n_overflow = n_overflow + jnp.sum(
            (ill.valid & f_nonzero & sh_ovf).astype(jnp.float32)
        )
        total = total + contrib * (~occluded).astype(jnp.float32)
    return total, n_shadow, n_overflow, stream


def trace_radiance(
    scene: SceneData,
    meta: SceneMeta,
    rays: Rays,
    stream: SampleStream,
    params: RenderParams,
    time=None,
    pass_idx=None,
) -> tuple[Vec3, Counters]:
    """Trace a wavefront to completion. Returns (radiance per ray, counters).

    ``time`` (N,): per-ray shutter time, constant along the path (the
    reference samples ``ctx.time`` once per pixel, `Viewport.cpp:309`).
    ``pass_idx``: stratifies the hero wavelength across passes in spectral
    mode (the pass-level analogue of the reference's 8 rotated wavelengths,
    `Wavelength.cpp:10-21`)."""
    n = rays.origin.x.shape
    pick_prob = _light_pick_probability(meta, params)

    wavelength = None
    if params.spectral:
        from ..color.spectrum import sample_wavelength, sample_wavelength_stratified

        u_l, stream = next_1d(stream)
        if pass_idx is not None:
            wavelength = sample_wavelength_stratified(u_l, pass_idx)
        else:
            wavelength = sample_wavelength(u_l)

    # camera segment traced up front; every later segment is traced fused
    # with the preceding bounce's shadow ray (ONE wavefront dispatch/bounce)
    hits0 = scene_traverse(scene, rays.origin, rays.dir, time=time)
    # single shadow ray per lane => the occlusion query can fuse with the
    # next closest-hit ('all'-strategy multi-light NEE keeps its own query)
    fused_shadow = params.mis and not (
        params.light_strategy == "all" and meta.n_lights > 1
    )

    init = _PathState(
        origin=rays.origin,
        direction=rays.dir,
        hits=hits0,
        throughput=Vec3.ones(n),
        result=Vec3.zeros(n),
        alive=jnp.ones(n, bool),
        last_pdf=jnp.ones(n, jnp.float32),
        last_specular=jnp.ones(n, bool),
        stream=stream,
        num_rays=jnp.full((), float(rays.origin.x.shape[0]), jnp.float32),
        num_shadow_rays=jnp.zeros((), jnp.float32),
        num_overflow=jnp.zeros((), jnp.float32),
        num_box_tests=jnp.zeros((), jnp.float32),
        num_tri_tests=jnp.zeros((), jnp.float32),
        dispersed=jnp.zeros(n, bool) if params.spectral else None,
    )

    def bounce(state: _PathState, depth) -> _PathState:
        num_rays = state.num_rays
        hits = state.hits
        num_box = state.num_box_tests
        num_tri = state.num_tri_tests
        if params.count_traversal:
            from ..ops.traverse import scene_traversal_cost

            bt, tt = scene_traversal_cost(scene, state.origin, state.direction, time=time)
            live = state.alive.astype(jnp.float32)
            num_box = num_box + jnp.sum(bt * live)
            num_tri = num_tri + jnp.sum(tt * live)
        num_overflow = state.num_overflow
        if hits.overflow is not None:
            num_overflow = num_overflow + jnp.sum(
                (state.alive & hits.overflow).astype(jnp.float32)
            )
        miss = hits.t >= BIG * 0.5
        # clamp miss-lane distances: t = BIG squares to inf in f32, and inf in
        # masked-out lanes poisons reverse-mode AD (0*inf = nan in cotangents)
        hits = hits._replace(t=jnp.clip(hits.t, 0.0, 1e12))

        # --- miss: global (infinite) lights ----------------------------------
        bg = _eval_global_lights(
            scene, meta, state.direction, state.last_pdf, state.last_specular,
            depth, pick_prob, use_mis_weights=params.mis,
        )
        m_miss = (state.alive & miss).astype(jnp.float32)
        result = state.result + state.throughput * bg * m_miss

        # --- shading frame at the hit ----------------------------------------
        from ..ops.materials import apply_normal_map
        from ..ops.traverse import scene_hit_frame

        frame = scene_hit_frame(scene, hits, state.origin, state.direction, time=time)
        frame = apply_normal_map(scene, frame)

        # --- direct light hit (`PathTracerMIS.cpp:174-212`) -------------------
        hit_light = state.alive & (~miss) & (frame.light_id >= 0)
        l_hit = gather_light(scene.lights, jnp.maximum(frame.light_id, 0))
        cos_at_light = dot(frame.normal, -state.direction)
        l_visible = cos_at_light > 1e-7
        direct_pdf_a = 1.0 / jnp.maximum(l_hit.area, 1e-8)
        direct_pdf_w = pdf_area_to_solid_angle(direct_pdf_a, hits.t, cos_at_light)
        # sphere lights: NEE samples the subtended cone, so the MIS pdf of
        # "light sampling would have produced this direction" is the cone pdf
        # (`SphereShape.cpp:108-124`)
        from ..math.sampling import sphere_cap_pdf
        from ..ops.lights import sphere_cone_cos_max

        cos_max, _, outside_s = sphere_cone_cos_max(
            l_hit.trans, l_hit.shape_param.x, state.origin
        )
        is_sphere_area = (l_hit.kind == LIGHT_AREA) & (
            l_hit.shape_kind == SHAPE_SPHERE
        )
        direct_pdf_w = jnp.where(
            is_sphere_area & outside_s, sphere_cap_pdf(cos_max), direct_pdf_w
        )
        # rect lights: NEE samples the Urena spherical quad, so the MIS pdf
        # of "light sampling would have chosen this direction" is 1/S
        # (`RectShape.cpp:66-94`); S measured from the previous vertex
        from ..math.sampling import spherical_quad_prepare
        from ..scene.types import SHAPE_RECT

        hx_r, hy_r = l_hit.shape_param.x, l_hit.shape_param.y
        corner = l_hit.rot.to_world(
            Vec3(-hx_r, -hy_r, jnp.zeros_like(hx_r))
        ) + l_hit.trans
        quad = spherical_quad_prepare(
            corner, l_hit.rot.r0 * (2.0 * hx_r), l_hit.rot.r1 * (2.0 * hy_r),
            state.origin,
        )
        is_rect_area = (l_hit.kind == LIGHT_AREA) & (l_hit.shape_kind == SHAPE_RECT)
        direct_pdf_w = jnp.where(is_rect_area, 1.0 / quad[-1], direct_pdf_w)
        use_mis = (depth > 0) & (~state.last_specular)
        w_light = jnp.where(
            use_mis, _combine_mis(state.last_pdf, direct_pdf_w * pick_prob), 1.0
        )
        if not params.mis:
            w_light = jnp.ones_like(w_light)
        m_light = (hit_light & l_visible).astype(jnp.float32)
        result = result + state.throughput * l_hit.color * (w_light * m_light)

        # --- surviving shading lanes ------------------------------------------
        survive = state.alive & (~miss) & (~hit_light)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v,
                              wavelength=wavelength, position=frame.position)

        # emission accumulation (`PathTracerMIS.cpp:306-317`)
        result = result + state.throughput * mp.emission * survive.astype(jnp.float32)

        wo_local = world_to_local(
            -state.direction, frame.tangent, frame.bitangent, frame.normal
        )

        stream = state.stream
        is_last = depth >= params.max_depth
        num_shadow = state.num_shadow_rays
        survive_pre = survive  # NEE applies with the PRE-RR throughput/mask
        shadow = None
        if params.mis and fused_shadow:
            nee_c, shadow_rays, shadow_cap, _needed, n_sh, stream = _sample_lights_nee(
                scene, meta, params, frame, mp, wo_local, pick_prob, is_last, stream,
                time=time, active=survive, defer=True,
            )
            shadow = (nee_c, shadow_rays, shadow_cap)
            num_shadow = num_shadow + n_sh
        elif params.mis:
            nee, n_sh, n_sh_ovf, stream = _sample_lights_nee(
                scene, meta, params, frame, mp, wo_local, pick_prob, is_last, stream,
                time=time, active=survive,
            )
            num_shadow = num_shadow + n_sh
            num_overflow = num_overflow + n_sh_ovf
            result = result + state.throughput * nee * survive.astype(jnp.float32)

        # --- depth cap (`PathTracerMIS.cpp:320-325`) ---------------------------
        survive = survive & (depth < params.max_depth)

        # --- Russian roulette (`PathTracerMIS.cpp:327-347`) --------------------
        u_rr, stream = next_1d(stream)
        threshold = 0.125 + 0.875 * jnp.clip(max_component(mp.base_color), 0.0, 1.0)
        do_rr = depth >= params.min_rr_depth
        rr_kill = do_rr & (u_rr > threshold)
        survive = survive & (~rr_kill)
        rr_scale = jnp.where(do_rr, 1.0 / jnp.maximum(threshold, 1e-6), 1.0)
        throughput = state.throughput * jnp.where(survive, rr_scale, 1.0)

        # --- BSDF sampling (`PathTracerMIS.cpp:349-368`) ------------------------
        u1, u2, u3, stream = next_3d(stream)
        smp = bsdf_ops.sample(mp, wo_local, u1, u2, u3)
        survive = survive & smp.valid
        wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
        throughput = throughput * vwhere(survive, smp.weight, Vec3.ones(n))
        survive = survive & (max_component(throughput) > 1e-7)

        # --- hero-wavelength collapse at the first dispersive scatter ----------
        # (`RoughDielectricBSDF.cpp:29-44`): continuation carries a single
        # wavelength; resolve its CIE->RGB weight into the throughput once
        dispersed = state.dispersed
        if params.spectral:
            from ..color.spectrum import rgb_resolve

            collapse = survive & mp.dispersive & (~state.dispersed)
            r, g, b = rgb_resolve(wavelength)
            throughput = vwhere(collapse, throughput * Vec3(r, g, b), throughput)
            dispersed = state.dispersed | (survive & mp.dispersive)

        new_origin = vwhere(survive, frame.position + wi_world * RAY_OFFSET, state.origin)
        new_dir = vwhere(survive, wi_world, state.direction)

        # --- next-segment traversal, FUSED with this bounce's shadow query ----
        # (the reference traces them as two separate queries per bounce,
        # `PathTracerMIS.cpp` Traverse + Traverse_Shadow; one combined
        # wavefront halves the per-dispatch fixed costs, and the engine's
        # liveness compaction makes the dead halves free).  Dead lanes carry
        # t_max = 0 -> zero candidates -> (almost) zero cost.
        next_cap = jnp.where(survive, BIG, 0.0)
        num_rays = num_rays + jnp.sum(survive.astype(jnp.float32))
        if shadow is not None:
            nee_c, shadow_rays, shadow_cap = shadow
            cat = lambda a, b: jnp.concatenate([a, b])
            catv = lambda a, b: Vec3(cat(a.x, b.x), cat(a.y, b.y), cat(a.z, b.z))
            mo = catv(new_origin, shadow_rays.origin)
            md = catv(new_dir, shadow_rays.dir)
            mcap = cat(next_cap, shadow_cap)
            mtime = cat(time, time) if time is not None else None
            mhits = scene_traverse(scene, mo, md, t_max=mcap, time=mtime)
            nn = new_origin.x.shape[0]
            hits_next = jax.tree.map(
                lambda a: a[:nn] if a is not None else None, mhits,
                is_leaf=lambda a: a is None,
            )
            occluded = mhits.t[nn:] < shadow_cap
            sh_ovf = mhits.overflow[nn:]
            num_overflow = num_overflow + jnp.sum(
                ((shadow_cap > 0.0) & sh_ovf).astype(jnp.float32)
            )
            nee_w = ((shadow_cap > 0.0) & (~occluded)).astype(jnp.float32)
            result = result + state.throughput * nee_c * (
                nee_w * survive_pre.astype(jnp.float32)
            )
        else:
            hits_next = scene_traverse(scene, new_origin, new_dir, t_max=next_cap, time=time)

        return _PathState(
            origin=new_origin,
            direction=new_dir,
            hits=hits_next,
            throughput=throughput,
            result=result,
            alive=survive,
            last_pdf=jnp.where(survive, smp.pdf, state.last_pdf),
            last_specular=jnp.where(survive, smp.specular, state.last_specular),
            stream=stream,
            num_rays=num_rays,
            num_shadow_rays=num_shadow,
            num_overflow=num_overflow,
            num_box_tests=num_box,
            num_tri_tests=num_tri,
            dispersed=dispersed,
        )

    # loop over bounce index; the final step only resolves the last segment's
    # miss / light-hit (the reference breaks after NEE at max depth)
    if params.unroll:
        state = init
        for d in range(params.max_depth + 1):
            state = bounce(state, jnp.int32(d))
    else:
        depths = jnp.arange(params.max_depth + 1)
        state, _ = jax.lax.scan(lambda s, d: (bounce(s, d), None), init, depths)
    return state.result, Counters(
        state.num_rays, state.num_shadow_rays, state.num_overflow,
        state.num_box_tests, state.num_tri_tests,
    )

"""Vertex Connection and Merging — bidirectional path tracing + progressive
photon merging, SmallVCM-style.

Re-expression of `Core/Rendering/VertexConnectionAndMerging.cpp` (970
LoC): every pass traces one light sub-path and one camera sub-path per pixel.
Light vertices are STORED (stacked per-depth arrays — the wavefront analogue
of the reference's per-thread `lightVertices` array, `VCM.cpp:32-45`), used
three ways:

1. connected to the camera (light-tracing splats, `ConnectToCamera`),
2. connected to camera-path vertices of the same pixel (`ConnectVertices` —
   the reference also pairs each pixel's camera path with that pixel's light
   path),
3. inserted as photons into a device-side hash grid and merged into camera
   vertices within the merging radius (`MergeVertices`).

All estimators are combined with the recursive dVC/dVM/dVCM MIS quantities
(`VCM.cpp:186-193,217-224,374-381,500-520,556-570` — balance heuristic,
``Mis(x) = x``).

Multi-chip (SURVEY §2.9 P4): ``render_pass_vcm`` takes ``rows``/``row0``/
``axis_name`` — under `shard_map` each device traces its own pixel band's
light AND camera paths (vertex connections pair same-pixel paths, so they
stay device-local, like the reference pairing each pixel's two sub-paths),
`all_gather`s the photon fields across devices before the grid build (the analogue
of concatenating per-thread photon lists + the single-threaded grid build,
`VertexConnectionAndMerging.cpp:140-170`), and `psum`s the light-tracing
splat frame (splats land on arbitrary pixels).  Driven by
`parallel/mesh.py:render_pass_vcm_sharded`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.sampling import local_to_world, world_to_local
from ..math.vec import Vec3, dot, max_component, where as vwhere
from ..ops import bsdf as bsdf_ops
from ..ops.bsdf import MatParams
from ..ops.hashgrid import build_hash_grid, gather_candidates
from ..ops.intersect import BIG, PrimFrame, eval_prim_frame
from ..ops.lights import emit, gather_light, illuminate
from ..ops.materials import resolve_material
from ..ops.traverse import scene_occluded, scene_traverse
from ..sampler.sampler import SampleStream, make_stream, next_1d, next_2d, next_3d
from ..scene.camera import Camera, camera_pdf_w, world_to_film
from ..scene.types import SceneData, SceneMeta
from .light_tracer import EMIT_OFFSET, SplatBatch, splat_to_film
from .path_tracer import RAY_OFFSET, SHADOW_OFFSET, _merge_frames


def _mis(x):
    """Balance-heuristic power (reference `Mis(x) = x`)."""
    return x


@dataclass(frozen=True)
class VcmParams:
    """`VertexConnectionAndMerging` knobs (`VCM.cpp:55-70`)."""

    max_path_length: int = 8
    initial_radius: float = 0.05
    min_radius: float = 0.02
    radius_multiplier: float = 1.0  # reference default (shrink disabled)
    use_vertex_connection: bool = True
    use_vertex_merging: bool = True
    max_photons_per_cell: int = 8


class _Vertex(NamedTuple):
    """Stored light vertex (LightVertex, `VCM.h:50-60`) as stacked arrays."""

    position: Vec3
    normal: Vec3
    tangent: Vec3
    bitangent: Vec3
    wo_world: Vec3  # direction toward the previous vertex (outgoing)
    throughput: Vec3
    mat: MatParams
    d_vc: jnp.ndarray
    d_vm: jnp.ndarray
    d_vcm: jnp.ndarray
    path_length: jnp.ndarray  # int32
    valid: jnp.ndarray  # bool


class _PathState(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3
    d_vc: jnp.ndarray
    d_vm: jnp.ndarray
    d_vcm: jnp.ndarray
    length: jnp.ndarray
    alive: jnp.ndarray
    last_specular: jnp.ndarray
    is_finite_light: jnp.ndarray
    stream: SampleStream


def _shade_frame(scene, hits, origin, direction):
    from ..ops.materials import apply_normal_map
    from ..ops.traverse import scene_hit_frame

    frame = scene_hit_frame(scene, hits, origin, direction)
    return apply_normal_map(scene, frame)


def _trace_light_phase(scene, meta, cam, stream, vcm: VcmParams, n_paths,
                       mis_vc_factor, mis_vm_factor):
    """Light sub-paths: store vertices, photons, and camera splats.

    Returns (vertices stacked (D, N), splats stacked (D, N)).
    """
    n = (n_paths,)
    n_lights = max(meta.n_lights, 1)
    pick_prob = 1.0 / n_lights

    u_pick, stream = next_1d(stream)
    light_idx = jnp.clip((u_pick * n_lights).astype(jnp.int32), 0, n_lights - 1)
    l = gather_light(scene.lights, light_idx)
    u1, u2, stream = next_2d(stream)
    u3, u4, u5, stream = next_3d(stream)
    em = emit(l, u1, u2, u3, u4, u5, scene_radius=meta.scene_radius)

    direct_pdf_a = em.direct_pdf_a * pick_prob
    emission_pdf = em.emission_pdf_w * pick_prob
    inv_emission = 1.0 / emission_pdf
    throughput = em.radiance * inv_emission
    alive = (max_component(throughput) > 1e-9) & jnp.ones(n, bool)
    if meta.n_lights == 0:
        alive = jnp.zeros(n, bool)

    # MIS init (`GenerateLightSample`, `VCM.cpp:470-490`)
    d_vcm = _mis(direct_pdf_a * inv_emission)
    cos_at = jnp.where(l.is_finite, em.cos_at_light, 1.0)
    d_vc = jnp.where(l.is_delta, 0.0, _mis(cos_at * inv_emission))
    d_vm = d_vc * mis_vc_factor  # dVM = dVC * misVCWeightFactor (`VCM.cpp:488`)

    init = _PathState(
        origin=em.position + em.direction * EMIT_OFFSET,
        direction=em.direction,
        throughput=throughput,
        d_vc=d_vc, d_vm=d_vm, d_vcm=d_vcm,
        length=jnp.ones(n, jnp.int32),
        alive=alive,
        last_specular=jnp.zeros(n, bool),
        is_finite_light=l.is_finite,
        stream=stream,
    )

    def bounce(state: _PathState, _):
        hits = scene_traverse(scene, state.origin, state.direction)
        miss = hits.t >= BIG * 0.5
        hits = hits._replace(t=jnp.clip(hits.t, 0.0, 1e12))
        frame = _shade_frame(scene, hits, state.origin, state.direction)
        hit_surface = state.alive & (~miss) & (frame.light_id < 0)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v,
                              position=frame.position)

        # MIS update at the hit (`VCM.cpp:369-381`)
        cos_in = jnp.abs(dot(state.direction, frame.normal))
        inv_cos = 1.0 / _mis(jnp.maximum(cos_in, 1e-6))
        dist_factor = jnp.where(
            (state.length > 1) | state.is_finite_light, _mis(hits.t * hits.t), 1.0
        )
        d_vcm = state.d_vcm * dist_factor * inv_cos
        d_vc = state.d_vc * inv_cos
        d_vm = state.d_vm * inv_cos

        # vertex storage (non-delta surfaces; our BSDF kinds are non-delta
        # except metal/dielectric smooth — approximated by the sample's
        # specular flag at eval time; store all, mask connections by f != 0)
        wo_world = -state.direction
        vertex = _Vertex(
            position=frame.position,
            normal=frame.normal,
            tangent=frame.tangent,
            bitangent=frame.bitangent,
            wo_world=wo_world,
            throughput=state.throughput,
            mat=mp,
            d_vc=d_vc, d_vm=d_vm, d_vcm=d_vcm,
            path_length=state.length,
            valid=hit_surface,
        )

        # camera splat (`ConnectToCamera`, `VCM.cpp:905-975`)
        to_cam = Vec3(
            cam.origin.x - frame.position.x,
            cam.origin.y - frame.position.y,
            cam.origin.z - frame.position.z,
        )
        d2 = dot(to_cam, to_cam)
        dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
        dir_to_cam = to_cam * (1.0 / dist)
        wo_local = world_to_local(wo_world, frame.tangent, frame.bitangent, frame.normal)
        wi_local = world_to_local(dir_to_cam, frame.tangent, frame.bitangent, frame.normal)
        f_cam, _pdf_fwd, pdf_rev = bsdf_ops.evaluate_with_rev(mp, wo_local, wi_local)
        fu, fv, on_film = world_to_film(cam, frame.position)
        visible = ~scene_occluded(
            scene, frame.position + frame.normal * SHADOW_OFFSET, dir_to_cam, dist * 0.999
        )[0]
        cos_to_cam = dot(dir_to_cam, frame.normal)
        cam_pdf_a = camera_pdf_w(cam, -dir_to_cam) * jnp.maximum(cos_to_cam, 0.0) / jnp.maximum(d2, 1e-12)
        # NOTE on count factors: with our film normalization (splat
        # contributions carry the full-film camera pdf and no 1/n, matching
        # the reference LightTracer), the consistent MIS pairing is the
        # reference's: no n here and no n in the camera dVCM init.  (The
        # SmallVCM n / 1/n pairing belongs to its per-pixel W_e normalization
        # — empirically it biases +1.4% here, this form is +0.2%.)
        w_light = _mis(cam_pdf_a) * (mis_vm_factor + d_vcm + d_vc * _mis(pdf_rev))
        mis_w = 1.0 / (w_light + 1.0)
        contrib = f_cam * state.throughput * (
            mis_w * cam_pdf_a / jnp.maximum(cos_to_cam, 1e-6)
        )
        splat_enabled = vcm.use_vertex_connection
        splat = SplatBatch(
            u=fu, v=fv, color=contrib,
            mask=hit_surface & on_film & visible & (cos_to_cam > 1e-6)
            & (max_component(f_cam) > 0.0) & splat_enabled,
        )

        # advance (`AdvancePath`, `VCM.cpp:496-578`)
        stream = state.stream
        s1, s2, s3, stream = next_3d(stream)
        smp = bsdf_ops.sample(mp, wo_local, s1, s2, s3)
        wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
        cos_out = jnp.abs(dot(wi_world, frame.normal))
        # reverse pdf of the sampled direction
        _f, _p, rev_pdf = bsdf_ops.evaluate_with_rev(mp, wo_local, smp.wi)
        survive = hit_surface & smp.valid & (state.length + 2 <= vcm.max_path_length + 1)
        new_throughput = state.throughput * smp.weight
        survive = survive & (max_component(new_throughput) > 1e-9)

        inv_pdf = 1.0 / jnp.maximum(smp.pdf, 1e-6)
        spec = smp.specular
        nd_vc = jnp.where(
            spec,
            d_vc * _mis(cos_out),
            _mis(cos_out * inv_pdf) * (d_vc * _mis(rev_pdf) + d_vcm + mis_vm_factor),
        )
        nd_vm = jnp.where(
            spec,
            d_vm * _mis(cos_out),
            _mis(cos_out * inv_pdf) * (d_vm * _mis(rev_pdf) + d_vcm * mis_vc_factor + 1.0),
        )
        nd_vcm = jnp.where(spec, 0.0, _mis(inv_pdf))

        new_state = _PathState(
            origin=vwhere(survive, frame.position + wi_world * RAY_OFFSET, state.origin),
            direction=vwhere(survive, wi_world, state.direction),
            throughput=vwhere(survive, new_throughput, state.throughput),
            d_vc=jnp.where(survive, nd_vc, state.d_vc),
            d_vm=jnp.where(survive, nd_vm, state.d_vm),
            d_vcm=jnp.where(survive, nd_vcm, state.d_vcm),
            length=state.length + survive.astype(jnp.int32),
            alive=survive,
            last_specular=spec,
            is_finite_light=state.is_finite_light,
            stream=stream,
        )
        return new_state, (vertex, splat)

    depths = jnp.arange(vcm.max_path_length)
    state, (vertices, splats) = jax.lax.scan(bounce, init, depths)
    return vertices, splats, state.stream


class _Photons(NamedTuple):
    """Photon fields for grid build + merging (32-byte `Photon`, `VCM.h:72-87`)
    — the all_gather'd subset of the stored vertices in multi-chip runs."""

    pos: Vec3
    wo: Vec3
    thr: Vec3
    d_vm: jnp.ndarray
    d_vcm: jnp.ndarray


def render_pass_vcm(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    film,
    pass_idx: jnp.ndarray,
    halton,
    vp,
    params,  # RenderParams (unused fields ok)
    vcm: VcmParams = VcmParams(),
    rows: int | None = None,
    row0=0,
    axis_name: str | None = None,
):
    """One full VCM pass: light phase -> photon grid -> camera phase.

    ``rows``/``row0``/``axis_name``: pixel-band mode under `shard_map` —
    this device traces the band's light+camera paths, all_gathers photons
    and psums the splat frame over ``axis_name`` (module docstring)."""
    w, h = vp.width, vp.height
    rows_ = h if rows is None else rows
    n = w * rows_  # paths on THIS device
    n_total = w * h  # global light-path count (normalizations use this)
    n_lights = max(meta.n_lights, 1)
    light_pick = 1.0 / n_lights

    # merging radii + eta factors (`PreRender`, `VCM.cpp:83-125`);
    # radius shrink per pass with VM delayed by one pass
    p = pass_idx.astype(jnp.float32)
    r_vc = jnp.maximum(vcm.initial_radius * vcm.radius_multiplier**p, vcm.min_radius)
    r_vm = jnp.maximum(
        vcm.initial_radius * vcm.radius_multiplier ** jnp.maximum(p - 1, 0.0),
        vcm.min_radius,
    )
    vm_norm = 1.0 / (jnp.pi * r_vm * r_vm * n_total)
    eta_vcm_vc = jnp.pi * r_vc * r_vc * n_total
    if vcm.use_vertex_merging:
        mis_vm_factor_vc = jnp.where(pass_idx > 0, _mis(eta_vcm_vc), 0.0)
    else:
        mis_vm_factor_vc = jnp.float32(0.0)
    mis_vc_factor_vc = _mis(1.0 / eta_vcm_vc) if vcm.use_vertex_connection else 0.0
    eta_vcm_vm = jnp.pi * r_vm * r_vm * n_total
    mis_vc_factor_vm = _mis(1.0 / eta_vcm_vm) if vcm.use_vertex_connection else 0.0

    # ---------------- light phase ----------------
    # global path ids: any row partitioning yields the same streams
    path_ids = (jnp.arange(n) + jnp.asarray(row0) * w).astype(jnp.uint32)
    lstream = make_stream(path_ids, pass_idx, seed=vp.seed + 0x5EC, halton=None)
    vertices, splats, _ = _trace_light_phase(
        scene, meta, cam, lstream, vcm, n, mis_vc_factor_vc, mis_vm_factor_vc
    )
    if axis_name is None:
        film = splat_to_film(film, splats, w, h)
    else:
        # splats land on arbitrary pixels: accumulate a full frame, reduce
        # across devices, keep this device's band (per-thread splat merge analogue)
        from ..render.film import make_film

        tmp = splat_to_film(make_film(w, h), splats, w, h)
        frame = jax.lax.psum(tmp.sum, axis_name)
        band = jax.lax.dynamic_slice(
            frame, (jnp.asarray(row0), 0, 0), (rows_, w, 3)
        )
        film = film._replace(sum=film.sum + band)

    # photon array = all valid vertices, flattened (D*N,)
    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    photon_valid = flat(vertices.valid)
    # park invalid photons far away so grid queries never match them
    far = 3.0e18
    photons = _Photons(
        pos=Vec3(
            jnp.where(photon_valid, flat(vertices.position.x), far),
            jnp.where(photon_valid, flat(vertices.position.y), far),
            jnp.where(photon_valid, flat(vertices.position.z), far),
        ),
        wo=Vec3(flat(vertices.wo_world.x), flat(vertices.wo_world.y), flat(vertices.wo_world.z)),
        thr=Vec3(flat(vertices.throughput.x), flat(vertices.throughput.y), flat(vertices.throughput.z)),
        d_vm=flat(vertices.d_vm),
        d_vcm=flat(vertices.d_vcm),
    )
    if axis_name is not None:
        # SURVEY P4: gather every device's photons across devices before the grid
        # build (`VCM.cpp:140-170`'s cross-thread concat + global build)
        photons = jax.tree.map(
            lambda x: jax.lax.all_gather(x, axis_name, tiled=True), photons
        )
    grid = build_hash_grid(photons.pos, r_vm)

    # ---------------- camera phase ----------------
    from ..render.renderer import pixel_grid
    from ..scene.camera import generate_rays

    cx, cy, pids = pixel_grid(w, h, rows, row0)
    cstream = make_stream(pids, pass_idx, seed=vp.seed, halton=halton)
    rays, cstream = generate_rays(cam, cx, cy, cstream)

    cam_pdf = camera_pdf_w(cam, rays.dir)
    init = _PathState(
        origin=rays.origin,
        direction=rays.dir,
        throughput=Vec3.ones((n,)),
        d_vc=jnp.zeros(n), d_vm=jnp.zeros(n),
        d_vcm=_mis(1.0 / jnp.maximum(cam_pdf, 1e-12)),
        length=jnp.ones(n, jnp.int32),
        alive=jnp.ones(n, bool),
        last_specular=jnp.ones(n, bool),
        is_finite_light=jnp.zeros(n, bool),
        stream=cstream,
    )

    def camera_bounce(state: _PathState, _):
        result = Vec3.zeros((n,))
        hits = scene_traverse(scene, state.origin, state.direction)
        miss = hits.t >= BIG * 0.5
        hits = hits._replace(t=jnp.clip(hits.t, 0.0, 1e12))
        frame = _shade_frame(scene, hits, state.origin, state.direction)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v,
                              position=frame.position)

        # MIS update (`VCM.cpp:216-224`)
        cos_in = jnp.abs(dot(state.direction, frame.normal))
        inv_cos = 1.0 / _mis(jnp.maximum(cos_in, 1e-6))
        d_vcm = state.d_vcm * _mis(hits.t * hits.t) * inv_cos
        d_vc = state.d_vc * inv_cos
        d_vm = state.d_vm * inv_cos

        # background on miss (`EvaluateGlobalLights` + `EvaluateLight` weights)
        from .path_tracer import _env_radiance
        from ..scene.types import LIGHT_BACKGROUND

        bg_total = Vec3.zeros((n,))
        for li, kind in enumerate(meta.light_kinds):
            if kind != LIGHT_BACKGROUND:
                continue
            radiance = _env_radiance(scene, li, state.direction)
            # NEE's actual direct pdf: env importance map when present
            # (matches PT's `_eval_global_lights` and the `illuminate(env=)`
            # call in the connection phase below), uniform hemisphere else
            if scene.env_dist is not None:
                from ..ops.lights import env_direction_pdf

                direct_pdf_a = env_direction_pdf(scene.env_dist, state.direction)
            else:
                direct_pdf_a = 1.0 / (2.0 * jnp.pi)
            from ..math import sampling as _sampling

            emission_pdf_w = _sampling.uniform_sphere_pdf() * _sampling.uniform_circle_pdf(
                meta.scene_radius
            )  # emit()'s actual pdf (`BackgroundLight` Emit)
            w_camera = _mis(direct_pdf_a * light_pick) * state.d_vcm + _mis(
                emission_pdf_w * light_pick
            ) * state.d_vc
            if vcm.use_vertex_merging and not vcm.use_vertex_connection:
                mis_w = jnp.where(
                    state.length > 1, jnp.where(state.last_specular, 1.0, 0.0), 1.0
                )
            else:
                mis_w = jnp.where(state.length > 1, 1.0 / (1.0 + w_camera), 1.0)
            bg_total = bg_total + radiance * mis_w
        result = result + state.throughput * bg_total * (state.alive & miss).astype(jnp.float32)

        # direct light hit (`EvaluateLight`, `VCM.cpp:580-640`)
        hit_light = state.alive & (~miss) & (frame.light_id >= 0)
        l_hit = gather_light(scene.lights, jnp.maximum(frame.light_id, 0))
        cos_at_light = dot(frame.normal, -state.direction)
        inv_area = 1.0 / jnp.maximum(l_hit.area, 1e-8)
        direct_pdf_a = inv_area
        emission_pdf_w = inv_area * jnp.maximum(cos_at_light, 1e-6) / jnp.pi
        w_camera = _mis(direct_pdf_a * light_pick) * d_vcm + _mis(
            emission_pdf_w * light_pick
        ) * d_vc
        if vcm.use_vertex_merging and not vcm.use_vertex_connection:
            # pure photon mapping: non-specular light hits come exclusively
            # through merging (`EvaluateLight` special case, `VCM.cpp:612-620`)
            mis_w = jnp.where(
                state.length > 1,
                jnp.where(state.last_specular, 1.0, 0.0),
                1.0,
            )
        else:
            mis_w = jnp.where(state.length > 1, 1.0 / (1.0 + w_camera), 1.0)
        m_light = (hit_light & (cos_at_light > 1e-6)).astype(jnp.float32)
        result = result + state.throughput * l_hit.color * (mis_w * m_light)

        hit_surface = state.alive & (~miss) & (frame.light_id < 0)
        # emission accumulation
        result = result + state.throughput * mp.emission * hit_surface.astype(jnp.float32)

        wo_local = world_to_local(
            -state.direction, frame.tangent, frame.bitangent, frame.normal
        )
        stream = state.stream
        can_connect = hit_surface & (state.length + 1 <= vcm.max_path_length)

        # --- NEE / vertex connection to lights (`SampleLight`, `VCM.cpp:643-720`)
        if vcm.use_vertex_connection:
            nee_total = Vec3.zeros((n,))
            for li in range(max(meta.n_lights, 1)):
                if meta.n_lights == 0:
                    break
                l = gather_light(scene.lights, jnp.full((n,), li, jnp.int32))
                u1, u2, u3, stream = next_3d(stream)
                ill = illuminate(l, frame.position, frame.normal, u1, u2, u3,
                                 env=scene.env_dist, scene_radius=meta.scene_radius)
                wi_local = world_to_local(
                    ill.dir_to_light, frame.tangent, frame.bitangent, frame.normal
                )
                f, pdf_fwd, pdf_rev = bsdf_ops.evaluate_with_rev(mp, wo_local, wi_local)
                occluded, _sh_ovf = scene_occluded(
                    scene,
                    frame.position + ill.dir_to_light * SHADOW_OFFSET,
                    ill.dir_to_light,
                    jnp.minimum(ill.distance * 0.999, BIG),
                )
                cos_to_light = dot(frame.normal, ill.dir_to_light)
                bsdf_pdf = jnp.where(l.is_delta, 0.0, pdf_fwd)
                w_light = _mis(bsdf_pdf / jnp.maximum(ill.direct_pdf_w, 1e-12))
                w_cam = _mis(
                    ill.emission_pdf_w * jnp.maximum(cos_to_light, 1e-6)
                    / jnp.maximum(ill.direct_pdf_w * jnp.maximum(ill.cos_at_light, 1e-6), 1e-12)
                ) * (mis_vm_factor_vc + d_vcm + d_vc * _mis(pdf_rev))
                mis_w2 = 1.0 / (w_light + 1.0 + w_cam)
                ok = (
                    can_connect & ill.valid & (~occluded) & (cos_to_light > 1e-6)
                    & (max_component(f) > 0.0)
                )
                nee_total = nee_total + ill.radiance * f * (
                    mis_w2 / jnp.maximum(ill.direct_pdf_w, 1e-12) * ok.astype(jnp.float32)
                )
            result = result + state.throughput * nee_total

        # --- vertex connection to stored light vertices (`ConnectVertices`,
        # batched: all D light vertices of this pixel connect at once — one
        # traversal + one BSDF eval over a (D*N,) wavefront instead of a
        # D-times unrolled graph)
        if vcm.use_vertex_connection:
            D = vcm.max_path_length

            def tile(x):  # (N,) -> (D*N,)
                return jnp.broadcast_to(x, (D,) + x.shape).reshape(-1)

            def tile3(v3):
                return Vec3(tile(v3.x), tile(v3.y), tile(v3.z))

            def vflat(x):  # (D, N, ...) -> (D*N, ...)
                return x.reshape((-1,) + x.shape[2:])

            def vflat3(v3):
                return Vec3(vflat(v3.x), vflat(v3.y), vflat(v3.z))

            lv_pos = vflat3(vertices.position)
            lv_nrm = vflat3(vertices.normal)
            lv_tan = vflat3(vertices.tangent)
            lv_bit = vflat3(vertices.bitangent)
            lv_wo = vflat3(vertices.wo_world)
            lv_thr = vflat3(vertices.throughput)
            lv_mat = jax.tree_util.tree_map(vflat, vertices.mat)
            lv_dvc = vflat(vertices.d_vc)
            lv_dvcm = vflat(vertices.d_vcm)
            lv_len = vflat(vertices.path_length)
            lv_valid = vflat(vertices.valid)

            c_pos = tile3(frame.position)
            c_nrm = tile3(frame.normal)
            c_tan = tile3(frame.tangent)
            c_bit = tile3(frame.bitangent)
            c_wo_local = Vec3(tile(wo_local.x), tile(wo_local.y), tile(wo_local.z))
            c_mp = jax.tree_util.tree_map(
                lambda x: tile(x) if isinstance(x, jnp.ndarray) else x, mp
            )
            c_dvc = tile(d_vc)
            c_dvcm = tile(d_vcm)
            c_len = tile(state.length)
            c_can = tile(can_connect)

            length_ok = lv_len + c_len + 1 <= vcm.max_path_length
            to_lv = lv_pos - c_pos
            d2v = dot(to_lv, to_lv)
            distv = jnp.sqrt(jnp.maximum(d2v, 1e-12))
            ldir = to_lv * (1.0 / distv)
            cos_cam_v = dot(c_nrm, ldir)
            cos_light_v = dot(lv_nrm, -ldir)
            wi_local_c = world_to_local(ldir, c_tan, c_bit, c_nrm)
            f_cam, cam_pdf_f, cam_pdf_r = bsdf_ops.evaluate_with_rev(c_mp, c_wo_local, wi_local_c)
            lwo_local = world_to_local(lv_wo, lv_tan, lv_bit, lv_nrm)
            lwi_local = world_to_local(-ldir, lv_tan, lv_bit, lv_nrm)
            f_light, light_pdf_f, light_pdf_r = bsdf_ops.evaluate_with_rev(lv_mat, lwo_local, lwi_local)
            geom = 1.0 / jnp.maximum(d2v, 1e-12)
            occluded = scene_occluded(scene, c_pos + ldir * SHADOW_OFFSET, ldir, distv * 0.999)[0]
            cam_pdf_a = cam_pdf_f * jnp.maximum(cos_light_v, 1e-6) / jnp.maximum(d2v, 1e-12)
            light_pdf_a = light_pdf_f * jnp.maximum(cos_cam_v, 1e-6) / jnp.maximum(d2v, 1e-12)
            w_light = _mis(cam_pdf_a) * (mis_vm_factor_vc + lv_dvcm + lv_dvc * _mis(light_pdf_r))
            w_cam = _mis(light_pdf_a) * (mis_vm_factor_vc + c_dvcm + c_dvc * _mis(cam_pdf_r))
            mis_w3 = 1.0 / (w_light + 1.0 + w_cam)
            ok = (
                c_can & lv_valid & length_ok & (~occluded)
                & (cos_cam_v > 1e-6) & (cos_light_v > 1e-6)
                & (max_component(f_cam) > 0.0) & (max_component(f_light) > 0.0)
            )
            contrib = lv_thr * f_cam * f_light * (geom * mis_w3 * ok.astype(jnp.float32))
            vc_total = Vec3(
                jnp.sum(contrib.x.reshape(D, -1), axis=0),
                jnp.sum(contrib.y.reshape(D, -1), axis=0),
                jnp.sum(contrib.z.reshape(D, -1), axis=0),
            )
            result = result + state.throughput * vc_total

        # --- vertex merging (`MergeVertices`, `VCM.cpp:824-905`; batched:
        # gather K candidate photons per pixel, one BSDF eval over (N*K,))
        if vcm.use_vertex_merging:
            cand_idx, cand_mask = gather_candidates(
                grid, frame.position, vcm.max_photons_per_cell
            )  # (N, K)
            K = cand_idx.shape[-1]
            ci = cand_idx.reshape(-1)

            ph_pos = Vec3(photons.pos.x[ci], photons.pos.y[ci], photons.pos.z[ci])
            ph_dir = Vec3(photons.wo.x[ci], photons.wo.y[ci], photons.wo.z[ci])
            ph_thr = Vec3(photons.thr.x[ci], photons.thr.y[ci], photons.thr.z[ci])
            ph_dvm = photons.d_vm[ci]
            ph_dvcm = photons.d_vcm[ci]

            def rep(x):  # (N,) -> (N*K,) repeating each element K times
                return jnp.repeat(x, K)

            q_pos = Vec3(rep(frame.position.x), rep(frame.position.y), rep(frame.position.z))
            q_nrm = Vec3(rep(frame.normal.x), rep(frame.normal.y), rep(frame.normal.z))
            q_tan = Vec3(rep(frame.tangent.x), rep(frame.tangent.y), rep(frame.tangent.z))
            q_bit = Vec3(rep(frame.bitangent.x), rep(frame.bitangent.y), rep(frame.bitangent.z))
            q_wo = Vec3(rep(wo_local.x), rep(wo_local.y), rep(wo_local.z))
            q_mp = jax.tree_util.tree_map(
                lambda x: rep(x) if isinstance(x, jnp.ndarray) else x, mp
            )
            q_dvcm = rep(d_vcm)
            q_dvm = rep(d_vm)

            dpx = ph_pos.x - q_pos.x
            dpy = ph_pos.y - q_pos.y
            dpz = ph_pos.z - q_pos.z
            within = (dpx * dpx + dpy * dpy + dpz * dpz) <= r_vm * r_vm
            cos_to_light = dot(q_nrm, ph_dir)
            wi_l = world_to_local(ph_dir, q_tan, q_bit, q_nrm)
            f, pdf_f, pdf_r = bsdf_ops.evaluate_with_rev(q_mp, q_wo, wi_l)
            w_light = ph_dvcm * mis_vc_factor_vm + ph_dvm * _mis(pdf_f)
            w_cam = q_dvcm * mis_vc_factor_vm + q_dvm * _mis(pdf_r)
            mw = 1.0 / (w_light + 1.0 + w_cam)
            weight = mw / jnp.maximum(cos_to_light, 1e-6)
            ok = cand_mask.reshape(-1) & within & (cos_to_light > 1e-6) & rep(can_connect)
            contrib = f * ph_thr * (weight * ok.astype(jnp.float32))
            merged = Vec3(
                jnp.sum(contrib.x.reshape(-1, K), axis=-1),
                jnp.sum(contrib.y.reshape(-1, K), axis=-1),
                jnp.sum(contrib.z.reshape(-1, K), axis=-1),
            )
            do_vm = pass_idx > 0
            result = result + state.throughput * merged * (
                vm_norm * do_vm.astype(jnp.float32)
            )

        # --- advance (camera AdvancePath)
        s1, s2, s3, stream = next_3d(stream)
        smp = bsdf_ops.sample(mp, wo_local, s1, s2, s3)
        wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
        cos_out = jnp.abs(dot(wi_world, frame.normal))
        _f2, _p2, rev_pdf = bsdf_ops.evaluate_with_rev(mp, wo_local, smp.wi)
        survive = hit_surface & smp.valid & (state.length <= vcm.max_path_length)
        new_throughput = state.throughput * smp.weight
        survive = survive & (max_component(new_throughput) > 1e-9)

        inv_pdf = 1.0 / jnp.maximum(smp.pdf, 1e-6)
        spec = smp.specular
        nd_vc = jnp.where(
            spec, d_vc * _mis(cos_out),
            _mis(cos_out * inv_pdf) * (d_vc * _mis(rev_pdf) + d_vcm + mis_vm_factor_vc),
        )
        nd_vm = jnp.where(
            spec, d_vm * _mis(cos_out),
            _mis(cos_out * inv_pdf) * (d_vm * _mis(rev_pdf) + d_vcm * mis_vc_factor_vc + 1.0),
        )
        nd_vcm = jnp.where(spec, 0.0, _mis(inv_pdf))

        new_state = _PathState(
            origin=vwhere(survive, frame.position + wi_world * RAY_OFFSET, state.origin),
            direction=vwhere(survive, wi_world, state.direction),
            throughput=vwhere(survive, new_throughput, state.throughput),
            d_vc=jnp.where(survive, nd_vc, state.d_vc),
            d_vm=jnp.where(survive, nd_vm, state.d_vm),
            d_vcm=jnp.where(survive, nd_vcm, state.d_vcm),
            length=state.length + survive.astype(jnp.int32),
            alive=survive,
            last_specular=spec,
            is_finite_light=state.is_finite_light,
            stream=stream,
        )
        return new_state, result

    depths = jnp.arange(vcm.max_path_length)
    state, per_depth = jax.lax.scan(camera_bounce, init, depths)
    radiance = Vec3(
        jnp.sum(per_depth.x, axis=0),
        jnp.sum(per_depth.y, axis=0),
        jnp.sum(per_depth.z, axis=0),
    )

    from ..render.film import accumulate_frame

    film = accumulate_frame(film, radiance, use_secondary=(pass_idx % 2 == 0))
    return film

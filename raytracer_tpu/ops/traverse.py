"""Unified scene traversal: analytic prims + (optional) triangle-mesh BVH.

The analogue of `Scene::Traverse` / `Scene::Traverse_Shadow`
(`Core/Scene/Scene.cpp:219-261`): closest hit across all geometry kinds, and
an any-hit occlusion query for shadow rays.

Mesh traversal backend selection (the analogue of the reference's
Single/Packet ``TraversalMode`` knob, `Core/Rendering/Context.h:17-21`):

- ``"wave"``: binned-wavefront engine (`ops/wave_traverse.py`) — per-ray
  exact candidates, cluster-binned execution, multi-round resume.  EXACT
  (agrees with the skip-link walk), pure jnp, covered by the CPU test suite.
  The production default.
- ``"cluster"``: per-ray dense two-phase jnp path (`ops/cluster_traverse.py`)
  — exact per-ray candidates with per-ray cluster-row gathers; kept as a
  second orthogonal implementation for validation.
- ``"bvh"``: lock-step skip-link BVH walk (`ops/bvh_traverse.py`) — exact;
  kept for small meshes and as the correctness oracle.
- ``"null"``: skips mesh traversal (perf ablation only).
- ``"auto"`` (default): wave.

Any path that can truncate reports per-ray ``Hits.overflow`` (closest hit)
and a shadow overflow mask (any hit) — surfaced through the render counters:
the "no silent caps" rule.  The wave path's overflow is exact-by-rounds and
practically always zero.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..math.vec import Vec3
from ..scene.types import SceneData
from .intersect import BIG, Hits, intersect_prims

_MODE = "auto"
_VALID_MODES = ("auto", "wave", "cluster", "bvh", "null")


def set_traversal_mode(mode: str) -> None:
    """Select the mesh traversal backend (see module docstring)."""
    global _MODE
    if mode not in _VALID_MODES:
        raise ValueError(f"traversal mode {mode!r} not in {_VALID_MODES}")
    _MODE = mode


def get_traversal_mode() -> str:
    return _MODE


def _resolved_mode(scene: SceneData) -> str:
    # the env override goes through the SAME validation as
    # set_traversal_mode — a typo must raise, not silently fall through the
    # backend dispatch chain
    mode = _MODE
    env = os.environ.get("RT_TRAVERSAL_MODE")
    if env:
        if env not in _VALID_MODES:
            raise ValueError(
                f"RT_TRAVERSAL_MODE={env!r} not in {_VALID_MODES}"
            )
        mode = env
    if mode == "bvh" and scene.bvh is None:
        # a user selecting the exact oracle must not silently get another path
        raise ValueError(
            "traversal mode 'bvh' requested but the scene has no skip-link BVH "
            "(scene was built without one); use 'wave' or rebuild with a BVH"
        )
    return "wave" if mode == "auto" else mode


def _cs_closest(mode, clusters, bvh, tris, origin: Vec3, direction: Vec3, t_cap):
    """Dispatch closest-hit over ONE cluster set to the selected backend.

    Returns (t, tri_id, u, v, overflow, attr): ``attr`` is the winner's
    interpolated shading frame (`interp_tri_attr`) or None."""
    args = jax.lax.stop_gradient((clusters, origin, direction, t_cap))
    if mode == "null":
        # diagnostics only: skip mesh traversal entirely (perf ablation)
        n = origin.x.shape
        return (jnp.full(n, BIG), jnp.full(n, -1, jnp.int32),
                jnp.zeros(n), jnp.zeros(n), jnp.zeros(n, bool), None)
    if mode == "wave":
        from .wave_traverse import interp_tri_attr, wave_closest_hit

        t, tri, u, v, ovf = wave_closest_hit(*args)
        # interpolate on the DETACHED clusters (args[0]) — traversal
        # backends are AD-detached
        return t, tri, u, v, ovf, interp_tri_attr(args[0], tri, u, v)
    if mode == "bvh":
        from .bvh_traverse import bvh_closest_hit

        t_t, tid, tu, tv = bvh_closest_hit(bvh, tris, origin, direction, t_cap)
        return t_t, tid, tu, tv, jnp.zeros(origin.x.shape, bool), None
    from .cluster_traverse import cluster_closest_hit

    return cluster_closest_hit(*args) + (None,)


def _cs_occluded(mode, clusters, bvh, tris, origin: Vec3, direction: Vec3, t_max):
    """Any-hit over ONE cluster set. Returns (occluded, overflow)."""
    n = origin.x.shape
    args = jax.lax.stop_gradient((clusters, origin, direction, t_max))
    if mode == "null":
        return jnp.zeros(n, bool), jnp.zeros(n, bool)
    if mode == "wave":
        from .wave_traverse import wave_any_hit

        return wave_any_hit(*args)
    if mode == "bvh":
        from .bvh_traverse import bvh_any_hit

        return bvh_any_hit(bvh, tris, origin, direction, t_max), jnp.zeros(n, bool)
    from .cluster_traverse import cluster_any_hit

    return cluster_any_hit(*args)


def _instance_local_ray(scene: SceneData, i: int, origin: Vec3, direction: Vec3, time):
    """World ray -> instance i's object space (`Scene::Traverse_Object`,
    `Scene.cpp:128-145`): rigid inverse at the ray's shutter time."""
    from ..scene.types import Rot3

    inst = scene.instances
    at = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
    rot = Rot3(at(inst.rot.r0), at(inst.rot.r1), at(inst.rot.r2))
    trans = at(inst.trans)
    if time is not None:
        trans = trans + at(inst.vel) * time
    o_l = rot.to_local(origin - trans)
    d_l = rot.to_local(direction)
    return o_l, d_l


def scene_traverse(scene: SceneData, origin: Vec3, direction: Vec3, t_max=None, time=None) -> Hits:
    """``time`` (N,): per-ray shutter time for motion blur (analytic prims
    and instanced meshes; baked world-space triangles are static)."""
    n = origin.x.shape
    if t_max is None:
        t_max = jnp.full(n, BIG)
    t_p, pid = intersect_prims(scene.prims, origin, direction, t_max, time)
    mode = _resolved_mode(scene)

    best_t = t_p
    best_prim = pid
    best_tri = jnp.full(n, -1, jnp.int32)
    best_u = jnp.zeros(n, jnp.float32)
    best_v = jnp.zeros(n, jnp.float32)
    best_inst = jnp.full(n, -1, jnp.int32)
    overflow = jnp.zeros(n, bool)
    z = jnp.zeros(n, jnp.float32)
    best_attr = (z, z, z, z, z, z)
    have_attr = True

    def fold(t_t, tid, tu, tv, inst_id, attr):
        nonlocal best_t, best_prim, best_tri, best_u, best_v, best_inst
        nonlocal best_attr, have_attr
        closer = (t_t < best_t) & (tid >= 0)
        best_t = jnp.where(closer, t_t, best_t)
        best_prim = jnp.where(closer, -1, best_prim)
        best_tri = jnp.where(closer, tid, best_tri)
        best_u = jnp.where(closer, tu, best_u)
        best_v = jnp.where(closer, tv, best_v)
        best_inst = jnp.where(closer, inst_id, best_inst)
        if attr is None or not have_attr:
            have_attr = False
        else:
            best_attr = tuple(
                jnp.where(closer, a, b) for a, b in zip(attr, best_attr)
            )

    if scene.tris is not None and scene.clusters is not None:
        t_t, tid, tu, tv, ovf, attr = _cs_closest(
            mode, scene.clusters, scene.bvh, scene.tris, origin, direction,
            jnp.minimum(t_p, t_max),
        )
        overflow = overflow | ovf
        fold(t_t, tid, tu, tv, -1, attr)
    elif scene.tris is not None and scene.bvh is not None:
        from .bvh_traverse import bvh_closest_hit

        t_t, tid, tu, tv = bvh_closest_hit(
            scene.bvh, scene.tris, origin, direction, jnp.minimum(t_p, t_max)
        )
        fold(t_t, tid, tu, tv, -1, None)

    if scene.instances is not None:
        # two-level traversal: ray -> instance space, shared mesh geometry
        # traced once per instance (`Scene.cpp:128-145` semantics; geometry
        # is stored ONCE per mesh regardless of instance count)
        inst_mode = "wave" if mode == "bvh" else mode  # per-mesh BVH not kept
        for i, mid in enumerate(scene.instances.mesh_ids):
            geom = scene.mesh_geoms[mid]
            o_l, d_l = _instance_local_ray(scene, i, origin, direction, time)
            t_t, tid, tu, tv, ovf, attr = _cs_closest(
                inst_mode, geom.clusters, None, geom.tris, o_l, d_l, best_t
            )
            overflow = overflow | ovf
            fold(t_t, tid, tu, tv, i, attr)

    has_mesh = (scene.tris is not None and scene.clusters is not None) or (
        scene.instances is not None
    )
    return Hits(
        t=best_t, prim_id=best_prim, tri_id=best_tri, u=best_u, v=best_v,
        overflow=overflow, inst_id=best_inst,
        attr=best_attr if (have_attr and has_mesh) else None,
    )


def scene_traversal_cost(scene: SceneData, origin: Vec3, direction: Vec3, time=None):
    """Per-ray traversal-work estimate: (box_tests, tri_tests).

    The observability counterpart of the reference's compile-gated
    intersection counters (`Core/Rendering/Counters.h:43-48`,
    `RT_ENABLE_INTERSECTION_COUNTERS`, heatmap AOVs `DebugRenderer.h:27-33`):
    box tests = analytic prims + super/sub-cluster slab tests, tri tests =
    64 x the sub-clusters whose box a ray overlaps (exactly the
    Moller-Trumbore work the production wave engines perform)."""
    n = origin.x.shape
    box_tests = jnp.full(n, float(scene.prims.count), jnp.float32)
    tri_tests = jnp.zeros(n, jnp.float32)
    tiny = 1e-12
    inv = lambda d: 1.0 / jnp.where(jnp.abs(d) > tiny, d, jnp.where(d >= 0, tiny, -tiny))
    ix, iy, iz = inv(direction.x), inv(direction.y), inv(direction.z)

    def cs_cost(cs_set, o, invd):
        k = cs_set.tris_per_cluster
        boxes = jnp.stack(
            [cs_set.box_min_x, cs_set.box_min_y, cs_set.box_min_z,
             cs_set.box_max_x, cs_set.box_max_y, cs_set.box_max_z], axis=1
        )
        t1x = (boxes[None, :, 0] - o[0][:, None]) * invd[0][:, None]
        t2x = (boxes[None, :, 3] - o[0][:, None]) * invd[0][:, None]
        t1y = (boxes[None, :, 1] - o[1][:, None]) * invd[1][:, None]
        t2y = (boxes[None, :, 4] - o[1][:, None]) * invd[1][:, None]
        t1z = (boxes[None, :, 2] - o[2][:, None]) * invd[2][:, None]
        t2z = (boxes[None, :, 5] - o[2][:, None]) * invd[2][:, None]
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z),
        )
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        hit = tmax >= jnp.maximum(tmin, 0.0)
        overlapped = jnp.sum(hit.astype(jnp.float32), axis=1)
        return jnp.full(n, float(cs_set.num_clusters), jnp.float32), overlapped * k

    if scene.clusters is not None:
        o = (origin.x, origin.y, origin.z)
        b, t = cs_cost(scene.clusters, o, (ix, iy, iz))
        box_tests = box_tests + b
        tri_tests = tri_tests + t
    if scene.instances is not None:
        for i, mid in enumerate(scene.instances.mesh_ids):
            o_l, d_l = _instance_local_ray(scene, i, origin, direction, time)
            il = (
                inv(d_l.x), inv(d_l.y), inv(d_l.z)
            )
            b, t = cs_cost(scene.mesh_geoms[mid].clusters, (o_l.x, o_l.y, o_l.z), il)
            box_tests = box_tests + b
            tri_tests = tri_tests + t
    return box_tests, tri_tests


def scene_hit_frame(scene: SceneData, hits: Hits, origin: Vec3, direction: Vec3, time=None):
    """Shading frame for any hit kind — analytic prim, baked triangle, or
    instanced-mesh triangle (object-space attributes rotated into world, the
    `Scene::EvaluateIntersection` local->world step, `Scene.cpp:344-350`)."""
    from ..scene.types import Rot3
    from .bvh_traverse import eval_tri_frame
    from .intersect import eval_prim_frame

    frame = eval_prim_frame(scene.prims, hits.prim_id, origin, direction, hits.t, time=time)
    if os.environ.get("RT_SKIP_TRI_FRAME"):  # perf-ablation diagnostics only
        return frame
    is_tri = hits.tri_id >= 0
    inst = hits.inst_id if hits.inst_id is not None else jnp.full(origin.x.shape, -1, jnp.int32)

    if hits.attr is not None:
        # fast path: the traversal already produced the winner's
        # interpolated shading frame (normal / texcoord / material) with one
        # row-gather from the attribute table — no per-vertex gathers here
        # (`MeshShape::EvaluateIntersection` fused into traversal)
        from ..integrators.path_tracer import _merge_frames
        from ..math.sampling import build_onb
        from ..math.vec import normalize
        from ..scene.types import Rot3
        from .intersect import PrimFrame

        nx, ny, nz, tu, tv, matf = hits.attr
        nrm = Vec3(nx, ny, nz)
        if scene.instances is not None:
            ii = scene.instances
            for i in range(len(ii.mesh_ids)):
                at = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
                rot = Rot3(at(ii.rot.r0), at(ii.rot.r1), at(ii.rot.r2))
                from ..math.vec import where as vwhere

                nrm = vwhere(inst == i, rot.to_world(nrm), nrm)
        normal = normalize(nrm, eps=1e-20)
        tangent, bitangent = build_onb(normal)
        tri_frame = PrimFrame(
            position=origin + direction * jnp.clip(hits.t, 0.0, 1e12),
            normal=normal,
            tangent=tangent,
            bitangent=bitangent,
            tex_u=tu,
            tex_v=tv,
            material_id=matf.astype(jnp.int32),
            light_id=jnp.full_like(hits.tri_id, -1),
        )
        return _merge_frames(is_tri, tri_frame, frame)

    if scene.tris is not None:
        from ..integrators.path_tracer import _merge_frames

        tri_frame = eval_tri_frame(scene.tris, hits, origin, direction)
        frame = _merge_frames(is_tri & (inst < 0), tri_frame, frame)
    if scene.instances is not None:
        from ..integrators.path_tracer import _merge_frames

        ii = scene.instances
        for i, mid in enumerate(ii.mesh_ids):
            geom = scene.mesh_geoms[mid]
            f_i = eval_tri_frame(geom.tris, hits, origin, direction)
            at = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
            rot = Rot3(at(ii.rot.r0), at(ii.rot.r1), at(ii.rot.r2))
            f_w = f_i._replace(
                normal=rot.to_world(f_i.normal),
                tangent=rot.to_world(f_i.tangent),
                bitangent=rot.to_world(f_i.bitangent),
            )
            frame = _merge_frames(is_tri & (inst == i), f_w, frame)
    return frame


def scene_occluded(scene: SceneData, origin: Vec3, direction: Vec3, t_max, time=None):
    """Any-hit shadow query (`Scene.cpp:245-261`).

    Returns (occluded, overflow): ``overflow`` marks shadow rays whose mesh
    query may have been truncated by the backend (wave: exact, ~never)."""
    n = origin.x.shape
    t_p, _ = intersect_prims(scene.prims, origin, direction, t_max, time)
    occ = t_p < t_max
    overflow = jnp.zeros(n, bool)
    mode = _resolved_mode(scene)
    if scene.tris is not None and scene.clusters is not None:
        mesh_occ, ovf = _cs_occluded(
            mode, scene.clusters, scene.bvh, scene.tris, origin, direction, t_max
        )
        occ = occ | mesh_occ
        overflow = overflow | ovf
    elif scene.tris is not None and scene.bvh is not None:
        from .bvh_traverse import bvh_any_hit

        occ = occ | bvh_any_hit(scene.bvh, scene.tris, origin, direction, t_max)
    if scene.instances is not None:
        inst_mode = "wave" if mode == "bvh" else mode
        for i, mid in enumerate(scene.instances.mesh_ids):
            geom = scene.mesh_geoms[mid]
            o_l, d_l = _instance_local_ray(scene, i, origin, direction, time)
            # already-occluded rays query with t_max = 0 (early-out analogue)
            lim = jnp.where(occ, 0.0, jnp.asarray(t_max) * jnp.ones(n, jnp.float32))
            mesh_occ, ovf = _cs_occluded(
                inst_mode, geom.clusters, None, geom.tris, o_l, d_l, lim
            )
            occ = occ | mesh_occ
            overflow = overflow | ovf
    return occ, overflow

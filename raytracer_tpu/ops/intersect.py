"""Wavefront ray / analytic-primitive intersection.

Re-expression of the reference's shape intersectors
(`Core/Shapes/SphereShape.cpp:29-46`, `BoxShape` slab test,
`Core/Shapes/RectShape.cpp:32-49`) and of `Scene::Traverse_Object`
(`Core/Scene/Scene.cpp:128-145`): rays are transformed into each primitive's
local space, intersected branchlessly, and the closest hit is kept.

Instead of a per-ray BVH walk over a handful of analytic objects, we `lax.scan`
over primitives: each step is a full-width elementwise op over the whole ray
wavefront — ideal VPU shape, compile time independent of prim count.  Meshes
(thousands+ of triangles) go through the BVH kernels in `bvh_traverse.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.vec import Vec3, cross, dot, normalize, where as vwhere
from ..scene.types import PRIM_BOX, PRIM_RECT, PRIM_SPHERE, Primitives, Rot3

BIG = 3.0e38  # python float: inlines into jaxprs (avoid hoisted-const executable args)
HIT_EPS = 1e-4


class Hits(NamedTuple):
    """Closest-hit record (SoA) — analogue of `HitPoint` (`HitPoint.h:14-51`)."""

    t: jnp.ndarray  # (N,) distance, BIG if miss
    prim_id: jnp.ndarray  # (N,) int32 index into Primitives, -1 = miss/tri
    tri_id: jnp.ndarray  # (N,) int32 triangle index, -1 unless triangle hit
    u: jnp.ndarray  # (N,) barycentric / local coords
    v: jnp.ndarray
    # True where the traversal backend may have truncated (candidate-budget
    # overflow, see ops/traverse.py) — surfaced via Counters, never silent
    overflow: jnp.ndarray = None
    # instance index for hits on instanced meshes (scene.instances);
    # -1 = baked geometry / analytic prim / miss
    inst_id: jnp.ndarray = None
    # traversal-emitted interpolated shading frame for triangle hits (wave
    # closest mode, `interp_tri_attr`): 6-tuple (nx, ny, nz, tex_u, tex_v, material_id as f32)
    # in the MESH's space (object space for instanced hits) — consumed by
    # `scene_hit_frame` instead of per-ray attribute gathers
    attr: tuple = None


def _local_ray(prim_rot: Rot3, prim_trans: Vec3, origin: Vec3, direction: Vec3):
    o = prim_rot.to_local(origin - prim_trans)
    d = prim_rot.to_local(direction)
    return o, d


def _intersect_sphere(o: Vec3, d: Vec3, radius):
    """Stable quadratic (`SphereShape.cpp:29-46`); returns (near, far, valid)."""
    v = dot(d, -o)
    det = radius * radius - dot(o, o) + v * v
    valid = det > 0.0
    # 1e-12 floor: sqrt' at 0 is inf => nan tangents in AD (miss lanes masked)
    s = jnp.sqrt(jnp.maximum(det, 1e-12))
    return v - s, v + s, valid


def _intersect_box(o: Vec3, d: Vec3, half: Vec3):
    """Slab test (`Geometry.h:57-130`); returns (near, far, valid).

    1e-9 guards (not 1e-20): 1/x JVP is -1/x^2, and 1e40 overflows f32.
    """
    inv = Vec3(
        1.0 / jnp.where(jnp.abs(d.x) > 1e-9, d.x, 1e-9),
        1.0 / jnp.where(jnp.abs(d.y) > 1e-9, d.y, 1e-9),
        1.0 / jnp.where(jnp.abs(d.z) > 1e-9, d.z, 1e-9),
    )
    t1 = Vec3((-half.x - o.x) * inv.x, (-half.y - o.y) * inv.y, (-half.z - o.z) * inv.z)
    t2 = Vec3((half.x - o.x) * inv.x, (half.y - o.y) * inv.y, (half.z - o.z) * inv.z)
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1.x, t2.x), jnp.minimum(t1.y, t2.y)), jnp.minimum(t1.z, t2.z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1.x, t2.x), jnp.maximum(t1.y, t2.y)), jnp.maximum(t1.z, t2.z))
    return tmin, tmax, tmax >= tmin


def _intersect_rect(o: Vec3, d: Vec3, half: Vec3):
    """Finite plane at local z=0 (`RectShape.cpp:32-49`)."""
    dz = jnp.where(jnp.abs(d.z) > 1e-9, d.z, 1e-9)
    t = -o.z / dz
    px = o.x + d.x * t
    py = o.y + d.y * t
    valid = (t > 1e-7) & (jnp.abs(px) < half.x) & (jnp.abs(py) < half.y)
    return t, t, valid


def _prim_hit_distance(kind, o, d, param, t_min, t_max):
    """Branchless closest valid distance for one primitive vs the wavefront.

    Mirrors `IShape::Traverse` (`Shape.cpp:19-45`): prefer nearDist if in range,
    else farDist (so rays starting inside glass hit the back face).
    """
    sn, sf, sv = _intersect_sphere(o, d, param.x)
    bn, bf, bv = _intersect_box(o, d, param)
    rn, rf, rv = _intersect_rect(o, d, param)
    near = jnp.select([kind == PRIM_SPHERE, kind == PRIM_BOX], [sn, bn], rn)
    far = jnp.select([kind == PRIM_SPHERE, kind == PRIM_BOX], [sf, bf], rf)
    valid = jnp.select([kind == PRIM_SPHERE, kind == PRIM_BOX], [sv, bv], rv)
    near_ok = valid & (near > t_min) & (near < t_max)
    far_ok = valid & (far > t_min) & (far < t_max)
    t = jnp.where(near_ok, near, jnp.where(far_ok, far, BIG))
    return t


def intersect_prims(prims: Primitives, origin: Vec3, direction: Vec3, t_max, time=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Closest hit over all analytic prims. Returns (t, prim_id).

    ``time`` (N,) is the per-ray shutter time: each prim's translation becomes
    ``trans + vel*time`` (motion blur, `Scene::Traverse_Object` sampling
    `GetInverseTransform(time)`, `Scene.cpp:132-136`). None = static.
    """
    n = origin.x.shape
    init = (jnp.full(n, BIG), jnp.full(n, -1, jnp.int32))

    def step(carry, prim):
        best_t, best_id = carry
        kind, r0x, r0y, r0z, r1x, r1y, r1z, r2x, r2y, r2z, tx, ty, tz, px, py, pz, vx, vy, vz, idx = prim
        rot = Rot3(Vec3(r0x, r0y, r0z), Vec3(r1x, r1y, r1z), Vec3(r2x, r2y, r2z))
        trans = Vec3(tx, ty, tz)
        if time is not None:
            trans = Vec3(tx + vx * time, ty + vy * time, tz + vz * time)
        o, d = _local_ray(rot, trans, origin, direction)
        t = _prim_hit_distance(kind, o, d, Vec3(px, py, pz), HIT_EPS, jnp.minimum(best_t, t_max))
        closer = t < best_t
        return (jnp.where(closer, t, best_t), jnp.where(closer, idx, best_id)), None

    p = prims
    stacked = (
        p.kind,
        p.rot.r0.x, p.rot.r0.y, p.rot.r0.z,
        p.rot.r1.x, p.rot.r1.y, p.rot.r1.z,
        p.rot.r2.x, p.rot.r2.y, p.rot.r2.z,
        p.trans.x, p.trans.y, p.trans.z,
        p.param.x, p.param.y, p.param.z,
        p.vel.x, p.vel.y, p.vel.z,
        jnp.arange(p.count, dtype=jnp.int32),
    )
    if p.count == 0:
        return init
    (best_t, best_id), _ = jax.lax.scan(step, init, stacked)
    return best_t, best_id


def occluded_prims(prims: Primitives, origin: Vec3, direction: Vec3, t_max, time=None) -> jnp.ndarray:
    """Any-hit shadow query (`Traversal_Single.h:99-179` semantics)."""
    t, pid = intersect_prims(prims, origin, direction, t_max, time)
    return t < t_max


class PrimFrame(NamedTuple):
    """World-space shading frame at an analytic-prim hit — the analogue of
    `Scene::EvaluateIntersection` (`Scene.cpp:305-365`)."""

    position: Vec3
    normal: Vec3  # geometric == shading normal for analytic prims
    tangent: Vec3
    bitangent: Vec3
    tex_u: jnp.ndarray
    tex_v: jnp.ndarray
    material_id: jnp.ndarray
    light_id: jnp.ndarray


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def gather_prim(prims: Primitives, idx):
    idx = jnp.maximum(idx, 0)
    rot = Rot3(
        _gather_vec3(prims.rot.r0, idx),
        _gather_vec3(prims.rot.r1, idx),
        _gather_vec3(prims.rot.r2, idx),
    )
    return (
        prims.kind[idx],
        rot,
        _gather_vec3(prims.trans, idx),
        _gather_vec3(prims.param, idx),
        prims.material_id[idx],
        prims.light_id[idx],
    )


def eval_prim_frame(prims: Primitives, prim_id, origin: Vec3, direction: Vec3, t, time=None) -> PrimFrame:
    """Compute position / normal / uv / tangent frame for the closest hits.

    Per-kind local frames match the reference:
    - sphere: normal = p/r, tangent from cross with Y (`SphereShape.cpp:156-173`)
    - box: face normal from dominant axis (`BoxShape.cpp` cube-UV mapping,
      simplified: uv from the two in-face coords)
    - rect: +Z normal, uv = local xy (`RectShape.cpp:124-133`)

    ``time`` (N,): per-ray shutter time; prim translation becomes trans+vel*t
    (motion blur) so the local frame matches the traversal-time transform.
    """
    kind, rot, trans, param, mat_id, light_id = gather_prim(prims, prim_id)
    if time is not None:
        idx = jnp.maximum(prim_id, 0)
        vel = _gather_vec3(prims.vel, idx)
        trans = trans + vel * time
    # clamp miss-lane distances (t = BIG) so every arithmetic path below stays
    # finite: masked-out lanes with inf/nan would poison reverse-mode AD
    # through jnp.where (cotangents flow into both branches)
    t = jnp.clip(t, 0.0, 1e12)
    pos_world = origin + direction * t
    p_local = rot.to_local(pos_world - trans)

    # sphere  (1e-8 floor: keeps 1/r and r^2 finite in f32 even for the
    # radius-0 dummy prim used by empty scenes)
    inv_r = 1.0 / jnp.maximum(param.x, 1e-8)
    sph_n = p_local * inv_r
    # uv: spherical coords of -p (SphereShape::EvaluateIntersection).
    # AD guards: arctan2 at (0,0) and arccos at +-1 have nan/inf derivatives
    # (sphere poles); clamp away from the singular points
    horiz2 = p_local.x * p_local.x + p_local.z * p_local.z
    safe_px = jnp.where(horiz2 < 1e-12, 1.0, -p_local.x)
    sph_u = jnp.arctan2(-p_local.z, safe_px) / (2.0 * jnp.pi) + 0.5
    sph_v = jnp.arccos(jnp.clip(-sph_n.y, -0.999999, 0.999999)) / jnp.pi

    # box: dominant axis of p/half
    q = Vec3(p_local.x / jnp.maximum(param.x, 1e-8), p_local.y / jnp.maximum(param.y, 1e-8), p_local.z / jnp.maximum(param.z, 1e-8))
    aq = Vec3(jnp.abs(q.x), jnp.abs(q.y), jnp.abs(q.z))
    is_x = (aq.x >= aq.y) & (aq.x >= aq.z)
    is_y = (aq.y > aq.x) & (aq.y >= aq.z)
    box_n = Vec3(
        jnp.where(is_x, jnp.sign(q.x), 0.0),
        jnp.where(is_y, jnp.sign(q.y), 0.0),
        jnp.where(is_x | is_y, 0.0, jnp.sign(q.z)),
    )
    box_u = jnp.where(is_x, q.z, jnp.where(is_y, q.x, q.x))
    box_v = jnp.where(is_x, q.y, jnp.where(is_y, q.z, q.y))

    # rect
    rect_n = Vec3(jnp.zeros_like(t), jnp.zeros_like(t), jnp.ones_like(t))

    n_local = vwhere(kind == PRIM_SPHERE, sph_n, vwhere(kind == PRIM_BOX, box_n, rect_n))
    u = jnp.where(kind == PRIM_SPHERE, sph_u, jnp.where(kind == PRIM_BOX, box_u, p_local.x))
    v = jnp.where(kind == PRIM_SPHERE, sph_v, jnp.where(kind == PRIM_BOX, box_v, p_local.y))
    # per-object texture scale (`RectShape.cpp:128`); (1,1) everywhere unless
    # the scene set "textureScale"
    if prims.uv_scale is not None:
        us = _gather_vec3(prims.uv_scale, jnp.maximum(prim_id, 0))
        u = u * us.x
        v = v * us.y

    normal = normalize(rot.to_world(n_local), eps=1e-20)
    # tangent frame: consistent, from normal (reference orthonormalizes too,
    # `Scene.cpp:338-350`)
    from ..math.sampling import build_onb

    tangent, bitangent = build_onb(normal)
    return PrimFrame(
        position=pos_world,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        tex_u=u,
        tex_v=v,
        material_id=mat_id,
        light_id=light_id,
    )

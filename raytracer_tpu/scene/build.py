"""Host-side scene construction: python objects -> flat device arrays.

Mirrors the role of ``Scene::BuildBVH`` + ``SceneLoader`` in the reference
(`Core/Scene/Scene.cpp:36-126`): classify objects into traceable prims vs
lights vs global lights, flatten parameters, and upload SoA arrays.
"""

from __future__ import annotations

import math as _math
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from ..math.transform import RigidTransform
from ..math.vec import Vec3
from . import types as T


@dataclass
class MaterialDesc:
    name: str = "default"
    bsdf: str = "diffuse"
    base_color: tuple = (0.7, 0.7, 0.7)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.1
    metalness: float = 0.0
    ior: float = 1.5
    k: float = 4.0
    base_color_tex: int = T.INVALID_ID
    emission_tex: int = T.INVALID_ID
    roughness_tex: int = T.INVALID_ID
    metalness_tex: int = T.INVALID_ID
    normal_tex: int = T.INVALID_ID
    mask_tex: int = T.INVALID_ID
    normal_strength: float = 1.0
    dispersive: bool = False  # Cauchy dispersion (spectral mode only)
    abbe: float = 30.0  # Abbe number V_d (lower = stronger dispersion)
    dispersion_c: float = 0.00420  # reference BK7 default (`Material.cpp:26`)
    dispersion_d: float = 0.0
    disp_use_abbe: bool = False  # True => (n_d, abbe) Cauchy extension form


@dataclass
class PrimDesc:
    kind: int  # PRIM_*
    transform: RigidTransform
    param: tuple  # (radius,0,0) or half-size
    material_id: int
    light_id: int = T.INVALID_ID
    velocity: tuple = (0.0, 0.0, 0.0)  # linear motion over the shutter (t in [0,1])
    uv_scale: tuple = (1.0, 1.0)  # RectShape::mTextureScale ("textureScale")


@dataclass
class DecalDesc:
    """Projected-texture decal (`SceneObject_Decal.h:21-37`)."""

    transform: RigidTransform
    half_size: tuple = (0.5, 0.5, 0.5)
    base_color: tuple = (1.0, 1.0, 1.0)
    base_color_tex: int = T.INVALID_ID
    alpha_tex: int = T.INVALID_ID
    roughness: float = 0.5
    alpha_min: float = 0.0
    alpha_max: float = 1.0
    order: int = 0


@dataclass
class LightDesc:
    kind: int  # LIGHT_*
    color: tuple
    transform: RigidTransform = field(default_factory=RigidTransform)
    shape_kind: int = T.SHAPE_RECT
    shape_param: tuple = (0.5, 0.5, 0.0)
    angle_rad: float = 0.0  # spot / directional cone half-angle
    env_tex: int = T.INVALID_ID

    def surface_area(self) -> float:
        sx, sy, sz = self.shape_param
        if self.shape_kind == T.SHAPE_RECT:
            return 4.0 * sx * sy  # RectShape::GetSurfaceArea
        if self.shape_kind == T.SHAPE_SPHERE:
            return 4.0 * _math.pi * sx * sx
        if self.shape_kind == T.SHAPE_BOX:
            return 8.0 * (sx * sy + sy * sz + sz * sx)
        return 0.0

    def flags(self) -> tuple[bool, bool]:
        """(is_delta, is_finite) per `Core/Scene/Light/*::GetFlags`."""
        cos_eps = 0.9999
        if self.kind == T.LIGHT_AREA:
            return False, True
        if self.kind == T.LIGHT_BACKGROUND:
            return False, False
        if self.kind == T.LIGHT_POINT:
            return True, True
        if self.kind == T.LIGHT_SPOT:
            delta = _math.cos(self.angle_rad) > cos_eps
            return delta, True
        if self.kind == T.LIGHT_DIRECTIONAL:
            delta = _math.cos(self.angle_rad) > cos_eps
            return delta, False
        raise ValueError(self.kind)


def _vec3_np(rows: list, idx) -> Vec3:
    a = np.asarray(rows, dtype=np.float32).reshape(-1, 3)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _rot3(transforms: list[RigidTransform]) -> T.Rot3:
    rows = np.stack([t.rot for t in transforms], 0).astype(np.float32) if transforms else np.zeros((0, 3, 3), np.float32)
    mk = lambda i: Vec3(jnp.asarray(rows[:, i, 0]), jnp.asarray(rows[:, i, 1]), jnp.asarray(rows[:, i, 2]))
    return T.Rot3(mk(0), mk(1), mk(2))



def _tris_attr_arrays(tris, _np):
    """(T,3,3) normals / (T,3,2) uvs / (T,) material ids from a Triangles."""
    nv = lambda v: _np.stack([_np.asarray(v.x), _np.asarray(v.y), _np.asarray(v.z)], -1)
    normals = _np.stack([nv(tris.n0), nv(tris.n1), nv(tris.n2)], axis=1)
    uvs = _np.stack(
        [_np.stack([_np.asarray(tris.uv0_u), _np.asarray(tris.uv0_v)], -1),
         _np.stack([_np.asarray(tris.uv1_u), _np.asarray(tris.uv1_v)], -1),
         _np.stack([_np.asarray(tris.uv2_u), _np.asarray(tris.uv2_v)], -1)],
        axis=1,
    )
    return normals, uvs, _np.asarray(tris.material_id)


class SceneBuilder:
    """Accumulates scene content then freezes to a SceneData pytree."""

    def __init__(self):
        self.materials: list[MaterialDesc] = []
        self.prims: list[PrimDesc] = []
        self.lights: list[LightDesc] = []
        self.decals: list[DecalDesc] = []
        self._mat_index: dict[str, int] = {}
        # mesh triangle accumulation (world space)
        self._tri_v = []  # (n,3,3) vertex positions
        self._tri_n = []  # (n,3,3) vertex normals
        self._tri_uv = []  # (n,3,2)
        self._tri_mat = []  # (n,)
        # shared object-space meshes + instances (two-level structure)
        self._mesh_geoms = []
        self._mesh_instances = []
        self.textures = None  # set by loader when bitmap textures exist

    # --- materials -------------------------------------------------------------
    def add_material(self, desc: MaterialDesc) -> int:
        idx = len(self.materials)
        self.materials.append(desc)
        if desc.name:
            self._mat_index[desc.name] = idx
        return idx

    def material_id(self, name: str) -> int:
        if name not in self._mat_index:
            raise KeyError(f"unknown material '{name}'")
        return self._mat_index[name]

    def default_material_id(self) -> int:
        if "__default__" not in self._mat_index:
            return self.add_material(MaterialDesc(name="__default__"))
        return self._mat_index["__default__"]

    # --- geometry ----------------------------------------------------------------
    def add_sphere(self, transform: RigidTransform, radius: float, material_id: int, light_id=T.INVALID_ID, velocity=(0.0, 0.0, 0.0)):
        self.prims.append(PrimDesc(T.PRIM_SPHERE, transform, (radius, 0.0, 0.0), material_id, light_id, velocity))

    def add_box(self, transform: RigidTransform, half_size, material_id: int, light_id=T.INVALID_ID, velocity=(0.0, 0.0, 0.0)):
        self.prims.append(PrimDesc(T.PRIM_BOX, transform, tuple(half_size), material_id, light_id, velocity))

    def add_rect(self, transform: RigidTransform, half_size2, material_id: int, light_id=T.INVALID_ID, velocity=(0.0, 0.0, 0.0), uv_scale=(1.0, 1.0)):
        sx, sy = half_size2
        self.prims.append(PrimDesc(T.PRIM_RECT, transform, (sx, sy, 0.0), material_id, light_id, velocity, tuple(uv_scale)))

    def add_mesh(self, vertices, indices, normals, uvs, material_ids, transform: RigidTransform | None = None):
        """Add a triangle mesh. vertices (V,3), indices (F,3), normals (V,3),
        uvs (V,2), material_ids (F,). Pre-transformed to world space (the
        wavefront design flattens instances; cf. two-level BVH `Scene.cpp:128-145`)."""
        vertices = np.asarray(vertices, np.float64)
        normals = np.asarray(normals, np.float64)
        if transform is not None:
            vertices = vertices * transform.scale @ transform.rot + transform.translation
            normals = normals @ transform.rot
        indices = np.asarray(indices, np.int64)
        tri_v = vertices[indices]  # (F,3,3)
        tri_n = normals[indices]
        tri_uv = np.asarray(uvs, np.float64)[indices] if uvs is not None else np.zeros((len(indices), 3, 2))
        self._tri_v.append(tri_v)
        self._tri_n.append(tri_n)
        self._tri_uv.append(tri_uv)
        self._tri_mat.append(np.asarray(material_ids, np.int64))

    def add_mesh_geometry(self, vertices, indices, normals, uvs, material_ids) -> int:
        """Register a shared OBJECT-SPACE mesh; returns a mesh id for
        :meth:`add_mesh_instance`.  Geometry is stored once no matter how
        many instances reference it (the reference's shared `Mesh` owned by
        several scene objects, `SceneObject_Shape.h:10-32`)."""
        mid = len(self._mesh_geoms)
        self._mesh_geoms.append((
            np.asarray(vertices, np.float64), np.asarray(indices, np.int64),
            np.asarray(normals, np.float64),
            np.asarray(uvs, np.float64) if uvs is not None else None,
            np.asarray(material_ids, np.int64),
        ))
        return mid

    def add_mesh_instance(self, mesh_id: int, transform: RigidTransform, velocity=(0.0, 0.0, 0.0)) -> int:
        """Place an instance of a registered mesh: rigid transform + linear
        shutter velocity (mesh motion blur, `SceneObject.h:22-55`
        `GetTransform(time)` with per-ray time)."""
        if getattr(transform, "scale", 1.0) != 1.0:
            raise ValueError(
                "instances are rigid (rotation+translation); bake scaled "
                "meshes with add_mesh or pre-scale the geometry"
            )
        self._mesh_instances.append((mesh_id, transform, tuple(velocity)))
        return len(self._mesh_instances) - 1

    # --- lights ------------------------------------------------------------------
    def add_light(self, desc: LightDesc) -> int:
        light_id = len(self.lights)
        self.lights.append(desc)
        # finite area lights are hit-testable scene geometry
        # (`SceneObject_Light.cpp:27-53`)
        if desc.kind == T.LIGHT_AREA:
            null_mat = self._light_material_id()
            prim_kind = {T.SHAPE_RECT: T.PRIM_RECT, T.SHAPE_SPHERE: T.PRIM_SPHERE, T.SHAPE_BOX: T.PRIM_BOX}[desc.shape_kind]
            self.prims.append(PrimDesc(prim_kind, desc.transform, tuple(desc.shape_param), null_mat, light_id))
        return light_id

    def _light_material_id(self) -> int:
        if "__light__" not in self._mat_index:
            return self.add_material(MaterialDesc(name="__light__", bsdf="null", base_color=(0, 0, 0)))
        return self._mat_index["__light__"]

    # --- freeze --------------------------------------------------------------------
    def build(self) -> T.SceneData:
        if not self.materials:
            self.default_material_id()
        mats = self.materials
        materials = T.Materials(
            bsdf=jnp.asarray([T.BSDF_NAMES[m.bsdf] for m in mats], jnp.int32),
            base_color=_vec3_np([m.base_color for m in mats], None),
            emission=_vec3_np([m.emission for m in mats], None),
            roughness=jnp.asarray([m.roughness for m in mats], jnp.float32),
            metalness=jnp.asarray([m.metalness for m in mats], jnp.float32),
            ior=jnp.asarray([m.ior for m in mats], jnp.float32),
            k=jnp.asarray([m.k for m in mats], jnp.float32),
            base_color_tex=jnp.asarray([m.base_color_tex for m in mats], jnp.int32),
            emission_tex=jnp.asarray([m.emission_tex for m in mats], jnp.int32),
            roughness_tex=jnp.asarray([m.roughness_tex for m in mats], jnp.int32),
            metalness_tex=jnp.asarray([m.metalness_tex for m in mats], jnp.int32),
            normal_tex=jnp.asarray([m.normal_tex for m in mats], jnp.int32),
            mask_tex=jnp.asarray([m.mask_tex for m in mats], jnp.int32),
            normal_strength=jnp.asarray([m.normal_strength for m in mats], jnp.float32),
            dispersive=jnp.asarray([m.dispersive for m in mats], bool),
            abbe=jnp.asarray([m.abbe for m in mats], jnp.float32),
            dispersion_c=jnp.asarray([m.dispersion_c for m in mats], jnp.float32),
            dispersion_d=jnp.asarray([m.dispersion_d for m in mats], jnp.float32),
            disp_use_abbe=jnp.asarray([m.disp_use_abbe for m in mats], bool),
        )

        prim_list = self.prims
        if not prim_list:
            # a radius-0 sphere can never be hit (discriminant <= 0); keeps
            # every gather shape static without special empty-scene kernels
            prim_list = [
                PrimDesc(T.PRIM_SPHERE, RigidTransform(), (0.0, 0.0, 0.0), 0)
            ]
        prims = T.Primitives(
            kind=jnp.asarray([p.kind for p in prim_list], jnp.int32),
            rot=_rot3([p.transform for p in prim_list]),
            trans=_vec3_np([tuple(p.transform.translation) for p in prim_list], None),
            param=_vec3_np([p.param for p in prim_list], None),
            material_id=jnp.asarray([p.material_id for p in prim_list], jnp.int32),
            light_id=jnp.asarray([p.light_id for p in prim_list], jnp.int32),
            vel=_vec3_np([p.velocity for p in prim_list], None),
            uv_scale=_vec3_np([(p.uv_scale[0], p.uv_scale[1], 1.0) for p in prim_list], None),
        )

        lights = self._build_lights()
        tris, bvh = self._build_tris()
        clusters = None
        if tris is not None:
            import numpy as _np

            from .clusters import build_clusters

            v0 = _np.stack([_np.asarray(tris.v0.x), _np.asarray(tris.v0.y), _np.asarray(tris.v0.z)], -1)
            e1 = _np.stack([_np.asarray(tris.e1.x), _np.asarray(tris.e1.y), _np.asarray(tris.e1.z)], -1)
            e2 = _np.stack([_np.asarray(tris.e2.x), _np.asarray(tris.e2.y), _np.asarray(tris.e2.z)], -1)
            nrm, uv, mid = _tris_attr_arrays(tris, _np)
            clusters = build_clusters(v0, e1, e2, normals=nrm, uvs=uv, material_ids=mid)
        mesh_geoms, instances = self._build_instances()
        scene = T.SceneData(prims=prims, tris=tris, bvh=bvh, materials=materials,
                            lights=lights, textures=self.textures, clusters=clusters,
                            env_dist=self._build_env_dist(),
                            decals=self._build_decals(),
                            mesh_geoms=mesh_geoms, instances=instances)
        meta = self._build_meta(scene)
        return scene, meta

    @staticmethod
    def _scene_radius(scene: "T.SceneData") -> float:
        """World bounding-sphere radius about the origin, from the built
        geometry.  Replaces the reference's hardcoded 30
        (`BackgroundLight.cpp:16`, its own TODO): background/directional
        photon emission samples a disk of this radius, so a large scene with
        a smaller hardcoded radius would silently miss geometry in
        light-tracing/VCM.  Conservative (rotation-free norm bounds)."""
        import numpy as _np

        r = 0.0

        def acc(dist):
            nonlocal r
            if dist.size:
                m = float(_np.max(dist))
                if _np.isfinite(m):
                    r = max(r, m)

        p = scene.prims
        kind = _np.asarray(p.kind)
        # skip the radius-0 placeholder sphere of empty scenes
        px, py, pz = (_np.asarray(v) for v in (p.param.x, p.param.y, p.param.z))
        extent = _np.sqrt(px * px + py * py + pz * pz)
        center = _np.sqrt(
            _np.asarray(p.trans.x) ** 2 + _np.asarray(p.trans.y) ** 2
            + _np.asarray(p.trans.z) ** 2
        )
        real = extent > 0.0
        acc((center + extent)[real])
        if scene.tris is not None:
            v0 = _np.stack([_np.asarray(scene.tris.v0.x), _np.asarray(scene.tris.v0.y), _np.asarray(scene.tris.v0.z)], -1)
            e1 = _np.stack([_np.asarray(scene.tris.e1.x), _np.asarray(scene.tris.e1.y), _np.asarray(scene.tris.e1.z)], -1)
            e2 = _np.stack([_np.asarray(scene.tris.e2.x), _np.asarray(scene.tris.e2.y), _np.asarray(scene.tris.e2.z)], -1)
            for v in (v0, v0 + e1, v0 + e2):
                acc(_np.linalg.norm(v, axis=1))
        if scene.instances is not None:
            it = scene.instances
            ic = _np.sqrt(
                _np.asarray(it.trans.x) ** 2 + _np.asarray(it.trans.y) ** 2
                + _np.asarray(it.trans.z) ** 2
            )
            for i, mid in enumerate(it.mesh_ids):
                g = scene.mesh_geoms[mid].tris
                v0 = _np.stack([_np.asarray(g.v0.x), _np.asarray(g.v0.y), _np.asarray(g.v0.z)], -1)
                e1 = _np.stack([_np.asarray(g.e1.x), _np.asarray(g.e1.y), _np.asarray(g.e1.z)], -1)
                e2 = _np.stack([_np.asarray(g.e2.x), _np.asarray(g.e2.y), _np.asarray(g.e2.z)], -1)
                obj_r = max(
                    float(_np.max(_np.linalg.norm(v, axis=1)))
                    for v in (v0, v0 + e1, v0 + e2)
                )
                acc(_np.asarray([ic[i] + obj_r]))
        if r <= 0.0:
            return 30.0  # empty scene: keep the reference default
        return float(max(1.05 * r, 1e-3))

    def add_decal(self, desc: DecalDesc) -> int:
        idx = len(self.decals)
        self.decals.append(desc)
        return idx

    def _build_decals(self):
        """Flatten decals, pre-sorted by descending ``order`` so application
        order matches the reference's sort (`Scene.cpp:448-456`)."""
        if not self.decals:
            return None
        ds = sorted(self.decals, key=lambda d: -d.order)
        return T.Decals(
            rot=_rot3([d.transform for d in ds]),
            trans=_vec3_np([tuple(d.transform.translation) for d in ds], None),
            half_size=_vec3_np([d.half_size for d in ds], None),
            base_color=_vec3_np([d.base_color for d in ds], None),
            base_color_tex=jnp.asarray([d.base_color_tex for d in ds], jnp.int32),
            alpha_tex=jnp.asarray([d.alpha_tex for d in ds], jnp.int32),
            roughness=jnp.asarray([d.roughness for d in ds], jnp.float32),
            alpha_min=jnp.asarray([d.alpha_min for d in ds], jnp.float32),
            alpha_max=jnp.asarray([d.alpha_max for d in ds], jnp.float32),
        )

    def _build_env_dist(self):
        """2-D luminance×sin(theta) distribution over the background light's
        lat-long env bitmap, for NEE importance sampling (the analogue of
        `BitmapTexture::MakeSamplable`, `BitmapTexture.cpp:122-152`, extended
        to 2-D)."""
        if self.textures is None:
            return None
        bg = next((l for l in self.lights if l.kind == T.LIGHT_BACKGROUND), None)
        if bg is None or bg.env_tex < 0:
            return None
        atlas = self.textures
        if int(np.asarray(atlas.kind)[bg.env_tex]) != T.TEX_BITMAP:
            return None
        y0 = int(np.asarray(atlas.y0)[bg.env_tex])
        h = int(np.asarray(atlas.height)[bg.env_tex])
        w = int(np.asarray(atlas.width)[bg.env_tex])
        img = np.asarray(atlas.data)[y0:y0 + h, :w, :]
        lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float64)
        theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
        from ..math.distribution import make_distribution_2d

        return make_distribution_2d(lum * np.sin(theta)[:, None])

    def _build_meta(self, scene: "T.SceneData" = None) -> T.SceneMeta:
        ls = self.lights if self.lights else []
        kinds = tuple(l.kind for l in ls) if ls else (T.LIGHT_POINT,)
        deltas = tuple(l.flags()[0] for l in ls) if ls else (True,)
        bg = next((i for i, l in enumerate(ls) if l.kind == T.LIGHT_BACKGROUND), -1)
        return T.SceneMeta(
            light_kinds=kinds,
            light_is_delta=deltas,
            n_lights=len(ls),
            background_light_index=bg,
            scene_radius=self._scene_radius(scene) if scene is not None else 30.0,
        )

    def _build_lights(self) -> T.Lights:
        ls = self.lights
        if not ls:
            # one dummy light keeps shapes static; flagged so it never samples
            ls = [LightDesc(kind=T.LIGHT_POINT, color=(0.0, 0.0, 0.0))]
            dummy = True
        else:
            dummy = False
        flags = [l.flags() for l in ls]
        lights = T.Lights(
            kind=jnp.asarray([l.kind for l in ls], jnp.int32),
            color=_vec3_np([l.color for l in ls], None),
            rot=_rot3([l.transform for l in ls]),
            trans=_vec3_np([tuple(l.transform.translation) for l in ls], None),
            shape_kind=jnp.asarray([l.shape_kind for l in ls], jnp.int32),
            shape_param=_vec3_np([l.shape_param for l in ls], None),
            area=jnp.asarray([l.surface_area() for l in ls], jnp.float32),
            cos_angle=jnp.asarray([_math.cos(l.angle_rad) for l in ls], jnp.float32),
            is_delta=jnp.asarray([f[0] for f in flags], bool),
            is_finite=jnp.asarray([f[1] for f in flags], bool),
            env_tex=jnp.asarray([l.env_tex for l in ls], jnp.int32),
        )
        self.n_real_lights = 0 if dummy else len(self.lights)
        return lights

    def _build_instances(self):
        """Freeze shared meshes (object space) + the instance table."""
        if not self._mesh_instances:
            return (), None
        import numpy as _np

        from .bvh import build_bvh_over_triangles
        from .clusters import build_clusters

        geoms = []
        for verts, idxs, norms, uvs, mats in self._mesh_geoms:
            tri_v = verts[idxs].astype(_np.float32)
            tri_n = norms[idxs].astype(_np.float32)
            tri_uv = (uvs[idxs] if uvs is not None else _np.zeros((len(idxs), 3, 2))).astype(_np.float32)
            tris, _bvh = build_bvh_over_triangles(tri_v, tri_n, tri_uv, mats.astype(_np.int32))
            v0 = _np.stack([_np.asarray(tris.v0.x), _np.asarray(tris.v0.y), _np.asarray(tris.v0.z)], -1)
            e1 = _np.stack([_np.asarray(tris.e1.x), _np.asarray(tris.e1.y), _np.asarray(tris.e1.z)], -1)
            e2 = _np.stack([_np.asarray(tris.e2.x), _np.asarray(tris.e2.y), _np.asarray(tris.e2.z)], -1)
            nrm, uv, mid = _tris_attr_arrays(tris, _np)
            geoms.append(T.MeshGeom(tris=tris, clusters=build_clusters(
                v0, e1, e2, normals=nrm, uvs=uv, material_ids=mid)))

        insts = self._mesh_instances
        instances = T.Instances(
            rot=_rot3([t for _, t, _ in insts]),
            trans=_vec3_np([tuple(t.translation) for _, t, _ in insts], None),
            vel=_vec3_np([v for _, _, v in insts], None),
            mesh_ids=tuple(int(m) for m, _, _ in insts),
        )
        return tuple(geoms), instances

    def _build_tris(self):
        if not self._tri_v:
            return None, None
        from .bvh import build_bvh_over_triangles

        tri_v = np.concatenate(self._tri_v, 0).astype(np.float32)
        tri_n = np.concatenate(self._tri_n, 0).astype(np.float32)
        tri_uv = np.concatenate(self._tri_uv, 0).astype(np.float32)
        tri_mat = np.concatenate(self._tri_mat, 0).astype(np.int32)
        return build_bvh_over_triangles(tri_v, tri_n, tri_uv, tri_mat)

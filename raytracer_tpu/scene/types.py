"""Device-side scene representation: flat structure-of-arrays pytrees.

The reference models the scene as an OOP graph (ISceneObject / IShape / ILight /
BSDF virtual dispatch, `Core/Scene/SceneObject.h`, `Core/Shapes/Shape.h`,
`Core/Scene/Light/Light.h`).  Virtual dispatch is hostile to SPMD wavefronts;
the re-expression flattens everything into typed SoA arrays with
integer-kind dispatch (branchless masked evaluation / `lax.switch`):

- ``Primitives``: all *analytic* traceable objects (sphere / box / rect / csg
  participants) with their rigid transforms, material ids and light ids.
  Area-light geometry lives here too (the reference wraps lights in
  ``LightSceneObject`` so they are hit-testable, `SceneObject_Light.cpp:27-53`;
  here a primitive with ``light_id >= 0`` plays that role).
- ``Triangles`` + ``BVHArrays``: mesh geometry pre-transformed to world space,
  with precomputed v0/edge1/edge2 like the reference's ``ProcessedTriangle``
  (`Core/Mesh/VertexBuffer.cpp:110-128`) plus per-vertex shading attributes.
- ``Materials``: PBR parameter table (`Core/Material/Material.h:44-77`).
- ``Lights``: every light's parameters in one table (`Core/Scene/Light/*`).
- ``Camera``: perspective + DoF + distortion (`Core/Scene/Camera.h`).

Everything is a NamedTuple => a JAX pytree: jit/grad/shard-map friendly.
Counts are static per scene, so one compilation per scene shape class.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..math.vec import Vec3

# --- enums (static ints) -------------------------------------------------------
PRIM_SPHERE = 0
PRIM_BOX = 1
PRIM_RECT = 2

BSDF_NULL = 0
BSDF_DIFFUSE = 1
BSDF_ROUGH_DIFFUSE = 2
BSDF_DIELECTRIC = 3
BSDF_ROUGH_DIELECTRIC = 4
BSDF_METAL = 5
BSDF_ROUGH_METAL = 6
BSDF_PLASTIC = 7
BSDF_ROUGH_PLASTIC = 8

BSDF_NAMES = {
    "null": BSDF_NULL,
    "diffuse": BSDF_DIFFUSE,
    "roughDiffuse": BSDF_ROUGH_DIFFUSE,
    "dielectric": BSDF_DIELECTRIC,
    "roughDielectric": BSDF_ROUGH_DIELECTRIC,
    "metal": BSDF_METAL,
    "roughMetal": BSDF_ROUGH_METAL,
    "plastic": BSDF_PLASTIC,
    "roughPlastic": BSDF_ROUGH_PLASTIC,
}

LIGHT_AREA = 0
LIGHT_BACKGROUND = 1
LIGHT_POINT = 2
LIGHT_SPOT = 3
LIGHT_DIRECTIONAL = 4

SHAPE_RECT = 0
SHAPE_SPHERE = 1
SHAPE_BOX = 2

# roughness below this threshold => treat rough BSDF as its specular version
# (`Core/Material/BSDF/BSDF.h:57`)
SPECULAR_ROUGHNESS_THRESHOLD = 0.005

# sentinel hit ids (`Core/Traversal/HitPoint.h:8-9`)
INVALID_ID = -1


class Rot3(NamedTuple):
    """Rotation as three world-space basis rows (row-vector convention).

    ``r0/r1/r2`` are the images of local X/Y/Z; components are (P,) arrays.
    local->world: x*r0 + y*r1 + z*r2 ; world->local: dots with rows.
    """

    r0: Vec3
    r1: Vec3
    r2: Vec3

    def to_world(self, v: Vec3) -> Vec3:
        return self.r0 * v.x + self.r1 * v.y + self.r2 * v.z

    def to_local(self, v: Vec3) -> Vec3:
        from ..math.vec import dot

        return Vec3(dot(v, self.r0), dot(v, self.r1), dot(v, self.r2))


class Primitives(NamedTuple):
    """Analytic traceable objects, SoA over P prims."""

    kind: jnp.ndarray  # (P,) int32: PRIM_*
    rot: Rot3  # local->world rotation rows, (P,) each
    trans: Vec3  # world translation, (P,)
    param: Vec3  # sphere: (radius,-,-); box/rect: half-size
    material_id: jnp.ndarray  # (P,) int32
    light_id: jnp.ndarray  # (P,) int32, INVALID_ID unless this prim IS a light
    # linear velocity over the shutter interval: effective translation at ray
    # time t is trans + vel*t — the analogue of the reference's per-object
    # keyframed transform `ISceneObject::GetTransform(time)`
    # (`Core/Scene/Object/SceneObject.h:22-55`, sampled per pixel at
    # `Viewport.cpp:309`)
    vel: Vec3  # (P,)
    # per-object texture-coordinate scale (u, v) — `RectShape::mTextureScale`
    # (`Core/Shapes/RectShape.cpp:128`, parsed from JSON "textureScale")
    uv_scale: Vec3 = None

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Triangles(NamedTuple):
    """World-space triangle soup (ProcessedTriangle layout), SoA over T tris."""

    v0: Vec3
    e1: Vec3  # v1 - v0
    e2: Vec3  # v2 - v0
    n0: Vec3  # per-vertex shading normals
    n1: Vec3
    n2: Vec3
    uv0_u: jnp.ndarray
    uv0_v: jnp.ndarray
    uv1_u: jnp.ndarray
    uv1_v: jnp.ndarray
    uv2_u: jnp.ndarray
    uv2_v: jnp.ndarray
    material_id: jnp.ndarray  # (T,) int32

    @property
    def count(self) -> int:
        return self.material_id.shape[0]


class BVHFlat(NamedTuple):
    """Flattened binary BVH in a gather-friendly, *stackless* device layout.

    The reference walks its BVH with a per-thread stack and near-child-first
    ordering (`Core/Traversal/Traversal_Single.h:16-96`).  A per-ray stack is
    hostile to a lock-step wavefront, so we pre-thread the tree instead: for each of
    the 8 ray-direction octants the host computes *skip links* — ``hit`` (next
    node when the ray hits this node's box: the octant-near child) and ``miss``
    (next node in that octant's depth-first order when the box is missed or the
    subtree is done).  Traversal is then a single int32 of state per ray and a
    `lax.while_loop`; near-first ordering (the reference's key heuristic,
    `Traversal_Single.h:65-75`) is preserved exactly because links were
    threaded per octant using each node's split axis.

    Node AABBs are packed as one (M, 8) row per node (min.xyz, max.xyz, pad,
    pad ≈ the reference's 32-byte node, `Core/BVH/BVH.h:22-62`) so a per-ray
    node fetch is ONE row gather.  Every leaf owns exactly ``LEAF_SIZE``
    triangle slots (padded with degenerate triangles that cannot be hit), so
    leaf processing is branch- and length-free.
    """

    nodes_box: jnp.ndarray  # (M, 8) f32: min.xyz, max.xyz, 0, 0
    node_first_tri: jnp.ndarray  # (M,) int32: leaf -> first padded-tri slot; inner -> -1
    hit_link: jnp.ndarray  # (8, M) int32 per-octant next-on-hit (-1 = done)
    miss_link: jnp.ndarray  # (8, M) int32 per-octant next-on-miss (-1 = done)
    tri_geom: jnp.ndarray  # (Tpad, 9) f32: v0, e1, e2 per padded leaf slot
    tri_id: jnp.ndarray  # (Tpad,) int32: original (reordered) triangle index, -1 = pad
    # --- packed traversal tables (ONE gather per node step + one per leaf):
    # row = [bmin(3), bmax(3), leaf_row|-1, hit_link, miss_link] per octant,
    # int lanes bitcast to f32.  Leaf row = 4 tris x (v0,e1,e2) + 4 ids.
    packed_nodes: jnp.ndarray  # (8*M, 9) f32 (lanes 6..8 bitcast int32)
    leaf_geom: jnp.ndarray  # (L, 40) f32: 36 geom floats + 4 bitcast int32 ids

    @property
    def num_nodes(self) -> int:
        return self.node_first_tri.shape[0]


class Materials(NamedTuple):
    """PBR material table (`Core/Material/Material.h:44-77`), SoA over M."""

    bsdf: jnp.ndarray  # (M,) int32: BSDF_*
    base_color: Vec3  # (M,)
    emission: Vec3  # (M,)
    roughness: jnp.ndarray  # (M,)
    metalness: jnp.ndarray  # (M,)
    ior: jnp.ndarray  # (M,)
    k: jnp.ndarray  # (M,) extinction for conductors
    # texture indices into the texture atlas; INVALID_ID = constant parameter
    base_color_tex: jnp.ndarray  # (M,) int32
    emission_tex: jnp.ndarray
    roughness_tex: jnp.ndarray
    metalness_tex: jnp.ndarray
    normal_tex: jnp.ndarray
    mask_tex: jnp.ndarray
    normal_strength: jnp.ndarray  # (M,)
    # spectral dispersion (`Material.h:60-66`; active in spectral mode only).
    # Reference form: ior(lambda) = IoR + C/lambda_um^2 + D/lambda_um^4 with
    # BK7 defaults C=0.0042, D=0 (`Material.cpp:23-28`, the only values its
    # scenes can use — SceneLoader parses just the "dispersive" bool).  Our
    # extension: an explicit "abbe" key selects the (n_d, V_d) Cauchy form.
    dispersive: jnp.ndarray  # (M,) bool
    abbe: jnp.ndarray  # (M,) f32 Abbe number V_d (extension form)
    dispersion_c: jnp.ndarray = None  # (M,) f32 Cauchy C (um^2)
    dispersion_d: jnp.ndarray = None  # (M,) f32 Cauchy D (um^4)
    disp_use_abbe: jnp.ndarray = None  # (M,) bool: abbe form instead of C/D

    @property
    def count(self) -> int:
        return self.bsdf.shape[0]


class Lights(NamedTuple):
    """All lights, SoA over L (`Core/Scene/Light/*`)."""

    kind: jnp.ndarray  # (L,) int32: LIGHT_*
    color: Vec3  # (L,) radiance / intensity
    rot: Rot3  # light local->world rotation
    trans: Vec3  # light position
    shape_kind: jnp.ndarray  # (L,) int32 SHAPE_* (area lights)
    shape_param: Vec3  # rect/box: half-size; sphere: (radius,-,-)
    area: jnp.ndarray  # (L,) surface area of area lights
    cos_angle: jnp.ndarray  # (L,) spot/directional cone cosine
    is_delta: jnp.ndarray  # (L,) bool (Flag_IsDelta)
    is_finite: jnp.ndarray  # (L,) bool (Flag_IsFinite)
    env_tex: jnp.ndarray  # (L,) int32 texture id for background lights

    @property
    def count(self) -> int:
        return self.kind.shape[0]


import dataclasses as _dc

import jax as _jax


@_jax.tree_util.register_dataclass
@_dc.dataclass(frozen=True)
class Camera:
    """Perspective camera + DoF (`Core/Scene/Camera.h:56-108`).

    Differentiable parameters (origin / rotation rows / fov tangent) are traced
    pytree leaves so gradients flow to camera pose; feature toggles
    (``enable_dof`` / ``bokeh_shape`` / …) are static metadata so jit emits
    only the active branches.
    """

    origin: Vec3  # scalars
    right: Vec3  # transform row 0
    up: Vec3  # transform row 1
    forward: Vec3  # transform row 2
    tan_half_fov: jnp.ndarray  # scalar
    aspect: jnp.ndarray  # scalar width/height
    # depth of field
    aperture: jnp.ndarray
    focal_distance: jnp.ndarray
    # barrel distortion (`Camera.cpp:86-92`)
    distortion_const: jnp.ndarray
    distortion_variable: jnp.ndarray
    # motion blur: camera transform at shutter-close (t=1); ray transforms are
    # lerped + re-orthonormalized by per-ray time (`Camera::SampleTransform`,
    # `Core/Scene/Camera.cpp:61-79`)
    origin_end: Vec3
    right_end: Vec3
    up_end: Vec3
    forward_end: Vec3
    # --- static (hashable) config ------------------------------------------
    enable_dof: bool = _dc.field(default=False, metadata={"static": True})
    bokeh_shape: int = _dc.field(default=0, metadata={"static": True})
    aperture_blades: int = _dc.field(default=5, metadata={"static": True})
    enable_distortion: bool = _dc.field(default=False, metadata={"static": True})
    enable_motion_blur: bool = _dc.field(default=False, metadata={"static": True})


# texture kinds (`Core/Textures/*`): bitmap / checkerboard / simplex-noise /
# mix(A,B,weight) / constant
TEX_BITMAP = 0
TEX_CHECKERBOARD = 1
TEX_NOISE = 2
TEX_MIX = 3
TEX_CONST = 4


class TextureAtlas(NamedTuple):
    """The whole texture system as one SoA table (K textures).

    Bitmaps are packed row-wise into ONE (rows, W_atlas, 3) array so a
    per-ray fetch is a single 2-D gather regardless of which texture each ray
    addresses; procedural textures (checkerboard `CheckerboardTexture.cpp`,
    simplex-noise FBM `NoiseTexture.cpp`, mix `MixTexture.h`) are evaluated
    inline, branchlessly selected by per-texture integer ``kind``.
    """

    data: jnp.ndarray  # (rows, W, 3) f32 linear — packed bitmap storage
    y0: jnp.ndarray  # (K,) int32 first row of texture k (bitmaps)
    height: jnp.ndarray  # (K,) int32
    width: jnp.ndarray  # (K,) int32
    filter_mode: jnp.ndarray  # (K,) int32: 0 nearest, 1 bilinear, 2 bilinear-smoothstep
    kind: jnp.ndarray  # (K,) int32: TEX_*
    color_a: Vec3  # (K,) checkerboard/noise color A, const color
    color_b: Vec3  # (K,) color B
    octaves: jnp.ndarray  # (K,) int32 noise FBM octaves
    sub_a: jnp.ndarray  # (K,) int32 mix input A texture id
    sub_b: jnp.ndarray  # (K,) int32 mix input B texture id
    sub_w: jnp.ndarray  # (K,) int32 mix weight texture id


class Decals(NamedTuple):
    """Projected-texture decals, SoA over D, pre-sorted by descending
    ``order`` (`SceneObject_Decal.h:21-37`, applied `Scene.cpp:446-462`).

    A decal is a unit box in its local space; shading points inside it get
    base color / roughness alpha-blended from the decal's texture.  D is
    small and static, so application is a branchless loop (no decal BVH)."""

    rot: Rot3  # local->world rotation rows, (D,) each
    trans: Vec3  # (D,) box center
    half_size: Vec3  # (D,) box half-extents
    base_color: Vec3  # (D,) constant factor
    base_color_tex: jnp.ndarray  # (D,) int32 texture id or INVALID_ID
    alpha_tex: jnp.ndarray  # (D,) int32 alpha texture (.x channel) or INVALID_ID
    roughness: jnp.ndarray  # (D,)
    alpha_min: jnp.ndarray  # (D,)
    alpha_max: jnp.ndarray  # (D,)

    @property
    def count(self) -> int:
        return self.roughness.shape[0]


class MeshGeom(NamedTuple):
    """One shared OBJECT-SPACE mesh: geometry stored once, referenced by any
    number of instances (the reference's Mesh/MeshShape owned by several
    `ShapeSceneObject`s, `Core/Scene/Object/SceneObject_Shape.h:10-32`)."""

    tris: Triangles  # object-space triangle table
    clusters: object  # ClusterSet built over the object-space triangles


import dataclasses as _idc

import jax as _ijax


@_ijax.tree_util.register_dataclass
@_idc.dataclass(frozen=True)
class Instances:
    """Instance table: per-instance rigid transform + linear velocity.

    The re-expression of the reference's two-level structure
    (`Core/Scene/Scene.cpp:128-145`: transform the ray into object space at
    each top-level leaf, `SceneObject.h:22-55` `GetTransform(time)`): rays
    are transformed per instance and traced through the SHARED object-space
    mesh; `mesh_ids` is static so each instance's geometry dispatch is
    resolved at trace time.  `vel` is the shutter-interval translation —
    per-ray time gives rigid-motion blur for meshes."""

    rot: Rot3  # object->world rotation rows, (I,) components
    trans: Vec3  # (I,)
    vel: Vec3  # (I,) translation over the shutter interval
    mesh_ids: tuple = _idc.field(default=(), metadata={"static": True})

    @property
    def count(self) -> int:
        return len(self.mesh_ids)


class SceneData(NamedTuple):
    """Complete device-side scene: the pytree passed into the render kernels."""

    prims: Primitives
    tris: Optional[Triangles]
    bvh: Optional[BVHFlat]
    materials: Materials
    lights: Lights
    textures: Optional[TextureAtlas]
    clusters: object = None  # Optional[ClusterSet]: dense two-phase mesh traversal
    # Optional[Distribution2D] over the background light's env map (luminance ×
    # sin(theta) weights) — enables env importance sampling in NEE
    env_dist: object = None
    decals: Optional[Decals] = None
    # shared object-space meshes + their instances (two-level structure);
    # baked world-space `tris` and instanced meshes can coexist
    mesh_geoms: tuple = ()
    instances: Optional[Instances] = None

    @property
    def has_tris(self) -> bool:
        return self.tris is not None and self.tris.count > 0


import dataclasses as _dataclasses


@_dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene metadata used for trace-time dispatch decisions
    — light kinds drive which global-light branches get emitted, etc.  Kept
    separate from SceneData so the pytree stays purely numeric."""

    light_kinds: tuple = ()
    light_is_delta: tuple = ()
    n_lights: int = 0  # real lights (0 if only the dummy placeholder exists)
    background_light_index: int = -1
    # world bounding-sphere radius derived from the scene bounds at build
    # time (the reference hardcodes 30, `BackgroundLight.cpp:16` — its own
    # TODO); drives background/directional light emission sampling + pdfs
    scene_radius: float = 30.0

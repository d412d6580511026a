"""JSON scene loading — same schema as the reference's `Demo/SceneLoader.cpp`
so its `Data/TestScenes/*.json` files load verbatim.

Schema (all verified against `SceneLoader.cpp`):
- ``textures``: [{name, type: bitmap|checkerboard|noise|mix, path | colorA/
  colorB [+octaves] | textureA/textureB/weightTexture}]  (`:269-360`)
- ``materials``: [{name, bsdf, baseColor, emissionColor, roughness, metalness,
  IoR, K, dispersive, *Texture refs, normalMapStrength}]  (`:364-416`)
- ``objects``: [{type: sphere|box|rect|plane|mesh|csg, radius|size|path,
  transform {translation, orientation(DEGREES), scale}, material}]  (`:418-500`)
- ``lights``: area (transform+shape, or legacy position/edge0/edge1), point,
  spot(angle deg), directional(angle deg), background, sphere(position,
  radius)  (`:501-618`)
- ``camera``: {transform, fieldOfView deg, enableDOF, aperture,
  focalPlaneDistance}  (`:652-690`)

Box/rect ``size`` are HALF-extents (`BoxShape` slab is ±mSize,
`BoxShape.cpp:90-106`; `RectShape.cpp:24`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..math.transform import RigidTransform, parse_transform
from ..ops.textures import AtlasBuilder, FILTER_BILINEAR_SMOOTHSTEP
from ..scene import types as T
from ..scene.build import LightDesc, MaterialDesc, SceneBuilder
from ..scene.camera import make_camera
from .obj import load_obj

_SHAPE_KINDS = {"plane": T.SHAPE_RECT, "rect": T.SHAPE_RECT, "sphere": T.SHAPE_SPHERE, "box": T.SHAPE_BOX}


class SceneLoadError(RuntimeError):
    pass


def _load_bitmap(data_path: str, rel: str) -> np.ndarray:
    """Load a bitmap as linear f32: BMP and EXR through the repo's own
    codecs; PNG/JPG through Pillow when it is installed."""
    path = rel if os.path.isabs(rel) else os.path.join(data_path, rel)
    if not os.path.exists(path):
        raise SceneLoadError(f"texture not found: {path}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from .exr import read_exr

        return read_exr(path)
    from ..color.colorhelpers import srgb_to_linear
    import jax.numpy as jnp

    if ext == ".bmp":
        from .bitmap import read_bmp

        try:
            img = read_bmp(path)[..., :3]
        except ValueError as e:
            raise SceneLoadError(str(e)) from e
        # the reference freads the BMP pixel array raw (`BitmapBMP.cpp:127`)
        # without undoing the format's bottom-up row order, so its v axis is
        # flipped relative to the authored image; read_bmp returns top-down —
        # flip to match the reference's sampling (verified: checker phase on
        # bitmap_texture_test inverts without this, corr -0.89 -> +parity)
        img = img[::-1]
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise SceneLoadError(
                f"texture {path}: reading {ext or 'this'} files needs Pillow, "
                "which is not installed (BMP and EXR textures need nothing)"
            ) from e
        img = np.asarray(Image.open(path).convert("RGB"))
    return np.asarray(srgb_to_linear(jnp.asarray(img.astype(np.float32) / 255.0)))


def _parse_textures(
    doc: dict, data_path: str, strict: bool = False
) -> tuple[AtlasBuilder, dict[str, int], list[str]]:
    atlas = AtlasBuilder()
    names: dict[str, int] = {}
    missing: list[str] = []
    pending_mix = []
    for tex in doc.get("textures", []):
        name = tex.get("name")
        if not name:
            raise SceneLoadError("texture missing 'name'")
        typ = tex.get("type", "bitmap")
        if typ == "bitmap":
            try:
                img = _load_bitmap(data_path, tex["path"].replace("\\", "/"))
            except SceneLoadError:
                if strict:
                    raise
                missing.append(tex["path"])
                names[name] = atlas.add_const((1.0, 1.0, 1.0))
                continue
            names[name] = atlas.add_bitmap(img, FILTER_BILINEAR_SMOOTHSTEP)
        elif typ == "checkerboard":
            names[name] = atlas.add_checkerboard(tuple(tex["colorA"]), tuple(tex["colorB"]))
        elif typ == "noise":
            names[name] = atlas.add_noise(
                tuple(tex["colorA"]), tuple(tex["colorB"]), int(tex.get("octaves", 1))
            )
        elif typ == "mix":
            # sub-textures may be declared later; patch after the loop
            names[name] = atlas.add_mix(0, 0, 0)
            pending_mix.append((names[name], tex))
        else:
            raise SceneLoadError(f"unknown texture type '{typ}'")
    for tid, tex in pending_mix:
        atlas.rows[tid]["sa"] = names[tex["textureA"]]
        atlas.rows[tid]["sb"] = names[tex["textureB"]]
        atlas.rows[tid]["sw"] = names[tex["weight"]]  # key per `SceneLoader.cpp:355`
    return atlas, names, missing


class _TexResolver:
    """Texture reference resolution (`TryParseTextureName`,
    `SceneLoader.cpp:218-242`): a declared texture name, else a bitmap path
    relative to the data dir.  Missing files resolve to a 1x1 white
    placeholder with a warning unless ``strict`` (this environment ships the
    reference's scene JSONs but not its TEXTURES/ assets)."""

    def __init__(self, atlas: AtlasBuilder, names: dict[str, int], data_path: str, strict: bool):
        self.atlas = atlas
        self.names = names
        self.data_path = data_path
        self.strict = strict
        self.missing: list[str] = []

    def get(self, obj: dict, key: str) -> int:
        name = obj.get(key)
        if name is None:
            return T.INVALID_ID
        if name in self.names:
            return self.names[name]
        rel = name.replace("\\", "/")
        try:
            img = _load_bitmap(self.data_path, rel)
        except SceneLoadError:
            if self.strict:
                raise
            self.missing.append(rel)
            self.names[name] = self.atlas.add_const((1.0, 1.0, 1.0))
            return self.names[name]
        self.names[name] = self.atlas.add_bitmap(img, FILTER_BILINEAR_SMOOTHSTEP)
        return self.names[name]


def _parse_materials(doc: dict, builder: SceneBuilder, tex: "_TexResolver"):
    for m in doc.get("materials", []):
        name = m.get("name")
        if not name:
            raise SceneLoadError("material missing 'name'")
        bsdf = m.get("bsdf", "diffuse")
        if bsdf not in T.BSDF_NAMES:
            raise SceneLoadError(
                f"unknown bsdf '{bsdf}' in material '{name}' "
                f"(known: {', '.join(sorted(T.BSDF_NAMES))})"
            )
        builder.add_material(
            MaterialDesc(
                name=name,
                bsdf=bsdf,
                base_color=tuple(m.get("baseColor", (0.7, 0.7, 0.7))),
                emission=tuple(m.get("emissionColor", (0, 0, 0))),
                roughness=float(m.get("roughness", 0.1)),
                metalness=float(m.get("metalness", 0.0)),
                ior=float(m.get("IoR", 1.5)),
                k=float(m.get("K", 4.0)),
                base_color_tex=tex.get(m, "baseColorTexture"),
                emission_tex=tex.get(m, "emissionTexture"),
                roughness_tex=tex.get(m, "roughnessTexture"),
                metalness_tex=tex.get(m, "metalnessTexture"),
                normal_tex=tex.get(m, "normalMap"),
                mask_tex=tex.get(m, "maskMap"),
                normal_strength=float(m.get("normalMapStrength", 1.0)),
                dispersive=bool(m.get("dispersive", False)),
                abbe=float(m.get("abbe", 30.0)),
                dispersion_c=float(m.get("dispersionC", 0.00420)),
                dispersion_d=float(m.get("dispersionD", 0.0)),
                disp_use_abbe="abbe" in m,
            )
        )


def _parse_objects(doc: dict, builder: SceneBuilder, data_path: str):
    # a mesh path used by MULTIPLE objects becomes a shared object-space
    # geometry + per-object instances (geometry stored once — the
    # reference's shared Mesh across ShapeSceneObjects, `Scene.cpp:128-145`)
    from collections import Counter

    path_uses = Counter(
        (o.get("path"), float(o.get("scale", 1.0)))
        for o in doc.get("objects", [])
        if o.get("type") == "mesh"
    )
    mesh_geom_cache: dict = {}
    for o in doc.get("objects", []):
        typ = o.get("type")
        tf = parse_transform(o.get("transform"))
        mat_name = o.get("material")
        mat_id = builder.material_id(mat_name) if mat_name else builder.default_material_id()
        if typ == "sphere":
            builder.add_sphere(tf, float(o.get("radius", 1.0)), mat_id)
        elif typ == "box":
            builder.add_box(tf, tuple(o["size"]), mat_id)
        elif typ in ("rect", "plane"):
            ts = o.get("textureScale", [1.0, 1.0])
            size = o.get("size", (3.0e37, 3.0e37))
            builder.add_rect(tf, (float(size[0]), float(size[1])), mat_id,
                             uv_scale=(float(ts[0]), float(ts[1])))
        elif typ == "mesh":
            path = o["path"]
            full = path if os.path.isabs(path) else os.path.join(data_path, path)
            mesh = load_obj(full, scale=float(o.get("scale", 1.0)))
            # map OBJ materials onto the scene material table
            # (`MeshLoader.cpp:84-102`: Kd/Ke + roughness 0.075, default bsdf)
            remap = []
            for om in mesh.materials:
                remap.append(
                    builder.add_material(
                        MaterialDesc(
                            name=f"{os.path.basename(path)}:{om.name}",
                            bsdf="diffuse",
                            base_color=om.diffuse,
                            emission=om.emission,
                            roughness=0.075,
                            ior=om.ior,
                        )
                    )
                )
            fm = np.asarray([remap[i] for i in mesh.face_materials], np.int64)
            key = (path, float(o.get("scale", 1.0)))
            if path_uses[key] > 1 and getattr(tf, "scale", 1.0) == 1.0:
                if key not in mesh_geom_cache:
                    mesh_geom_cache[key] = builder.add_mesh_geometry(
                        mesh.vertices, mesh.faces, mesh.normals, mesh.uvs, fm
                    )
                builder.add_mesh_instance(mesh_geom_cache[key], tf)
            else:
                builder.add_mesh(mesh.vertices, mesh.faces, mesh.normals, mesh.uvs, fm, tf)
        elif typ == "csg":
            raise SceneLoadError("csg objects not supported yet")
        else:
            raise SceneLoadError(f"unknown object type '{typ}'")


def _parse_lights(doc: dict, builder: SceneBuilder, tex: "_TexResolver"):
    for l in doc.get("lights", []):
        typ = l.get("type")
        color = tuple(l.get("color", (1, 1, 1)))
        tf = parse_transform(l.get("transform"))
        if typ == "area":
            shape = l.get("shape")
            if shape is not None:
                skind = _SHAPE_KINDS.get(shape.get("type", "plane"))
                if skind is None:
                    raise SceneLoadError(f"unknown area light shape '{shape.get('type')}'")
                if skind == T.SHAPE_SPHERE:
                    sp = (float(shape.get("radius", 1.0)), 0.0, 0.0)
                else:
                    size = shape.get("size", (1.0, 1.0))
                    sp = (float(size[0]), float(size[1]), float(size[2]) if len(size) > 2 else 0.0)
                builder.add_light(
                    LightDesc(kind=T.LIGHT_AREA, color=color, transform=tf,
                              shape_kind=skind, shape_param=sp,
                              env_tex=tex.get(l, "texture"))
                )
            else:
                # legacy parallelogram: position + edge0 + edge1
                pos = np.asarray(l["position"], np.float64)
                e0 = np.asarray(l["edge0"], np.float64)
                e1 = np.asarray(l["edge1"], np.float64)
                center = pos + 0.5 * (e0 + e1)
                half0 = 0.5 * np.linalg.norm(e0)
                half1 = 0.5 * np.linalg.norm(e1)
                x = e0 / max(np.linalg.norm(e0), 1e-12)
                y = e1 / max(np.linalg.norm(e1), 1e-12)
                z = np.cross(x, y)
                z /= max(np.linalg.norm(z), 1e-12)
                tf = RigidTransform(translation=center)
                tf.rot = np.stack([x, y, z])
                builder.add_light(
                    LightDesc(kind=T.LIGHT_AREA, color=color, transform=tf,
                              shape_kind=T.SHAPE_RECT, shape_param=(half0, half1, 0.0))
                )
        elif typ == "sphere":
            # sphere-shaped area light: position + radius (`SceneLoader.cpp:590-596`)
            tf = RigidTransform(translation=tuple(l.get("position", (0, 0, 0))))
            builder.add_light(
                LightDesc(kind=T.LIGHT_AREA, color=color, transform=tf,
                          shape_kind=T.SHAPE_SPHERE,
                          shape_param=(float(l.get("radius", 1.0)), 0.0, 0.0))
            )
        elif typ == "point":
            builder.add_light(LightDesc(kind=T.LIGHT_POINT, color=color, transform=tf))
        elif typ == "spot":
            builder.add_light(
                LightDesc(kind=T.LIGHT_SPOT, color=color, transform=tf,
                          angle_rad=np.deg2rad(float(l.get("angle", 0.0))))
            )
        elif typ == "directional":
            builder.add_light(
                LightDesc(kind=T.LIGHT_DIRECTIONAL, color=color, transform=tf,
                          angle_rad=np.deg2rad(float(l.get("angle", 0.0))))
            )
        elif typ == "background":
            builder.add_light(
                LightDesc(kind=T.LIGHT_BACKGROUND, color=color,
                          env_tex=tex.get(l, "texture"))
            )
        else:
            raise SceneLoadError(f"unknown light type '{typ}'")


def load_scene(path: str, data_path: str | None = None, aspect: float = 1.0,
               strict: bool = False):
    """Load a reference-format JSON scene.

    Returns (scene_data, scene_meta, camera).  ``data_path`` is the asset root
    for texture/mesh paths (the reference's --data option, `Main.cpp:6-46`);
    defaults to the scene file's directory.
    """
    doc = json.load(open(path))
    data_path = data_path or os.path.dirname(os.path.abspath(path))

    builder = SceneBuilder()
    atlas_builder, tex_names, missing0 = _parse_textures(doc, data_path, strict)
    tex = _TexResolver(atlas_builder, tex_names, data_path, strict)
    tex.missing.extend(missing0)
    _parse_materials(doc, builder, tex)
    _parse_objects(doc, builder, data_path)
    _parse_lights(doc, builder, tex)
    if tex.missing:
        import warnings
        warnings.warn(
            f"{path}: {len(tex.missing)} texture file(s) not found, using white "
            f"placeholders: {tex.missing[:3]}..."
        )
    if atlas_builder.rows:
        builder.textures = atlas_builder.build()

    scene, meta = builder.build()

    cam_doc = doc.get("camera", {})
    cam_tf = parse_transform(cam_doc.get("transform"))
    camera = make_camera(
        cam_tf,
        fov_deg=float(cam_doc.get("fieldOfView", 60.0)),
        aspect=aspect,
        enable_dof=bool(cam_doc.get("enableDOF", False)),
        aperture=float(cam_doc.get("aperture", 0.1)),
        focal_distance=float(cam_doc.get("focalPlaneDistance", 2.0)),
    )
    return scene, meta, camera

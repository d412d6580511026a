"""Sponza-class procedural interior — the "big scene" benchmark + parity
target.

The reference checkout ships `Data/TestScenes/sponza.json` but not the OBJ
asset (`MODELS/crytek-sponza/`), so BASELINE.md's north-star scene cannot be
loaded.  This generates a comparable workload from scratch — a colonnaded
hall (~1M triangles, 6 meshes, 7 materials, 3 bitmap textures, rect area
lights + spot + background) — written in the reference SceneLoader schema so
BOTH renderers consume the identical files:

- floor / ceiling / walls: displaced subdivided grids (stone + plaster)
- two rows of fluted columns with capitals (baked into one mesh)
- torus-knot centrepieces (glossy metal), analytic sphere + box props
- textures: generated BMPs (checker marble, plaster noise, floor tiles)

Files land in the checkout's git-ignored ``build/scenes/interior/``; entry:
ensure_interior().
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from raytracer_tpu.io.bitmap import write_bmp  # noqa: E402

BENCH_DIR = os.path.join(_ROOT, "build", "scenes", "interior")
SEED = 11

# hall dimensions
HX, HY, HZ = 16.0, 7.0, 40.0  # half-width, height, half-depth


def _write_bmp(path, img):
    """24-bit BMP (both loaders read BMP)."""
    write_bmp(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _textures(rng):
    os.makedirs(BENCH_DIR, exist_ok=True)
    paths = {}
    # floor tiles: checker with per-tile value noise
    n = 256
    yy, xx = np.mgrid[0:n, 0:n]
    tile = ((xx // 32 + yy // 32) % 2).astype(np.float32)
    marb = 0.55 + 0.25 * tile[..., None] + 0.08 * rng.standard_normal((n, n, 1))
    img = np.repeat(marb, 3, axis=2) * np.array([1.0, 0.97, 0.9])
    paths["floor"] = os.path.join(BENCH_DIR, "tex_floor.bmp")
    _write_bmp(paths["floor"], img)
    # plaster: low-frequency blotches
    f = rng.standard_normal((16, 16, 1))
    big = np.kron(f, np.ones((16, 16, 1)))
    img = 0.75 + 0.06 * big + 0.03 * rng.standard_normal((n, n, 1))
    paths["plaster"] = os.path.join(BENCH_DIR, "tex_plaster.bmp")
    _write_bmp(paths["plaster"], np.repeat(img, 3, axis=2) * np.array([1.0, 0.95, 0.88]))
    # column marble: vertical veins
    v = np.sin(xx * 0.21 + 3.0 * np.sin(yy * 0.02)) * 0.5 + 0.5
    img = (0.6 + 0.25 * v)[..., None] * np.array([0.95, 0.93, 0.9])
    img += 0.04 * rng.standard_normal((n, n, 3))
    paths["marble"] = os.path.join(BENCH_DIR, "tex_marble.bmp")
    _write_bmp(paths["marble"], img)
    return paths


def _grid(nx, nz, fx, half_u, half_v):
    """Subdivided quad grid in (u, v) with height function fx(u, v)."""
    us = np.linspace(-half_u, half_u, nx, dtype=np.float32)
    vs = np.linspace(-half_v, half_v, nz, dtype=np.float32)
    U, V = np.meshgrid(us, vs)
    H = fx(U, V).astype(np.float32)
    verts = np.stack([U, H, V], axis=-1).reshape(-1, 3)
    idx = np.arange(nx * nz).reshape(nz, nx)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, d, b], axis=1), np.stack([a, c, d], axis=1)], axis=0
    )
    uv = np.stack([(U + half_u) / (2 * half_u), (V + half_v) / (2 * half_v)], -1).reshape(-1, 2)
    return verts, faces, uv


def _transform(verts, scale=1.0, rot_x=0.0, rot_z=0.0, translate=(0, 0, 0)):
    v = verts * scale
    if rot_x:
        c, s = np.cos(rot_x), np.sin(rot_x)
        v = v @ np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float32).T
    if rot_z:
        c, s = np.cos(rot_z), np.sin(rot_z)
        v = v @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32).T
    return v + np.asarray(translate, np.float32)


def _column(rng, n_seg=96, n_ring=64):
    """One fluted column with torus capital: ~2*n_seg*n_ring + capital tris."""
    # shaft: radius modulated by flutes
    ys = np.linspace(0.0, HY - 1.2, n_seg, dtype=np.float32)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False, dtype=np.float32)
    TH, Y = np.meshgrid(th, ys)
    R = 0.55 * (1.0 + 0.05 * np.cos(12 * TH)) * (1.0 + 0.08 * (1 - Y / HY))
    X = R * np.cos(TH)
    Z = R * np.sin(TH)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    idx = np.arange(n_seg * n_ring).reshape(n_seg, n_ring)
    a = idx[:-1, :]
    b = np.roll(idx[:-1, :], -1, axis=1)
    c = idx[1:, :]
    d = np.roll(idx[1:, :], -1, axis=1)
    faces = np.concatenate(
        [np.stack([a.ravel(), b.ravel(), d.ravel()], 1),
         np.stack([a.ravel(), d.ravel(), c.ravel()], 1)], axis=0
    )
    # capital: squashed torus at the top
    tn, tm = 24, 48
    u = np.linspace(0, 2 * np.pi, tm, endpoint=False, dtype=np.float32)
    v = np.linspace(0, 2 * np.pi, tn, endpoint=False, dtype=np.float32)
    UU, VV = np.meshgrid(u, v)
    tr, sr = 0.62, 0.22
    TX = (tr + sr * np.cos(VV)) * np.cos(UU)
    TZ = (tr + sr * np.cos(VV)) * np.sin(UU)
    TY = 0.5 * sr * np.sin(VV) + (HY - 1.1)
    tverts = np.stack([TX, TY, TZ], -1).reshape(-1, 3)
    tidx = np.arange(tn * tm).reshape(tn, tm) + len(verts)
    ta = tidx
    tb = np.roll(tidx, -1, 1)
    tc = np.roll(tidx, -1, 0)
    td = np.roll(np.roll(tidx, -1, 0), -1, 1)
    tfaces = np.concatenate(
        [np.stack([ta.ravel(), tb.ravel(), td.ravel()], 1),
         np.stack([ta.ravel(), td.ravel(), tc.ravel()], 1)], axis=0
    )
    return np.concatenate([verts, tverts]), np.concatenate([faces, tfaces])


def _torus_knot(p=2, q=3, n_seg=400, n_ring=40, scale=0.9):
    t = np.linspace(0, 2 * np.pi, n_seg, endpoint=False, dtype=np.float32)
    r = 2.0 + np.cos(q * t)
    cx = r * np.cos(p * t)
    cy = np.sin(q * t) + 2.2
    cz = r * np.sin(p * t)
    center = np.stack([cx, cy, cz], -1) * scale
    # Frenet-ish frame
    d = np.roll(center, -1, 0) - center
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    up = np.array([0, 1, 0], np.float32)
    s = np.cross(d, up)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    m = np.cross(s, d)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False, dtype=np.float32)
    tube = 0.22 * scale
    verts = (
        center[:, None, :]
        + tube * (np.cos(th)[None, :, None] * s[:, None, :] + np.sin(th)[None, :, None] * m[:, None, :])
    ).reshape(-1, 3)
    idx = np.arange(n_seg * n_ring).reshape(n_seg, n_ring)
    a = idx
    b = np.roll(idx, -1, 1)
    c = np.roll(idx, -1, 0)
    d2 = np.roll(np.roll(idx, -1, 0), -1, 1)
    faces = np.concatenate(
        [np.stack([a.ravel(), b.ravel(), d2.ravel()], 1),
         np.stack([a.ravel(), d2.ravel(), c.ravel()], 1)], axis=0
    )
    return verts, faces


def _write_obj(path, mtl_file, parts):
    """parts: list of (material_name, verts, faces, uvs-or-None)."""
    with open(path, "w") as f:
        f.write(f"mtllib {mtl_file}\n")
        v_off = 1
        vt_off = 1
        chunks = []
        for mat, verts, faces, uvs in parts:
            for v in verts:
                f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
            if uvs is not None:
                for t in uvs:
                    f.write(f"vt {t[0]:.5f} {t[1]:.5f}\n")
            chunks.append((mat, faces, v_off, vt_off if uvs is not None else None))
            v_off += len(verts)
            if uvs is not None:
                vt_off += len(uvs)
        for mat, faces, vo, vto in chunks:
            f.write(f"usemtl {mat}\n")
            if vto is not None:
                for a, b, c in faces:
                    f.write(
                        f"f {a+vo}/{a+vto} {b+vo}/{b+vto} {c+vo}/{c+vto}\n"
                    )
            else:
                for a, b, c in faces:
                    f.write(f"f {a+vo} {b+vo} {c+vo}\n")


def ensure_interior(force: bool = False) -> str:
    """Generate the interior scene (idempotent); returns the JSON path."""
    json_path = os.path.join(BENCH_DIR, "interior.json")
    if os.path.exists(json_path) and not force:
        return json_path
    os.makedirs(BENCH_DIR, exist_ok=True)
    rng = np.random.default_rng(SEED)
    tex = _textures(rng)

    mtl_path = os.path.join(BENCH_DIR, "interior.mtl")
    with open(mtl_path, "w") as f:
        f.write(
            f"newmtl floor\nKd 0.8 0.8 0.8\nmap_Kd {tex['floor']}\n"
            f"newmtl plaster\nKd 0.85 0.82 0.78\nmap_Kd {tex['plaster']}\n"
            f"newmtl marble\nKd 0.9 0.9 0.9\nmap_Kd {tex['marble']}\n"
            "newmtl ceiling\nKd 0.7 0.72 0.75\n"
            "newmtl bronze\nKd 0.05 0.04 0.03\nKs 0.95 0.64 0.54\nNs 600\n"
            "newmtl wood\nKd 0.45 0.29 0.17\n"
        )

    rough = lambda U, V: (
        0.03 * np.sin(U * 2.3) * np.cos(V * 1.7)
        + 0.008 * rng.standard_normal(U.shape)
    )

    # floor + ceiling (~210k tris combined)
    fv, ff, fuv = _grid(230, 230, rough, HX, HZ)
    cv, cf, cuv = _grid(230, 230, lambda U, V: HY - rough(U, V), HX, HZ)
    cf = cf[:, ::-1]  # flip winding (normals down)
    _write_obj(
        os.path.join(BENCH_DIR, "shell_floor.obj"), "interior.mtl",
        [("floor", fv, ff, fuv)],
    )
    _write_obj(
        os.path.join(BENCH_DIR, "shell_ceiling.obj"), "interior.mtl",
        [("ceiling", cv, cf, cuv)],
    )

    # walls (~160k tris): two long + two short, displaced plaster.
    # _grid gives (u, h, v); re-map axes per wall so h is the inward offset.
    walls = []
    wv, wf, wuv = _grid(260, 60, rough, HZ, HY / 2)
    for side, x0 in enumerate((-HX, HX)):
        inward = -np.sign(x0)
        v = np.stack(
            [x0 + inward * wv[:, 1], wv[:, 2] + HY / 2, wv[:, 0]], -1
        ).astype(np.float32)
        walls.append(("plaster", v, wf if side == 0 else wf[:, ::-1], wuv))
    sv, sf, suv = _grid(120, 60, rough, HX, HY / 2)
    for side, z0 in enumerate((-HZ, HZ)):
        inward = -np.sign(z0)
        v = np.stack(
            [sv[:, 0], sv[:, 2] + HY / 2, z0 + inward * sv[:, 1]], -1
        ).astype(np.float32)
        walls.append(("plaster", v, sf if side == 1 else sf[:, ::-1], suv))
    _write_obj(os.path.join(BENCH_DIR, "shell_walls.obj"), "interior.mtl", walls)

    # columns (~530k tris): two rows of 14, baked into one mesh
    col_v, col_f = _column(rng)
    parts = []
    for i in range(14):
        z = -HZ + 3.0 + i * (2 * HZ - 6.0) / 13.0
        for x in (-HX + 3.0, HX - 3.0):
            parts.append(
                ("marble", _transform(col_v, translate=(x, 0.0, z)), col_f, None)
            )
    _write_obj(os.path.join(BENCH_DIR, "columns.obj"), "interior.mtl", parts)

    # centrepieces (~100k tris): three bronze torus knots down the aisle
    kv, kf = _torus_knot()
    kparts = [
        ("bronze", _transform(kv, translate=(0.0, 0.0, z)), kf, None)
        for z in (-18.0, 0.0, 18.0)
    ]
    _write_obj(os.path.join(BENCH_DIR, "knots.obj"), "interior.mtl", kparts)

    objects = [
        {"type": "mesh", "path": os.path.join(BENCH_DIR, "shell_floor.obj")},
        {"type": "mesh", "path": os.path.join(BENCH_DIR, "shell_ceiling.obj")},
        {"type": "mesh", "path": os.path.join(BENCH_DIR, "shell_walls.obj")},
        {"type": "mesh", "path": os.path.join(BENCH_DIR, "columns.obj")},
        {"type": "mesh", "path": os.path.join(BENCH_DIR, "knots.obj")},
        # analytic props
        {"type": "sphere", "radius": 1.1, "material": "chrome",
         "transform": {"translation": [-6.0, 1.1, -9.0]}},
        {"type": "box", "size": [0.9, 0.9, 0.9], "material": "glass",
         "transform": {"translation": [6.0, 0.95, 9.0]}},
    ]
    materials = [
        {"name": "chrome", "bsdf": "metal", "color": [0.95, 0.96, 0.97],
         "roughness": 0.08},
        {"name": "glass", "bsdf": "dielectric", "color": [1.0, 1.0, 1.0],
         "IoR": 1.5},
    ]
    lights = [
        {"type": "area", "color": [14.0, 13.0, 11.5],
         "transform": {"translation": [0.0, HY - 0.12, -12.0],
                       "orientation": [180.0, 0.0, 0.0]},
         "shape": {"type": "rect", "size": [3.2, 3.2]}},
        {"type": "area", "color": [14.0, 13.0, 11.5],
         "transform": {"translation": [0.0, HY - 0.12, 12.0],
                       "orientation": [180.0, 0.0, 0.0]},
         "shape": {"type": "rect", "size": [3.2, 3.2]}},
        {"type": "background", "color": [0.12, 0.14, 0.18]},
    ]
    scene = {
        "materials": materials,
        "objects": objects,
        "lights": lights,
        "camera": {
            "transform": {
                "translation": [0.0, 2.6, -HZ + 2.5],
                "orientation": [6.0, 0.0, 0.0],
            },
            "fieldOfView": 70.0,
        },
    }
    with open(json_path, "w") as f:
        json.dump(scene, f, indent=1)
    return json_path


if __name__ == "__main__":
    p = ensure_interior(force=True)
    import subprocess

    total = 0
    for fn in os.listdir(BENCH_DIR):
        if fn.endswith(".obj"):
            n = int(subprocess.run(["grep", "-c", "^f ", os.path.join(BENCH_DIR, fn)],
                                   capture_output=True, text=True).stdout.strip() or 0)
            print(f"{fn}: {n} tris")
            total += n
    print(f"total: {total} tris -> {p}")

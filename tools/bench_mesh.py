"""Deterministic bench-mesh scene shared by bench.py and the reference
harness (tools/ref_baseline/bench_scene.cpp).

Generates a wavy-heightfield surface mesh (the representative "Sponza-class"
geometry from tools/traversal_bench.py — NOT a random triangle soup, which
traversal_bench.py:26-29 itself flags as unrepresentative) and writes:

- ``bench_mesh.obj`` + ``bench_mesh.mtl`` (Kd 0.73 diffuse)
- ``bench_mesh.json`` — reference SceneLoader schema, loadable verbatim by
  BOTH `/root/reference` (Demo/SceneLoader.cpp) and our
  `raytracer_tpu.io.scene_loader` — geometry/material/light/camera parity by
  construction.

Everything is keyed by triangle count; files land in the checkout's
git-ignored ``build/scenes/``.
"""

from __future__ import annotations

import os

import numpy as np

BENCH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "scenes"
)
SEED = 7
SPREAD = 4.0


def make_mesh(t: int, rng=None):
    """Heightfield vertices/faces (same surface as traversal_bench.make_mesh)."""
    rng = rng or np.random.default_rng(SEED)
    g = max(2, int(np.sqrt(t / 2)) + 1)
    xs = np.linspace(-SPREAD, SPREAD, g, dtype=np.float32)
    zs = np.linspace(-SPREAD, SPREAD, g, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs)
    Y = (
        0.8 * np.sin(X * 1.7) * np.cos(Z * 1.3)
        + 0.3 * np.sin(X * 5.1 + Z * 3.7)
        + rng.normal(0, 0.02, X.shape)
    ).astype(np.float32)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    idx = np.arange(g * g).reshape(g, g)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    # wind counter-clockwise seen from above (+Y normals: the camera side)
    faces = np.concatenate(
        [np.stack([a, d, b], axis=1), np.stack([a, c, d], axis=1)], axis=0
    )
    return verts, faces


def ensure_scene(n_tris: int = 200_000) -> str:
    """Write obj/mtl/json (idempotent); returns the scene JSON path."""
    os.makedirs(BENCH_DIR, exist_ok=True)
    tag = f"{n_tris // 1000}k"
    obj_path = os.path.join(BENCH_DIR, f"bench_mesh_{tag}.obj")
    json_path = os.path.join(BENCH_DIR, f"bench_mesh_{tag}.json")
    mtl_path = os.path.join(BENCH_DIR, "bench_mesh.mtl")
    if not os.path.exists(mtl_path):
        with open(mtl_path, "w") as f:
            f.write("newmtl gray\nKd 0.73 0.73 0.73\nKs 0 0 0\n")
    if not os.path.exists(obj_path):
        verts, faces = make_mesh(n_tris)
        # smooth per-vertex normals (area-weighted face-normal accumulation)
        fn = np.cross(
            verts[faces[:, 1]] - verts[faces[:, 0]],
            verts[faces[:, 2]] - verts[faces[:, 0]],
        )
        vn = np.zeros_like(verts)
        for k in range(3):
            np.add.at(vn, faces[:, k], fn)
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        with open(obj_path, "w") as f:
            f.write("mtllib bench_mesh.mtl\n")
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for v in vn:
                f.write(f"vn {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            f.write("usemtl gray\n")
            for a, b, c in faces + 1:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
    if not os.path.exists(json_path):
        import json

        scene = {
            "materials": [],
            "objects": [
                {"type": "mesh", "path": obj_path}
            ],
            "lights": [
                {"type": "background", "color": [0.8, 0.9, 1.0]},
                {
                    "type": "directional",
                    "color": [4.0, 3.8, 3.5],
                    "angle": 0.5,
                    "transform": {"orientation": [50.0, 20.0, 0.0]},
                },
            ],
            "camera": {
                "transform": {
                    "translation": [0.0, 3.5, -7.5],
                    "orientation": [35.0, 0.0, 0.0],
                },
                "fieldOfView": 60.0,
            },
        }
        with open(json_path, "w") as f:
            json.dump(scene, f, indent=1)
    return json_path


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    print(ensure_scene(n))

"""Deterministic stand-in textures for reference TestScenes.

The reference Data/ ships without its TEXTURES directory; scenes like
texture_test.json reference TEXTURES/default.bmp.  This generates a
deterministic checkerboard-with-gradient BMP so BOTH renderers (the patched
reference build and ours) consume identical texels — golden parity by
construction, regenerated on demand (never committed binary).
"""

import os

import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from raytracer_tpu.io.bitmap import write_bmp  # noqa: E402


def default_bmp(path: str, size: int = 64):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    y, x = np.mgrid[0:size, 0:size]
    checker = ((x // 8 + y // 8) % 2).astype(np.float32)
    r = checker * 255
    g = (x / size) * 255
    b = (y / size) * 255
    img = np.stack([r, g, b], -1).astype(np.uint8)
    write_bmp(path, img)
    return path


def env_exr(path: str, w: int = 256, h: int = 128):
    """Small lat-long HDR environment: sky gradient + warm sun blob + dark
    ground — stands in for the unshipped 4K park EXR that
    material_env_test.json references."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    from raytracer_tpu.io.exr import write_exr

    v = (np.arange(h) + 0.5) / h  # 0 = up
    u = (np.arange(w) + 0.5) / w
    V, U = np.meshgrid(v, u, indexing="ij")
    sky_t = np.clip(1.0 - V * 2.0, 0.0, 1.0)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.25 + 0.9 * sky_t
    img[..., 1] = 0.35 + 0.8 * sky_t
    img[..., 2] = 0.55 + 0.7 * sky_t
    ground = V > 0.5
    img[ground] = np.array([0.18, 0.14, 0.10], np.float32)
    # sun: gaussian blob at (u=0.3, v=0.25)
    d2 = ((U - 0.3) * 2) ** 2 + ((V - 0.25) * 4) ** 2
    img += (40.0 * np.exp(-d2 / 0.002))[..., None] * np.array([1.0, 0.85, 0.6])
    write_exr(path, img)
    return path


def ensure(data_dir: str = "/tmp/refdata"):
    p = os.path.join(data_dir, "TEXTURES", "default.bmp")
    if not os.path.exists(p):
        default_bmp(p)
    e = os.path.join(
        data_dir, "TEXTURES", "ENV",
        "OutdoorCityParkingLotEveningClear_4K.exr",
    )
    if not os.path.exists(e):
        env_exr(e)
    return data_dir


if __name__ == "__main__":
    print(ensure(sys.argv[1] if len(sys.argv) > 1 else "/tmp/refdata"))

"""Texture evaluation — vectorized bitmap gathers + inline procedural kinds.

Re-expression of the reference texture stack:
- `BitmapTexture.cpp:57-80` — nearest / bilinear / bilinear-smoothstep over
  wrapped UVs; all bitmaps live in one packed atlas so a per-ray fetch is a
  single 2-D gather.
- `CheckerboardTexture.cpp:31-40` — (u>.5) xor (v>.5) color select.
- `NoiseTexture.cpp` — 2-D simplex-noise FBM (fresh jnp implementation of the
  standard simplex algorithm, vectorized over the wavefront).
- `MixTexture.h` — lerp(texA, texB, weightTex) with one level of nesting.

Textures with id INVALID_ID resolve to constant 1.0 (parameter modulation is
``constant * texture`` like `MaterialParameter.h:10-33`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..math.vec import Vec3
from ..scene.types import (
    INVALID_ID,
    TEX_BITMAP,
    TEX_CHECKERBOARD,
    TEX_CONST,
    TEX_MIX,
    TEX_NOISE,
    TextureAtlas,
)

FILTER_NEAREST = 0
FILTER_BILINEAR = 1
FILTER_BILINEAR_SMOOTHSTEP = 2

MAX_NOISE_OCTAVES = 8


class AtlasBuilder:
    """Host-side accumulation of textures into one TextureAtlas."""

    def __init__(self):
        self.images: list[np.ndarray] = []  # per-BITMAP image
        self.rows = []  # per-texture dict of metadata

    def add_bitmap(self, image: np.ndarray, filter_mode: int = FILTER_BILINEAR) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_BITMAP, image=len(self.images), filter=filter_mode))
        self.images.append(np.asarray(image, np.float32)[..., :3])
        return tid

    def add_checkerboard(self, color_a, color_b) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_CHECKERBOARD, ca=color_a, cb=color_b))
        return tid

    def add_noise(self, color_a, color_b, octaves: int = 1) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_NOISE, ca=color_a, cb=color_b, octaves=octaves))
        return tid

    def add_mix(self, tex_a: int, tex_b: int, tex_w: int) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_MIX, sa=tex_a, sb=tex_b, sw=tex_w))
        return tid

    def add_const(self, color) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_CONST, ca=color))
        return tid

    def build(self) -> TextureAtlas:
        rows = self.rows or [dict(kind=TEX_CONST, ca=(1.0, 1.0, 1.0))]
        images = self.images or [np.ones((1, 1, 3), np.float32)]
        w_atlas = max(im.shape[1] for im in images)
        total_rows = sum(im.shape[0] for im in images)
        data = np.zeros((total_rows, w_atlas, 3), np.float32)
        img_y0, img_h, img_w = [], [], []
        y = 0
        for im in images:
            h, w = im.shape[:2]
            data[y : y + h, :w] = im
            img_y0.append(y)
            img_h.append(h)
            img_w.append(w)
            y += h

        k = len(rows)
        y0 = np.zeros(k, np.int32)
        hh = np.ones(k, np.int32)
        ww = np.ones(k, np.int32)
        fm = np.full(k, FILTER_BILINEAR, np.int32)
        kind = np.zeros(k, np.int32)
        ca = np.ones((k, 3), np.float32)
        cb = np.zeros((k, 3), np.float32)
        octaves = np.ones(k, np.int32)
        sa = np.zeros(k, np.int32)
        sb = np.zeros(k, np.int32)
        sw = np.zeros(k, np.int32)
        for i, r in enumerate(rows):
            kind[i] = r["kind"]
            if r["kind"] == TEX_BITMAP:
                j = r["image"]
                y0[i], hh[i], ww[i], fm[i] = img_y0[j], img_h[j], img_w[j], r["filter"]
            if "ca" in r:
                ca[i] = r["ca"]
            if "cb" in r:
                cb[i] = r["cb"]
            if "octaves" in r:
                octaves[i] = min(r["octaves"], MAX_NOISE_OCTAVES)
            if r["kind"] == TEX_MIX:
                sa[i], sb[i], sw[i] = r["sa"], r["sb"], r["sw"]
        return TextureAtlas(
            data=jnp.asarray(data),
            y0=jnp.asarray(y0), height=jnp.asarray(hh), width=jnp.asarray(ww),
            filter_mode=jnp.asarray(fm),
            kind=jnp.asarray(kind),
            color_a=Vec3(jnp.asarray(ca[:, 0]), jnp.asarray(ca[:, 1]), jnp.asarray(ca[:, 2])),
            color_b=Vec3(jnp.asarray(cb[:, 0]), jnp.asarray(cb[:, 1]), jnp.asarray(cb[:, 2])),
            octaves=jnp.asarray(octaves),
            sub_a=jnp.asarray(sa), sub_b=jnp.asarray(sb), sub_w=jnp.asarray(sw),
        )


def build_atlas(images: list[np.ndarray], filter_modes: list[int] | None = None) -> TextureAtlas:
    """Bitmap-only convenience constructor."""
    b = AtlasBuilder()
    for i, im in enumerate(images):
        b.add_bitmap(im, (filter_modes or [FILTER_BILINEAR] * len(images))[i])
    return b.build()


# --- bitmap fetch --------------------------------------------------------------
def _fetch(atlas: TextureAtlas, y0, h, w, ix, iy) -> Vec3:
    ix = jnp.mod(ix, w)
    iy = jnp.mod(iy, h)
    texel = atlas.data[y0 + iy, ix]  # (N, 3) gather
    return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])


def _bitmap_eval(atlas: TextureAtlas, tid, u, v) -> Vec3:
    y0 = atlas.y0[tid]
    h = atlas.height[tid]
    w = atlas.width[tid]
    fmode = atlas.filter_mode[tid]
    uu = jnp.mod(u, 1.0) * w.astype(jnp.float32)
    vv = jnp.mod(v, 1.0) * h.astype(jnp.float32)
    n_ix = jnp.clip(uu.astype(jnp.int32), 0, w - 1)
    n_iy = jnp.clip(vv.astype(jnp.int32), 0, h - 1)
    # texel-CORNER convention, exactly as the reference: texel0 = floor(u*W),
    # texel1 = texel0+1 wrapped, weight = frac — no half-texel recentering
    # (`BitmapTexture.cpp:47-72`; a -0.5 center convention shifts the whole
    # texture half a texel and bleeds checker cells at tile seams)
    ix0 = jnp.clip(jnp.floor(uu).astype(jnp.int32), 0, w - 1)
    iy0 = jnp.clip(jnp.floor(vv).astype(jnp.int32), 0, h - 1)
    fu = uu - jnp.floor(uu)
    fv = vv - jnp.floor(vv)
    smooth = fmode == FILTER_BILINEAR_SMOOTHSTEP
    fu = jnp.where(smooth, fu * fu * (3.0 - 2.0 * fu), fu)
    fv = jnp.where(smooth, fv * fv * (3.0 - 2.0 * fv), fv)
    ix1 = jnp.where(ix0 + 1 >= w, 0, ix0 + 1)  # wrap secondary coords
    iy1 = jnp.where(iy0 + 1 >= h, 0, iy0 + 1)
    c00 = _fetch(atlas, y0, h, w, ix0, iy0)
    c10 = _fetch(atlas, y0, h, w, ix1, iy0)
    c01 = _fetch(atlas, y0, h, w, ix0, iy1)
    c11 = _fetch(atlas, y0, h, w, ix1, iy1)
    bil = (
        c00 * ((1.0 - fu) * (1.0 - fv))
        + c10 * (fu * (1.0 - fv))
        + c01 * ((1.0 - fu) * fv)
        + c11 * (fu * fv)
    )
    nearest = _fetch(atlas, y0, h, w, n_ix, n_iy)
    is_nearest = fmode == FILTER_NEAREST
    return Vec3(
        jnp.where(is_nearest, nearest.x, bil.x),
        jnp.where(is_nearest, nearest.y, bil.y),
        jnp.where(is_nearest, nearest.z, bil.z),
    )


# --- simplex noise (fresh vectorized implementation) ---------------------------
def _hash2(ix, iy):
    """Integer lattice hash -> gradient index (replaces the permutation table
    with an arithmetic hash — table-free is gather-free)."""
    h = ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343) + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0x9E3779B1)
    return (h >> jnp.uint32(24)).astype(jnp.int32)  # 8 bits


def _gradient_dot(hash8, x, y):
    """8 gradient directions, matching the reference's Gradient scheme
    (`NoiseTexture.cpp:33-39`)."""
    h = hash8 & 0x3F
    u = jnp.where(h < 4, x, y)
    v = jnp.where(h < 4, y, x)
    return jnp.where((h & 1) != 0, -u, u) + jnp.where((h & 2) != 0, -2.0 * v, 2.0 * v)


def _simplex2(x, y):
    """2-D simplex noise in [-1, 1], vectorized."""
    f2 = 0.366025403
    g2 = 0.211324865
    s = (x + y) * f2
    i = jnp.floor(x + s)
    j = jnp.floor(y + s)
    t = (i + j) * g2
    x0 = x - (i - t)
    y0 = y - (j - t)
    i1 = (x0 > y0).astype(jnp.float32)
    j1 = 1.0 - i1
    x1 = x0 - i1 + g2
    y1 = y0 - j1 + g2
    x2 = x0 - 1.0 + 2.0 * g2
    y2 = y0 - 1.0 + 2.0 * g2
    ii = i.astype(jnp.int32)
    jj = j.astype(jnp.int32)

    def corner(cx, cy, gi, gj):
        tt = 0.5 - cx * cx - cy * cy
        m = jnp.maximum(tt, 0.0)
        m2 = m * m
        return m2 * m2 * _gradient_dot(_hash2(gi, gj), cx, cy)

    n = (
        corner(x0, y0, ii, jj)
        + corner(x1, y1, ii + i1.astype(jnp.int32), jj + j1.astype(jnp.int32))
        + corner(x2, y2, ii + 1, jj + 1)
    )
    return 45.23065 * n  # normalization to ~[-1, 1]


def _noise_fbm(u, v, n_octaves):
    """FBM over simplex octaves; static MAX unroll, masked by per-ray count."""
    total = jnp.zeros_like(u)
    amp_sum = jnp.zeros_like(u)
    for o in range(MAX_NOISE_OCTAVES):
        active = (o < n_octaves).astype(jnp.float32)
        freq = float(2**o)
        amp = float(0.5**o)
        total = total + active * amp * _simplex2(u * freq, v * freq)
        amp_sum = amp_sum + active * amp
    val = 0.5 + 0.5 * total / jnp.maximum(amp_sum, 1e-6)
    return jnp.clip(val, 0.0, 1.0)


def _gv(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _eval_non_mix(atlas: TextureAtlas, tid, u, v) -> Vec3:
    """Evaluate one texture id per ray, excluding TEX_MIX recursion."""
    kind = atlas.kind[tid]
    bmp = _bitmap_eval(atlas, tid, u, v)
    ca = _gv(atlas.color_a, tid)
    cb = _gv(atlas.color_b, tid)
    # checkerboard: (u > .5) xor (v > .5) -> A else B (`CheckerboardTexture.cpp:31-40`)
    cu = jnp.mod(u, 1.0) > 0.5
    cv = jnp.mod(v, 1.0) > 0.5
    chk_a = cu ^ cv
    checker = Vec3(
        jnp.where(chk_a, ca.x, cb.x),
        jnp.where(chk_a, ca.y, cb.y),
        jnp.where(chk_a, ca.z, cb.z),
    )
    noise_w = _noise_fbm(u, v, atlas.octaves[tid])
    noise = ca * noise_w + cb * (1.0 - noise_w)

    out = bmp
    for k_, val in ((TEX_CHECKERBOARD, checker), (TEX_NOISE, noise), (TEX_CONST, ca)):
        m = kind == k_
        out = Vec3(
            jnp.where(m, val.x, out.x),
            jnp.where(m, val.y, out.y),
            jnp.where(m, val.z, out.z),
        )
    return out


def sample_texture_many(atlas: TextureAtlas, tex_ids, u, v) -> Vec3:
    """Per-ray texture sample over mixed kinds; INVALID_ID lanes get 1.0."""
    valid = tex_ids != INVALID_ID
    tid = jnp.maximum(tex_ids, 0)
    base = _eval_non_mix(atlas, tid, u, v)
    # one level of mix nesting (`MixTexture.h`)
    is_mix = atlas.kind[tid] == TEX_MIX
    va = _eval_non_mix(atlas, atlas.sub_a[tid], u, v)
    vb = _eval_non_mix(atlas, atlas.sub_b[tid], u, v)
    vw = _eval_non_mix(atlas, atlas.sub_w[tid], u, v)
    mixed = va + (vb - va) * vw.x
    out = Vec3(
        jnp.where(is_mix, mixed.x, base.x),
        jnp.where(is_mix, mixed.y, base.y),
        jnp.where(is_mix, mixed.z, base.z),
    )
    one = jnp.ones_like(out.x)
    return Vec3(
        jnp.where(valid, out.x, one),
        jnp.where(valid, out.y, one),
        jnp.where(valid, out.z, one),
    )

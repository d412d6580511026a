"""Packed GPU-style data formats, vectorized (`Core/Math/Packed.h:14-200`).

The reference compresses photons and buffers with packed encodings:
octahedron-mapped unit vectors in 4 bytes (`PackedUnitVector3`), shared/
YCoCg HDR color in 8 bytes (`PackedColorRgbHdr`), R11G11B10 floats, 5-6-5
color and fp16 (`Half.h`).  On an accelerator these matter for the device
memory footprint of photon maps and films; all codecs below are elementwise
jnp ops over whole arrays.

Error budgets are validated in tests/test_packed.py the same way the
reference's `MathPackedTest.cpp` sweeps values and asserts max error.
"""

from __future__ import annotations

import jax.numpy as jnp

from .vec import Vec3, dot


# --- octahedral unit vectors (PackedUnitVector3: 2x16-bit snorm) ---------------
def oct_encode(v: Vec3) -> jnp.ndarray:
    """Unit vector -> (N,) uint32 (16+16-bit octahedral snorm)."""
    norm = jnp.abs(v.x) + jnp.abs(v.y) + jnp.abs(v.z)
    inv = 1.0 / jnp.maximum(norm, 1e-20)
    px = v.x * inv
    py = v.y * inv
    # fold the lower hemisphere
    fx = (1.0 - jnp.abs(py)) * jnp.sign(jnp.where(px == 0.0, 1.0, px))
    fy = (1.0 - jnp.abs(px)) * jnp.sign(jnp.where(py == 0.0, 1.0, py))
    ox = jnp.where(v.z < 0.0, fx, px)
    oy = jnp.where(v.z < 0.0, fy, py)
    qx = jnp.round((ox * 0.5 + 0.5) * 65535.0).astype(jnp.uint32)
    qy = jnp.round((oy * 0.5 + 0.5) * 65535.0).astype(jnp.uint32)
    return qx | (qy << jnp.uint32(16))


def oct_decode(p: jnp.ndarray) -> Vec3:
    """(N,) uint32 -> unit Vec3."""
    qx = (p & jnp.uint32(0xFFFF)).astype(jnp.float32) / 65535.0 * 2.0 - 1.0
    qy = (p >> jnp.uint32(16)).astype(jnp.float32) / 65535.0 * 2.0 - 1.0
    z = 1.0 - jnp.abs(qx) - jnp.abs(qy)
    t = jnp.maximum(-z, 0.0)
    x = qx - jnp.sign(jnp.where(qx == 0.0, 1.0, qx)) * t
    y = qy - jnp.sign(jnp.where(qy == 0.0, 1.0, qy)) * t
    inv_len = 1.0 / jnp.sqrt(jnp.maximum(x * x + y * y + z * z, 1e-20))
    return Vec3(x * inv_len, y * inv_len, z * inv_len)


# --- fp16 (`Half.h`) -------------------------------------------------------------
def half_encode(x: jnp.ndarray) -> jnp.ndarray:
    """f32 -> uint16 bits (IEEE half). XLA-native cast, not bit twiddling."""
    return jnp.asarray(x, jnp.float16).view(jnp.uint16)


def half_decode(bits: jnp.ndarray) -> jnp.ndarray:
    return bits.view(jnp.float16).astype(jnp.float32)


# --- shared-exponent HDR RGB (RGBE, 4 bytes; the role of PackedColorRgbHdr) -----
def rgbe_encode(c: Vec3) -> jnp.ndarray:
    """HDR RGB -> (N,) uint32 RGBE (8-bit mantissas + shared 8-bit exponent)."""
    m = jnp.maximum(jnp.maximum(c.x, c.y), jnp.maximum(c.z, 1e-32))
    e = jnp.ceil(jnp.log2(m)).astype(jnp.int32)
    scale = jnp.exp2(-e.astype(jnp.float32)) * 255.0
    r = jnp.clip(jnp.round(c.x * scale), 0, 255).astype(jnp.uint32)
    g = jnp.clip(jnp.round(c.y * scale), 0, 255).astype(jnp.uint32)
    b = jnp.clip(jnp.round(c.z * scale), 0, 255).astype(jnp.uint32)
    eb = jnp.clip(e + 128, 0, 255).astype(jnp.uint32)
    zero = m <= 1e-30
    packed = r | (g << jnp.uint32(8)) | (b << jnp.uint32(16)) | (eb << jnp.uint32(24))
    return jnp.where(zero, jnp.uint32(0), packed)


def rgbe_decode(p: jnp.ndarray) -> Vec3:
    r = (p & jnp.uint32(0xFF)).astype(jnp.float32)
    g = ((p >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.float32)
    b = ((p >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.float32)
    eb = (p >> jnp.uint32(24)).astype(jnp.int32)
    scale = jnp.exp2((eb - 128).astype(jnp.float32)) / 255.0
    scale = jnp.where(p == 0, 0.0, scale)
    return Vec3(r * scale, g * scale, b * scale)


# --- YCoCg <-> RGB (`Packed.h` PackedColorRgbHdr uses YCoCg) --------------------
def rgb_to_ycocg(c: Vec3) -> Vec3:
    y = 0.25 * c.x + 0.5 * c.y + 0.25 * c.z
    co = 0.5 * c.x - 0.5 * c.z
    cg = -0.25 * c.x + 0.5 * c.y - 0.25 * c.z
    return Vec3(y, co, cg)


def ycocg_to_rgb(c: Vec3) -> Vec3:
    tmp = c.x - c.z
    return Vec3(tmp + c.y, c.x + c.z, tmp - c.y)


# --- R11G11B10 float (`Packed.h` PackedFloat3) -----------------------------------
def _to_small_float(x: jnp.ndarray, mant_bits: int) -> jnp.ndarray:
    """f32 -> unsigned small float with 5-bit exponent, ``mant_bits`` mantissa."""
    x = jnp.maximum(x, 0.0)
    bits = jnp.asarray(x, jnp.float32).view(jnp.uint32)
    exp = ((bits >> jnp.uint32(23)) & jnp.uint32(0xFF)).astype(jnp.int32) - 127
    mant = (bits >> jnp.uint32(23 - mant_bits)) & jnp.uint32((1 << mant_bits) - 1)
    out = ((jnp.clip(exp, -14, 15) + 15).astype(jnp.uint32) << jnp.uint32(mant_bits)) | mant
    # below the smallest normal (2^-14): flush to zero rather than clamp up
    return jnp.where((x <= 0.0) | (exp < -14), jnp.uint32(0), out)


def _from_small_float(p: jnp.ndarray, mant_bits: int) -> jnp.ndarray:
    exp = (p >> jnp.uint32(mant_bits)).astype(jnp.int32) - 15
    mant = (p & jnp.uint32((1 << mant_bits) - 1)).astype(jnp.float32)
    val = (1.0 + mant / (1 << mant_bits)) * jnp.exp2(exp.astype(jnp.float32))
    return jnp.where(p == 0, 0.0, val)


def r11g11b10_encode(c: Vec3) -> jnp.ndarray:
    r = _to_small_float(c.x, 6)
    g = _to_small_float(c.y, 6)
    b = _to_small_float(c.z, 5)
    return r | (g << jnp.uint32(11)) | (b << jnp.uint32(22))


def r11g11b10_decode(p: jnp.ndarray) -> Vec3:
    r = _from_small_float(p & jnp.uint32(0x7FF), 6)
    g = _from_small_float((p >> jnp.uint32(11)) & jnp.uint32(0x7FF), 6)
    b = _from_small_float(p >> jnp.uint32(22), 5)
    return Vec3(r, g, b)

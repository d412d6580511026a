"""Structure-of-arrays 3-vector math for wavefront kernels.

The reference renderer carries rays in AVX registers, one float per SIMD lane
(``Core/Math/Vector8.h``, ``Core/Math/Vector3x8.h``).  The wavefront analogue
is a structure-of-arrays vector: three independent ``(N, ...)`` arrays, one per
component, so every arithmetic op is a full-width elementwise op over the ray
batch and no layout pads a trailing dim of 3.

All functions are shape-polymorphic: components may be any broadcast-compatible
shape (scalars included), and everything works under ``jit``/``vmap``/``grad``.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class Vec3(NamedTuple):
    """SoA 3-vector: three same-shaped arrays (or scalars).

    Replacement for the reference's ``Vector4``/``Vector3x8``
    (`Core/Math/Vector4.h`, `Core/Math/Vector3x8.h`).
    """

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # --- construction helpers -------------------------------------------------
    @staticmethod
    def full(v: Scalar) -> "Vec3":
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape=(), dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return Vec3(z, z, z)

    @staticmethod
    def ones(shape=(), dtype=jnp.float32) -> "Vec3":
        o = jnp.ones(shape, dtype)
        return Vec3(o, o, o)

    @staticmethod
    def from_array(a) -> "Vec3":
        """Build from an array whose last axis is 3."""
        a = jnp.asarray(a)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jnp.ndarray:
        """Stack into an array with trailing axis 3 (host/IO use only)."""
        return jnp.stack(jnp.broadcast_arrays(self.x, self.y, self.z), axis=-1)

    # --- arithmetic -----------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_sq(a: Vec3) -> jnp.ndarray:
    return dot(a, a)


def length(a: Vec3) -> jnp.ndarray:
    return jnp.sqrt(length_sq(a))


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    """Normalize; with eps > 0 guards against zero-length vectors."""
    inv = jnp.where if eps else None
    n2 = length_sq(a)
    if eps:
        n2 = jnp.maximum(n2, eps)
    del inv
    r = jnp.sqrt(n2)
    return Vec3(a.x / r, a.y / r, a.z / r)


def rsqrt_normalize(a: Vec3) -> Vec3:
    """Normalize via rsqrt (mirrors FastNormalize3 in the reference)."""
    import jax

    inv = jax.lax.rsqrt(length_sq(a))
    return a * inv


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Reflect direction ``i`` (pointing *into* the surface) about normal ``n``.

    Matches ``Vector4::Reflect3`` semantics (`Core/Math/Vector4.h`):
    ``r = i - 2*dot(i, n)*n``.
    """
    return i - n * (2.0 * dot(i, n))


def refract(i: Vec3, n: Vec3, eta: jnp.ndarray) -> Vec3:
    """Refract ``i`` (pointing into the surface) through normal ``n``.

    Matches ``Vector4::Refract3`` (`Core/Math/Vector4.cpp`): ``eta`` is the
    *material IoR* (n_inside / n_outside); the ratio is flipped automatically
    based on which side the ray comes from. Returns the (normalized)
    transmitted direction. On total internal reflection the result is invalid
    (caller must gate on the Fresnel term as the reference BSDFs do).
    """
    cosi = dot(i, n)
    # when ray enters from outside, cosi < 0; eta is n1/n2 as passed for the
    # outside->inside case and must be inverted when exiting.
    eta_eff = jnp.where(cosi > 0.0, eta, 1.0 / eta)
    n_eff = Vec3(
        jnp.where(cosi > 0.0, -n.x, n.x),
        jnp.where(cosi > 0.0, -n.y, n.y),
        jnp.where(cosi > 0.0, -n.z, n.z),
    )
    c = jnp.abs(cosi)
    # 1e-12 floor keeps sqrt differentiable at the TIR boundary (AD-safe)
    k = jnp.maximum(1e-12, 1.0 - eta_eff * eta_eff * (1.0 - c * c))
    t = i * eta_eff + n_eff * (eta_eff * c - jnp.sqrt(k))
    return normalize(t, eps=1e-20)


def where(mask: jnp.ndarray, a: Vec3, b: Vec3) -> Vec3:
    """Lane select — analogue of ``Vector4::Select``."""
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y), jnp.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z))


def vabs(a: Vec3) -> Vec3:
    return Vec3(jnp.abs(a.x), jnp.abs(a.y), jnp.abs(a.z))


def max_component(a: Vec3) -> jnp.ndarray:
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def min_component(a: Vec3) -> jnp.ndarray:
    return jnp.minimum(a.x, jnp.minimum(a.y, a.z))


def is_finite(a: Vec3) -> jnp.ndarray:
    return jnp.isfinite(a.x) & jnp.isfinite(a.y) & jnp.isfinite(a.z)

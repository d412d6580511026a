"""Deterministic counter-based sample streams.

The reference uses a stateful per-thread xoroshiro RNG plus a per-frame Halton
vector with per-pixel scrambling (`Core/Sampling/HaltonSampler.*`,
`Core/Sampling/GenericSampler.cpp:83-112`).  Stateful RNGs don't map to traced
SPMD programs, so this design is *counter-based*: every sample is a
pure hash of (pixel_id, pass, dimension), giving bit-reproducible renders for a
given seed regardless of device count or tiling — the property the reference
gets from per-thread streams, but stronger.

Two stream kinds, matching the reference's SamplingParams (`Context.h:44-56`):

- ``uniform``: PCG-style hash of (pixel, pass, dim) -> iid uniforms.
- ``halton`` (low-discrepancy): per-pass global Halton value in dimension d,
  Cranley-Patterson rotated by a per-(pixel, dim) hash — the exact structure of
  the reference's GenericSampler (frame-global Halton + pixel salt).

Streams are pytrees; ``next_1d``/``next_2d``/``next_3d`` are pure and advance a
traced dimension counter, so they thread through ``lax`` loops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

MAX_DIMS = 64  # matches RenderingParams::samplingParams.dimensions default


# --- integer hashing (uint32, VPU-friendly) -----------------------------------
def _u32(x):
    return jnp.asarray(x, jnp.uint32)


def hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """PCG output-function style finalizer; good avalanche, 6 int ops."""
    x = _u32(x)
    x = x * _u32(747796405) + _u32(2891336453)
    word = ((x >> ((x >> _u32(28)) + _u32(4))) ^ x) * _u32(277803737)
    return (word >> _u32(22)) ^ word


def hash_combine(a, b) -> jnp.ndarray:
    return hash_u32(_u32(a) ^ (_u32(b) * _u32(0x9E3779B9)))


def u32_to_unit_float(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 in [0, 1)."""
    # take the top 24 bits so the float mantissa is fully random
    return (x >> _u32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


# --- Halton (host-side per-pass vector) ---------------------------------------
_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
    239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
]


def radical_inverse(index: int, base: int) -> float:
    """Van der Corput radical inverse of ``index`` in ``base``."""
    inv_base = 1.0 / base
    reversed_digits = 0
    inv_base_n = 1.0
    while index:
        next_index = index // base
        digit = index - next_index * base
        reversed_digits = reversed_digits * base + digit
        inv_base_n *= inv_base
        index = next_index
    return min(reversed_digits * inv_base_n, 1.0 - 1e-7)


def halton_frame_vector(sample_index: int, n_dims: int = MAX_DIMS) -> np.ndarray:
    """Per-pass global Halton point (one value per dimension)."""
    return np.array(
        [radical_inverse(sample_index + 1, _PRIMES[d % len(_PRIMES)]) for d in range(n_dims)],
        dtype=np.float32,
    )


# --- blue noise ----------------------------------------------------------------
BLUE_NOISE_SIZE = 128
BLUE_NOISE_LAYERS = 4
_blue_noise_cache: Optional[np.ndarray] = None


def blue_noise_table() -> np.ndarray:
    """(128, 128, 4) float32 in [0,1): the void-and-cluster dither table.

    Plays the role of the reference's `Data/BlueNoise128_RGBA16.dat`
    (`GenericSampler.cpp:10-54`) but is *generated* (tools/gen_bluenoise.py),
    not copied."""
    global _blue_noise_cache
    if _blue_noise_cache is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "bluenoise128.npy")
        _blue_noise_cache = (np.load(path).astype(np.float32) + 0.5) / 65536.0
    return _blue_noise_cache


def blue_noise_for_pixels(pixel_ids: jnp.ndarray, width: int) -> jnp.ndarray:
    """Gather each pixel's 4 blue-noise rotation values, tiled mod 128
    (`GenericSampler.cpp:83-98`). Returns (N, 4) float32."""
    table = jnp.asarray(blue_noise_table())
    px = jnp.mod(pixel_ids % width, BLUE_NOISE_SIZE)
    py = jnp.mod(pixel_ids // width, BLUE_NOISE_SIZE)
    return table[py, px]  # (N, 4)


# --- stream -------------------------------------------------------------------
class SampleStream(NamedTuple):
    """Per-ray sample stream state (a pytree; threads through lax loops)."""

    pixel_hash: jnp.ndarray  # (N,) uint32, hash of pixel id + seed
    pass_salt: jnp.ndarray  # scalar uint32
    dim: jnp.ndarray  # scalar int32, next dimension to consume
    halton: Optional[jnp.ndarray]  # (MAX_DIMS,) f32 per-pass Halton vector, or None
    blue: Optional[jnp.ndarray]  # (N, 4) f32 per-pixel blue-noise rotations, or None


def make_stream(
    pixel_ids: jnp.ndarray,
    pass_index: jnp.ndarray,
    seed: int = 0,
    halton: Optional[jnp.ndarray] = None,
    blue: Optional[jnp.ndarray] = None,
) -> SampleStream:
    ph = hash_combine(_u32(pixel_ids), _u32(seed & 0xFFFFFFFF))
    salt = hash_u32(_u32(pass_index) ^ _u32((seed * 0x85EBCA6B) & 0xFFFFFFFF))
    return SampleStream(ph, salt, jnp.int32(0), halton, blue)


def next_1d(s: SampleStream) -> tuple[jnp.ndarray, SampleStream]:
    d = _u32(s.dim)
    bits = hash_u32(s.pixel_hash ^ hash_combine(d, s.pass_salt))
    if s.halton is not None:
        # low-discrepancy: global Halton value rotated per pixel — blue-noise
        # rotation for the first 4 dims (screen-space blue error distribution,
        # `GenericSampler.cpp:83-112`), hash rotation beyond
        rot_bits = hash_u32(s.pixel_hash ^ hash_combine(d, _u32(0xB5297A4D)))
        rot = u32_to_unit_float(rot_bits)
        if s.blue is not None:
            blue_rot = s.blue[:, jnp.minimum(s.dim, BLUE_NOISE_LAYERS - 1)]
            rot = jnp.where(s.dim < BLUE_NOISE_LAYERS, blue_rot, rot)
        base = s.halton[jnp.minimum(s.dim, MAX_DIMS - 1)]
        in_range = s.dim < MAX_DIMS
        u = jnp.where(
            in_range,
            jnp.mod(base + rot, 1.0),
            u32_to_unit_float(bits),
        )
    else:
        u = u32_to_unit_float(bits)
    return u, s._replace(dim=s.dim + 1)


def next_2d(s: SampleStream):
    u1, s = next_1d(s)
    u2, s = next_1d(s)
    return u1, u2, s


def next_3d(s: SampleStream):
    u1, s = next_1d(s)
    u2, s = next_1d(s)
    u3, s = next_1d(s)
    return u1, u2, u3, s

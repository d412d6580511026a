"""Color space conversions and tonemapping, vectorized.

Re-expression of ``Core/Color/ColorHelpers.h``: sRGB <-> linear, the four
tonemappers (Clamped / Reinhard / Hejl-Burgess-Dawson / ACES) and HSV -> RGB.
Operates on plain arrays (any shape) or per-channel SoA.
"""

from __future__ import annotations

import jax.numpy as jnp

TONEMAP_CLAMPED = 0
TONEMAP_REINHARD = 1
TONEMAP_HEJL = 2
TONEMAP_ACES = 3

TONEMAPPER_NAMES = {
    "clamped": TONEMAP_CLAMPED,
    "reinhard": TONEMAP_REINHARD,
    "hejl": TONEMAP_HEJL,
    "aces": TONEMAP_ACES,
}


def linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    """Exact sRGB OETF (the reference uses a polynomial fit; we use exact)."""
    c = jnp.clip(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(c, 1e-7), 1.0 / 2.4) - 0.055
    return jnp.where(c <= 0.0031308, lo, hi)


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    c = jnp.clip(c, 0.0, 1.0)
    lo = c / 12.92
    hi = jnp.power((c + 0.055) / 1.055, 2.4)
    return jnp.where(c <= 0.04045, lo, hi)


def tonemap(color: jnp.ndarray, tonemapper: int = TONEMAP_ACES) -> jnp.ndarray:
    """Apply tonemapping curve; matches `ColorHelpers.h:85-131`."""
    color = jnp.maximum(color, 0.0)
    if tonemapper == TONEMAP_CLAMPED:
        return linear_to_srgb(color)
    if tonemapper == TONEMAP_REINHARD:
        return linear_to_srgb(color / (1.0 + color))
    if tonemapper == TONEMAP_HEJL:
        t0 = color * (color * 6.2 + 0.5)
        t2 = color * (color * 6.2 + 1.7) + 0.06
        return t0 / jnp.maximum(t2, 1e-20)  # note: curve embeds gamma
    if tonemapper == TONEMAP_ACES:
        t0 = color * (color * 2.51 + 0.03)
        t2 = color * (color * 2.43 + 0.59) + 0.14
        return linear_to_srgb(t0 / jnp.maximum(t2, 1e-20))
    raise ValueError(f"invalid tonemapper {tonemapper}")


def luminance(r, g, b):
    """Rec.709 luma (used by saturation adjustment in `Viewport.cpp:492-550`)."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def hsv_to_rgb(h, s, v):
    """HSV -> linear RGB (`ColorHelpers.h` HSVtoRGB)."""
    h = jnp.mod(h, 1.0) * 6.0
    i = jnp.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, v, v, q])
    return r, g, b

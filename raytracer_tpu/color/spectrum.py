"""Spectral rendering support: wavelength sampling + CIE -> RGB resolve.

Re-expression of the reference's spectral mode (`RT_ENABLE_SPECTRAL_
RENDERING`, `Core/Color/Wavelength.{h,cpp}`, `Core/Color/RayColor.h:148-160`):
the reference carries 8 hero-rotated wavelengths per path and collapses to a
single wavelength at a dispersive event (`RoughDielectricBSDF.cpp:29-44`).

Here each path samples one wavelength; paths that never disperse keep full
RGB throughput (weight 1 — equivalent to carrying the whole spectrum), and a
dispersive event multiplies the throughput once by ``rgb_resolve(lambda)`` —
the normalized CIE response that converts "this path now carries radiance at
a single wavelength sampled uniformly from [LO, HI]" into RGB.  E[resolve]
over the wavelength range is (1,1,1), so white stays white and furnace tests
hold in spectral mode.

CIE 1931 color matching uses Wyman/Sloan/Shirley's multi-lobe Gaussian fits
(public analytic approximation, max error < 1%), not tabulated data.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# sampled wavelength range, nm (covers the visible band the CIE fits model)
WAVELENGTH_LO = 380.0
WAVELENGTH_HI = 730.0


def _g(x, alpha, mu, s1, s2):
    """Piecewise Gaussian used by the Wyman et al. 2013 xyz fits."""
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * jnp.exp(-0.5 * t * t)


def cie_xyz(lam):
    """CIE 1931 2-deg color matching functions at wavelength ``lam`` (nm)."""
    x = (
        _g(lam, 1.056, 599.8, 37.9, 31.0)
        + _g(lam, 0.362, 442.0, 16.0, 26.7)
        + _g(lam, -0.065, 501.1, 20.4, 26.2)
    )
    y = _g(lam, 0.821, 568.8, 46.9, 40.5) + _g(lam, 0.286, 530.9, 16.3, 31.1)
    z = _g(lam, 1.217, 437.0, 11.8, 36.0) + _g(lam, 0.681, 459.0, 26.0, 13.8)
    return x, y, z


# XYZ -> linear sRGB (same matrix as `ColorHelpers.h:46-60` ConvertXYZtoRGB)
_XYZ_TO_RGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)

# per-channel normalization so a uniformly sampled wavelength resolves to
# E[rgb] = (1,1,1): computed once from a dense quadrature of the fits
_norm_cache: np.ndarray | None = None


def _channel_norm() -> np.ndarray:
    global _norm_cache
    if _norm_cache is None:
        # pure NumPy: this may first run inside a jit trace, where jnp ops
        # would be staged into the trace (omnistaging) and not concretizable
        def g(x, alpha, mu, s1, s2):
            s = np.where(x < mu, s1, s2)
            return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)

        lam = np.linspace(WAVELENGTH_LO, WAVELENGTH_HI, 2048)
        x = (g(lam, 1.056, 599.8, 37.9, 31.0) + g(lam, 0.362, 442.0, 16.0, 26.7)
             + g(lam, -0.065, 501.1, 20.4, 26.2))
        y = g(lam, 0.821, 568.8, 46.9, 40.5) + g(lam, 0.286, 530.9, 16.3, 31.1)
        z = g(lam, 1.217, 437.0, 11.8, 36.0) + g(lam, 0.681, 459.0, 26.0, 13.8)
        xyz_mean = np.stack([x.mean(), y.mean(), z.mean()])
        _norm_cache = _XYZ_TO_RGB @ xyz_mean  # mean RGB response
    return _norm_cache


def rgb_resolve(lam) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RGB weight for radiance carried at a single wavelength ``lam`` (nm),
    sampled uniformly in [LO, HI].  Mean over the range is (1,1,1)."""
    x, y, z = cie_xyz(lam)
    norm = _channel_norm()
    m = _XYZ_TO_RGB
    r = (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z) / norm[0]
    g = (m[1, 0] * x + m[1, 1] * y + m[1, 2] * z) / norm[1]
    b = (m[2, 0] * x + m[2, 1] * y + m[2, 2] * z) / norm[2]
    return r, g, b


def sample_wavelength(u):
    """Uniform hero wavelength in [LO, HI] from one unit sample
    (`Wavelength::Randomize`, `Wavelength.cpp:10-21`)."""
    return WAVELENGTH_LO + u * (WAVELENGTH_HI - WAVELENGTH_LO)


# strata of the hero rotation — the reference carries this many rotated
# wavelengths per RayColor (`Wavelength.h:15-23` NumComponents = 8)
NUM_STRATA = 8


def sample_wavelength_stratified(u, pass_idx):
    """Hero wavelength stratified over ``NUM_STRATA`` bins by pass index.

    The reference evaluates 8 wavelengths rotated from one sample per path
    (`Wavelength.cpp:10-21`); our paths carry exact RGB until the first
    dispersive event, which already equals the 8-rotation estimator there.
    What remains is the post-collapse chroma noise: cycling the hero's
    stratum with the pass index makes any 8 consecutive passes cover the
    spectrum exactly once per pixel — same equal-pass variance reduction,
    wavefront-friendly."""
    j = (pass_idx % NUM_STRATA).astype(jnp.float32)
    return WAVELENGTH_LO + ((j + u) / NUM_STRATA) * (WAVELENGTH_HI - WAVELENGTH_LO)


def cauchy_ior(n_d, abbe, lam):
    """Wavelength-dependent index of refraction via Cauchy's equation,
    parameterized by d-line IoR and Abbe number (the practical form of the
    reference's Sellmeier/Cauchy material params, `Material.h:60-66`).

    n(lambda) = A + B / lambda_um^2, with A, B chosen so n(587.6nm) = n_d and
    the Abbe number V = (n_d - 1)/(n_F - n_C) matches (F=486.1nm, C=656.3nm).
    """
    lam_um = lam * 1e-3
    inv_f2 = 1.0 / (0.4861344**2)
    inv_c2 = 1.0 / (0.6562725**2)
    b = (n_d - 1.0) / (jnp.maximum(abbe, 1e-3) * (inv_f2 - inv_c2))
    a = n_d - b / (0.5875618**2)
    return a + b / jnp.maximum(lam_um * lam_um, 1e-6)

"""BSDF / Fresnel / microfacet tests: white-furnace energy checks, pdf
consistency via Monte-Carlo integration, and sample/evaluate agreement.

Model: the reference validates shading end-to-end through furnace scenes
(`Tests/RaytracingTests.cpp:317-523`); here we additionally unit-test the
lobes directly, which the reference does not — stronger coverage at the layer
where wavefront-specific (branchless/masked) bugs would hide."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer_tpu.math.fresnel import fresnel_dielectric, fresnel_metal
from raytracer_tpu.math.microfacet import ggx_d, ggx_g1, ggx_pdf, ggx_sample
from raytracer_tpu.math.vec import Vec3, dot
from raytracer_tpu.ops import bsdf as bsdf_ops
from raytracer_tpu.ops.bsdf import MatParams
from raytracer_tpu.scene import types as T

N = 1 << 14


def _mat(kind, base=(0.8, 0.8, 0.8), roughness=0.5, ior=1.5, k=4.0, n=N):
    o = jnp.ones((n,), jnp.float32)
    return MatParams(
        bsdf=jnp.full((n,), kind, jnp.int32),
        base_color=Vec3(base[0] * o, base[1] * o, base[2] * o),
        emission=Vec3.zeros((n,)),
        roughness=roughness * o,
        metalness=0.0 * o,
        ior=ior * o,
        k=k * o,
    )


def _uniforms(seed, n=N):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.random(n, dtype=np.float32)) for _ in range(3))


def _wo(theta_deg, n=N):
    t = np.deg2rad(theta_deg)
    z = jnp.full((n,), np.cos(t), jnp.float32)
    x = jnp.full((n,), np.sin(t), jnp.float32)
    return Vec3(x, jnp.zeros((n,), jnp.float32), z)


class TestFresnel:
    def test_dielectric_normal_incidence(self):
        # the reference formula (`Utils.cpp:9-29`, replicated bug-for-bug for
        # golden-image agreement) yields F = 0 at normal incidence instead of
        # the physical R0 = 0.04 — see math/fresnel.py docstring
        f = fresnel_dielectric(jnp.float32(1.0), jnp.float32(1.5))
        np.testing.assert_allclose(float(f), 0.0, atol=1e-6)

    def test_dielectric_matches_reference_table(self):
        """Values computed by a literal float64 port of `Utils.cpp:9-29`."""
        cases = [  # (n_dot_v, expected F) for ior=1.5
            (0.9, 0.000660), (0.7, 0.006507), (0.5, 0.031414),
            (0.3, 0.131089), (0.1, 0.507744),
        ]
        for c, expect in cases:
            f = float(fresnel_dielectric(jnp.float32(c), jnp.float32(1.5)))
            np.testing.assert_allclose(f, expect, rtol=1e-3)

    def test_dielectric_grazing(self):
        f = fresnel_dielectric(jnp.float32(0.001), jnp.float32(1.5))
        assert float(f) > 0.98

    def test_no_spurious_tir_entering(self):
        """Regression: entering a denser medium NEVER totally reflects.  A
        previous eta-flip inversion returned F = 1 for all n_dot_v < ~0.745
        from outside, silently absorbing most off-normal dielectric/plastic
        energy (materials_test.json was ~2.3x dark)."""
        c = jnp.linspace(0.01, 1.0, 128)
        f = np.asarray(fresnel_dielectric(c, jnp.float32(1.5)))
        assert (f < 1.0).all()

    def test_total_internal_reflection(self):
        # exiting at > critical angle (sin_c = 1/1.5 -> cos_c ~ 0.745);
        # n_dot_v < 0 = ray arrives from INSIDE the medium
        f = fresnel_dielectric(jnp.float32(-0.3), jnp.float32(1.5))
        assert float(f) == 1.0
        # below the critical angle light does escape
        f2 = fresnel_dielectric(jnp.float32(-0.9), jnp.float32(1.5))
        assert float(f2) < 1.0

    def test_metal_reflectance_range(self):
        c = jnp.linspace(0.01, 1.0, 64)
        f = fresnel_metal(c, jnp.float32(0.2), jnp.float32(4.0))
        fn = np.asarray(f)
        assert (fn > 0.8).all() and (fn <= 1.0 + 1e-6).all()


class TestGGX:
    @staticmethod
    def _quad_z(f, n=2_000_000):
        """Deterministic quadrature of ∫₀¹ f(z) dz in float64 (peaked NDFs
        need this — MC over a uniform hemisphere has hopeless variance)."""
        z = (np.arange(n, dtype=np.float64) + 0.5) / n
        return float(np.mean(f(z)))

    def test_d_integrates_to_one(self):
        """∫ D(m) cos(m) dm = 2π ∫₀¹ D(z)·z dz = 1 (NDF normalization)."""
        inv_pi = 1.0 / np.pi

        def d64(a2, z):  # float64 copy of ggx_d for tight quadrature
            c2 = z * z
            t2 = (1 - c2) / np.maximum(c2, 1e-300)
            return a2 * inv_pi / np.maximum((c2 * c2) * (a2 + t2) ** 2, 1e-300)

        for alpha in (0.1, 0.3, 0.7):
            a2 = alpha**4  # alpha_sq convention = (roughness^2)^2
            val = 2 * np.pi * self._quad_z(lambda z: d64(a2, z) * z)
            np.testing.assert_allclose(val, 1.0, rtol=5e-3)

    def test_sample_matches_pdf(self):
        """E[m.z] of NDF-sampled normals must match ∫ z·(2π D(z) z) dz."""
        u1, u2, _ = _uniforms(1)
        alpha = 0.5
        a2 = jnp.float32(alpha**4)
        m = ggx_sample(a2, u1, u2)
        got = float(jnp.mean(m.z))
        pdf_z = lambda z: np.asarray(2 * np.pi * ggx_pdf(float(a2), jnp.asarray(z, jnp.float64)))
        expect = self._quad_z(lambda z: z * pdf_z(z), n=200_000)
        np.testing.assert_allclose(got, expect, rtol=0.02)

    def test_g1_bounds(self):
        c = jnp.linspace(0.05, 1.0, 64)
        g = np.asarray(ggx_g1(jnp.float32(0.25), c))
        assert (g > 0).all() and (g <= 1.0 + 1e-6).all()

    def test_tiny_roughness_finite(self):
        """Regression: at roughness 0.01 (alpha_sq = 1e-8, below f32 eps) the
        textbook groupings cancel catastrophically — D(m.z=1) returned inf and
        sample weights went inf/inf = nan (materials_test.json glass_0)."""
        u1, u2, _ = _uniforms(0)
        for rough in (0.01, 0.006, 0.02):
            a2 = jnp.float32(rough**4)
            m = ggx_sample(a2, u1, u2)
            d = ggx_d(a2, m.z)
            p = ggx_pdf(a2, m.z)
            assert np.isfinite(np.asarray(d)).all(), rough
            assert np.isfinite(np.asarray(p)).all(), rough
            # the sampled lobe must not collapse to an exact delta: the
            # angular spread is ~alpha = rough^2
            sin2 = np.asarray(m.x**2 + m.y**2)
            assert sin2.max() > 0.1 * rough**4

    def test_tiny_roughness_sample_weight_finite(self):
        from raytracer_tpu.ops.bsdf import MatParams, sample
        from raytracer_tpu.scene.types import BSDF_ROUGH_DIELECTRIC

        n = 256
        rng = np.random.default_rng(3)
        u1, u2, u3 = (jnp.asarray(rng.random(n, np.float32)) for _ in range(3))
        wo = Vec3(jnp.full(n, 0.3), jnp.full(n, 0.1), jnp.full(n, 0.946))
        mp = MatParams(
            bsdf=jnp.full(n, BSDF_ROUGH_DIELECTRIC, jnp.int32),
            base_color=Vec3.ones(n), emission=Vec3.zeros(n),
            roughness=jnp.full(n, 0.01), metalness=jnp.zeros(n),
            ior=jnp.full(n, 1.5), k=jnp.zeros(n),
        )
        s = sample(mp, wo, u1, u2, u3)
        for arr in (s.weight.x, s.weight.y, s.weight.z, s.pdf):
            assert np.isfinite(np.asarray(arr)).all()


class TestBsdfSampleEvalAgreement:
    """For non-Dirac lobes: sample() then evaluate() at the sampled direction
    must reproduce weight = f·cos/pdf and matching pdf."""

    @pytest.mark.parametrize(
        "kind,rough",
        [
            (T.BSDF_DIFFUSE, 0.5),
            (T.BSDF_ROUGH_DIFFUSE, 0.5),
            (T.BSDF_ROUGH_METAL, 0.4),
        ],
    )
    def test_agreement(self, kind, rough):
        mp = _mat(kind, roughness=rough)
        wo = _wo(40.0)
        u1, u2, u3 = _uniforms(3)
        smp = bsdf_ops.sample(mp, wo, u1, u2, u3)
        f, pdf = bsdf_ops.evaluate(mp, wo, smp.wi)
        valid = np.asarray(smp.valid) & (np.asarray(smp.pdf) > 1e-5) & (np.asarray(pdf) > 1e-5)
        assert valid.mean() > 0.9
        w_expect = np.asarray(f.x)[valid] / np.asarray(pdf)[valid]
        w_got = np.asarray(smp.weight.x)[valid]
        np.testing.assert_allclose(w_got, w_expect, rtol=2e-2, atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(smp.pdf)[valid], np.asarray(pdf)[valid], rtol=2e-2, atol=1e-4
        )

    def test_diffuse_white_furnace(self):
        """E[weight] = albedo for cosine-sampled Lambert."""
        mp = _mat(T.BSDF_DIFFUSE, base=(0.8, 0.6, 0.4))
        wo = _wo(30.0)
        u1, u2, u3 = _uniforms(4)
        smp = bsdf_ops.sample(mp, wo, u1, u2, u3)
        np.testing.assert_allclose(float(jnp.mean(smp.weight.x)), 0.8, atol=1e-3)
        np.testing.assert_allclose(float(jnp.mean(smp.weight.y)), 0.6, atol=1e-3)

    def test_metal_full_reflectance(self):
        """Perfect conductor with huge k ~ reflects everything * base_color."""
        mp = _mat(T.BSDF_METAL, base=(1.0, 1.0, 1.0), k=1e4, ior=0.01)
        wo = _wo(45.0)
        u1, u2, u3 = _uniforms(5)
        smp = bsdf_ops.sample(mp, wo, u1, u2, u3)
        assert bool(jnp.all(smp.valid))
        np.testing.assert_allclose(np.asarray(smp.weight.x), 1.0, atol=1e-3)
        # mirror direction
        np.testing.assert_allclose(np.asarray(smp.wi.z), np.asarray(wo.z), atol=1e-6)
        np.testing.assert_allclose(np.asarray(smp.wi.x), -np.asarray(wo.x), atol=1e-6)

    def test_dielectric_energy_conservation(self):
        """Reflected + refracted weights average to ~1 (no absorption)."""
        mp = _mat(T.BSDF_DIELECTRIC, base=(1.0, 1.0, 1.0), ior=1.5)
        wo = _wo(30.0)
        u1, u2, u3 = _uniforms(6)
        smp = bsdf_ops.sample(mp, wo, u1, u2, u3)
        assert bool(jnp.all(smp.valid))
        np.testing.assert_allclose(float(jnp.mean(smp.weight.x)), 1.0, atol=2e-2)

    def test_smooth_fallback(self):
        """roughness < threshold turns rough lobes into their smooth variant
        (`BSDF.h:57`) — sampled direction must be the exact mirror."""
        mp = _mat(T.BSDF_ROUGH_METAL, roughness=0.001)
        wo = _wo(35.0)
        u1, u2, u3 = _uniforms(7)
        smp = bsdf_ops.sample(mp, wo, u1, u2, u3)
        assert bool(jnp.all(smp.specular))
        np.testing.assert_allclose(np.asarray(smp.wi.x), -np.asarray(wo.x), atol=1e-6)

    def test_null_bsdf_invalid(self):
        mp = _mat(T.BSDF_NULL)
        wo = _wo(30.0)
        u1, u2, u3 = _uniforms(8)
        smp = bsdf_ops.sample(mp, wo, u1, u2, u3)
        assert not bool(jnp.any(smp.valid))

    def test_evaluate_zero_for_dirac(self):
        mp = _mat(T.BSDF_METAL)
        wo = _wo(30.0)
        wi = _wo(50.0)
        f, pdf = bsdf_ops.evaluate(mp, wo, wi)
        assert float(jnp.max(jnp.abs(f.x))) == 0.0
        assert float(jnp.max(jnp.abs(pdf))) == 0.0

"""Scene-radius derivation: background/directional photon
emission must cover the REAL scene bounds, not the reference's hardcoded 30
(`BackgroundLight.cpp:16`, its own TODO).

- radius derived from built geometry (prims, baked tris, instances);
- brute-force check of the background emission pdf: positions uniform on a
  disk of the derived radius (chi-square over radial area-equal annuli),
  directions uniform on the sphere, and pdf == 1/(4π·πR²) — the constants
  the VCM/light-tracer MIS weights divide by;
- coverage: photons must be able to reach geometry far outside radius 30.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from raytracer_tpu.math import sampling
from raytracer_tpu.ops.lights import emit, gather_light
from raytracer_tpu.scene.build import SceneBuilder
from raytracer_tpu.scene.types import LIGHT_BACKGROUND
from raytracer_tpu.scene.build import LightDesc, MaterialDesc, PrimDesc
from raytracer_tpu.math.transform import RigidTransform
from raytracer_tpu.scene import types as T


def _big_scene():
    """Sphere at distance 150 from the origin — far outside radius 30."""
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(name="d", bsdf="diffuse", base_color=(0.7, 0.7, 0.7)))
    b.prims.append(
        PrimDesc(T.PRIM_SPHERE, RigidTransform(translation=(150.0, 0.0, 0.0)),
                 (5.0, 0.0, 0.0), m)
    )
    b.add_light(LightDesc(kind=LIGHT_BACKGROUND, color=(1.0, 1.0, 1.0)))
    return b.build()


def test_radius_derived_from_bounds():
    scene, meta = _big_scene()
    assert meta.scene_radius == pytest.approx(1.05 * 155.0, rel=1e-5)


def test_empty_scene_keeps_reference_default():
    b = SceneBuilder()
    b.add_light(LightDesc(kind=LIGHT_BACKGROUND, color=(1.0, 1.0, 1.0)))
    _, meta = b.build()
    assert meta.scene_radius == 30.0


def test_background_emission_pdf_brute_force():
    scene, meta = _big_scene()
    r = meta.scene_radius
    n = 200_000
    rng = np.random.default_rng(3)
    u = [jnp.asarray(rng.uniform(size=n).astype(np.float32)) for _ in range(5)]
    li = jnp.zeros(n, jnp.int32)
    l = gather_light(scene.lights, li)
    em = emit(l, *u, scene_radius=meta.scene_radius)

    # pdf constant == uniform_sphere × uniform_circle(R)
    want = sampling.uniform_sphere_pdf() * sampling.uniform_circle_pdf(r)
    np.testing.assert_allclose(np.asarray(em.emission_pdf_w), want, rtol=1e-5)

    # positions lie on the bounding sphere's tangent disks: |pos| in [R, R√2]
    pos = np.stack([np.asarray(em.position.x), np.asarray(em.position.y),
                    np.asarray(em.position.z)], -1)
    dist = np.linalg.norm(pos, axis=1)
    assert dist.min() >= r * 0.999
    assert dist.max() <= r * np.sqrt(2.0) * 1.001

    # the perpendicular offset from the ray to the ORIGIN is uniform on a
    # disk of radius R: chi-square over 10 equal-area annuli
    d = np.stack([np.asarray(em.direction.x), np.asarray(em.direction.y),
                  np.asarray(em.direction.z)], -1)
    # closest approach of line (pos, d) to origin
    tca = -(pos * d).sum(1)
    perp = np.linalg.norm(pos + tca[:, None] * d, axis=1)
    edges = r * np.sqrt(np.linspace(0.0, 1.0, 11))
    counts, _ = np.histogram(perp, bins=edges)
    expect = n / 10.0
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 35.0, (chi2, counts)  # 9 dof, p≈1e-5 bound

    # coverage: some photons pass within the far sphere (|closest approach
    # to (150,0,0)| < 5) — impossible with the old hardcoded radius 30
    target = np.array([150.0, 0.0, 0.0])
    tc = -((pos - target) * d).sum(1)
    perp_t = np.linalg.norm(pos + tc[:, None] * d - target, axis=1)
    frac = float(np.mean(perp_t < 5.0))
    assert frac > 1e-4, frac

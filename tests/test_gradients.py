"""Differentiable rendering: gradients vs finite differences (BASELINE.md
"gradient agreement" metric).  Deterministic sampling makes the FD estimator
exact up to float precision — same samples for f(x) and f(x+h)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_tpu.integrators.path_tracer import RenderParams
from raytracer_tpu.math.transform import RigidTransform
from raytracer_tpu.render.renderer import ViewportParams, trace_rows
from raytracer_tpu.scene import types as T
from raytracer_tpu.scene.build import LightDesc, MaterialDesc, SceneBuilder
from raytracer_tpu.scene.camera import make_camera

import pytest

pytestmark = pytest.mark.slow  # full-render / FD-gradient suite: smoke tier skips it


def _scene():
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(bsdf="diffuse", base_color=(0.6, 0.5, 0.4)))
    b.add_rect(RigidTransform(translation=(0, 0, 3), euler_deg=(180, 0, 0)), (20, 20), m)
    b.add_sphere(RigidTransform(translation=(0.5, 0, 2)), 0.4, m)
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.5, 0.5, 0.5)))
    b.add_light(
        LightDesc(kind=T.LIGHT_POINT, color=(5.0, 4.0, 3.0),
                  transform=RigidTransform(translation=(0, 1, 1)))
    )
    return b.build()


VP = ViewportParams(width=8, height=8, seed=1)
PARAMS = RenderParams(max_depth=4, mis=True)


def _loss(scene, meta, cam, base_color):
    s = scene._replace(materials=scene.materials._replace(base_color=base_color))
    r, _ = trace_rows(s, meta, cam, jnp.int32(0), None, VP, PARAMS)
    return jnp.mean(r.x + 2.0 * r.y + 0.5 * r.z)


class TestGradients:
    def test_grad_matches_finite_difference(self):
        scene, meta = _scene()
        cam = make_camera(RigidTransform(), fov_deg=40.0)
        bc = scene.materials.base_color
        f = jax.jit(lambda b: _loss(scene, meta, cam, b))
        g = jax.jit(jax.grad(lambda b: _loss(scene, meta, cam, b)))(bc)

        h = 1e-3
        for comp, garr in (("x", g.x), ("y", g.y), ("z", g.z)):
            e = jnp.zeros_like(bc.x).at[0].set(h)
            bp = bc._replace(**{comp: getattr(bc, comp) + e})
            bm = bc._replace(**{comp: getattr(bc, comp) - e})
            fd = (float(f(bp)) - float(f(bm))) / (2 * h)
            ad = float(garr[0])
            assert np.isfinite(ad)
            np.testing.assert_allclose(ad, fd, rtol=0.05, atol=1e-3,
                                       err_msg=f"component {comp}")

    def test_grad_emission(self):
        scene, meta = _scene()
        cam = make_camera(RigidTransform(), fov_deg=40.0)

        def loss(em):
            s = scene._replace(materials=scene.materials._replace(emission=em))
            r, _ = trace_rows(s, meta, cam, jnp.int32(0), None, VP, PARAMS)
            return jnp.mean(r.x)

        em = scene.materials.emission
        g = jax.jit(jax.grad(loss))(em)
        h = 1e-3
        f = jax.jit(loss)
        e = jnp.zeros_like(em.x).at[0].set(h)
        fd = (float(f(em._replace(x=em.x + e))) - float(f(em._replace(x=em.x - e)))) / (2 * h)
        np.testing.assert_allclose(float(g.x[0]), fd, rtol=0.05, atol=1e-4)

    def test_grad_light_color(self):
        scene, meta = _scene()
        cam = make_camera(RigidTransform(), fov_deg=40.0)

        def loss(lc):
            s = scene._replace(lights=scene.lights._replace(color=lc))
            r, _ = trace_rows(s, meta, cam, jnp.int32(0), None, VP, PARAMS)
            return jnp.mean(r.x)

        lc = scene.lights.color
        g = jax.jit(jax.grad(loss))(lc)
        assert bool(jnp.all(jnp.isfinite(g.x)))
        # background light (idx 0) contributes positively to the red channel
        assert float(g.x[0]) > 0.0

    def test_grad_camera_pose_finite(self):
        scene, meta = _scene()

        def loss(origin_z):
            import dataclasses
            from raytracer_tpu.math.vec import Vec3
            cam = make_camera(RigidTransform(), fov_deg=40.0)
            cam2 = dataclasses.replace(
                cam, origin=Vec3(cam.origin.x, cam.origin.y, cam.origin.z + origin_z)
            )
            r, _ = trace_rows(scene, meta, cam2, jnp.int32(0), None, VP, PARAMS)
            return jnp.mean(r.x)

        g = jax.jit(jax.grad(loss))(jnp.float32(0.0))
        assert np.isfinite(float(g))


def _smooth_scene():
    """Silhouette-free view (one big rect fills the frame): finite differences
    of camera parameters stay smooth — no visibility-edge crossings, which AD
    deliberately does not differentiate (stop-grad through discrete hits)."""
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(bsdf="diffuse", base_color=(0.6, 0.5, 0.4)))
    b.add_rect(RigidTransform(translation=(0, 0, 3), euler_deg=(180, 0, 0)), (50, 50), m)
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.5, 0.5, 0.5)))
    b.add_light(
        LightDesc(kind=T.LIGHT_POINT, color=(5.0, 4.0, 3.0),
                  transform=RigidTransform(translation=(0, 1, 1)))
    )
    return b.build()


class TestCameraGradients:
    """FD agreement for the camera axis of differentiable rendering
    (origin AND one rotation row)."""

    PARAMS = RenderParams(max_depth=2, mis=True)

    def _cam_loss(self, scene, meta):
        import dataclasses
        from raytracer_tpu.math.vec import Vec3

        def loss(theta, origin_z):
            base = make_camera(RigidTransform(), fov_deg=40.0)
            # yaw rotation around +Y applied to the (right, forward) rows —
            # differentiable rotation of the camera basis
            c, s = jnp.cos(theta), jnp.sin(theta)
            right = Vec3(base.right.x * c - base.forward.x * s,
                         base.right.y * c - base.forward.y * s,
                         base.right.z * c - base.forward.z * s)
            forward = Vec3(base.right.x * s + base.forward.x * c,
                           base.right.y * s + base.forward.y * c,
                           base.right.z * s + base.forward.z * c)
            cam = dataclasses.replace(
                base,
                right=right,
                forward=forward,
                origin=Vec3(base.origin.x, base.origin.y, base.origin.z + origin_z),
            )
            r, _ = trace_rows(scene, meta, cam, jnp.int32(0), None, VP, self.PARAMS)
            return jnp.mean(r.x + r.y + r.z)

        return loss

    def test_grad_camera_origin_fd(self):
        scene, meta = _smooth_scene()
        loss = self._cam_loss(scene, meta)
        f = jax.jit(lambda z: loss(jnp.float32(0.0), z))
        ad = float(jax.jit(jax.grad(loss, argnums=1))(jnp.float32(0.0), jnp.float32(0.0)))
        h = 1e-2
        fd = (float(f(jnp.float32(h))) - float(f(jnp.float32(-h)))) / (2 * h)
        assert np.isfinite(ad)
        np.testing.assert_allclose(ad, fd, rtol=0.1, atol=1e-3)

    def test_grad_camera_yaw_fd(self):
        scene, meta = _smooth_scene()
        loss = self._cam_loss(scene, meta)
        f = jax.jit(lambda t: loss(t, jnp.float32(0.0)))
        ad = float(jax.jit(jax.grad(loss, argnums=0))(jnp.float32(0.0), jnp.float32(0.0)))
        h = 1e-2
        fd = (float(f(jnp.float32(h))) - float(f(jnp.float32(-h)))) / (2 * h)
        assert np.isfinite(ad)
        np.testing.assert_allclose(ad, fd, rtol=0.1, atol=1e-3)

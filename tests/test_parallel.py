"""Multi-device correctness: the sharded render/train paths must agree with
the single-chip paths exactly.

The reference's only concurrency boundary is a thread pool over image tiles
whose per-thread results merge deterministically (`Viewport.cpp:227-287`);
the device analogue (SURVEY §2.9 P3) shards the pixel-row axis over a device
mesh.  Because every sample is a pure hash of the GLOBAL pixel id + pass +
seed, any row partitioning must produce bit-identical radiance — these tests
pin that claim (conftest.py provides the 8-virtual-device CPU mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.integrators.path_tracer import RenderParams
from raytracer_tpu.math.transform import RigidTransform
from raytracer_tpu.parallel.mesh import (
    AXIS,
    film_sharding,
    make_mesh,
    render_pass_sharded,
    train_step_sharded,
)
from raytracer_tpu.render.film import make_film
from raytracer_tpu.render.renderer import ViewportParams, trace_rows
from raytracer_tpu.scene.camera import make_camera
from raytracer_tpu.scene.presets import cornell_box, cornell_camera_kw

import pytest

pytestmark = pytest.mark.slow  # full-render / FD-gradient suite: smoke tier skips it

W, H = 16, 32
VP = ViewportParams(width=W, height=H, seed=0)
PARAMS = RenderParams(max_depth=3, mis=True)


@pytest.fixture(scope="module")
def setup():
    scene, meta = cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw)
    return scene, meta, cam


def _run_sharded(scene, meta, cam, n_dev, n_passes=2):
    mesh = make_mesh(jax.devices()[:n_dev])
    film = jax.device_put(make_film(W, H), film_sharding(mesh))
    counters = None
    for p in range(n_passes):
        film, counters = render_pass_sharded(
            scene=scene, meta=meta, cam=cam, film=film, pass_idx=jnp.int32(p),
            halton=None, vp=VP, params=PARAMS, mesh=mesh,
        )
    return np.asarray(film.sum), counters


class TestShardedRender:
    def test_1_vs_8_device_bit_identical(self, setup):
        """Row-band partitioning must not change a single bit of the film."""
        scene, meta, cam = setup
        film1, _ = _run_sharded(scene, meta, cam, n_dev=1)
        film8, _ = _run_sharded(scene, meta, cam, n_dev=8)
        np.testing.assert_array_equal(film1, film8)

    def test_sharded_matches_unsharded_pass(self, setup):
        """The shard_map'd pass equals a plain trace_rows over the frame."""
        scene, meta, cam = setup
        film8, _ = _run_sharded(scene, meta, cam, n_dev=8, n_passes=1)
        radiance, _ = trace_rows(
            scene, meta, cam, jnp.int32(0), None, VP, PARAMS
        )
        expect = np.stack(
            [np.asarray(radiance.x), np.asarray(radiance.y), np.asarray(radiance.z)],
            axis=-1,
        ).reshape(H, W, 3)
        np.testing.assert_array_equal(film8, expect)

    def test_counters_surfaced_and_whole_frame(self, setup):
        """Sharded counters are psum'd to whole-frame totals (the analogue of
        merging per-thread RayTracingCounters, `Viewport.cpp:282-287`)."""
        scene, meta, cam = setup
        _, counters = _run_sharded(scene, meta, cam, n_dev=8, n_passes=1)
        assert counters is not None
        # primary rays = one per pixel at minimum
        assert float(counters.num_rays) >= W * H
        _, unsharded = trace_rows(scene, meta, cam, jnp.int32(0), None, VP, PARAMS)
        assert float(counters.num_rays) == float(unsharded.num_rays)
        assert float(counters.num_shadow_rays) == float(unsharded.num_shadow_rays)


class TestShardedTrain:
    def test_loss_and_grads_match_unsharded(self, setup):
        """Sharded forward+backward+psum == unsharded value_and_grad."""
        scene, meta, cam = setup
        target = jnp.full((H, W, 3), 0.25, jnp.float32)
        mesh = make_mesh(jax.devices()[:8])
        loss_sh, grads_sh = train_step_sharded(
            scene=scene, meta=meta, cam=cam, target=target,
            pass_idx=jnp.int32(1), vp=VP, params=PARAMS, mesh=mesh,
        )

        def loss_fn(mat_params):
            base_color, emission, roughness = mat_params
            materials = scene.materials._replace(
                base_color=base_color, emission=emission, roughness=roughness
            )
            s = scene._replace(materials=materials)
            radiance, _ = trace_rows(s, meta, cam, jnp.int32(1), None, VP, PARAMS)
            img = jnp.stack(
                [
                    radiance.x.reshape(H, W),
                    radiance.y.reshape(H, W),
                    radiance.z.reshape(H, W),
                ],
                axis=-1,
            )
            return jnp.sum((img - target) ** 2) / (W * H * 3)

        m = scene.materials
        loss_un, grads_un = jax.value_and_grad(loss_fn)(
            (m.base_color, m.emission, m.roughness)
        )
        np.testing.assert_allclose(float(loss_sh), float(loss_un), rtol=1e-5)
        flat_sh = jax.tree.leaves(grads_sh)
        flat_un = jax.tree.leaves(grads_un)
        assert len(flat_sh) == len(flat_un) > 0
        for a, b in zip(flat_sh, flat_un):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
            )
        assert all(np.isfinite(np.asarray(g)).all() for g in flat_sh)


class TestShardedVcm:
    def test_vcm_sharded_matches_single_device(self, setup):
        """Sharded VCM (banded light+camera paths, photon all_gather, splat
        psum) must match the single-device pass: same global path ids =>
        same sub-paths; the gathered photon set is the same set.

        Photon ORDER differs across shardings (gather concatenates bands), so
        grid cell candidate selection can differ when a cell overflows — with
        few photons per cell the result is identical; tolerance covers f32
        reduction-order drift only."""
        from raytracer_tpu.integrators.vcm import VcmParams, render_pass_vcm
        from raytracer_tpu.parallel.mesh import render_pass_vcm_sharded

        scene, meta, cam = setup
        vcm = VcmParams(max_path_length=3)

        film1 = make_film(W, H)
        film1 = render_pass_vcm(
            scene, meta, cam, film1, jnp.int32(0), None, VP, PARAMS, vcm
        )
        ref = np.asarray(film1.sum)

        mesh = make_mesh(jax.devices()[:8])
        film8 = jax.device_put(make_film(W, H), film_sharding(mesh))
        film8 = render_pass_vcm_sharded(
            scene=scene, meta=meta, cam=cam, film=film8, pass_idx=jnp.int32(0),
            vp=VP, params=PARAMS, mesh=mesh, vcm=vcm,
        )
        got = np.asarray(film8.sum)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)

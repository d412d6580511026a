"""Utils layer: profiler registry, checkpoint/resume, BVH save/load.

Mirrors the reference's Utils coverage (SURVEY §2.7): scoped timers
(`Core/Utils/Profiler.h:25-102`), asset persistence (`Core/BVH/BVH.h:87-88`),
plus the render-state resumability SURVEY §5 requires.
"""

import numpy as np
import pytest

from raytracer_tpu.integrators.path_tracer import RenderParams
from raytracer_tpu.math.transform import RigidTransform
from raytracer_tpu.render.renderer import Viewport, ViewportParams
from raytracer_tpu.scene.build import LightDesc, MaterialDesc, SceneBuilder
from raytracer_tpu.scene.camera import make_camera


class TestProfiler:
    def test_scoped_timer_collects(self):
        from raytracer_tpu.utils import collect, reset, scoped_timer

        reset()
        for _ in range(3):
            with scoped_timer("unit.region"):
                pass
        stats = collect()
        assert stats["unit.region"]["count"] == 3
        assert stats["unit.region"]["total"] >= 0.0
        assert stats["unit.region"]["min"] <= stats["unit.region"]["avg"] <= stats["unit.region"]["max"]

    def test_profiled_decorator_and_report(self):
        from raytracer_tpu.utils import collect, profiled, report, reset

        reset()

        @profiled("unit.fn")
        def fn(x):
            return x + 1

        assert fn(1) == 2
        assert collect()["unit.fn"]["count"] == 1
        assert "unit.fn" in report()

    def test_logger_levels(self, capsys):
        from raytracer_tpu.utils import log_error, log_info, log_warning

        log_info("info %d", 1)
        log_warning("warn")
        log_error("err")
        err = capsys.readouterr().err
        assert "info 1" in err and "warn" in err and "err" in err


def _cornell_viewport(seed=0):
    from raytracer_tpu.scene.presets import cornell_box, cornell_camera_kw

    scene, meta = cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw)
    return Viewport(
        scene, meta, cam,
        ViewportParams(width=16, height=16, seed=seed),
        RenderParams(max_depth=3, mis=True),
    )


class TestCheckpoint:
    def test_resume_is_bit_exact(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        straight = _cornell_viewport().render(4)

        first = _cornell_viewport().render(2)
        first.save_checkpoint(path)
        resumed = _cornell_viewport().load_checkpoint(path).render(2)

        np.testing.assert_array_equal(
            np.asarray(straight.film.sum), np.asarray(resumed.film.sum)
        )
        assert int(resumed.film.num_passes) == 4
        assert resumed.total_rays == straight.total_rays

    def test_mismatched_seed_rejected(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        _cornell_viewport(seed=0).render(1).save_checkpoint(path)
        with pytest.raises(ValueError, match="seed"):
            _cornell_viewport(seed=1).load_checkpoint(path)

    def test_mismatched_shape_rejected(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        _cornell_viewport().render(1).save_checkpoint(path)
        vp = _cornell_viewport()
        vp.vp_params = ViewportParams(width=8, height=8, seed=0)
        with pytest.raises(ValueError, match="film"):
            vp.load_checkpoint(path)


class TestBvhPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        from raytracer_tpu.scene.bvh import build_bvh_over_triangles, load_bvh, save_bvh

        rng = np.random.default_rng(7)
        n = 64
        v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        tri_v = np.stack(
            [v0,
             v0 + rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32),
             v0 + rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32)],
            axis=1,
        )
        tri_n = np.tile(np.array([0, 0, 1], np.float32), (n, 3, 1))
        tri_uv = np.zeros((n, 3, 2), np.float32)
        tri_mat = np.zeros(n, np.int32)
        tris, bvh = build_bvh_over_triangles(tri_v, tri_n, tri_uv, tri_mat)

        path = str(tmp_path / "bvh.npz")
        save_bvh(path, bvh)
        loaded = load_bvh(path)
        for field in type(bvh)._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(bvh, field)), np.asarray(getattr(loaded, field)),
                err_msg=field,
            )

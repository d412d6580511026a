"""Multi-host layer (SURVEY §2.9 distributed backend row).

- smoke: a ("hosts", "chips") mesh built single-process must render
  identically to the 1-D mesh (same band decomposition, axes-generic psums);
- slow: a REAL 2-process `jax.distributed` CPU cluster (4 virtual devices
  per process) renders a sharded pass; each process checks its local film
  band bit-exactly against a single-process render.  This is the dryrun for
  the cross-host / within-host split of the multi-host path
  (`parallel/mesh.py`).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from raytracer_tpu.integrators.path_tracer import RenderParams
from raytracer_tpu.math.transform import RigidTransform
from raytracer_tpu.parallel.mesh import (
    film_sharding,
    make_mesh,
    make_multihost_mesh,
    render_pass_sharded,
)
from raytracer_tpu.render.film import make_film
from raytracer_tpu.render.renderer import ViewportParams
from raytracer_tpu.scene.camera import make_camera
from raytracer_tpu.scene.presets import cornell_box, cornell_camera_kw

import jax.numpy as jnp


def _render(mesh, size=32, passes=2):
    scene, meta = cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw)
    vp = ViewportParams(width=size, height=size, seed=0)
    params = RenderParams(max_depth=3, mis=True)
    film = make_film(size, size)
    if mesh is not None:
        film = jax.device_put(film, film_sharding(mesh))
    for i in range(passes):
        film, _ = render_pass_sharded(
            scene, meta, cam, film, jnp.int32(i), None, vp, params, mesh
        )
    return np.asarray(film.sum)


def test_hosts_chips_mesh_matches_flat():
    """(1, N) hosts×chips mesh == 1-D tiles mesh, bit-exact."""
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs >= 2 devices")
    flat = _render(make_mesh(devs))
    hc = _render(make_multihost_mesh(devs))  # single process => (1, N)
    assert np.array_equal(flat, hc)


_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


@pytest.mark.slow
def test_two_process_cpu_cluster():
    """Spawn a real 2-process jax.distributed CPU cluster and render."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            MH_COORD=f"localhost:{port}",
            MH_NPROC="2",
            MH_PID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, _WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {pid} no OK marker:\n{out}"

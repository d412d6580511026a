"""Rays/s scaling-efficiency harness (BASELINE.md open row; the device-mesh
re-expression of the reference's ThreadPool scaling axis,
`Core/Utils/ThreadPool.h:16-58`).

Renders the SAME fixed 256x256 Cornell MIS workload through
`render_pass_sharded` at 1/2/4/8 devices (strong scaling: each device traces
H/n pixel rows) and reports throughput per device count.

Efficiency semantics depend on the platform:
- several GPUs: devices add compute -> ``scaling_efficiency`` =
  thr_n / (n * thr_1), target >= 0.80 (BASELINE.md).
- virtual CPU devices (tests): the N "devices" SHARE the host's cores, so
  thr_n cannot exceed thr_1; what the harness measures is the SHARDING
  OVERHEAD (shard_map partitioning + the counters psum), reported as
  ``sharding_overhead_virtual_cpu`` = T_1 / T_n (ideal 1.0) — never under
  the device metric's name.

Usage:
  python tools/scaling_bench.py            # current platform's devices
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/scaling_bench.py        # 8 virtual CPU devices

Prints one JSON line per device count + a summary line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(out=print):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.math.transform import RigidTransform
    from raytracer_tpu.parallel.mesh import make_mesh, render_pass_sharded
    from raytracer_tpu.render.film import make_film
    from raytracer_tpu.render.renderer import ViewportParams
    from raytracer_tpu.scene.camera import make_camera
    from raytracer_tpu.scene.presets import cornell_box, cornell_camera_kw

    scene, meta = cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw)
    vp = ViewportParams(width=256, height=256, seed=0)
    params = RenderParams(max_depth=6, mis=True)

    devices = jax.devices()
    platform = devices[0].platform
    counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    shared_cores = platform == "cpu"  # virtual devices share the host cores

    def force(x):
        for leaf in jax.tree_util.tree_leaves(x):
            np.asarray(leaf)[:1] if getattr(leaf, "ndim", 0) else np.asarray(leaf)
        return x

    results = {}
    for n in counts:
        mesh = make_mesh(np.asarray(devices[:n]))
        film = make_film(vp.width, vp.height)
        # pin the film shards to the mesh so the first pass doesn't time the
        # initial host->device layout
        def run(passes):
            f, c = film, None
            for p in range(passes):
                f, c = render_pass_sharded(
                    scene, meta, cam, f, jnp.int32(p), None, vp, params, mesh
                )
            return f, c

        f, c = run(2)  # compile + warmup
        force(f.sum)
        t0 = time.perf_counter()
        reps = 4
        f, c = run(reps)
        force(f.sum)
        dt = (time.perf_counter() - t0) / reps
        nrays = float(c.num_rays + c.num_shadow_rays)
        thr = nrays / dt / 1e6
        results[n] = (dt, thr)
        out(json.dumps({
            "metric": f"scaling_rays_per_sec_{n}dev",
            "value": round(thr, 3), "unit": "Mray/s",
            "platform": platform, "devices": n,
            "seconds_per_pass": round(dt, 4),
        }))

    n_max = counts[-1]
    t1, thr1 = results[1]
    tn, thrn = results[n_max]
    if shared_cores:
        eff = t1 / tn  # sharding overhead factor (ideal 1.0)
        metric = "sharding_overhead_virtual_cpu"
        mode = "virtual-cpu sharding overhead (ideal 1.0; devices share cores)"
    else:
        eff = thrn / (n_max * thr1)
        metric = "scaling_efficiency"
        mode = "multi-device strong-scaling efficiency (target >= 0.80)"
    summary = {
        "metric": metric,
        "value": round(eff, 4),
        "unit": "ratio",
        "platform": platform,
        "devices": n_max,
        "semantics": mode,
    }
    out(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

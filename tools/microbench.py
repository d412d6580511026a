"""Micro-benchmark suite — per-kernel throughput on the active JAX backend.

The reference ships google-benchmark micro-benches for its kernels
(`Benchmark/GeometryBenchmark.cpp`, `RandomBenchmark.cpp`,
`TranscendentalBenchmark.cpp`, `VectorBenchmark.cpp`, `HashGridBenchmark.cpp`
— SURVEY §6).  This is the JAX equivalent: each hot kernel is jitted,
warmed, then timed over a large wavefront; results print as JSON lines.

Usage: python tools/microbench.py [--cpu] [--n 1048576]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def _time(fn, *args, iters=10):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from raytracer_tpu.math.vec import Vec3
    n = args.n
    rng = np.random.default_rng(0)

    def vec3(scale=1.0, offset=0.0):
        return Vec3(*(jnp.asarray(rng.uniform(-1, 1, n) * scale + offset, jnp.float32)
                      for _ in range(3)))

    results = []

    def bench(name, seconds, unit_count, unit="Mop/s"):
        rate = unit_count / seconds / 1e6
        r = {"bench": name, "rate": round(rate, 2), "unit": unit,
             "time_us": round(seconds * 1e6, 1)}
        results.append(r)
        print(json.dumps(r), flush=True)

    # --- ray-triangle intersection (`GeometryBenchmark.cpp:25`) -----------------
    from raytracer_tpu.ops.bvh_traverse import _moller_trumbore

    o = vec3(0.1)
    d = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.ones(n))
    geom = jnp.asarray(rng.uniform(-1, 1, (n, 9)), jnp.float32)
    f = jax.jit(lambda g, o, d: _moller_trumbore(g, o, d))
    bench("ray_triangle", _time(f, geom, o, d, iters=args.iters), n, "Mtests/s")

    # --- BSDF sample + evaluate -------------------------------------------------
    from raytracer_tpu.ops.bsdf import MatParams, evaluate, sample

    mp = MatParams(
        bsdf=jnp.full(n, 6, jnp.int32),  # rough metal (GGX)
        base_color=vec3(0.5, 0.5), emission=vec3(0.0),
        roughness=jnp.full(n, 0.3), metalness=jnp.full(n, 1.0),
        ior=jnp.full(n, 1.5), k=jnp.full(n, 4.0),
        dispersive=jnp.zeros(n, bool),
    )
    from raytracer_tpu.math.vec import normalize

    wo = normalize(Vec3(jnp.full(n, 0.3), jnp.full(n, 0.1), jnp.full(n, 0.9)))
    u = jnp.asarray(rng.random((3, n)), jnp.float32)
    fs = jax.jit(lambda mp, wo, u: sample(mp, wo, u[0], u[1], u[2]))
    bench("bsdf_sample_all_lobes", _time(fs, mp, wo, u, iters=args.iters), n, "Msamples/s")
    fe = jax.jit(lambda mp, wo: evaluate(mp, wo, wo))
    bench("bsdf_evaluate_all_lobes", _time(fe, mp, wo, iters=args.iters), n, "Mevals/s")

    # --- counter-based sampler (`RandomBenchmark.cpp`) ---------------------------
    from raytracer_tpu.sampler.sampler import hash_u32, u32_to_unit_float

    ids = jnp.arange(n, dtype=jnp.uint32)
    fr = jax.jit(lambda x: u32_to_unit_float(hash_u32(x)))
    bench("rng_hash_uniform", _time(fr, ids, iters=args.iters), n)

    # --- tonemap + postprocess ops (`ColorHelpers.h:85-131`) --------------------
    from raytracer_tpu.color.colorhelpers import tonemap

    img = jnp.asarray(rng.random((1024, 1024, 3)), jnp.float32) * 4.0
    ft = jax.jit(tonemap)
    bench("tonemap_aces", _time(ft, img, iters=args.iters), img.size // 3, "Mpx/s")

    # --- 2-D distribution sampling (env importance, `Distribution.cpp:85`) ------
    from raytracer_tpu.math.distribution import make_distribution_2d, sample_2d

    dist = make_distribution_2d(rng.random((256, 512)))
    u1 = jnp.asarray(rng.random(n), jnp.float32)
    u2 = jnp.asarray(rng.random(n), jnp.float32)
    fd = jax.jit(lambda a, b: sample_2d(dist, a, b))
    bench("env_distribution_sample", _time(fd, u1, u2, iters=args.iters), n, "Msamples/s")

    # --- full scene traversal (cornell, analytic prims) --------------------------
    from raytracer_tpu.ops.traverse import scene_traverse
    from raytracer_tpu.scene.presets import cornell_box

    scene, _ = cornell_box()
    o2 = vec3(0.4)
    d2 = normalize(vec3(1.0))
    ftr = jax.jit(lambda o, d: scene_traverse(scene, o, d))
    bench("scene_traverse_cornell", _time(ftr, o2, d2, iters=args.iters), n, "Mrays/s")

    # --- mesh BVH traversal ------------------------------------------------------
    try:
        from raytracer_tpu.scene.presets import random_mesh_scene

        mscene, _ = random_mesh_scene()
        ftm = jax.jit(lambda o, d: scene_traverse(mscene, o, d))
        bench("scene_traverse_mesh_bvh", _time(ftm, o2, d2, iters=args.iters), n, "Mrays/s")
    except Exception as e:  # preset may not exist in minimal builds
        print(f"# mesh bench skipped: {e}", file=sys.stderr)

    return results


if __name__ == "__main__":
    main()

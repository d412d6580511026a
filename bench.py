"""Benchmark harness: Mrays/s of the MIS path tracer.

Prints ONE JSON line per metric: {"metric", "value", "unit", "vs_baseline"}.
The driver consumes the FIRST line; further lines are extra diagnostics.

Two configs, each measured against the reference renderer built from source
on this host (tools/ref_baseline/build_ref.sh, 2-core AVX2 CPU):

- analytic Cornell box (512^2, depth 6, MIS) vs the reference's 3.95 Mray/s
  on the identical scene (tools/ref_baseline/ref_baseline.cpp);
- 200k-triangle heightfield mesh (512^2, depth 6, MIS) vs the reference's
  MEASURED 3.26 Mray/s on the IDENTICAL scene: both renderers load the same
  JSON + OBJ emitted by tools/bench_mesh.py, and the reference number comes
  from tools/ref_baseline/bench_scene.cpp run on this host (BASELINE.md).

Runs on a GPU only: it raises when JAX's default backend is anything else.
"""

import json
import time

import jax
import jax.numpy as jnp

# reference renderer on this environment's host CPU (tools/ref_baseline)
REF_CORNELL_MRAYS = 3.95
# reference CPU on the SAME bench-mesh scene (tools/ref_baseline/bench_scene,
# bench_mesh_200k.json, 512^2 x 8 passes, depth 6):
# measured 3.26 Mray/s — see BASELINE.md "mesh scene" row
REF_MESH_MRAYS = 3.26
# reference CPU on the generated Sponza-class interior (800k tris,
# tools/gen_interior.py; bench_scene 512^2 x 2 passes, depth 6, 2026-08-21:
# {"total_rays": 3640689, "seconds": 5.4218, "mrays_per_sec": 0.671})
REF_INTERIOR_MRAYS = 0.671


def bench_backward(scene, meta, cam, size=256):
    """Forward+backward throughput: value_and_grad of an image loss w.r.t.
    material tables (the differentiable-rendering row BASELINE.md demands)."""
    import jax

    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.render.renderer import ViewportParams, trace_rows

    vp = ViewportParams(width=size, height=size, seed=0)
    params = RenderParams(max_depth=4, mis=True)

    @jax.jit
    def step(tables):
        # the SAME three full material tables train_step_sharded
        # differentiates (parallel/mesh.py) — base_color, emission, roughness
        base_color, emission, roughness = tables
        mats = scene.materials._replace(
            base_color=base_color, emission=emission, roughness=roughness
        )
        s = scene._replace(materials=mats)
        radiance, counters = trace_rows(s, meta, cam, jnp.int32(0), None, vp, params)
        loss = (radiance.x + radiance.y + radiance.z).mean()
        return loss, counters.num_rays + counters.num_shadow_rays

    grad_fn = jax.jit(jax.value_and_grad(lambda t: step(t)[0]))
    m = scene.materials
    tables = (m.base_color, m.emission, m.roughness)
    jax.block_until_ready(grad_fn(tables))
    _, nrays = step(tables)
    nrays = float(nrays)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = grad_fn(tables)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return nrays / dt / 1e6


def bench_scene(scene, meta, cam, size, params, n_passes):
    """All timed passes run in ONE jitted scan (`render_passes`), so the
    timing is about the render and not per-pass host dispatch, like the
    reference's in-process pass loop keeps its timing about the render."""
    from raytracer_tpu.render.film import make_film
    from raytracer_tpu.render.renderer import ViewportParams, _jitted_render_passes

    vp = ViewportParams(width=size, height=size, seed=0)
    film = make_film(vp.width, vp.height)
    # warmup batch compiles the executable AND renders passes [0, n)
    film, counters = _jitted_render_passes(
        scene, meta, cam, film, jnp.int32(0), None, vp, params, n_passes
    )
    jax.block_until_ready(film)

    t0 = time.perf_counter()
    film, counters = _jitted_render_passes(
        scene, meta, cam, film, jnp.int32(n_passes), None, vp, params, n_passes
    )
    jax.block_until_ready(film)
    dt = time.perf_counter() - t0
    # counters are summed over the batch (exact total, not per-pass estimate)
    total_rays = float(counters.num_rays + counters.num_shadow_rays)
    overflow = float(counters.num_overflow) if counters.num_overflow is not None else 0.0
    return total_rays / dt / 1e6, overflow


def main():
    import os
    import sys

    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.math.transform import RigidTransform
    from raytracer_tpu.scene.camera import make_camera
    from raytracer_tpu.scene.presets import cornell_box, cornell_camera_kw
    from raytracer_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's default backend is "
            f"{jax.default_backend()!r}"
        )
    enable_compile_cache()

    # --- analytic Cornell (the reference-comparable headline) ---------------
    scene, meta = cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw)
    mrays, _ = bench_scene(
        scene, meta, cam, size=512,
        params=RenderParams(max_depth=6, mis=True), n_passes=8,
    )
    print(json.dumps({
        "metric": "mrays_per_sec_cornell_mis",
        "value": round(mrays, 3),
        "unit": "Mray/s",
        "vs_baseline": round(mrays / REF_CORNELL_MRAYS, 3),
    }))

    # --- mesh + traversal (SURVEY hard part #1): the SAME scene the
    # reference harness measures (tools/bench_mesh.py emits one JSON + OBJ
    # consumed by both renderers) --------------------------------------------
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from bench_mesh import ensure_scene
    from gen_interior import ensure_interior
    from raytracer_tpu.io.scene_loader import load_scene

    mscene, mmeta, mcam = load_scene(ensure_scene(200_000))
    mesh_mrays, overflow = bench_scene(
        mscene, mmeta, mcam, size=512,
        params=RenderParams(max_depth=6, mis=True), n_passes=4,
    )
    print(json.dumps({
        "metric": "mrays_per_sec_mesh200k_mis",
        "value": round(mesh_mrays, 3),
        "unit": "Mray/s",
        "vs_baseline": round(mesh_mrays / REF_MESH_MRAYS, 3),
        "traversal_overflow_rays": overflow,
    }))

    # --- Sponza-class interior (800k tris, 6 meshes, textures, area lights;
    # tools/gen_interior.py) — forward and forward+backward rows, vs the
    # reference measured on the IDENTICAL scene files (BASELINE.md) ---------
    iscene, imeta, icam = load_scene(ensure_interior())
    int_mrays, int_ovf = bench_scene(
        iscene, imeta, icam, size=512,
        params=RenderParams(max_depth=6, mis=True), n_passes=4,
    )
    print(json.dumps({
        "metric": "mrays_per_sec_interior800k_mis",
        "value": round(int_mrays, 3),
        "unit": "Mray/s",
        "vs_baseline": round(int_mrays / REF_INTERIOR_MRAYS, 3),
        "traversal_overflow_rays": int_ovf,
    }))

    # differentiable row: forward+backward Mray/s (loss + material grads)
    fb_mrays = bench_backward(iscene, imeta, icam, size=256)
    print(json.dumps({
        "metric": "mrays_per_sec_interior800k_fwd_bwd",
        "value": round(fb_mrays, 3),
        "unit": "Mray/s (forward rays; cost includes reverse pass)",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()

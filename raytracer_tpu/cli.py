"""Command-line renderer — the role of the reference's Demo app entry
(`Demo/Main.cpp:6-46`: width/height/scene/data/renderer options), headless:
renders N passes and writes EXR/PNG outputs plus a progress/stats line.

Usage:
    python -m raytracer_tpu --scene path/to/scene.json --passes 64 \
        --width 512 --height 512 --output out.png --hdr-output out.exr
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu",
        description="Differentiable Monte Carlo path tracer in JAX",
    )
    p.add_argument("--scene", "-s", help="JSON scene file (reference schema); omit for built-in Cornell box")
    p.add_argument("--data", "-d", default=None, help="asset root for textures/meshes (default: scene dir)")
    p.add_argument("--width", "-w", type=int, default=512)
    p.add_argument("--height", "-e", type=int, default=512)
    p.add_argument("--passes", "-p", type=int, default=16)
    p.add_argument("--renderer", "-r", default="Path Tracer MIS",
                   help="Path Tracer | Path Tracer MIS | Light Tracer | Debug")
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--output", "-o", default="output.png", help="tonemapped PNG/BMP output")
    p.add_argument("--hdr-output", default=None, help="optional EXR (linear radiance) output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--no-low-discrepancy", action="store_true")
    p.add_argument("--stats-json", action="store_true", help="print stats as one JSON line")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from .integrators.path_tracer import RenderParams
    from .math.transform import RigidTransform
    from .render.renderer import Viewport, ViewportParams
    from .scene.camera import make_camera

    if args.scene:
        from .io.scene_loader import load_scene

        scene, meta, cam = load_scene(
            args.scene, data_path=args.data, aspect=args.width / args.height
        )
    else:
        from .scene.presets import cornell_box, cornell_camera_kw

        scene, meta = cornell_box()
        t_kw, c_kw = cornell_camera_kw()
        cam = make_camera(RigidTransform(**t_kw), aspect=args.width / args.height, **c_kw)

    name = args.renderer.lower()
    light_tracer = False
    vcm_mode = False
    if name in ("path tracer", "pathtracer", "pt"):
        params = RenderParams(max_depth=args.max_depth, mis=False)
    elif name in ("path tracer mis", "pt-mis", "mis"):
        params = RenderParams(max_depth=args.max_depth, mis=True)
    elif name in ("light tracer", "lighttracer", "lt"):
        params = RenderParams(max_depth=args.max_depth, mis=True)
        light_tracer = True
    elif name == "vcm":
        params = RenderParams(max_depth=args.max_depth, mis=True)
        vcm_mode = True
    else:
        print(f"error: unknown renderer '{args.renderer}' "
              "(available: 'Path Tracer', 'Path Tracer MIS', 'Light Tracer', 'VCM')",
              file=sys.stderr)
        return 2

    vp = Viewport(
        scene, meta, cam,
        ViewportParams(width=args.width, height=args.height, seed=args.seed,
                       use_low_discrepancy=not args.no_low_discrepancy),
        params,
    )

    t0 = time.perf_counter()
    if vcm_mode:
        import jax as _jax
        import jax.numpy as jnp

        from .integrators.vcm import VcmParams, render_pass_vcm

        vcm = VcmParams(max_path_length=min(args.max_depth, 10))
        vfn = _jax.jit(
            lambda s, c, f, p: render_pass_vcm(
                s, meta, c, f, p, None, vp.vp_params, params, vcm
            )
        )
        for i in range(args.passes):
            vp.film = vfn(scene, cam, vp.film, jnp.int32(i))
    elif light_tracer:
        import jax as _jax
        import jax.numpy as jnp

        from .integrators.light_tracer import render_pass_light_tracer

        ltfn = _jax.jit(
            lambda s, c, f, p: render_pass_light_tracer(
                s, meta, c, f, p, None, vp.vp_params, params
            )
        )
        total = 0.0
        for i in range(args.passes):
            vp.film, counters = ltfn(scene, cam, vp.film, jnp.int32(i))
            total += float(counters.num_rays)
        vp.total_rays = total
    else:
        vp.render(args.passes)
    dt = time.perf_counter() - t0

    from .io.bitmap import write_image

    write_image(args.output, vp.image())
    if args.hdr_output:
        from .io.exr import write_exr

        write_exr(args.hdr_output, vp.radiance())

    stats = vp.progress()
    stats.update(
        seconds=round(dt, 3),
        mrays_per_sec=round((stats["total_rays"] + stats["total_shadow_rays"]) / dt / 1e6, 3),
        output=args.output,
        platform=jax.devices()[0].platform,
    )
    if args.stats_json:
        print(json.dumps(stats))
    else:
        print(
            f"{stats['passes_finished']} passes in {stats['seconds']}s "
            f"({stats['mrays_per_sec']} Mray/s on {stats['platform']}) -> {args.output}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

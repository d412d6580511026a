#!/usr/bin/env python3
"""Drive the path tracer's main path once on a GPU and check what comes out.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

One GPU, through the entry points a user calls (`load_scene` /
`scene.presets` -> `Viewport.render`, `parallel.mesh.train_step_sharded`,
`integrators.vcm.render_pass_vcm`), at the sizes of the benchmark rows:

- cornell / mesh200k / interior800k: 512^2, depth 6, MIS, progressive passes;
- interior800k fwd+bwd: value_and_grad of an image loss w.r.t. the three
  material tables, 256^2, depth 4;
- vcm: one VCM pass over the Cornell box at 512^2 (the interior's VCM pass
  runs sharded under ``--four-cards``);

then the agreement checks, each printed beside its tolerance:

- traversal: the `wave` engine against the exact skip-link `bvh` oracle on
  262,144 camera rays and the cosine bounce taken from their hits, plus each
  engine's time and a profiler trace of one mesh pass that attributes the
  pass's device time to wave's candidate extraction (phase 1) and to its
  pair sort + Möller-Trumbore blocks + reduce (phase 2);
- render vs cpu: Cornell and mesh200k at 128^2 x 16 passes on the GPU and on
  the in-process CPU backend (same counter-based sample streams);
- grads vs cpu: one `train_step_sharded` on the Cornell box at 64^2, depth 4;
- lookup: the one-hot table lookup against the plain gather, bit for bit.

With ``--four-cards``: the interior at 512^2 over a 4-device mesh against
the same passes on one card, one sharded train step against the one-card
step, one sharded VCM pass, and each card's peak memory.

Every phase prints one line; a failed check raises, so the process exits
non-zero.  The last line is one JSON object naming the device.  Without a
GPU the script fails before printing any result.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

os.environ["JAX_PLATFORMS"] = "cuda,cpu"  # CPU only for the explicit references

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

TRACE_DIR = os.path.join(ROOT, "build", "chip_smoke_trace")

# sizes of the benchmark rows (module constants so a CPU rehearsal can
# shrink them; the script itself never does)
SIZE = 512  # render phases; the traversal wavefronts are SIZE^2 rays
FB_SIZE = 256  # forward+backward step
CMP_SIZE, CMP_PASSES = 128, 16  # render vs cpu
GRAD_SIZE = 64  # grads vs cpu
MESH_TRIS = 200_000

# --- tolerances (value, reason); every check prints its limit beside it ----
TOL = {
    "tri_agree_min": (0.9999, "both engines are exact; only t-ties may differ"),
    "tie_rel_t": (1e-6, "a tie: the two hits' t agree to f32 rounding"),
    "t_rel_max": (1e-5, "same Möller-Trumbore arithmetic, other fusion order"),
    "mean_rel_max": (1e-3, "same sample streams; paths diverge only where rounding differs"),
    "down4_rel_max": (5e-3, "4x4-box means, relative L1; divergent paths are MC noise"),
    "loss_rel_max": (1e-5, "same streams; f32 sums in another order"),
    "grad_cos_min": (0.9999, "per-table gradient direction; reduction order differs"),
    "shard_loss_rel_max": (1e-5, "same per-band math; psum adds 4 partial sums"),
    "shard_grad_cos_min": (0.9999, "same per-band math; psum adds 4 partial sums"),
}


class Failed(AssertionError):
    pass


class CompileLog:
    """Counts compile seconds and persistent-cache hits through JAX's own
    monitoring events (trace + lowering + backend compile or cache read)."""

    _DURATIONS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.secs = 0.0
        self.hits = 0
        self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **_):
        if event in self._DURATIONS:
            self.secs += duration

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def mark(self):
        return (self.secs, self.hits, self.misses)

    def since(self, m):
        return self.secs - m[0], self.hits - m[1], self.misses - m[2]


class Phase:
    """One phase: timings, counters and checks, printed as one line."""

    def __init__(self, name, log: CompileLog):
        self.name = name
        self.log = log
        self.fields = []
        self.failures = []
        self._m = log.mark()

    def add(self, key, value):
        if isinstance(value, float):
            value = f"{value:.6g}"
        self.fields.append(f"{key}={value}")

    def check(self, key, value, op, limit, reason=None):
        ok = {"<=": value <= limit, ">=": value >= limit, "==": value == limit}[op]
        v = f"{value:.6g}" if isinstance(value, float) else str(value)
        self.fields.append(f"{key}={v}({op}{limit}{'' if ok else ' FAIL'})")
        if not ok:
            self.failures.append(f"{key}={v} not {op} {limit}" + (f" [{reason}]" if reason else ""))

    def tol(self, key, value, name):
        limit, reason = TOL[name]
        self.check(key, value, "<=" if name.endswith("_max") else ">=", limit, reason)

    def done(self, devices=None):
        secs, hits, misses = self.log.since(self._m)
        head = [f"[phase] {self.name}", f"compile_s={secs:.3f}",
                f"cache_hits={hits}/{hits + misses}"]
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", "n/a")
                 for d in (devices or jax.devices()[:1])]
        tail = [f"peak_bytes_in_use={','.join(map(str, peaks))}"]
        print(" ".join(head + self.fields + tail), flush=True)
        if self.failures:
            raise Failed(f"phase {self.name}: " + "; ".join(self.failures))


def _cpu():
    return jax.devices("cpu")[0]


def _card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi rc={out.returncode}: {out.stderr.strip()}"
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"


def _builder_name():
    from raytracer_tpu.native import load_library

    return "native" if load_library("bvh_builder") is not None else "numpy"


def _load(which):
    """Generate (if needed) and load a benchmark scene; returns
    (scene, meta, cam, generate seconds, load seconds)."""
    from raytracer_tpu.io.scene_loader import load_scene

    t0 = time.perf_counter()
    if which == "mesh200k":
        from bench_mesh import ensure_scene

        path = ensure_scene(MESH_TRIS)
    else:
        from gen_interior import ensure_interior

        path = ensure_interior()
    t1 = time.perf_counter()
    scene, meta, cam = load_scene(path)
    jax.block_until_ready(scene)
    return scene, meta, cam, t1 - t0, time.perf_counter() - t1


def _cornell():
    from raytracer_tpu.math.transform import RigidTransform
    from raytracer_tpu.scene.camera import make_camera
    from raytracer_tpu.scene.presets import cornell_box, cornell_camera_kw

    scene, meta = cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    return scene, meta, make_camera(RigidTransform(**t_kw), **c_kw)


def _viewport(scene, meta, cam, size, depth):
    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.render.renderer import Viewport, ViewportParams

    return Viewport(scene, meta, cam, ViewportParams(width=size, height=size, seed=0),
                    RenderParams(max_depth=depth, mis=True))


def _rays(vp):
    return vp.total_rays + vp.total_shadow_rays


# --------------------------------------------------------------------------
# one card: main path


def render_phase(log, name, scene, meta, cam, passes, setup=None, trace=False):
    """Viewport.render at SIZE^2, depth 6: one call that compiles, one timed."""
    ph = Phase(name, log)
    if setup:
        for k, v in setup.items():
            ph.add(k, v)
    vp = _viewport(scene, meta, cam, SIZE, 6)
    vp.render(passes)
    jax.block_until_ready(vp.film)
    r0 = _rays(vp)
    t0 = time.perf_counter()
    vp.render(passes)
    jax.block_until_ready(vp.film)
    run = time.perf_counter() - t0
    rays = _rays(vp) - r0
    ph.add("passes", passes)
    ph.add("run_s", run)
    ph.add("rays", int(rays))
    ph.add("mray_s", rays / run / 1e6)
    ph.check("rays_gt0", int(rays > 0), "==", 1)
    ph.check("overflow", int(vp.total_overflow), "==", 0)
    ph.check("film_finite", int(np.isfinite(vp.radiance()).all()), "==", 1)
    ph.done()
    if trace:
        trace_phase(log, vp, passes)
    return vp


def trace_phase(log, vp, passes):
    """Profile one more render call and attribute its device time."""
    ph = Phase("mesh200k_trace", log)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    jax.profiler.start_trace(TRACE_DIR)
    try:
        vp.render(passes)
        jax.block_until_ready(vp.film)
    finally:
        jax.profiler.stop_trace()
    paths = glob.glob(os.path.join(TRACE_DIR, "**", "*.xplane.pb"), recursive=True)
    ph.check("trace_files", len(paths), ">=", 1)
    if paths:
        share = device_time_shares(paths[0], ("_wave_trace", "wave_phase1", "wave_phase2"))
        ph.add("device_busy_s", share["total_s"])
        ph.add("events", share["events"])
        ph.add("wave_share", share["_wave_trace"])
        ph.add("phase1_share", share["wave_phase1"])
        # Möller-Trumbore fuses into phase 2's kernels: its share is at most this
        ph.add("phase2_share", share["wave_phase2"])
        ph.add("top_op", share["top_op"])
        ph.add("summary", share["summary_path"])
    ph.done()


def device_time_shares(xplane_path, needles):
    """Sum the durations of GPU events and the part whose name or stats
    mention each needle (named scopes reach the trace through the HLO op
    metadata).  Writes a JSON summary of the busiest ops beside the trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    totals = {n: 0 for n in needles}
    by_name = {}
    total = 0
    count = 0
    lines_seen = {}
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            lines_seen[f"{plane.name}:{line.name}"] = 0
            # kernel events live on the stream lines; the "XLA Ops" /
            # "XLA Modules" lines repeat the same time at op granularity
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                dur = ev.duration_ns
                stats = {k: str(v) for k, v in ev.stats}
                text = ev.name + " " + " ".join(stats.values())
                total += dur
                count += 1
                lines_seen[f"{plane.name}:{line.name}"] += 1
                key = stats.get("hlo_op", ev.name)
                rec = by_name.setdefault(key, [0, 0, ""])
                rec[0] += dur
                rec[1] += 1
                rec[2] = rec[2] or " | ".join(f"{k}={v[:160]}" for k, v in stats.items())
                for n in needles:
                    if n in text:
                        totals[n] += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:40]
    summary = {
        "total_ns": total, "events": count, "lines": lines_seen,
        "needles_ns": totals,
        "top_ops": [{"op": k, "ns": v[0], "n": v[1], "stats": v[2]} for k, v in top],
    }
    out = os.path.join(TRACE_DIR, "summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    res = {n: (totals[n] / total if total else float("nan")) for n in needles}
    top_op = f"{top[0][0]}:{top[0][1][0] / total:.4f}" if top else "none"
    res.update(total_s=total * 1e-9, events=count, top_op=top_op,
               summary_path=os.path.relpath(out, ROOT))
    return res


def _loss_and_grad(meta, vp, params):
    """value_and_grad of the mean image radiance w.r.t. the three material
    tables `train_step_sharded` differentiates; counters ride as aux."""
    from raytracer_tpu.render.renderer import trace_rows

    def loss(tables, scene, cam):
        base_color, emission, roughness = tables
        mats = scene.materials._replace(
            base_color=base_color, emission=emission, roughness=roughness
        )
        radiance, counters = trace_rows(
            scene._replace(materials=mats), meta, cam, jnp.int32(0), None, vp, params
        )
        return (radiance.x + radiance.y + radiance.z).mean(), counters

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def fwd_bwd_phase(log, scene, meta, cam):
    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.render.renderer import ViewportParams

    ph = Phase(f"interior800k_fwd_bwd_{FB_SIZE}_d4", log)
    step = _loss_and_grad(meta, ViewportParams(width=FB_SIZE, height=FB_SIZE, seed=0),
                          RenderParams(max_depth=4, mis=True))
    m = scene.materials
    tables = (m.base_color, m.emission, m.roughness)
    jax.block_until_ready(step(tables, scene, cam))
    t0 = time.perf_counter()
    (loss, counters), grads = step(tables, scene, cam)
    jax.block_until_ready(grads)
    run = time.perf_counter() - t0
    rays = float(counters.num_rays + counters.num_shadow_rays)
    ph.add("run_s", run)
    ph.add("rays", int(rays))
    ph.add("mray_s", rays / run / 1e6)
    ph.add("loss", float(loss))
    ph.check("rays_gt0", int(rays > 0), "==", 1)
    ph.check("overflow", int(counters.num_overflow), "==", 0)
    finite = all(bool(jnp.all(jnp.isfinite(g))) for g in jax.tree.leaves(grads))
    ph.check("loss_grads_finite", int(finite and np.isfinite(float(loss))), "==", 1)
    ph.check("grads_nonzero", int(any(bool(jnp.any(g != 0)) for g in jax.tree.leaves(grads))), "==", 1)
    ph.done()


def vcm_phase(log, name, scene, meta, cam):
    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.integrators.vcm import VcmParams, _trace_light_phase, render_pass_vcm
    from raytracer_tpu.render.film import make_film
    from raytracer_tpu.render.renderer import ViewportParams
    from raytracer_tpu.sampler.sampler import make_stream

    ph = Phase(f"{name}_vcm_{SIZE}", log)
    vpp = ViewportParams(width=SIZE, height=SIZE, seed=0)
    params = RenderParams(max_depth=6, mis=True)
    vcm = VcmParams(max_path_length=6)
    fn = jax.jit(lambda s, c, f, p: render_pass_vcm(s, meta, c, f, p, None, vpp, params, vcm))
    film = jax.block_until_ready(fn(scene, cam, make_film(SIZE, SIZE), jnp.int32(0)))
    t0 = time.perf_counter()
    film = jax.block_until_ready(fn(scene, cam, film, jnp.int32(1)))
    ph.add("run_s", time.perf_counter() - t0)
    ph.add("rays", "not counted by render_pass_vcm")

    # the light phase of the same pass, to count the photons it stores
    n = vpp.width * vpp.height

    def photons(s, c, p):
        stream = make_stream(jnp.arange(n, dtype=jnp.uint32), p, seed=vpp.seed + 0x5EC)
        vertices, _, _ = _trace_light_phase(s, meta, c, stream, vcm, n, 0.0, 0.0)
        return jnp.sum(vertices.valid)

    n_ph = int(jax.jit(photons)(scene, cam, jnp.int32(1)))
    ph.check("photons_stored", int(n_ph > 0), "==", 1)
    ph.add("photons", n_ph)
    ph.check("film_finite", int(bool(jnp.all(jnp.isfinite(film.sum)))), "==", 1)
    ph.done()


# --------------------------------------------------------------------------
# one card: agreement


def _wavefronts(scene, cam):
    """SIZE^2 camera rays (262,144 at 512^2), and the cosine bounce from
    their hits (misses keep their camera ray)."""
    from raytracer_tpu.math.sampling import build_onb, local_to_world, sample_hemisphere_cos
    from raytracer_tpu.math.vec import dot, where as vwhere
    from raytracer_tpu.ops.bvh_traverse import bvh_closest_hit, eval_tri_frame
    from raytracer_tpu.ops.intersect import BIG, Hits
    from raytracer_tpu.render.renderer import pixel_grid
    from raytracer_tpu.sampler.sampler import hash_u32, make_stream, u32_to_unit_float
    from raytracer_tpu.scene.camera import generate_rays

    @jax.jit
    def make(scene, cam):
        cx, cy, pids = pixel_grid(SIZE, SIZE)
        rays, _ = generate_rays(cam, cx, cy, make_stream(pids, jnp.int32(0)))
        o, d = rays.origin, rays.dir
        t, tri, u, v = bvh_closest_hit(scene.bvh, scene.tris, o, d, jnp.full(pids.shape, BIG))
        n = pids.shape[0]
        hits = Hits(t=t, prim_id=jnp.full(n, -1, jnp.int32), tri_id=tri, u=u, v=v)
        fr = eval_tri_frame(scene.tris, hits, o, d)
        nrm = vwhere(dot(fr.normal, d) > 0, fr.normal * -1.0, fr.normal)
        tg, bt = build_onb(nrm)
        pid = pids.astype(jnp.uint32)
        u1 = u32_to_unit_float(hash_u32(pid * jnp.uint32(2) + jnp.uint32(1)))
        u2 = u32_to_unit_float(hash_u32(pid * jnp.uint32(2) + jnp.uint32(0x9E3779B9)))
        wi = local_to_world(sample_hemisphere_cos(u1, u2), tg, bt, nrm)
        hit = tri >= 0
        o2 = vwhere(hit, fr.position + nrm * 1e-3, o)
        d2 = vwhere(hit, wi, d)
        return (o, d), (o2, d2)

    cam_w, bounce_w = make(scene, cam)
    return {"camera": cam_w, "bounce": bounce_w}


def _timed(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps


def traversal_phase(log, scene, cam):
    from raytracer_tpu.ops.bvh_traverse import bvh_any_hit, bvh_closest_hit
    from raytracer_tpu.ops.intersect import BIG
    from raytracer_tpu.ops.wave_traverse import wave_any_hit, wave_closest_hit

    wave_c = jax.jit(wave_closest_hit)
    wave_a = jax.jit(wave_any_hit)
    bvh_c = jax.jit(bvh_closest_hit)
    bvh_a = jax.jit(bvh_any_hit)
    for label, (o, d) in _wavefronts(scene, cam).items():
        n = o.x.shape[0]
        ph = Phase(f"traversal_{label}_{n}", log)
        tmax = jnp.full((n,), BIG)
        (tw, iw, _, _, ovf), t_wave = _timed(wave_c, scene.clusters, o, d, tmax)
        (tb, ib, _, _), t_bvh = _timed(bvh_c, scene.bvh, scene.tris, o, d, tmax)
        tw, iw, tb, ib = map(np.asarray, (tw, iw, tb, ib))
        same = iw == ib
        both = same & (ib >= 0)
        rel_t = np.abs(tw - tb) / np.maximum(np.abs(tb), 1e-30)
        tie = (iw >= 0) & (ib >= 0) & (rel_t <= TOL["tie_rel_t"][0])
        ph.add("wave_s", t_wave)
        ph.add("bvh_s", t_bvh)
        ph.add("hit_frac", float(np.mean(ib >= 0)))
        ph.tol("tri_agree", float(np.mean(same)), "tri_agree_min")
        ph.check("non_tie_mismatch", int(np.sum(~same & ~tie)), "==", 0)
        ph.add("ties", int(np.sum(~same & tie)))
        ph.tol("t_rel", float(rel_t[both].max()) if both.any() else 0.0, "t_rel_max")
        ph.check("overflow", int(np.sum(np.asarray(ovf))), "==", 0)

        # any-hit: limits at a random 0.25-0.95 or 1.05-4 x the oracle's
        # closest t (misses: a long finite limit), so no limit sits on a hit
        r = np.random.default_rng(7).uniform(0.0, 1.0, n)
        f = np.where(r < 0.5, 0.25 + 1.4 * r, 1.05 + 2.0 * (r - 0.5) * 2.95)
        lim = jnp.asarray(np.where(ib >= 0, f * tb, 1e3).astype(np.float32))
        (aw, aovf), ta_wave = _timed(wave_a, scene.clusters, o, d, lim)
        ab, ta_bvh = _timed(bvh_a, scene.bvh, scene.tris, o, d, lim)
        aw, ab = np.asarray(aw), np.asarray(ab)
        ph.add("wave_any_s", ta_wave)
        ph.add("bvh_any_s", ta_bvh)
        ph.check("any_hit_mismatch", int(np.sum((aw != ab) & ~tie)), "==", 0)
        ph.check("any_overflow", int(np.sum(np.asarray(aovf))), "==", 0)
        ph.done()


def render_vs_cpu_phase(log, name, scene, meta, cam):
    """CMP_SIZE^2 x CMP_PASSES on the GPU and on the CPU backend."""
    ph = Phase(f"{name}_vs_cpu_{CMP_SIZE}x{CMP_PASSES}", log)
    gpu = _viewport(scene, meta, cam, CMP_SIZE, 6)
    t0 = time.perf_counter()
    gpu.render(CMP_PASSES)
    a = gpu.radiance()
    ph.add("gpu_s", time.perf_counter() - t0)
    cpu = _cpu()
    with jax.default_device(cpu):
        vc = _viewport(jax.device_put(scene, cpu), meta, jax.device_put(cam, cpu), CMP_SIZE, 6)
        t0 = time.perf_counter()
        vc.render(CMP_PASSES)
        b = vc.radiance()
        ph.add("cpu_s", time.perf_counter() - t0)
    ph.check("finite", int(np.isfinite(a).all() and np.isfinite(b).all()), "==", 1)
    mean_a, mean_b = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    ph.tol("mean_rel", float(np.max(np.abs(mean_a - mean_b) / np.abs(mean_b))), "mean_rel_max")
    q = CMP_SIZE // 4
    da = a.reshape(q, 4, q, 4, 3).mean((1, 3))
    db = b.reshape(q, 4, q, 4, 3).mean((1, 3))
    ph.tol("down4_rel", float(np.abs(da - db).sum() / np.abs(db).sum()), "down4_rel_max")
    ph.add("bit_equal_px_frac", float(np.mean(np.all(a == b, axis=-1))))
    ph.check("overflow", int(gpu.total_overflow + vc.total_overflow), "==", 0)
    ph.done()


def _train_step(scene, meta, cam, vp, params, devices):
    from jax.sharding import NamedSharding, PartitionSpec

    from raytracer_tpu.parallel.mesh import make_mesh, train_step_sharded

    mesh = make_mesh(devices)
    step = jax.jit(lambda s, c, t, p: train_step_sharded(s, meta, c, t, p, vp, params, mesh))
    target = np.zeros((vp.height, vp.width, 3), np.float32)
    args = jax.device_put((scene, cam, target, np.int32(0)), NamedSharding(mesh, PartitionSpec()))
    loss, grads = step(*args)
    return float(loss), [np.asarray(g, np.float64).ravel() for g in grads]


def _cos(a, b):
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(np.dot(a, b) / max(na * nb, 1e-300))


def grads_vs_cpu_phase(log):
    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.render.renderer import ViewportParams

    ph = Phase(f"grads_vs_cpu_cornell_{GRAD_SIZE}_d4", log)
    scene, meta, cam = _cornell()
    vp = ViewportParams(width=GRAD_SIZE, height=GRAD_SIZE, seed=0)
    params = RenderParams(max_depth=4, mis=True)
    lg, gg = _train_step(scene, meta, cam, vp, params, jax.devices()[:1])
    lc, gc = _train_step(scene, meta, cam, vp, params, [_cpu()])
    ph.add("loss_gpu", lg)
    ph.add("loss_cpu", lc)
    ph.check("finite", int(np.isfinite([lg, lc]).all()
                           and all(np.isfinite(g).all() for g in gg + gc)), "==", 1)
    ph.tol("loss_rel", abs(lg - lc) / max(abs(lc), 1e-30), "loss_rel_max")
    for k, a, b in zip(("base_color", "emission", "roughness"), gg, gc):
        ph.tol(f"cos_{k}", _cos(a, b), "grad_cos_min")
    ph.done()


def lookup_phase(log):
    from raytracer_tpu.ops.smallgather import lookup_columns

    ph = Phase("lookup_onehot_vs_gather", log)
    rng = np.random.default_rng(0)
    m = 97
    f = ((1.0 + 2.0 ** -20) * rng.uniform(-3, 3, m)).astype(np.float32)
    f[0] = np.float32(1.0 + 2.0 ** -20)  # not exact in TF32
    i = rng.integers(-(2 ** 23), 2 ** 23, m).astype(np.int32)
    b = rng.uniform(size=m) > 0.5
    idx = rng.integers(0, m, SIZE * SIZE).astype(np.int32)
    got = jax.jit(lookup_columns)(jnp.asarray(idx), [jnp.asarray(c) for c in (f, i, b)])
    bad = sum(int(np.sum(np.asarray(g).view(np.uint8) != c[idx].view(np.uint8)))
              for g, c in zip(got, (f, i, b)))
    ph.check("mismatched_bytes", bad, "==", 0)
    ph.done()


def one_card(log):
    cornell = _cornell()
    render_phase(log, f"cornell_{SIZE}_d6", *cornell, passes=4)

    mscene, mmeta, mcam, gen_s, load_s = _load("mesh200k")
    render_phase(log, f"mesh200k_{SIZE}_d6", mscene, mmeta, mcam, passes=2, trace=True,
                 setup={"builder": _builder_name(), "generate_s": gen_s, "load_s": load_s})
    traversal_phase(log, mscene, mcam)

    iscene, imeta, icam, gen_s, load_s = _load("interior800k")
    render_phase(log, f"interior800k_{SIZE}_d6", iscene, imeta, icam, passes=1,
                 setup={"builder": _builder_name(), "generate_s": gen_s, "load_s": load_s})
    fwd_bwd_phase(log, iscene, imeta, icam)
    vcm_phase(log, "cornell", *cornell)

    render_vs_cpu_phase(log, "cornell", *cornell)
    render_vs_cpu_phase(log, "mesh200k", mscene, mmeta, mcam)
    grads_vs_cpu_phase(log)
    lookup_phase(log)


# --------------------------------------------------------------------------
# four cards


def four_cards(log):
    from raytracer_tpu.integrators.path_tracer import RenderParams
    from raytracer_tpu.integrators.vcm import VcmParams
    from raytracer_tpu.parallel.mesh import (
        film_sharding, make_mesh, render_pass_sharded, render_pass_vcm_sharded,
    )
    from raytracer_tpu.render.film import make_film
    from raytracer_tpu.render.renderer import ViewportParams, _jitted_render_passes

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise Failed(f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    scene, meta, cam, gen_s, load_s = _load("interior800k")
    mesh = make_mesh(devices)
    vp = ViewportParams(width=SIZE, height=SIZE, seed=0)
    params = RenderParams(max_depth=6, mis=True)

    ph = Phase(f"interior800k_{SIZE}_d6_x2_sharded4_vs_one", log)
    ph.add("builder", _builder_name())
    ph.add("generate_s", gen_s)
    ph.add("load_s", load_s)
    fwd = jax.jit(lambda s, c, f, p: render_pass_sharded(s, meta, c, f, p, None, vp, params, mesh))
    film = jax.device_put(make_film(SIZE, SIZE), film_sharding(mesh))
    rays = 0.0
    ovf = 0.0
    t0 = time.perf_counter()
    for p in range(2):
        film, counters = fwd(scene, cam, film, jnp.int32(p))
        rays += float(counters.num_rays + counters.num_shadow_rays)
        ovf += float(counters.num_overflow)
    sharded = np.asarray(film.sum)
    ph.add("sharded_first_call_s", time.perf_counter() - t0)
    one, c1 = _jitted_render_passes(scene, meta, cam, make_film(SIZE, SIZE), jnp.int32(0),
                                    None, vp, params, 2)
    one = np.asarray(one.sum)
    ph.add("rays", int(rays))
    ph.check("rays_gt0", int(rays > 0), "==", 1)
    ph.check("overflow", int(ovf + float(c1.num_overflow)), "==", 0)
    ph.check("rays_equal_one_card", int(rays == float(c1.num_rays + c1.num_shadow_rays)), "==", 1)
    ph.check("film_finite", int(np.isfinite(sharded).all()), "==", 1)
    ph.add("max_abs_diff", float(np.abs(sharded - one).max()))
    ph.add("bit_identical", int(np.array_equal(sharded, one)))
    ph.done(devices)

    ph = Phase(f"interior800k_train_{FB_SIZE}_d4_sharded4_vs_one", log)
    vpt = ViewportParams(width=FB_SIZE, height=FB_SIZE, seed=0)
    pt = RenderParams(max_depth=4, mis=True)
    l4, g4 = _train_step(scene, meta, cam, vpt, pt, devices)
    l1, g1 = _train_step(scene, meta, cam, vpt, pt, devices[:1])
    ph.add("loss_4", l4)
    ph.add("loss_1", l1)
    ph.check("finite", int(np.isfinite([l4, l1]).all()
                           and all(np.isfinite(g).all() for g in g4 + g1)), "==", 1)
    ph.tol("loss_rel", abs(l4 - l1) / max(abs(l1), 1e-30), "shard_loss_rel_max")
    for k, a, b in zip(("base_color", "emission", "roughness"), g4, g1):
        ph.tol(f"cos_{k}", _cos(a, b), "shard_grad_cos_min")
    ph.done(devices)

    ph = Phase(f"interior800k_vcm_{SIZE}_sharded4", log)
    vfn = jax.jit(lambda s, c, f, p: render_pass_vcm_sharded(
        s, meta, c, f, p, vp, params, mesh, VcmParams(max_path_length=6)))
    vfilm = vfn(scene, cam, jax.device_put(make_film(SIZE, SIZE), film_sharding(mesh)), jnp.int32(0))
    ph.check("film_finite", int(bool(jnp.all(jnp.isfinite(vfilm.sum)))), "==", 1)
    ph.done(devices)

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", -1) for d in devices]
    print("[cards] peak_bytes_in_use " + " ".join(f"gpu{d.id}={p}" for d, p in zip(devices, peaks)),
          flush=True)
    if min(peaks) <= 0:
        raise Failed(f"a card did no work: peaks {peaks}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path and its one-card comparison")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}")
    from raytracer_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"[card] {_card_line()}", flush=True)
    print(f"[jax] {jax.__version__} devices={len(jax.devices())} kind={dev.device_kind} "
          f"compile_cache={cache} entries_at_start={entries} "
          f"({'warm' if entries else 'cold'})", flush=True)
    log = CompileLog()
    t0 = time.perf_counter()
    (four_cards if args.four_cards else one_card)(log)
    print(f"[total] wall_s={time.perf_counter() - t0:.3f} compile_s={log.secs:.3f} "
          f"cache_hits={log.hits}/{log.hits + log.misses}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

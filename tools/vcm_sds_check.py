"""Render sds.json with OUR VCM at the golden's pass count (384) and compare
against the reference VCM golden (tests/goldens/sds_vcm.exr): promote the VCM image-level parity test out of xfail if the
divergence was a pass-count (merge-radius schedule) artifact.
"""
import sys, warnings
import numpy as np

sys.path.insert(0, ".")

from raytracer_tpu.integrators.path_tracer import RenderParams
from raytracer_tpu.integrators.vcm import VcmParams, render_pass_vcm
from raytracer_tpu.io.exr import read_exr
from raytracer_tpu.io.scene_loader import load_scene
from raytracer_tpu.render.film import make_film
from raytracer_tpu.render.renderer import ViewportParams

import jax.numpy as jnp

passes = int(sys.argv[1]) if len(sys.argv) > 1 else 384

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    scene, meta, cam = load_scene(
        "/root/reference/Data/TestScenes/sds.json", data_path="/root/reference/Data"
    )
vp = ViewportParams(width=128, height=128, seed=0)
params = RenderParams(max_depth=8, mis=True)
vcm = VcmParams(max_path_length=8)
film = make_film(128, 128)
import time
t0 = time.time()
for p in range(passes):
    film = render_pass_vcm(scene, meta, cam, film, jnp.int32(p), None, vp, params, vcm)
    if p == 0:
        np.asarray(film.sum)[:1]
        print(f"first pass+compile: {time.time()-t0:.1f}s", flush=True)
ours = np.asarray(film.sum) / passes
print(f"{passes} passes in {time.time()-t0:.1f}s")

g = read_exr("tests/goldens/sds_vcm.exr")
ds = lambda im: im.reshape(32, 4, 32, 4, 3).mean(axis=(1, 3))
go, oo = ds(g), ds(ours)
rel = np.abs(oo - go) / np.maximum(go, 1e-2)
print(f"vs reference VCM golden: mean_rel={float(rel.mean()):.4f} "
      f"ratio={float(oo.mean()/go.mean()):.4f}")
np.save("/tmp/sds_vcm_ours.npy", ours)

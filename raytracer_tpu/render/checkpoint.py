"""Render-state checkpoint / resume.

The reference has no render checkpointing — only asset-level
`BVH::SaveToFile/LoadFromFile` (`Core/BVH/BVH.h:87-88`) and EXR dumps of the
accumulated film (`Bitmap::SaveEXR`).  Its pass-based accumulation is however
*naturally* resumable: the full render state is {sum bitmap, secondary sum,
passes finished, sampler seed} (SURVEY §5).  This framework makes that a
first-class capability: deterministic per-pass sample streams are keyed by
(pixel, pass, dim), so saving the film pytree + pass counter + seed and
reloading it continues the render bit-exactly — including across process
restarts and across different device counts (the film is re-sharded on load).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .film import Film

_FORMAT_VERSION = 1


def save_checkpoint(path: str, film: Film, seed: int, extra: dict | None = None) -> None:
    """Write render state to ``path`` (.npz). Atomic via rename."""
    meta = {"version": _FORMAT_VERSION, "seed": int(seed)}
    if extra:
        meta.update(extra)
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        sum=np.asarray(film.sum),
        secondary_sum=np.asarray(film.secondary_sum),
        num_passes=np.asarray(film.num_passes),
        num_secondary_passes=np.asarray(film.num_secondary_passes),
        meta=json.dumps(meta),
    )
    # np.savez appends .npz if missing
    tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(tmp_real, path)


def load_checkpoint(path: str) -> tuple[Film, int, dict]:
    """Read render state: returns (film, seed, meta)."""
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version: {meta.get('version')}")
        film = Film(
            sum=jnp.asarray(z["sum"]),
            secondary_sum=jnp.asarray(z["secondary_sum"]),
            num_passes=jnp.asarray(z["num_passes"]),
            num_secondary_passes=jnp.asarray(z["num_secondary_passes"]),
        )
    return film, int(meta["seed"]), meta

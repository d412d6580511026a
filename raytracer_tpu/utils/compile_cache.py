"""Persistent XLA compilation cache for the program's entry points.

The integrator is a large scan-of-bounces graph, so compilation is a large
part of every cold run.  Entry points (`cli.main`, `bench.main`,
`chip_smoke.py`, `__graft_entry__`) call :func:`enable_compile_cache` once
before their first compile; the package never does so at import, so library
users and the test suite keep JAX's defaults.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# fixed path inside the checkout: the cache directory is part of the cache
# key, so it must not move between runs
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to the checkout's ``.jax_cache/``.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

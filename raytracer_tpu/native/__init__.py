"""Native (C++) runtime components, loaded via ctypes.

The reference implements its whole runtime in C++; here the JAX/XLA compute
path is Python-traced, and the host-side runtime pieces that are hot at
scene-load / orchestration time are native:

- ``libbvh_builder.so`` — sweep-SAH BVH build + octant link threading
  (`bvh_builder.cpp`), ~100x the numpy builder.

Libraries are compiled from the sources on first use with g++ into the
checkout's git-ignored ``build/native/`` (rebuilt when the source is newer);
no binary is committed.  All callers fall back to the pure-Python
implementation when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_LOCK = threading.Lock()
_LIBS: dict[str, object] = {}


def _compile(src: str, out: str) -> bool:
    # generic x86-64 code: a library built on one host stays loadable on
    # another that shares the checkout
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", out, src]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        import warnings

        warnings.warn(f"native build failed: {res.stderr.decode()[:500]}")
        return False
    return True


def load_library(name: str):
    """Load (building if needed) lib<name>.so; returns None when unavailable."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        lib = None
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
            try:
                lib = ctypes.CDLL(out)
            except OSError:
                lib = None
        if lib is None and os.path.exists(src) and _compile(src, out):
            try:
                lib = ctypes.CDLL(out)
            except OSError:
                lib = None
        _LIBS[name] = lib
        return lib

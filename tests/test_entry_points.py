"""Entry-point plumbing: the persistent compile-cache helper, and the
on-card smoke script refusing to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from raytracer_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def keep_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_dir_defaults_to_checkout(monkeypatch, keep_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable_compile_cache() == path  # fixed, not per run


def test_cache_dir_from_environment_left_to_jax(monkeypatch, tmp_path, keep_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_cache_dir_is_git_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

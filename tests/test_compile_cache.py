"""Compile-cache location: JAX_COMPILATION_CACHE_DIR wins where set;
otherwise a fixed path inside the checkout."""

import os

import jax

from dealii_slod_tpu.utils.runtime import enable_compile_cache


def _cache_dir():
    return jax.config.jax_compilation_cache_dir


def test_env_var_is_honoured(monkeypatch, tmp_path):
    before = _cache_dir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compile_cache("/some/root", ".jax_cache") == str(
        tmp_path / "env")
    assert _cache_dir() == before          # nothing set in code


def test_fixed_path_inside_root(monkeypatch, tmp_path):
    before = _cache_dir()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache(str(tmp_path), ".jax_cache")
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert _cache_dir() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

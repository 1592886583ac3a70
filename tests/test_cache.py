"""Compile-cache directory rule (utils/cache.py)."""

import jax

from scrabblegan.utils import cache


def test_env_dir_wins_and_code_sets_none(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compilation_cache() == str(tmp_path)
        # the directory JAX already uses is left alone
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compilation_cache() == cache.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_CACHE_DIR
        root = cache.DEFAULT_CACHE_DIR.rsplit("/", 1)[0]
        assert open(f"{root}/.gitignore").read().splitlines().count(".jax_cache/") == 1
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

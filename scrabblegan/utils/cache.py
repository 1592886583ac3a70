"""Persistent XLA compilation cache, on every backend.

The bucketed design compiles one train-step specialization per word-length
bucket (SURVEY.md §7 "bounded recompilation"); with the persistent cache that
is a first-run-only cost — later processes (resume, infer, tests) load the
compiled executables from disk.

Where: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it itself, and
no other directory is set here); otherwise `.jax_cache/` at the root of the
checkout, which .gitignore lists.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on; returns its directory. Programs that
    compile faster than min_compile_secs are not cached."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return cache_dir

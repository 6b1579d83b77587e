"""Where JAX's persistent compilation cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache goes to one fixed directory inside the
checkout (``.jax_cache`` at the repository root, listed in
``.gitignore``): the directory is part of the cache key, so a path that
moved between runs would never hit.

Call :func:`enable_compile_cache` before the first compilation.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return CACHE_DIR

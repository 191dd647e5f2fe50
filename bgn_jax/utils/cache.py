"""The one persistent-compilation-cache rule for every entry point.

If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it at import and
nothing here sets another directory.  Otherwise the cache lives at a
fixed path inside the checkout (`.jax_cache` for the GPU entry points,
`.jax_cache_cpu` for the tests): the path is part of the cache key, so a
temporary or per-process directory would never hit."""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(name: str = ".jax_cache",
                         min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent cache; returns the directory in use."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = os.path.join(REPO_ROOT, name)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path

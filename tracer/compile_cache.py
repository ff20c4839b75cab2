"""Persistent XLA compilation cache.

``enable_compile_cache()`` is called by every entry point (``bench.py``,
``chip_smoke.py``, ``python -m tracer.cli``). When ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already reads it and nothing else is set here. Otherwise the
cache goes to a fixed ``<repo>/.jax_cache`` (git-ignored): the cache key
includes the path, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Returns the cache directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

"""Persistent XLA compilation cache.

A cold process compiles every solve graph it meets (seconds to minutes:
the stage-wise H=512 rollout is the longest).  JAX's persistent
compilation cache keeps those executables across processes.  Every CLI,
bench and script entry point calls :func:`enable_persistent_cache`
first.  The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it
is set, and otherwise at the fixed ``<repo>/.jax_cache`` (the path is
part of the cache key, so it never moves).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache at
    :func:`default_cache_dir` (created if needed) and return the path.
    Safe to call multiple times and after backend init."""
    import jax

    path = default_cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path

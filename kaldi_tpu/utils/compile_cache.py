"""Persistent XLA compilation cache location.

The decode, training and streaming programs take tens of seconds to
compile; a persistent cache lets a later process reuse them. The cache
key includes the directory, so it must not move between runs.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and
nothing here touches the cache. Otherwise the cache lives at one fixed
directory inside the checkout (`.jax_cache/`, listed in .gitignore).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation."""
    env_dir = os.environ.get(ENV)
    if env_dir:
        return env_dir
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return DEFAULT_DIR

"""Persistent XLA compile cache, shared by every entry point.

A cold process compiles each search and build step again, which on the GPU
costs tens of seconds per step. JAX's persistent cache keeps the compiled
programs between processes; its directory is part of what a later run has to
find again, so it is a fixed path and never one made from a temporary name,
a process id or the time.
"""

from __future__ import annotations

import os

import jax

# <repo>/.jax_cache (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed; otherwise the cache lives at :data:`DEFAULT_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

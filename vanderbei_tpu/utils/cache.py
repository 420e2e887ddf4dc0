"""Persistent XLA compilation cache.

A cold solve spends most of its time compiling the solver loops, so the
cache lets a re-run skip that.  It is opt-in per entry point (bench.py,
evaluate, the CLI, chip_smoke.py — the device-bound paths) rather than
global: CPU test runs would otherwise fill it with host-specific AOT objects
whose machine-feature stamps can differ from the executing host.

The cache lives where JAX_COMPILATION_CACHE_DIR says, or else at the fixed
path <checkout>/.jax_cache (the path is part of the cache key, so it must
not move).  `.gitignore` lists .jax_cache, so every fresh checkout starts
cold.
"""

from __future__ import annotations

import os

import jax


def default_cache_dir() -> str:
    return os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache"))


def enable_persistent_cache(path: str | None = None) -> str:
    """Point XLA's persistent compilation cache at `path` (default:
    default_cache_dir()) and return it."""
    path = path or default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path

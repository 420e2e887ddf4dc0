"""Profiling helpers.

The reference's profiling is bespoke stdout counters (nonz(L), arithmetic
op counts, clock()-based refactor timing — SURVEY.md section 5).  Here:

- `trace(dir)`: context manager around jax.profiler for device traces;
- `time_fn(fn, *args, reps=...)`: best-of-reps wall timing of a jitted
  function, each rep ended by block_until_ready.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, reps: int = 3, warmup: int = 1, **kwargs):
    """Best-of-reps wall seconds for fn(*args) after `warmup` calls.

    Returns (best_seconds, last_result).
    """
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        jax.block_until_ready(result)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        jax.block_until_ready(result)
        best = min(best, time.perf_counter() - t0)
    return best, result

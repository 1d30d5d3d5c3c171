"""Runtime configuration knobs (trace-time constants).

``time_parallel``: route Kalman recursions through the associative-scan
(parallel-in-time) implementations — O(log n) depth instead of O(n)
sequential steps.  Wins when chains x state-dim underfills the device (few
chains / long series); the sequential scan wins when thousands of vmapped
chains already saturate it.  Changing the flag requires retracing (new jit
cache entries), which happens automatically on the next call.
"""
from __future__ import annotations

import contextlib
import os

time_parallel: bool = False

# fixed default location of JAX's persistent compilation cache: the path is
# part of the cache key, so a directory that moves never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".xla_cache")


def set_time_parallel(value: bool) -> None:
    global time_parallel
    time_parallel = bool(value)


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this sets no directory; otherwise the cache goes to
    ``DEFAULT_CACHE_DIR`` (``<repo>/.xla_cache``)."""
    import jax
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache_dir


@contextlib.contextmanager
def parallel_time(value: bool = True):
    global time_parallel
    old = time_parallel
    time_parallel = bool(value)
    try:
        yield
    finally:
        time_parallel = old

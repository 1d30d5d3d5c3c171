"""Structured timing + device profiler hooks.

The reference's only instrumentation is `proc.time()` around each run
(`/root/reference/R/run_mcmc.R:207,270`); the rebuild's equivalent
(SURVEY.md §5.1) is structured per-phase wall timing (`McmcOutput.time`)
plus optional XLA profiler capture for kernel-level analysis.

    with profile_trace("/tmp/tb"):            # view in TensorBoard/xprof
        out = run_mcmc(model, ...)

    timer = PhaseTimer()
    with timer("mcmc") as phase:
        out = run_chains(...)
        phase.sync(out)                       # block on the result BEFORE
    timer.report(samples=chains * iters)      # the clock stops (async
                                              # dispatch would otherwise
                                              # undercount device time)
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """Capture an XLA profiler trace around the block (no-op when ``logdir``
    is None).  The trace records device kernels, fusion boundaries and
    host<->device transfers — open with TensorBoard's profile plugin."""
    if logdir is None:
        yield
        return
    import jax
    with jax.profiler.trace(logdir):
        yield


class _PhaseHandle:
    """Collects pytrees produced INSIDE a timed block; everything registered
    via ``.sync(x)`` is block_until_ready'd before the phase clock stops."""

    def __init__(self):
        self._items = []

    def sync(self, x):
        self._items.append(x)
        return x


class PhaseTimer:
    """Accumulating named wall-clock phases (device-synchronised)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        """Time a block.  The context yields a handle: call ``handle.sync(
        out)`` on results produced inside the block (or pass pre-existing
        arrays as ``sync=``); both are block_until_ready'd before the clock
        stops so JAX async dispatch doesn't hide device time."""
        handle = _PhaseHandle()
        if sync is not None:
            handle.sync(sync)
        t0 = time.time()
        try:
            yield handle
        finally:
            if handle._items:
                import jax
                jax.block_until_ready(handle._items)
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def report(self, samples: Optional[int] = None) -> Dict[str, float]:
        out = dict(self.phases)
        out["total"] = self.total
        if samples is not None and self.total > 0:
            out["samples_per_s"] = samples / self.total
        return out

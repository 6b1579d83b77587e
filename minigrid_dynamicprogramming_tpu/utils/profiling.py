"""Tracing / profiling layer (SURVEY §5).

The reference's only instrumentation is wall-clock FPS loops
(/root/reference/minigrid/benchmark.py:13-49) and the bot's BFS counters
(envs/babyai/core/baby_ai_bot.py:596-600).  The device-side equivalents:

- ``trace(logdir)`` — scoped ``jax.profiler`` trace capture.  The resulting
  directory opens in TensorBoard/Perfetto and shows per-HLO time on the
  device timeline (kernel durations, fusion boundaries, transfer stalls).
- ``annotate(name)`` — a named region that shows up inside traces; wraps
  ``jax.profiler.TraceAnnotation`` (host timeline) so framework phases
  (generate / step / obs / verify) are attributable.
- ``KernelTimer`` — per-kernel wall-clock counters with proper device
  synchronization, for the benchmark CLI's per-phase steps/s table and for
  regression tracking without a full trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import jax

__all__ = ["trace", "annotate", "KernelTimer"]


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a ``jax.profiler`` trace of the enclosed block into
    ``logdir`` (view with TensorBoard's profile plugin or Perfetto)."""
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host-timeline region inside a trace."""
    return jax.profiler.TraceAnnotation(name)


class KernelTimer:
    """Accumulates per-kernel wall-clock with device synchronization.

    ``timer.run("step", fn, *args)`` calls ``fn``, blocks on the result, and
    charges the elapsed time to the "step" counter.  ``report(units)``
    returns {name: {"seconds", "calls", "per_s"}} where ``per_s`` divides the
    units-of-work (e.g. env-steps) charged via ``units_per_call``.
    """

    def __init__(self):
        self._seconds: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}
        self._units: Dict[str, float] = {}

    def run(
        self,
        name: str,
        fn: Callable,
        *args,
        units: float = 0.0,
        **kwargs,
    ):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        self._seconds[name] = self._seconds.get(name, 0.0) + dt
        self._calls[name] = self._calls.get(name, 0) + 1
        self._units[name] = self._units.get(name, 0.0) + units
        return out

    @contextlib.contextmanager
    def section(self, name: str, units: float = 0.0):
        """Time an arbitrary block (caller is responsible for any device
        synchronization inside the block)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._seconds[name] = self._seconds.get(name, 0.0) + dt
            self._calls[name] = self._calls.get(name, 0) + 1
            self._units[name] = self._units.get(name, 0.0) + units

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, sec in self._seconds.items():
            units = self._units.get(name, 0.0)
            out[name] = {
                "seconds": round(sec, 6),
                "calls": self._calls[name],
                "per_s": round(units / sec, 1) if sec > 0 and units else 0.0,
            }
        return out

# SPDX-License-Identifier: CECILL-2.1
"""Tracing and per-stage timing.

The reference's observability is wall-clock prints (utils/time.py) and
structured INFO log lines. The device equivalents here:

- :func:`device_trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of XLA execution;
- :class:`StageTimer` — lightweight named-stage wall-clock accumulator for
  pipeline runs (host-side; device work is synchronized at stage ends);
- :func:`annotate` — ``jax.profiler.TraceAnnotation`` wrapper so pipeline
  stages show up by name inside device traces.
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

import jax

logger = logging.getLogger(__name__)

__all__ = ["device_trace", "StageTimer", "annotate"]


@contextlib.contextmanager
def device_trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a device profile into ``log_dir`` (TensorBoard format)."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Name a region inside a device trace."""
    with jax.profiler.TraceAnnotation(name):
        yield


@dataclass
class StageTimer:
    """Accumulate wall-clock time per named pipeline stage.

    Usage::

        timer = StageTimer()
        with timer.stage("metrics"):
            ...
        with timer.stage("tracking"):
            ...
        timer.report()
    """

    sync: bool = True
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with jax.profiler.TraceAnnotation(name):
                yield
        finally:
            if self.sync:
                try:
                    jax.effects_barrier()
                except Exception:
                    pass
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, *, log: bool = True) -> dict[str, float]:
        """Return {stage: seconds}; optionally log one line per stage."""
        if log:
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
                logger.info(
                    "> stage %-20s %8.3f s  (%d calls)",
                    name, total, self.counts[name],
                )
        return dict(self.totals)

"""Profiling hooks: JAX profiler traces and wall-clock timing.

The counterpart of the reference's (absent) tracing story: wrap any codec
call in :func:`trace` to capture a full XLA/device profile viewable in
TensorBoard/Perfetto, or :func:`timed` for lightweight wall-clock stats.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX profiler trace of the enclosed block::

        with utils.trace("/tmp/ect_trace"):
            frame.decompress(comp)

    The trace includes every XLA/Pallas kernel launch with device
    timelines; open with TensorBoard's profile plugin or Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class TimedResult:
    name: str
    seconds: float
    nbytes: int | None = None

    @property
    def throughput(self) -> float | None:
        if self.nbytes is None or self.seconds <= 0:
            return None
        return self.nbytes / self.seconds

    def __str__(self) -> str:
        s = f"{self.name}: {self.seconds*1e3:.2f} ms"
        if self.throughput is not None:
            s += f" ({self.throughput/1e6:.1f} MB/s)"
        return s


@contextlib.contextmanager
def timed(name: str, nbytes: int | None = None, results: list | None = None):
    """Wall-clock a block; appends a TimedResult to ``results`` if given."""
    t0 = time.perf_counter()
    r = TimedResult(name, 0.0, nbytes)
    try:
        yield r
    finally:
        r.seconds = time.perf_counter() - t0
        if results is not None:
            results.append(r)

"""Utilities: profiling hooks and codec metrics.

The reference has no tracing/metrics subsystem (SURVEY.md §5 — only
commented-out prints and unused perf-event dev-deps); the equivalents
live here: JAX profiler trace capture around codec calls and
frame-level statistics for observability.
"""

from .profiling import trace, timed
from .metrics import frame_stats

__all__ = ["trace", "timed", "frame_stats"]

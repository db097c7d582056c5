"""Tracing / profiling hooks.

The reference's observability stack is compile-time stat counters
(RECORD_STATS num_distcomps / total_query_time,
src/antitopo_engine.h:125-129) plus external callgrind/perf toggles around
the query loop (src/basic_bench.h:76-77,128-129).  Equivalents here:

  * the stat counters live on the engine (num_distcomps,
    num_distcomps_compressed, total_query_time_ns — see models/antitopo.py)
    and are carried out of the jitted kernels as explicit outputs,
  * ``trace(...)`` wraps a code region in a ``jax.profiler`` trace — the
    replacement for the callgrind toggles; open the resulting
    directory with TensorBoard or xprof to see per-kernel HLO timings.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/expann_tpu_trace", enabled: bool = True):
    """Profile a region: with trace("/tmp/tb"): eng.query_k_batch(...)"""
    if not enabled:
        yield
        return
    import jax

    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Name a region inside a trace (shows up in the xprof timeline)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield

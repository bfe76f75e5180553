"""Tracing / profiling helpers.

The reference's observability is std::chrono phase prints (mart.cc:216-258,
svml.cc:190-196) plus an opt-in traversal counter (rtnode.h:53-56).  The
Equivalents: wall-clock phase timers for host-side orchestration
and ``jax.profiler`` traces for device timelines (viewable in TensorBoard /
Perfetto).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None, verbose: bool = True):
    """Wall-clock a phase; optionally record into ``sink[name]`` seconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose:
            print(f"# [{name}] {dt:.3f} s")


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/quickrank_tpu_trace"):
    """Capture a jax.profiler device trace around a code block.

    View with TensorBoard (`tensorboard --logdir <dir>`) or upload the
    .trace.json.gz to Perfetto.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()

"""Structured per-stage timing + optional device tracing.

The reference's only observability is scattered ``print`` statements
(SURVEY.md §5); here every pipeline stage is timed through one registry
that can emit a structured JSON report, and a whole run can be wrapped in a
``jax.profiler`` trace for TensorBoard/Perfetto.

Usage::

    from oisat.utils.profiling import stage, report, device_trace

    with stage("regrid", granule=fname):
        ...
    print(report())                     # JSON summary per stage
    with device_trace("/tmp/trace"):    # XLA device trace (optional)
        run_month(...)
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

__all__ = ["stage", "report", "reset", "device_trace", "log"]

_lock = threading.Lock()
_stats = defaultdict(lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0})
_enabled = True


def log(msg: str, **fields):
    """One structured log line (stdout, JSON when fields present)."""
    if fields:
        print(msg + " " + json.dumps(fields, default=str))
    else:
        print(msg)


@contextlib.contextmanager
def stage(name: str, sync=None, **fields):
    """Time a pipeline stage.  ``sync``: optional array/pytree to block on
    before stopping the clock (device work is async)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            import jax

            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[name]
            s["count"] += 1
            s["total_s"] += dt
            s["max_s"] = max(s["max_s"], dt)


def report() -> str:
    """JSON report of all recorded stages (sorted by total time)."""
    with _lock:
        items = sorted(_stats.items(), key=lambda kv: -kv[1]["total_s"])
        return json.dumps(
            {k: {**v, "total_s": round(v["total_s"], 4), "max_s": round(v["max_s"], 4)}
             for k, v in items}, indent=2)


def reset():
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Wrap a block in a jax.profiler trace (view in TensorBoard/Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

"""Profiling / observability helpers (SURVEY.md §5.1).

The reference's instrumentation is host frame-time EMA (engine.rs:180-201),
BVH build stats (bvh.rs:474-530), and per-pixel traversal counters rendered
as heatmaps (debug modes 5-7). We keep all three (FrameTiming, BVHStats, and
the stats channel in kernels/traverse.py) and add device-level tooling:
``jax.profiler`` traces for XLA-level kernel timing and device-memory stats.
"""
from __future__ import annotations

import contextlib
import logging

log = logging.getLogger(__name__)


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/rt2_trace"):
    """Capture a jax.profiler trace around a block; view with TensorBoard or
    xprof. Usage::

        with profile_trace("/tmp/trace"):
            renderer.render(scene, params)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)


def device_memory_stats() -> dict:
    """Per-device memory stats (bytes) where the backend exposes them."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
        except Exception:
            s = None
        if s:
            out[str(d)] = dict(
                bytes_in_use=s.get("bytes_in_use"),
                peak_bytes_in_use=s.get("peak_bytes_in_use"),
                bytes_limit=s.get("bytes_limit"),
            )
    return out

"""Profiling annotations.

PyTorch counterpart of ``aligator_tpu/utils/profiling.py`` (the
reference's Tracy zones, ``ALIGATOR_TRACY_ZONE_SCOPED``): named ranges,
``torch.profiler.record_function``, that show in a ``torch.profiler``
trace (host-side events, with the device kernels launched inside them),
and :func:`trace_to`, which records a block and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``). A range costs a few
microseconds of host time when no profiler is recording.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


def zone(name: str):
    """Context manager marking a trace zone (Tracy's ZoneScopedN)."""
    return torch.profiler.record_function(name)


def annotate(name: str | None = None):
    """Decorator running a function inside a named trace zone (its
    qualified name by default)."""

    def deco(fn):
        zname = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(zname):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile a block (the host and, where a card is present, its
    kernels) and write a Chrome trace ``trace_<time>.json`` under
    ``logdir``; yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))

"""Profiling hooks.

Port of ``two_tower_models_tpu/utils/profiling.py``: ``trace(dir)`` records
the enclosed region with ``torch.profiler`` (host and, where a GPU is
present, device activity) and writes a Chrome trace into ``dir`` (open it
in Perfetto or ``chrome://tracing``); ``annotate(name)`` labels a region
on that timeline.  Both cost nothing when no trace is recording.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Record the enclosed region when a directory is given, and write it
    to ``<profile_dir>/trace_<pid>_<ns>.json``; a no-op otherwise."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


def annotate(name: str):
    """A named range on the profiler's timeline (around tower or loss
    regions)."""
    return torch.profiler.record_function(name)

"""Profiling: torch.profiler traces, named ranges and a stage timer.

The reference uses OTel spans and a per-stage latency report; the port
adds ``torch.profiler`` traces (host ranges and, on the card, CUDA kernels,
viewable in Perfetto or chrome://tracing) around any code region, named
ranges (``annotate``) that the serving path marks its stages with, and a
lightweight stage timer that feeds the rolling-window report the pipeline
exposes.

The port's copy of ``advanced_rag_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU ranges, and CUDA kernels when there is a
    card) and write a Chrome trace ``trace_<pid>_<ns>.json`` under
    ``log_dir``; yields the profiler, whose ``key_averages()`` sum the
    ranges and kernels by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in a trace (``torch.profiler.record_function``); also
    a decorator.  With no profiler running it records nothing and skips
    ``record_function``, whose enter and exit cost tens of microseconds
    even then (the serving path carries several ranges a batch)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Rolling-window stage timer (reference pipeline.py:406-412 shape)."""

    def __init__(self, window: int = 1000):
        self.window = window
        self._samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            window = self._samples.setdefault(name, [])
            window.append(ms)
            if len(window) > self.window:
                del window[: len(window) - self.window]

    def report(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for name, vals in self._samples.items():
            arr = np.asarray(vals)
            out[name] = {
                "p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99)),
                "count": len(vals),
            }
        return out


__all__ = ["device_trace", "annotate", "StageTimer"]

"""Profiling and tracing hooks on ``torch.profiler`` (the JAX package's
``utils/profiling.py``).

* :func:`trace` — a context manager that records the CPU and, where a
  card is present, the CUDA activity, and exports a Chrome trace
  (``*.pt.trace.json``) into ``log_dir``;
* :func:`annotate` — a named range (``record_function``) so layers and
  phases are attributable in traces;
* :func:`device_busy_s` / :func:`traced_device_s` — the device's busy
  seconds in a trace: the union of its kernel, memcpy and memset spans;
* :class:`StepTimer` — wall-clock phase timing (TTFT and tokens per
  second come from ``server/metrics.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

#: the Chrome-trace event categories that are device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the body; its Chrome trace is written to
    ``log_dir/<pid>-<time>.pt.trace.json`` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{os.getpid()}-{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """``with annotate("block/attn"):`` — a named range in the trace."""
    return torch.profiler.record_function(name)


def device_busy_s(log_dir: str) -> Optional[float]:
    """Device busy time (seconds) in the NEWEST ``*.pt.trace.json`` under
    ``log_dir``: the union of the complete events (``ph == "X"``) whose
    category is a device kernel, memcpy or memset. Union, not sum, so
    spans that overlap (kernels on two streams) count once. None when
    there is no trace or it holds no device span."""
    import glob
    import json

    paths = sorted(glob.glob(f"{log_dir}/**/*.pt.trace.json",
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return None
    with open(paths[-1]) as f:
        ev = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("ph") == "X" and e.get("dur")
                   and e.get("cat", "").lower() in DEVICE_CATEGORIES)
    total, end = 0.0, float("-inf")
    for s, t in spans:
        if s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1e6 if total else None


def traced_device_s(fn, log_dir: Optional[str] = None) -> Optional[float]:
    """Run ``fn()`` under a profiler trace and return the device busy
    seconds (None if tracing is unavailable — never raises)."""
    import shutil
    import tempfile

    d = log_dir or tempfile.mkdtemp(prefix="devtrace-")
    try:
        with trace(d):
            fn()
        return device_busy_s(d)
    except Exception:
        return None
    finally:
        if log_dir is None:
            shutil.rmtree(d, ignore_errors=True)


class StepTimer:
    """Accumulates per-phase wall time; blocking is the caller's job."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 6),
                    "mean_ms": round(v / self.counts[k] * 1e3, 3),
                    "count": self.counts[k]}
                for k, v in self.totals.items()}

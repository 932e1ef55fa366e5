"""Profiling and observability utilities (counterpart of
``dvo_slam_tpu/utils/stats.py``).

Equivalent of the reference's tracing subsystem (SURVEY.md §6):
dvo_core/include/dvo/util/stopwatch.h (stopwatch / stopwatch_collection —
static per-section timers around the dense-tracking loop) and the
per-frame Stats structs of DenseTracker::Result.

Device timing respects asynchronous CUDA launches: register a section's
device outputs with the yielded handle (``with watch.section("x") as s:
r = s.block_on(f())``) and the exit waits for their devices, so the
section measures device latency, not launch time. For kernel-level
profiles use ``trace(...)`` (torch.profiler; a Chrome trace).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch


def _cuda_devices(x, out):
    """The CUDA devices of every tensor in a (nested) tuple, list, dict or
    NamedTuple."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


class _Section:
    """Handle yielded by Stopwatch.section: register the section's device
    outputs so the exit waits for them (a CUDA launch returns before the
    device finishes — without waiting, the section would record launch
    time, not device latency)."""

    def __init__(self):
        self._outputs = []

    def block_on(self, x: Any) -> Any:
        """Register a (nest of) tensor(s) to wait for at section exit;
        returns the argument for inline use."""
        self._outputs.append(x)
        return x


class Stopwatch:
    """Named section timers (reference stopwatch_collection).

    with watch.section("track") as s:
        res = s.block_on(track(...))   # exit waits for the device result
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, block_on: Any = None):
        handle = _Section()
        if block_on is not None:  # pre-existing operands, if any
            handle._outputs.append(block_on)
        start = time.perf_counter()
        try:
            yield handle
        finally:
            for device in _cuda_devices(handle._outputs, set()):
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - start
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:30s} {s['count']:6d} x {s['mean_ms']:9.3f} ms "
                f"= {s['total_s']:8.3f} s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host activity, and the card's when
    there is one); writes ``log_dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameLogger:
    """Structured per-frame jsonl logging (reference ROS_INFO + Stats).

    Each record carries the tracking statistics the reference exposes via
    DenseTracker::Result::Statistics and the SLAM events (keyframe
    switches, loop closures).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "w") if path else None
        self.records = []

    def log(self, **fields):
        rec = {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in fields.items()
        }
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

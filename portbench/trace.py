"""The traced run's records: the harness's spans on the host and every
device record (kernels, copies, fills) of a ``torch.profiler`` session
over a steady sub-window of the measured window, with what the traffic
driver says of that sub-window (frames, sequences, how the level kernel's
rows read their slabs).

Per-layer readers (``portbench/metrics/<name>.py``) take a ``Trace``;
``breakdown`` gives the result line's device operations and idle gaps.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import NamedTuple

# The harness's spans around its calls into the program.
SPANS = ("engine.new", "engine.submit_chunk", "engine.collect_chunk",
         "engine.finish", "fleet.track", "fleet.readback")
WINDOW_SPAN = "window.traced"


def null_span(name):
    """A span that records nothing (set-up's warm-up)."""
    return contextlib.nullcontext()


class Record(NamedTuple):
    name: str
    start: float  # us, the profiler's clock
    end: float
    meta: dict  # the kernel's launch record (grid, block, ...), or {}


class Trace(NamedTuple):
    device: list  # Record of every device record inside the window
    spans: list  # Record of every harness span inside the window
    window: tuple  # (start_us, end_us) of the traced sub-window
    info: dict  # the traffic driver's account of the sub-window

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6


class Tracer:
    """Spans and the profiler session of one run. Off (``--trace 0``):
    spans cost nothing and nothing is recorded. On: ``start`` and ``stop``
    bound the traced sub-window, where each span is a
    ``record_function`` range."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.window = None  # [start_us, end_us] on the wall clock
        self._window_range = None
        self.info = {}

    def span(self, name):
        if self.on:
            from torch.profiler import record_function

            return record_function(name)
        return null_span(name)

    @property
    def active(self):
        return self._window_range is not None

    @property
    def owed(self):
        """On, and the sub-window not yet recorded: the window runs on."""
        return self.on and (self.prof is None or self.active)

    def start(self):
        """Open the session: a warm-up step (one device op, its records
        dropped, so that no launch of the sub-window falls in the tracer's
        first milliseconds), then the sub-window."""
        if not self.on or self.prof is not None:
            return
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        self.prof.step()
        self._window_range = record_function(WINDOW_SPAN)
        self._window_range.__enter__()
        self.window = [time.time_ns() / 1e3, None]

    def stop(self, **info):
        """Close the sub-window, with the driver's account of it."""
        if not self.active:
            return
        import torch

        torch.cuda.synchronize()
        self.window[1] = time.time_ns() / 1e3
        self._window_range.__exit__(None, None, None)
        self._window_range = None
        self.prof.stop()
        self.info = info

    def trace(self) -> Trace:
        """The session's records, inside the sub-window."""
        from torch.autograd import DeviceType

        events = list(self.prof.profiler.kineto_results.events())
        grids = _kernel_grids(self.prof)
        # The sub-window on the host's wall clock, the profiler's time base.
        w0, w1 = self.window
        skip = set(SPANS) | {WINDOW_SPAN}
        device, spans = [], []
        for e in events:
            s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
            if t < w0 or s > w1:
                continue
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if name in SPANS:
                    spans.append(Record(name, s, t, {}))
            elif (e.device_type() == DeviceType.CUDA and name not in skip
                  and not name.startswith("ProfilerStep")):
                grid = grids.get(e.correlation_id())
                device.append(Record(name, max(s, w0), min(t, w1),
                                     {"grid": grid} if grid else {}))
        device.sort(key=lambda r: r.start)
        spans.sort(key=lambda r: r.start)
        return Trace(device, spans, (w0, w1), self.info)


def _kernel_grids(prof):
    """{correlation id: [x, y, z]} of every kernel launch in the session:
    the grid is in the session's exported trace (the events' own
    metadata leaves it out). The export goes to a temporary file, read and
    removed here."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "kernel" and "grid" in args:
            out[args.get("correlation")] = args["grid"]
    return out


def intervals_union_us(records):
    """Microseconds covered by at least one record."""
    busy, end = 0.0, float("-inf")
    for r in sorted(records, key=lambda r: r.start):
        if r.end > end:
            busy += r.end - max(r.start, end)
            end = r.end
    return busy


def busy_s(trace: Trace):
    return intervals_union_us(trace.device) * 1e-6


def _gaps(trace: Trace):
    """(start, end) of every stretch of the window with no device
    record."""
    out, t = [], trace.window[0]
    for r in sorted(trace.device, key=lambda r: r.start):
        if r.start > t:
            out.append((t, r.start))
        t = max(t, r.end)
    if trace.window[1] > t:
        out.append((t, trace.window[1]))
    return out


def _host_at(trace: Trace, t):
    """The innermost harness span open on the host at time t."""
    held = [s for s in trace.spans if s.start <= t <= s.end]
    if not held:
        return "harness"
    return min(held, key=lambda s: s.end - s.start).name


def breakdown(trace: Trace, top=10):
    """The device operations that took most time, summed by name, and the
    longest idle gaps, each named by the harness span open on the host
    where it began: [[name, seconds], ...] each."""
    by_name = {}
    for r in trace.device:
        by_name[r.name] = by_name.get(r.name, 0.0) + (r.end - r.start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_at(trace, a), (b - a) * 1e-6]
                          for a, b in gaps]}

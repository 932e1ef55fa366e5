"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

A cell is found by name, from files alone: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``: the generator that reads it, ``traffic/
<driver>.py`` with its ``Driver`` class, and its parameters), and holds
the limit of each number the check compares. The per-layer metrics of a
traced run are every reader in ``metrics/`` that finds something to read
in the trace.

The result line (standard output, last line) holds ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit. The same numbers are the last lines on standard error.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Top-level modules the process may not hold once the window has closed.
BANNED = ("jax", "jaxlib", "flax", "dvo_slam_tpu")


class RunError(Exception):
    """A run that prints no result."""


def load_cell(name):
    """The cell's workload file with its configuration and its traffic
    mix's generator (``driver``) and parameters (``params``) inlined."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no workload file {path}")
    cell = json.loads(path.read_text())
    cell["name"] = name
    cell["config"] = json.loads(
        (HERE / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    cell["driver"], cell["params"] = mix["driver"], mix["params"]
    return cell


def metric_readers():
    """{name: module} of every per-layer reader in metrics/."""
    return {p.stem: importlib.import_module(f"portbench.metrics.{p.stem}")
            for p in sorted((HERE / "metrics").glob("*.py"))
            if not p.stem.startswith("_")}


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def p95(values):
    """The 95th percentile of all values (linear between order
    statistics)."""
    v = sorted(values)
    x = 0.95 * (len(v) - 1)
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def card_note():
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run(cell, seed, seconds, trace, t_start, device="cuda", log=sys.stderr):
    """One run: returns the result dict (the caller prints it)."""
    import torch

    from portbench.reference import full_float32
    from portbench.trace import Tracer, breakdown, busy_s

    cell = dict(cell, seed=seed)
    driver_mod = importlib.import_module(f"portbench.traffic.{cell['driver']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = driver_mod.Driver(cell, device=device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"# {cell['name']}: set-up {setup_s:.1f} s", file=log, flush=True)
    tracer = Tracer(bool(trace))
    window = driver.run(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    leaked = banned_modules()
    if leaked:
        raise RunError(f"the process holds {leaked} after the window")
    trace_breakdown = None
    if trace:
        tr = tracer.trace()
        metrics = {}
        for name, mod in metric_readers().items():
            value = mod.read(tr)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        extra = {"busy_s": busy_s(tr), "window_s": tr.window_s}
        trace_breakdown = breakdown(tr)
        tracer.prof = None
    else:
        metrics = {
            "fps": {"value": window["returned"] / window["window_s"],
                    "unit": "frames/s"},
            "pose_latency_ms_p95": {
                "value": 1e3 * p95(window["latencies_s"]), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        extra = {}
    t_check = time.perf_counter()
    with full_float32():
        values = driver.check(window)
    check_s = time.perf_counter() - t_check
    limits = cell["limits"]
    if set(values) != set(limits):
        raise RunError(f"checks {sorted(values)} against limits "
                       f"{sorted(limits)}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(values[k] <= limits[k] for k in limits)
    leaked = banned_modules()
    if leaked:
        raise RunError(f"the process holds {leaked}")
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": cell.get("chips", 1), "memory_peak_bytes": peak,
                  **extra}
    notes = dict(getattr(driver, "notes", {}), window_s=window["window_s"],
                 setup_s=setup_s, check_s=check_s,
                 card=card_note() if cuda else "cpu")
    print(f"# {cell['name']} seed {seed}: {json.dumps(notes)}", file=log)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return {"correct": bool(correct), "attempted": window["attempted"],
            "failed": window["failed"], "metrics": metrics,
            "device": device_rec,
            **({"breakdown": trace_breakdown} if trace else {}),
            "checks": checks}

"""The point-budget paths (TrackerConfig.point_budget_fraction > 0) of one
or more source trees, timed in turns on one card.

    python3 tests/torch_budget_ab.py TREE [TREE ...] [--rounds 2]

A TREE is the root of a checkout of this repository: ``.``, or a ``git
archive`` of another commit unpacked into a directory that .gitignore
lists. Each round runs the trees in turn, each in a child process that
imports that tree's dvo_slam_tpu_torch and chip_smoke (and builds that
tree's kernels under its own build/), every other round in reverse order
(A B, B A, ...). The child runs, at chip_smoke's settings:

- odometry (phase 10a): OdometryTracker over chip_smoke's 24-frame
  640x480 orbit at intensity_grad_threshold COMPACT_THRESHOLD, on the
  full grid and at point_budget_fraction COMPACT_BUDGET, a warm-up run
  then a timed one each: ms/frame after N_WARMUP frames (host clock
  around frames ending in a device sync), and the timed run's
  prepare_reference calls, pyramid and level launches;
- the offline cell (phases 6b and 6i): benchmark.run_tum_dataset in slam
  mode over bench/accuracy.py's noisy 640x480 loop (OFFLINE_FRAMES frames
  on disk, rendered once by this script into build/budget_ab/seq) with
  the CLI's `benchmark --fr 1` flags, on the full grid and at
  point_budget_fraction OFFLINE_BUDGET: engine fps, and the budget run's
  prepare_reference calls and level launches;
- the chunked engine (phases 8 and 10d): ChunkedKeyframeSlam over the
  640x480 ring in chunks of CHUNK (a forced keyframe before every chunk
  but the first, a depth-2 pipeline), SLAM_FRAMES frames on a warm-up
  instance then SLAM_FRAMES timed on a fresh one, on the full grid and at
  COMPACT_BUDGET: ms/frame, and the budget run's prepare_reference calls
  and scan-step launches.

Prints the card's name and power limit, a line per tree and round, then
per case each tree's median. Needs a card. Not a test: pytest does not
collect it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import dataclasses, json, sys, time
import numpy as np
import torch
import chip_smoke as s
from dvo_slam_tpu_torch import SlamConfig, TrackerConfig, benchmark, cli
from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
from dvo_slam_tpu_torch.models.odometry import OdometryTracker
from dvo_slam_tpu_torch.ops import camera, linearize, pyramid, scan_step
from dvo_slam_tpu_torch.utils import synthetic

seq = sys.argv[1]
dev = torch.device("cuda", 0)
out = {}


def counts():
    return {"prepare_reference": linearize.PREPARE_REFERENCE_CALLS,
            "track_level": linearize.LAUNCHES_TRACK_LEVEL,
            "pyramid": pyramid.LAUNCHES_PYRAMID,
            "scan_step": scan_step.LAUNCHES_SCAN_STEP}


def delta(before):
    return {k: v - before[k] for k, v in counts().items()}


full = TrackerConfig(intensity_grad_threshold=s.COMPACT_THRESHOLD)
budget = dataclasses.replace(full, point_budget_fraction=s.COMPACT_BUDGET)

# Odometry (10a).
scene = synthetic.two_plane_scene(sharpness=2.0)
poses = synthetic.orbit_trajectory(s.N_FRAMES, radius=0.06)
frames = synthetic.render_sequence(scene, np.asarray(s.K_TUPLE), s.W, s.H,
                                   poses)
for name, cfg in (("full", full), ("budget", budget)):
    for timed in (False, True):
        tracker = OdometryTracker(s.K_TUPLE, cfg, device=dev)
        before = counts()
        ms = []
        for k, (i, z) in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.update(i, z, float(k))
            torch.cuda.synchronize()
            if k >= s.N_WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
    out[f"odometry {name} ms/frame"] = float(np.mean(ms))
    if name == "budget":
        for k, v in delta(before).items():
            out[f"odometry budget {k} calls"] = v

# The offline cell (6b, 6i).
args = cli._parser().parse_args(["benchmark", seq, *s.OFFLINE_FLAGS])
tracker_cfg, slam_cfg = cli._tracker_cfg(args), cli._slam_cfg(args)
for name, frac in (("full", 0.0), ("budget", s.OFFLINE_BUDGET)):
    before = counts()
    res = benchmark.run_tum_dataset(
        seq, dataclasses.replace(tracker_cfg, point_budget_fraction=frac),
        slam_cfg, mode="slam", intrinsics=camera.TUM_FR1, device=dev)
    out[f"offline {name} fps"] = res.fps
    out[f"offline {name} ATE mm"] = 1e3 * res.ate_rmse_m
    if name == "budget":
        for k, v in delta(before).items():
            out[f"offline budget {k} calls"] = v

# The chunked engine (8, 10d).
ring, _ = s._ring()
for name, cfg in (("full", TrackerConfig()),
                  ("budget", dataclasses.replace(
                      TrackerConfig(),
                      intensity_grad_threshold=s.COMPACT_THRESHOLD,
                      point_budget_fraction=s.COMPACT_BUDGET))):
    for timed in (False, True):
        slam = ChunkedKeyframeSlam(s.K_TUPLE, cfg, SlamConfig(),
                                   enable_loop_closure=True, device=dev)
        slam.init()
        in_flight = 0
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, ii, zz, ts in s._chunks(ring, s.SLAM_FRAMES,
                                       100.0 if timed else 0.0):
            if c > 0:
                slam.force_keyframe()
            slam.submit_chunk(ii, zz, ts)
            in_flight += 1
            if in_flight == 2:
                slam.collect_chunk()
                in_flight -= 1
        while in_flight:
            slam.collect_chunk()
            in_flight -= 1
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / s.SLAM_FRAMES
    out[f"chunked {name} ms/frame"] = ms
    if name == "budget":
        for k, v in delta(before).items():
            out[f"chunked budget {k} calls"] = v
print(json.dumps({"out": out}), flush=True)
"""


def _run(tree, seq):
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _CHILD, seq], cwd=root,
                         env=env, capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"{tree}: exit {out.returncode}\n{out.stdout[-4000:]}\n"
                 f"{out.stderr[-4000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    return next(r["out"] for r in rows if "out" in r)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0
          else "nvidia-smi: not available", flush=True)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as s

    seq = os.path.abspath(os.path.join("build", "budget_ab", "seq"))
    if not os.path.isdir(seq):
        s._render_offline(seq, s.OFFLINE_FRAMES, s.W, s.H)
    got = {}
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            out = _run(tree, seq)
            for case, v in out.items():
                got.setdefault(case, {}).setdefault(tree, []).append(v)
            print(f"round {r} {tree}: " + ", ".join(
                f"{case} {v:.3f}" for case, v in out.items()), flush=True)
    for case, by_tree in got.items():
        print(f"{case}, median over rounds: " + ", ".join(
            f"{tree} {statistics.median(v):.3f}"
            for tree, v in by_tree.items()), flush=True)


if __name__ == "__main__":
    main()

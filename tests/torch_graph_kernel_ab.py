"""The pose-graph kernel (csrc/pose_graph.cu) of two or more source trees,
timed on the same seeded graphs in one run on one card.

    python3 tests/torch_graph_kernel_ab.py TREE [TREE ...] [--vertices 16 32]
        [--rounds 2]

A TREE is the root of a checkout of this repository: ``.``, or a ``git
archive`` of another commit or of a changed tree unpacked into a directory
that .gitignore lists. Each round times the trees in turn, each in a child
process that imports that tree's dvo_slam_tpu_torch and chip_smoke (and
builds that tree's kernels under its own build/), and every other round
takes them in reverse order (A B, B A, ...), so a drift of the card's
clock falls on both. Per vertex count the child builds
chip_smoke._ring_graph's seeded noisy two-lap ring, crops it to a bucket
of 64 edges and solves it as phase 5f solves its ring graphs (Cauchy,
adaptive GNC start from 16, SlamConfig's optimization_iterations), timed
by chip_smoke._events_us (CUDA events behind a spin kernel). Prints the
card's name and power limit, per tree, round and graph the steps, the
final chi2 and the device us per solve and per LM step, then per graph
each tree's median us per step. Needs a card. Not a test: pytest does not
collect it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = """
import functools, json, os, sys, tempfile
import torch
import chip_smoke
from dvo_slam_tpu_torch import SlamConfig
from dvo_slam_tpu_torch.models import pose_graph
from dvo_slam_tpu_torch.utils import g2o_io

dev = torch.device("cuda", 0)
cfg = SlamConfig()
kw = dict(iterations=cfg.optimization_iterations, use_robust=True,
          cauchy_c=cfg.cauchy_c, gnc_init=16.0, gnc_adaptive=True)
for M in map(int, sys.argv[1:]):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring.g2o")
        n_edges = chip_smoke._ring_graph(path, M)
        g = pose_graph.crop(g2o_io.load_g2o(path, max_vertices=M), M,
                            pose_graph.bucket(n_edges, 64))
    _, chi2, _ = pose_graph.optimize(g, device=dev, **kw)
    steps = int(pose_graph.LAST_STEPS)
    us = chip_smoke._events_us(
        functools.partial(pose_graph.optimize, g, device=dev, **kw),
        *((20, 5) if M <= 32 else (4, 3)))
    print(json.dumps({"M": M, "E": int(g.edge_i.shape[0]), "steps": steps,
                      "chi2": float(chi2), "us": us}), flush=True)
"""


def _run(tree, vertices):
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _CHILD, *map(str, vertices)],
                         cwd=root, env=env, capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--vertices", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0
          else "nvidia-smi: not available", flush=True)
    per_step = {}
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            for row in _run(tree, args.vertices):
                us_step = row["us"] / max(row["steps"], 1)
                per_step.setdefault((row["M"], tree), []).append(us_step)
                print(f"round {r} {tree}: M = {row['M']}, E = {row['E']}: "
                      f"{row['steps']} steps, chi2 {row['chi2']:.7g}, "
                      f"{row['us']:.2f} us per solve, {us_step:.2f} per "
                      f"step", flush=True)
    for M in args.vertices:
        print(f"M = {M}: us per step, median over rounds: " + ", ".join(
            f"{tree} {statistics.median(per_step[(M, tree)]):.2f}"
            for tree in args.trees), flush=True)


if __name__ == "__main__":
    main()

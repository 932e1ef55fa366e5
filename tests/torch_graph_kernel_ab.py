"""The pose-graph kernels (csrc/pose_graph.cu up to 128 vertices,
csrc/pose_graph_grid.cu past that and for CG) of two or more source trees,
timed on the same seeded graphs in one run on one card.

    python3 tests/torch_graph_kernel_ab.py TREE [TREE ...]
        [--cases ring256 ring512 ring1024 ring512cg slam256 cli2560
         cli2560cg] [--rounds 2] [--cusolver]

A TREE is the root of a checkout of this repository: ``.``, or a ``git
archive`` of another commit or of a changed tree unpacked into a directory
that .gitignore lists. Each round times the trees in turn, each in a child
process that imports that tree's dvo_slam_tpu_torch and chip_smoke (and
builds that tree's kernels under its own build/), and every other round
takes them in reverse order (A B, B A, ...), so a drift of the card's
clock falls on both. The cases (by default ring16 ring32), built by the
child from the tree's own chip_smoke:

- ``ringV``: chip_smoke._ring_graph's seeded
  noisy two-lap ring of V vertices, cropped to a bucket of 64 edges and
  solved as phase 5f solves its ring graphs (Cauchy, adaptive GNC start
  from 16, SlamConfig's optimization_iterations); ``ringVcg`` the same with
  the CG solver and GRAPH_CG_ITERATIONS LM steps, as 5f's CG case;
- ``slam256``: phase 5g's run past 128 keyframes (chip_smoke.phase_past128)
  and its last 256-slot solve, as 5g ran it;
- ``cli2560`` / ``cli2560cg``: phase 6f's ring (_ring_graph of
  OFFLINE_GRAPH_VERTICES vertices, uncropped) as `optimize-graph
  --no-robust-kernel` solves it, dense and CG.

Per tree, round and case: the LM steps, the final chi2, the device us per
solve and per LM step (chip_smoke._events_us: CUDA events behind a spin
kernel), the kernel's phase split per step (its timing buffer,
chip_smoke._graph_phases), the CG iterations of each step and, where the
tree records it, why each step came out zero (LAST_ZEROED). With
``--cusolver``, a child of this repository first times cholesky_ex +
cholesky_solve of each dense case's first damped system (the yardstick,
chip_smoke._cusolver_step_us), once, before the rounds. Then per case
each tree's median us per step and per CG iteration. Prints
the card's name and power limit first. Needs a card. Not a test: pytest
does not collect it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = """
import functools, json, os, sys, tempfile
import numpy as np
import torch
import chip_smoke
from dvo_slam_tpu_torch import SlamConfig
from dvo_slam_tpu_torch.models import pose_graph
from dvo_slam_tpu_torch.utils import g2o_io

dev = torch.device("cuda", 0)
cusolver = sys.argv[1] == "cusolver"
cfg = SlamConfig()
ring_kw = dict(iterations=cfg.optimization_iterations, use_robust=True,
               cauchy_c=cfg.cauchy_c, gnc_init=16.0, gnc_adaptive=True)


def ring(V, crop=True):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring.g2o")
        n_edges = chip_smoke._ring_graph(path, V)
        g = (g2o_io.load_g2o(path, max_vertices=V) if crop
             else g2o_io.load_g2o(path))
    return pose_graph.crop(g, V, pose_graph.bucket(n_edges, 64)) if crop \\
        else g


def case(name):
    if name == "slam256":
        return chip_smoke.phase_past128(dev)["graph"]
    if name.startswith("cli"):
        kw = dict(iterations=chip_smoke.OFFLINE_GRAPH_ITERATIONS,
                  use_robust=False,
                  solver="cg" if name.endswith("cg") else "dense")
        return ring(int(name[3:].removesuffix("cg")), crop=False), kw
    if name.endswith("cg"):
        return ring(int(name[4:-2])), dict(
            ring_kw, solver="cg", iterations=chip_smoke.GRAPH_CG_ITERATIONS)
    return ring(int(name[4:])), dict(ring_kw)


for name in sys.argv[2:]:
    g, kw = case(name)
    M, E = g.poses.shape[0], g.edge_i.shape[0]
    solver = kw.get("solver", "dense")
    if cusolver:
        if solver == "dense":
            us = chip_smoke._cusolver_step_us(g, kw, dev, 3, 3)
            print(json.dumps({"case": name, "M": M, "cusolver_us": us}),
                  flush=True)
        continue
    route = pose_graph.graph_route(solver, M, dev)
    _, chi2, _ = pose_graph.optimize(g, device=dev, **kw)
    steps = int(pose_graph.LAST_STEPS)
    zeroed = getattr(pose_graph, "LAST_ZEROED", None)
    zeroed = None if zeroed is None else zeroed[:steps].cpu().tolist()
    n = 20 if M <= 32 else 4 if M <= 512 else 2
    us = chip_smoke._events_us(
        functools.partial(pose_graph.optimize, g, device=dev, **kw), n, 3)
    split, span, split_steps, its = chip_smoke._graph_phases(
        g, kw, dev, route)
    row = {"case": name, "M": M, "E": E, "solver": solver, "route": route,
           "steps": steps, "chi2": float(chi2), "us": us, "split": split,
           "cg_iterations": its, "zeroed": zeroed}
    print(json.dumps(row), flush=True)
"""


def _run(tree, cases, mode="kernel"):
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _CHILD, mode, *cases],
                         cwd=root, env=env, capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--cases", nargs="+", default=["ring16", "ring32"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cusolver", action="store_true")
    args = ap.parse_args()
    cases = args.cases
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0
          else "nvidia-smi: not available", flush=True)
    if args.cusolver:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for row in _run(here, cases, "cusolver"):
            print(f"{row['case']} (M = {row['M']}): cholesky_ex + "
                  f"cholesky_solve of the first damped system "
                  f"{row['cusolver_us']:.2f} us", flush=True)
    per_step, per_it = {}, {}
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            for row in _run(tree, cases):
                steps = max(row["steps"], 1)
                us_step = row["us"] / steps
                its = sum(row["cg_iterations"] or [])
                per_step.setdefault((row["case"], tree), []).append(us_step)
                if its:
                    per_it.setdefault((row["case"], tree), []).append(
                        row["split"]["CG iterations"] * row["steps"] / its)
                print(f"round {r} {tree}: {row['case']} (M = {row['M']}, E = "
                      f"{row['E']}, {row['solver']}, {row['route']}): "
                      f"{row['steps']} steps, chi2 {row['chi2']:.7g}, "
                      f"{row['us']:.2f} us per solve, {us_step:.2f} per "
                      f"step; per step by phase "
                      + ", ".join(f"{k} {v:.2f}"
                                  for k, v in row["split"].items())
                      + (f"; CG iterations {row['cg_iterations']}"
                         if its else "")
                      + (f"; zeroed {row['zeroed']}"
                         if row["zeroed"] is not None else ""), flush=True)
    for c in cases:
        print(f"{c}: us per step, median over rounds: " + ", ".join(
            f"{tree} {statistics.median(per_step[(c, tree)]):.2f}"
            for tree in args.trees)
            + ("; us per CG iteration: " + ", ".join(
                f"{tree} {statistics.median(per_it[(c, tree)]):.3f}"
                for tree in args.trees if (c, tree) in per_it)
               if any((c, t) in per_it for t in args.trees) else ""),
            flush=True)


if __name__ == "__main__":
    main()

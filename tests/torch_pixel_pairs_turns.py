"""The pixel route's sharded pairs run of one or more source trees, timed
in turns on every card of the machine (a world of one rank a card).

    python3 tests/torch_pixel_pairs_turns.py TREE [TREE ...] [--rounds 2]

A TREE is the root of a checkout of this repository: ``.``, or another
tree unpacked into a directory that .gitignore lists (``git archive``).
Each round runs the trees in turn, every other round in reverse order,
each in a child process that imports that tree's dvo_slam_tpu_torch and
chip_smoke (building that tree's kernels under its own build/) and spawns
the world: sharded_track_pairs on phase 11's PARALLEL_B ring pairs at
640x480 (the default TrackerConfig, the default mesh), one warm-up call,
then the wall time (host clock to a device sync, behind a barrier) of
--runs calls. The parent prints each tree's median over its runs and
rounds, rank 0's, beside the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np


def rank(rank_, world_size, device, inp, runs):
    import time

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(world_size)
    refs, curs, _, Ks, T0 = cs._parallel_inputs(inp, device)[:5]
    local = (sharded.shard_pyramid(refs, mesh),
             sharded.shard_pyramid(curs, mesh, pixel=False), Ks,
             sharded.shard_rows(T0, mesh).contiguous())
    pairs = sharded.sharded_track_pairs(mesh, TrackerConfig())
    pairs(*local)
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        pairs(*local)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def child(tree, runs):
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from dvo_slam_tpu_torch import parallel
    from dvo_slam_tpu_torch.utils import se3_np

    frames, poses = cs._ring()
    rng = np.random.default_rng(7)
    n = len(frames)
    T0 = np.stack([(se3_np.inverse(poses[(b + 1) % n]) @ poses[b % n])
                   @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                   for b in range(cs.PARALLEL_B)]).astype(np.float32)
    inp = {"frames": frames, "new": frames[0], "T0": T0, "Tf": T0}
    walls = parallel.spawn(rank, torch.cuda.device_count(), "cuda",
                           (inp, runs), timeout_s=600)
    print("RESULT " + json.dumps({"walls": walls[0]}), flush=True)


def main(argv):
    rounds, runs = 2, 5
    for flag in ("--rounds", "--runs"):
        if flag in argv:
            i = argv.index(flag)
            value = int(argv[i + 1])
            argv = argv[:i] + argv[i + 2:]
            if flag == "--rounds":
                rounds = value
            else:
                runs = value
    trees = [os.path.abspath(t) for t in argv]
    got = {t: [] for t in trees}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree,
                 str(runs)], capture_output=True, text=True, check=False)
            line = [x for x in run.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if run.returncode != 0 or not line:
                sys.exit(f"{tree}: child failed ({run.returncode})\n"
                         f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
            got[tree] += json.loads(line[0][7:])["walls"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"{smi.splitlines()[0]} x {len(smi.splitlines())}; {rounds} rounds "
          f"of {runs} runs")
    for t in trees:
        w = 1e3 * np.array(got[t])
        print(f"sharded pairs wall, rank 0, ms: {os.path.relpath(t)} median "
              f"{np.median(w):.2f} (min {w.min():.2f}, max {w.max():.2f})")


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]))
    else:
        main(sys.argv[1:])

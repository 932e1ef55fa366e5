"""The level kernel's split mode (the pixel route, csrc/linearize.cu
split_stage_kernel) of one or more source trees, timed on phase 11's
inputs in one run on one card.

    python3 tests/torch_pixel_split_ab.py TREE [TREE ...] [--rounds 4]

A TREE is the root of a checkout of this repository: ``.``, or another
tree unpacked into a directory that .gitignore lists (``git archive``).
Each round runs the trees in turn, each in a child process that imports
that tree's dvo_slam_tpu_torch and chip_smoke (and builds that tree's
kernels under its own build/), and every other round takes them in
reverse order. The child tracks the first B = 1, 2 and 8 of phase 11's
pairs (chip_smoke.PARALLEL_B ring pairs at 640x480 from the ground truth
perturbed, the default TrackerConfig) over rank 0's band of every
tracked level alone on the card (chip_smoke._split_alone: a 1-rank gloo
group, every stage launch between two CUDA events behind a spin) and
prints the device us a stage launch by B, level and kind (the median
over the run's launches of that kind), and each B's launches and device
ms, an iteration's device us a level (its stages' medians summed, the
stages of the default config's iteration), and the poses the B = 8 run
ends each level with. The parent prints each figure's median over the
rounds beside the tree, and each tree's largest pose distance from the
first tree's (0.0 where the two compute the same bits).
"""

import json
import os
import subprocess
import sys

import numpy as np

BATCHES = (1, 2, 8)  # the first B of phase 11's pairs


def child(tree):
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.utils import se3_np

    dev = torch.device("cuda", 0)
    frames, poses = cs._ring()
    rng = np.random.default_rng(7)
    n = len(frames)
    T0 = np.stack([(se3_np.inverse(poses[(b + 1) % n]) @ poses[b % n])
                   @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                   for b in range(cs.PARALLEL_B)]).astype(np.float32)
    inp = {"frames": frames, "new": frames[0], "T0": T0, "Tf": T0}
    refs, curs, _, Ks, T0_t = cs._parallel_inputs(inp, dev)[:5]
    cfg = TrackerConfig()
    steps = cfg.tdist_scale_iters
    out = {}
    for B in BATCHES:
        (times, _, _), launches = cs._split_alone(
            tuple(x[:B] for x in refs), tuple(x[:B] for x in curs), Ks,
            T0_t[:B].contiguous(), cfg)
        med = {(int(round(np.log2(cs.H / h))), kind): float(np.median(us))
               for (h, kind), us in times.items()}
        out.update({f"B={B} level {lv} {kind}": v
                    for (lv, kind), v in med.items()})
        for lv in {lv for lv, _ in med}:
            out[f"B={B} level {lv} iteration"] = (
                med.get((lv, "first"), 0.0)
                + steps * med.get((lv, "sigma"), 0.0)
                + med.get((lv, "normal"), 0.0))
        out[f"B={B} launches"] = launches
        out[f"B={B} device ms"] = sum(sum(v) for v in times.values()) / 1e3
    out["poses"] = _poses(refs, curs, Ks, T0_t, cfg)
    print("RESULT " + json.dumps(out), flush=True)


def _poses(refs, curs, Ks, T0, cfg):
    """Each tracked level's poses of rank 0's bands at B = 8 in a 1-rank
    gloo group (the issue eager), as lists."""
    import torch.distributed as dist

    from dvo_slam_tpu_torch import parallel
    from dvo_slam_tpu_torch.ops import linearize

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
        rank=0, world_size=1)
    try:
        T, got = T0, []
        for lvl in cfg.tracked_levels:
            h = refs[lvl].shape[-2] // 2
            out, _ = linearize.track_level_split(
                linearize.RefSlabs(refs[lvl][:, :, :h].contiguous()),
                curs[lvl], Ks[lvl], T, cfg, dist.group.WORLD)
            T = out[:, linearize._LEVEL_T:linearize._LEVEL_LOGLIK
                    ].unflatten(-1, (4, 4))
            got.append(T.cpu().numpy().tolist())
        return got
    finally:
        dist.destroy_process_group()


def main(argv):
    rounds = 4
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    trees = [os.path.abspath(t) for t in argv]
    got = {t: [] for t in trees}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree],
                capture_output=True, text=True, check=False)
            line = [x for x in run.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if run.returncode != 0 or not line:
                sys.exit(f"{tree}: child failed ({run.returncode})\n"
                         f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
            got[tree].append(json.loads(line[0][7:]))
    import torch

    import subprocess as sp

    smi = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"], capture_output=True, text=True,
                 check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)} ({smi}); {rounds} rounds")
    base = np.array(got[trees[0]][0]["poses"])
    for t in trees:
        d = max(float(np.abs(np.array(g["poses"]) - base).max())
                for g in got[t])
        print(f"split poses, largest distance from {os.path.relpath(trees[0])}"
              f"'s: {os.path.relpath(t)} {d:.3e}")
    for key in sorted(k for k in got[trees[0]][0] if k != "poses"):
        print(f"split {key}: median over rounds: " + ", ".join(
            f"{os.path.relpath(t)} {np.median([g[key] for g in got[t]]):.2f}"
            for t in trees))


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        main(sys.argv[1:])

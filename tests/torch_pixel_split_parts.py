"""The pixel route's split mode taken apart on the card: each stage
launch by phase, and each stage pair's wall time (a launch and its
all-reduce) by part of the issue path.

    python3 tests/torch_pixel_split_parts.py            # one card
    python3 tests/torch_pixel_split_parts.py --world N  # N cards

On phase 11's pairs (chip_smoke.PARALLEL_B ring pairs at 640x480 from the
ground truth perturbed, the default TrackerConfig):

- the phases: rank 0's bands (the top half of every tracked level's
  rows) at B = 1 and 8 in a 1-rank gloo group, every stage launch with a
  phase-timing buffer (csrc/linearize.cu's stamps of row 0's rank-0 CTA:
  carry, decision, pass, reduction, barrier, write-out), and the same
  launches between CUDA events behind a spin (chip_smoke._split_alone);
  the median us by level, B and stage kind;
- the issue: the same bands at B = 8 in a 1-rank nccl group, a pairs run
  with the host's time in each part (chip_smoke._split_issue_parts: the
  eager ctypes launches and dist.all_reduce calls, the graph replays,
  the reads of the done flags) and NCCL's device time for the stage
  buffer (back to back, events);
- with --world N (N cards; instead of the two above): N ranks over nccl
  on the default mesh, the sharded pairs run (sharded_track_pairs) split
  the same way on every rank, with the ranks' skew at each eager
  all-reduce of a pixel group (the spread of the ranks' entry times on
  the host's monotonic clock).

Prints the card's name and power limit and the kernels' ptxas report
first (chip_smoke.phase_device).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _inputs():
    """Phase 11's inputs (numpy) for chip_smoke._parallel_inputs."""
    from dvo_slam_tpu_torch.utils import se3_np

    frames, poses = cs._ring()
    rng = np.random.default_rng(7)
    n = len(frames)
    T0 = np.stack([(se3_np.inverse(poses[(b + 1) % n]) @ poses[b % n])
                   @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                   for b in range(cs.PARALLEL_B)]).astype(np.float32)
    return {"frames": frames, "new": frames[0], "T0": T0, "Tf": T0}


def _bands_run(refs, curs, Ks, T0, cfg, group):
    """Rank 0's bands of every tracked level in ``group``
    (chip_smoke._split_bands), as a function of no arguments."""
    return lambda: cs._split_bands(refs, curs, Ks, T0, cfg, group)


def _by_level(meds):
    lines = []
    for (h, kind), (ph, span) in sorted(meds.items(), reverse=True):
        lvl = int(round(np.log2(cs.H / h)))
        lines.append(f"level {lvl} {kind}: span {span:.2f} us ("
                     + ", ".join(f"{k} {v:.2f}" for k, v in ph.items()) + ")")
    return lines


def phases(device, refs, curs, Ks, T0):
    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig, parallel

    cfg = TrackerConfig()
    for B in (1, 8):
        sub = (tuple(x[:B] for x in refs), tuple(x[:B] for x in curs), Ks,
               T0[:B].contiguous())
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
            rank=0, world_size=1)
        try:
            run = _bands_run(*sub, cfg, dist.group.WORLD)
            run()
            meds = cs._phase_medians(cs._split_phases(run))
            times = cs._split_stage_times(run)[0]
        finally:
            parallel.destroy()
        print(f"split phases B = {B} (device us, median; row 0's rank-0 "
              f"CTA's stamps):")
        for line in _by_level(meds):
            print("  " + line)
        print(f"split launches B = {B} between events (device us, median): "
              + "; ".join(f"level {int(round(np.log2(cs.H / h)))} {kind} "
                          f"{np.median(us):.2f}"
                          for (h, kind), us in sorted(times.items(),
                                                      reverse=True)))


def issue_alone(device, refs, curs, Ks, T0):
    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig, parallel
    from dvo_slam_tpu_torch.ops import linearize

    cfg = TrackerConfig()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
        rank=0, world_size=1)
    try:
        run = _bands_run(refs, curs, Ks, T0, cfg, dist.group.WORLD)
        captures = linearize.CAPTURES_SPLIT
        run()
        captures = linearize.CAPTURES_SPLIT - captures
        before = (linearize.LAUNCHES_TRACK_LEVEL_SPLIT,
                  linearize.COLLECTIVES_SPLIT, linearize.CAPTURES_SPLIT,
                  linearize.REPLAYS_SPLIT)
        parts = cs._split_issue_parts(run)
        counts = (linearize.LAUNCHES_TRACK_LEVEL_SPLIT - before[0],
                  linearize.COLLECTIVES_SPLIT - before[1],
                  linearize.CAPTURES_SPLIT - before[2],
                  linearize.REPLAYS_SPLIT - before[3])
        red = cs._stage_reduce_us(T0.shape[0], dist.group.WORLD, device)
    finally:
        parallel.destroy()
    print(f"split issue, 1-rank nccl group, rank 0's bands of "
          f"{T0.shape[0]} pairs (captures in the first run {captures}; a "
          f"later run's launches, all-reduces, captures, replays {counts}): "
          + cs._issue_summary(parts, red))


def world_rank(rank, world_size, device, inp):
    """One rank of --world: the sharded pairs run split by issue part."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.parallel import sharded

    cfg = TrackerConfig()
    mesh = sharded.make_mesh(world_size)
    refs, curs, _, Ks, T0 = cs._parallel_inputs(inp, device)[:5]
    local = (sharded.shard_pyramid(refs, mesh),
             sharded.shard_pyramid(curs, mesh, pixel=False), Ks,
             sharded.shard_rows(T0, mesh).contiguous())
    pairs = sharded.sharded_track_pairs(mesh, cfg)
    pairs(*local)
    torch.cuda.synchronize()
    dist.barrier()
    parts = cs._split_issue_parts(lambda: pairs(*local))
    red = cs._stage_reduce_us(local[3].shape[0], mesh.get_group("pixel"),
                              device)
    return {"coordinate": tuple(mesh.get_coordinate()), "parts": parts,
            "reduce_us": red, "rows": int(local[3].shape[0])}


def world(n):
    from dvo_slam_tpu_torch import parallel

    inp = _inputs()
    ranks = parallel.spawn(world_rank, n, "cuda", (inp,), timeout_s=600)
    groups = {}
    for r in ranks:
        groups.setdefault(r["coordinate"][0], []).append(r)
    skew = []
    for members in groups.values():
        common = min(len(m["parts"]["entered"]) for m in members)
        entered = np.array([m["parts"]["entered"][:common] for m in members])
        skew += list((entered.max(axis=0) - entered.min(axis=0)) / 1e3)
    for r in ranks:
        print(f"split issue, {n} ranks over nccl, rank {r['coordinate']} "
              f"({r['rows']} pairs): "
              + cs._issue_summary(r["parts"], r["reduce_us"], skew))


def main(argv):
    import torch

    cs.phase_device()  # the card's name and power limit, the build
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if "--world" in argv:
        world(int(argv[argv.index("--world") + 1]))
        return
    refs, curs, _, Ks, T0 = cs._parallel_inputs(_inputs(), device)[:5]
    phases(device, refs, curs, Ks, T0)
    issue_alone(device, refs, curs, Ks, T0)


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Host time of the chunked engine's ``submit_chunk`` by layer, on the card.

    python tests/torch_chunk_split.py [TREE ...]

For each TREE (the checkout holding this script by default, or a
`git archive` of another commit unpacked under build/), in a child process
of its own: chip_smoke.py's phase 8 loop (ChunkedKeyframeSlam, default
configs, loop closure on, the 640x480 ring in chunks of 16 with a depth-2
submit/collect pipeline, force_keyframe() before every chunk but the
first; 160 warm-up frames on one instance, then 160 timed on another),
with host clocks around each layer of every timed ``submit_chunk``:

- stage: the frames' uploads (chunked_slam.stage);
- on the per-frame Python step (models/keyframe_scan.py::_step, the route
  of trees without ``_track_chunk_kernels``): per frame the pyramid, the
  level launches, the rest of track_batched (its assembly), and the
  step's own eager ops split as the source orders them: the references
  and the initial-pose stack, is_nan and the odometry carry, the entropy
  ratio and the switch, the fusion, the switch measurement and the
  entropy history, the keyframe swap, the outputs dict; then the stacks
  of the outputs after the loop;
- on the kernel route (``_track_chunk_kernels``): the pyramid, level and
  scan-step launches (each wrapper's host time), and the rest (buffers,
  views, carry);
- the host copy (chunked_slam._HostCopy);

and around every timed ``collect_chunk``: the wait for the chunk's host
copy (``_HostCopy.arrays``: the device's work ahead of it) and the rest
of the walk.

Prints, per tree, ms per chunk of each layer (the mean over the timed
chunks), submit_chunk's own host ms (median and mean), and ms/frame of
the run.
Needs one card; writes nothing.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _Clock:
    """Accumulated host ms by layer; wrappers add their inclusive time
    while ``on``."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.on = False
        self.collecting = False

    def wrap(self, owner, name, layer):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[layer] += 1e3 * (time.perf_counter() - t0)

        setattr(owner, name, timed)


def _lapped_step(clock, keyframe_scan):
    """models/keyframe_scan.py::_step of the per-frame route as the trees
    without the kernel route have it, with a lap between its parts."""
    import torch

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import pyramid

    def step(carry, intensity, depth, force, Ks, cfg, scan_cfg):
        laps = [time.perf_counter()]

        def lap(layer):
            laps.append(time.perf_counter())
            if clock.on:
                clock.ms[layer] += 1e3 * (laps[-1] - laps[-2])

        dev = carry["T_kf_prev"].device
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        cur = pyramid.build_pyramid(intensity, depth, cfg.num_levels)
        lap("step: pyramid (incl.)")
        tracked = set(cfg.tracked_levels)
        refs = tuple(
            (kf_l, prev_l) if lvl in tracked else None
            for lvl, (kf_l, prev_l) in enumerate(zip(carry["kf"],
                                                     carry["prev"])))
        odo_init = carry["last_odo"] if cfg.use_initial_estimate else eye
        inits = torch.stack([carry["T_kf_prev"], odo_init])
        lap("step: references and inits stack")
        res = dense_tracker.track_batched(refs, cur, Ks, inits, cfg)
        lap("step: track_batched (incl.)")
        r_kf_T = res.transformation[0]
        r_odo_T = res.transformation[1]
        nan = res.is_nan()
        kf_nan, odo_nan = nan[0], nan[1]
        last_odo = torch.where(odo_nan, carry["last_odo"], r_odo_T)
        lap("step: is_nan and last_odo")
        accept = (~kf_nan) & (res.valid_ratio[0]
                              >= scan_cfg.min_constraint_ratio)
        h = res.entropy[0]
        ratio = torch.where(accept, keyframe_scan._entropy_ratio(
            h, carry["H_first"], carry["has_first"]), 1.0)
        switch = force | (~accept) | (ratio < scan_cfg.min_entropy_ratio)
        lap("step: entropy ratio and switch")
        T_alt = r_odo_T @ carry["T_kf_prev"]
        if scan_cfg.fuse_odometry:
            fused = keyframe_scan._fuse_relative_poses(
                r_kf_T, res.information[0], T_alt, res.information[1])
            T_kf_cur = torch.where(odo_nan, r_kf_T, fused)
        else:
            T_kf_cur = r_kf_T
        lap("step: fusion")
        Z_new = torch.where(accept, r_kf_T,
                            torch.where(odo_nan, carry["T_kf_prev"], T_alt))
        info_new = torch.where(
            accept, res.information[0],
            torch.where(odo_nan,
                        1e2 * torch.eye(6, dtype=torch.float32, device=dev),
                        res.information[1]))
        set_first = accept & (~carry["has_first"]) & torch.isfinite(h)
        H_first = torch.where(set_first, h, carry["H_first"])
        has_first = carry["has_first"] | set_first
        H_first = torch.where(switch, 0.0, H_first)
        has_first = has_first & ~switch
        lap("step: switch measurement and entropy history")
        kf = tuple(torch.where(switch, c, k) for c, k in zip(cur, carry["kf"]))
        lap("step: keyframe swap")
        new_carry = {
            "kf": kf, "prev": cur,
            "T_kf_prev": torch.where(switch, eye, T_kf_cur),
            "last_odo": last_odo, "H_first": H_first, "has_first": has_first,
        }
        out = {
            "rel_pose": torch.where(switch, eye, T_kf_cur), "switch": switch,
            "Z_switch": Z_new, "info_switch": info_new, "entropy": h,
            "entropy_ratio": ratio, "valid_ratio": res.valid_ratio[0],
            "accept": accept, "iterations": res.iterations, "is_nan": nan,
            "T_kf_meas": r_kf_T, "T_odo_meas": r_odo_T,
            "info_pair": res.information,
        }
        if cfg.collect_stats and scan_cfg.with_stats:
            out["stats"] = tuple(res.stats[:5])
        lap("step: carry and outputs")
        return new_carry, out

    return step


def run_tree(tree):
    """The split for the port in `tree` (this process imports it)."""
    sys.path.insert(0, str(tree))
    smoke = _smoke()

    import numpy as np
    import torch

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import chunked_slam, dense_tracker
    from dvo_slam_tpu_torch.models import keyframe_scan
    from dvo_slam_tpu_torch.ops import linearize, pyramid

    if not torch.cuda.is_available():
        sys.exit("torch_chunk_split: no CUDA card")
    device = torch.device("cuda", 0)
    clock = _Clock()
    kernel_route = hasattr(keyframe_scan, "_track_chunk_kernels")
    clock.wrap(chunked_slam, "stage", "stage")
    clock.wrap(pyramid, "build_pyramid_kernel", "pyramid launches")
    clock.wrap(linearize, "track_level_kernels", "level launches")
    scan_fn = "scan_chunk" if hasattr(keyframe_scan, "scan_chunk") \
        else "track_keyframe_chunk"
    clock.wrap(keyframe_scan, scan_fn, "scan (incl.)")
    if kernel_route:
        from dvo_slam_tpu_torch.ops import scan_step
        clock.wrap(scan_step, "scan_step_kernel", "scan_step launches")
    else:
        keyframe_scan._step = _lapped_step(clock, keyframe_scan)
    host_copy = chunked_slam._HostCopy

    class TimedCopy(host_copy):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            if clock.on:
                clock.ms["host copy"] += 1e3 * (time.perf_counter() - t0)

        def arrays(self):
            t0 = time.perf_counter()
            try:
                return super().arrays()
            finally:
                if clock.collecting:
                    clock.ms["collect: wait for the copy"] += 1e3 * (
                        time.perf_counter() - t0)

    chunked_slam._HostCopy = TimedCopy

    frames, _ = smoke._ring()
    submit_ms, chunks, slam = [], 0, None

    def run(t_base, timed):
        nonlocal chunks, slam
        slam = chunked_slam.ChunkedKeyframeSlam(
            smoke.K_TUPLE, TrackerConfig(), SlamConfig(),
            enable_loop_closure=True, device=device)
        slam.init()
        in_flight = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, ii, zz, ts in smoke._chunks(frames, smoke.SLAM_FRAMES,
                                           t_base):
            if c > 0:
                slam.force_keyframe()
            clock.on = timed
            t_s = time.perf_counter()
            slam.submit_chunk(ii, zz, ts)
            if timed:
                submit_ms.append(1e3 * (time.perf_counter() - t_s))
                chunks += 1
            clock.on = False
            in_flight += 1
            if in_flight == 2:
                collect(timed)
                in_flight -= 1
        while in_flight:
            collect(timed)
            in_flight -= 1
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / smoke.SLAM_FRAMES

    def collect(timed):
        clock.collecting = timed
        t_c = time.perf_counter()
        slam.collect_chunk()
        if timed:
            clock.ms["collect_chunk (incl.)"] += 1e3 * (
                time.perf_counter() - t_c)
        clock.collecting = False

    run(0.0, False)
    ms_frame = run(100.0, True)
    name = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"tree {tree}: {'kernel route' if kernel_route else 'per-frame step'}"
          f" on {name} ({limit}); {chunks} timed chunks of {smoke.CHUNK}")
    print(f"  submit_chunk host ms a chunk: median "
          f"{np.median(submit_ms):.3f}, mean {np.mean(submit_ms):.3f}; run "
          f"{ms_frame:.3f} ms/frame")
    scan = clock.ms.get("scan (incl.)", 0.0)
    if kernel_route:
        launches = sum(clock.ms.get(k, 0.0) for k in (
            "pyramid launches", "level launches", "scan_step launches"))
        clock.ms["scan: the rest (buffers, views, carry)"] = scan - launches
    else:
        steps = sum(v for k, v in clock.ms.items() if k.startswith("step:")
                    and "(incl.)" not in k)
        steps += clock.ms.get("step: pyramid (incl.)", 0.0)
        steps += clock.ms.get("step: track_batched (incl.)", 0.0)
        clock.ms["step: track_batched assembly (excl. level launches)"] = (
            clock.ms.get("step: track_batched (incl.)", 0.0)
            - clock.ms.get("level launches", 0.0))
        clock.ms["stacks after the loop"] = scan - steps
    total = sum(submit_ms)
    clock.ms["submit_chunk: the rest"] = total - scan - sum(
        clock.ms.get(k, 0.0) for k in ("stage", "host copy"))
    clock.ms["collect: the walk"] = (
        clock.ms.get("collect_chunk (incl.)", 0.0)
        - clock.ms.get("collect: wait for the copy", 0.0))
    for layer in sorted(clock.ms, key=lambda k: -clock.ms[k]):
        share = ("" if layer.startswith("collect") else
                 f" ({100 * clock.ms[layer] / total:.1f} % of submit_chunk)")
        print(f"  {layer}: {clock.ms[layer] / chunks:.3f} ms a chunk{share}")
    print("json " + json.dumps({"tree": str(tree), "device": name,
                                "limit": limit, "submit_ms": submit_ms,
                                "ms_frame": ms_frame,
                                "layers": {k: v / chunks
                                           for k, v in clock.ms.items()}}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        run_tree(Path(args.trees[0]).resolve())
        return
    rc = 0
    for tree in args.trees:
        rc |= subprocess.run([sys.executable, __file__, "--child",
                              str(Path(tree).resolve())]).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()

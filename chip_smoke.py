#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dvo_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit (nvcc). It imports nothing of JAX or of dvo_slam_tpu and
exits non-zero, printing no result, when there is no card or any phase
fails. Phases:

  1. device: the card's name and power limit (nvidia-smi) and the build
     of the port's kernels from csrc/ (libdvo_kernels.so);
  2. kernel against plain: the CUDA slab sampler against its plain
     PyTorch version on the same card tensors, at the three tracked
     levels of a noisy 640x480 synthetic pair (points warped by a
     perturbed ground-truth pose): inb and NaN pattern identical, values
     within 1e-5 * max|slab|; then both timed per call with CUDA events
     (median of 50 calls after a warm-up; a call's time includes its host
     dispatch when that is longer than its device work), beside one whole
     linearize at that level;
  3. main path: OdometryTracker.update over a 24-frame 640x480 synthetic
     orbit with the default TrackerConfig: ms/frame after 4 warm-up
     frames, mean IRLS iterations per level, ATE against the ground truth
     (must be < 5 mm), and the sampler's launch count (must equal the
     total IRLS iterations);
  4. profile (last: the host timings above are all taken before any
     profiler has run in the process): a few more frames of the main path
     under torch.profiler. From the device records: the device's busy and
     idle share of the frame (with the profiler on), its heaviest kernels,
     and per tracked level the sampler kernel's own device time per call
     and the device busy time per IRLS iteration.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

W, H = 640, 480
# bench.py's intrinsics for 640x480.
K_TUPLE = (525.0 * W / 640.0, 525.0 * H / 480.0, (W - 1) / 2.0, (H - 1) / 2.0)
N_FRAMES, N_WARMUP = 24, 4
ATE_LIMIT_M = 5e-3
TIMED_CALLS = 50


def _median_ms(fn, calls=TIMED_CALLS, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side record (kernels,
    copies, fills) in a profiler run."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(intervals):
    """Device busy time: the union of the record intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_device():
    import torch

    from dvo_slam_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.load()
    built = (f"built in {_build.BUILD_SECONDS:.2f} s"
             if _build.BUILD_SECONDS is not None else "reused from build/")
    print(f"phase 1 device: {_build.library_path().name} {built}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernel_vs_plain(device):
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import camera, linearize, pyramid, sampler
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

    cfg = TrackerConfig()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    rng = np.random.default_rng(0)
    frames = [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K_TUPLE), W, H, T), rng, dropout=0.02)
        for T in poses[:2]]
    # Reference cam -> current cam, perturbed off the optimum.
    T_rel = se3_np.inverse(poses[1]) @ poses[0]
    T = torch.as_tensor(
        T_rel @ se3_np.exp(np.array([2e-3, -1e-3, 1e-3, 1e-3, 2e-3, -1e-3])),
        dtype=torch.float32, device=device)
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE, device=device),
                                   cfg.num_levels)
    ref_pyr, cur_pyr = (
        pyramid.build_pyramid(torch.as_tensor(i, device=device),
                              torch.as_tensor(z, device=device),
                              cfg.num_levels)
        for i, z in frames)
    rows = []
    for lvl in cfg.tracked_levels:
        slab = cur_pyr[lvl]
        ref = linearize.prepare_reference(ref_pyr[lvl], Ks[lvl], cfg)
        u, v = linearize.warp(ref, Ks[lvl], T)[4:]
        out, inb = sampler.sample_slab(slab, u, v)
        want, want_inb = sampler.sample_slab_reference(slab, u, v)
        torch.cuda.synchronize()
        if not torch.equal(inb, want_inb):
            raise AssertionError(f"level {lvl}: inb differs from plain")
        if not torch.equal(torch.isnan(out), torch.isnan(want)):
            raise AssertionError(f"level {lvl}: NaN pattern differs")
        fin = torch.isfinite(want)
        err = (out[fin] - want[fin]).abs().max().item()
        tol = 1e-5 * slab.nan_to_num(posinf=0.0, neginf=0.0).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"level {lvl}: max |kernel - plain| {err} "
                                 f"> {tol}")
        # Timed here, inside the loop, on this level's tensors.
        def kernel():
            sampler.sample_slab(slab, u, v)

        def plain():
            sampler.sample_slab_reference(slab, u, v)

        # Plain, kernel, kernel, plain: the two orders share any drift.
        plain_ms = _median_ms(plain)
        ms = _median_ms(kernel)
        ms = min(ms, _median_ms(kernel))
        plain_ms = min(plain_ms, _median_ms(plain))
        lin_ms = _median_ms(
            lambda: linearize.linearize(ref, slab, Ks[lvl], T, cfg), calls=20)
        n = u.numel()
        rows.append({"level": lvl, "N": n, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
        print(f"phase 2 kernel vs plain: level {lvl} "
              f"({slab.shape[2]}x{slab.shape[1]}, N={n}, "
              f"inb {int(inb.sum())}): max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"per call (events, median of {TIMED_CALLS}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; one whole linearize {lin_ms:.4f} ms")
    return rows


def phase_main_path(device):
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import sampler
    from dvo_slam_tpu_torch.utils import evaluate, synthetic

    cfg = TrackerConfig()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    frames = synthetic.render_sequence(scene, np.asarray(K_TUPLE), W, H,
                                       poses)
    tracker = OdometryTracker(K_TUPLE, cfg, device=device)
    iters, frame_ms = [], []
    sampler.LAUNCHES = 0
    for k, (i, z) in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_w = tracker.update(i, z, float(k))
        torch.cuda.synchronize()
        if k >= N_WARMUP:
            frame_ms.append(1e3 * (time.perf_counter() - t0))
        if k > 0:
            res = tracker.last_result
            if bool(res.is_nan().item()) or not np.isfinite(T_w).all():
                raise AssertionError(f"frame {k}: tracking returned NaN")
            iters.append(res.iterations.cpu().numpy())
    launches = sampler.LAUNCHES
    ms_frame = float(np.mean(frame_ms))
    iters = np.stack(iters)
    est = [T for _, T in tracker.trajectory]
    ate = evaluate.ate_rmse(est, poses)
    print(f"phase 3 main path: {N_FRAMES} frames {W}x{H}, "
          f"{ms_frame:.3f} ms/frame ({1e3 / ms_frame:.2f} fps) after "
          f"{N_WARMUP} warm-up frames (per frame median "
          f"{np.median(frame_ms):.3f}, min {min(frame_ms):.3f}, max "
          f"{max(frame_ms):.3f} ms); mean iterations per level "
          f"{cfg.tracked_levels} = {iters.mean(axis=0).round(3).tolist()}; "
          f"ATE {1e3 * ate:.4f} mm; sampler launches {launches} "
          f"(IRLS iterations {int(iters.sum())})")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    if not (launches > 0 and launches == int(iters.sum())):
        raise AssertionError(f"sampler launches {launches} != IRLS "
                             f"iterations {int(iters.sum())}")
    return launches, tracker, frames


def phase_profile(tracker, frames, n=3):
    """n more frames of the main path (the orbit's first frames again,
    after its last) under torch.profiler: the device's busy and idle share
    of the frame, its heaviest kernels, and per tracked level the sampler
    kernel's device time per call and the device busy time per IRLS
    iteration. Each iteration launches the sampler once, so the records
    from one sampler launch up to the next belong to one iteration (the
    last iteration of a level also carries the next level's reference
    preparation, and of a frame the next frame's pyramid). Runs last: the
    host timings above are taken before any profiler has run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    levels = []  # tracked level of each sampler launch, in launch order
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(n):
            tracker.update(*frames[k], float(N_FRAMES + k))
            its = tracker.last_result.iterations.cpu().tolist()
            for lvl, it in zip(tracker.cfg.tracked_levels, its):
                levels += [lvl] * it
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    recs = sorted(_device_intervals(prof), key=lambda r: r[1])
    if not recs:
        print("phase 4 profile: device time not measured (the profiler "
              "recorded no device activity)")
        return
    busy = _busy_us(recs)
    by_name = {}
    for name, s, e in recs:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"phase 4 profile: {n} frames, {len(levels)} IRLS iterations, wall "
          f"{wall_us / 1e3 / n:.3f} ms/frame (profiler on), device busy "
          f"{busy / 1e3 / n:.3f} ms/frame, idle share {1 - busy / wall_us:.4f}"
          f"; {len(recs) / n:.0f} device records/frame")
    for name, (tot, cnt) in top:
        print(f"  {tot / n:9.1f} us/frame {cnt / n:6.1f} calls/frame  "
              f"{name[:90]}")
    # Split the records at the sampler launches.
    starts = [i for i, r in enumerate(recs) if "sample_slab_kernel" in r[0]]
    if len(starts) != len(levels):
        raise AssertionError(f"profiler saw {len(starts)} sampler launches, "
                             f"the tracker made {len(levels)}")
    per_level = {}
    for j, (i, lvl) in enumerate(zip(starts, levels)):
        stop = starts[j + 1] if j + 1 < len(starts) else len(recs)
        s_us, it_us, cnt = per_level.get(lvl, (0.0, 0.0, 0))
        per_level[lvl] = (s_us + recs[i][2] - recs[i][1],
                          it_us + _busy_us(recs[i:stop]), cnt + 1)
    for lvl in tracker.cfg.tracked_levels:
        s_us, it_us, cnt = per_level[lvl]
        print(f"phase 4 device time (profiler): level {lvl}, {cnt} "
              f"iterations: sampler kernel {s_us / cnt:.2f} us per call, "
              f"device busy {it_us / cnt / 1e3:.4f} ms per IRLS iteration")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this smoke test needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    phase_device()
    rows = phase_kernel_vs_plain(device)
    launches, tracker, frames = phase_main_path(device)
    phase_profile(tracker, frames)
    finest = rows[-1]
    print(json.dumps({"kernels": [{
        "name": "sample_slab",
        "route": "cuda",
        "source": "dvo_slam_tpu_torch/csrc/sampler.cu",
        "replaces": "dvo_slam_tpu/ops/pallas/sampler.py:226",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": finest["ms"],
        "plain_ms": finest["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dvo_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit (nvcc). It imports nothing of JAX or of dvo_slam_tpu and
exits non-zero, printing no result, when there is no card or any phase
fails. Phases:

  1. device: the card's name and power limit (nvidia-smi), the build of
     the port's kernels from csrc/ (libdvo_kernels.so, one nvcc per
     source in parallel) and ptxas's register and spill lines per kernel;
  2. kernels against plain, at the three tracked levels of a noisy
     640x480 synthetic pair (points warped by a perturbed ground-truth
     pose):
     a. the standalone CUDA slab sampler (csrc/sampler.cu) against its
        plain version: inb and NaN pattern identical, values within
        1e-5 * max|slab|; kernel, plain and torch grid_sample (the
        library yardstick, timed only) per call with CUDA events;
     b. the fused linearization (csrc/linearize.cu, K1 + K2) against
        linearize_reference on the same card tensors, for the configs
        tdist (default), photometric, reference_gradients and tdist_warm:
        n_raw, the valid mask and rI, rZ exact; A, b within 1e-4*max|.|;
        sigma, err_mean, log1p_sum, err_raw rtol 1e-4;
     c. one whole linearization per call with CUDA events (median of 50
        after a warm-up; a call's time includes its host dispatch when
        that is longer than its device work), fused beside plain;
  3. main path: OdometryTracker.update over a 24-frame 640x480 synthetic
     orbit with the default TrackerConfig: ms/frame after 4 warm-up
     frames, mean IRLS iterations per level, ATE against the ground truth
     (must be < 5 mm) and the launch counts, reset just before the run
     and read just after it: K1 launches must equal the IRLS iterations,
     K2 launches the iterations x (tdist_scale_iters + 1), and the
     standalone sampler's launches 0;
  4. profile (last: the host timings above are all taken before any
     profiler has run in the process): a few more frames of the main path
     under torch.profiler, split at K1's launches: the device's busy and
     idle share of the frame, its heaviest kernels, device records per
     IRLS iteration, and per tracked level each kernel's device time per
     call and the device busy time per IRLS iteration. Then, in one more
     profiler session, per level the device time per call (union of the
     device records over 10 calls) of every kernel, its plain version and
     the library call, each run as a labelled segment of the session.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import re
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
PROFILED_CALLS = 10
PROFILER_ATTEMPTS = 3
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; f32 FLOP/s outside the tensor
# cores, and f64 at half that rate (34 TFLOP/s).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 33.5e12
# Operations per point, counted from the sources: f32 and f64.
SAMPLER_F32_PER_CHANNEL = 9  # three lerps of sub, mul, add
K1_OPS = (88, 3)  # warp 18, 1/Z 1, projection 6, 6-channel lerp 58+4,
#                   residuals 2, moments 3 (f32); moment sums (f64)
K2_STEP_OPS = (18, 3)  # maha 9, weight 3, weighted moments 6; sums
K2_NE_OPS = (210, 29)  # weight 12, Jacobian 62, A 63, b 18, rest; sums
CONFIGS = {
    "tdist": {},
    "photometric": {"use_depth": False},
    "reference_gradients": {"gradient_source": "reference"},
    "tdist_warm": {"tdist_scale_warm_iters": 2},
}


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


def _kernel_of(name):
    """Which of the port's kernels a device record is, or None. Names are
    demangled ("reduce_kernel<1>") or not ("reduce_kernelILi1E")."""
    if "sample_slab_kernel" in name:
        return "sampler"
    if "residual_kernel" in name:
        return "K1"
    if "reduce_kernel" in name:
        for mode, what in ((0, "K2 step"), (1, "K2 normal")):
            if f"<{mode}>" in name or f"ILi{mode}E" in name:
                return what
    return None


def _traced(body, what):
    """Run body() under torch.profiler; return (body's result, the
    profiler). A session in which CUPTI delivered no device record at all
    is run again, up to PROFILER_ATTEMPTS times, and said so (2 sessions
    of ~340 did so in the smoke's runs so far); if every attempt is empty,
    the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = body()
            torch.cuda.synchronize()
        if _device_intervals(prof):
            return out, prof
        print(f"phase 4: the profiler recorded no device activity for "
              f"{what} (attempt {attempt} of {PROFILER_ATTEMPTS})")
        time.sleep(1.0)
    raise AssertionError(f"the profiler recorded no device activity for "
                         f"{what} in {PROFILER_ATTEMPTS} attempts")


def _profile_segments(segments, what, calls=PROFILED_CALLS):
    """Device records of `calls` calls of each fn in segments (label ->
    fn), after one warm-up call each, all in one profiler session. Each
    segment runs inside a record_function range under its label and ends
    in a device sync inside it, so its device records start inside the
    range (host and device records share the profiler's clock). Returns
    label -> records; the device-side copies of the ranges themselves are
    left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    for fn in segments.values():
        fn()

    def body():
        for label, fn in segments.items():
            with record_function(label):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()

    prof = _traced(body, what)[1]
    spans = {e.name: e.time_range for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name in segments}
    recs = [r for r in _device_intervals(prof) if r[0] not in segments]
    out = {}
    for label in segments:
        span = spans[label]
        out[label] = [r for r in recs if span.start <= r[1] <= span.end]
        if not out[label]:
            raise AssertionError(f"no device record in the segment {label}")
    return out


def _bound_ms(bytes_moved, f32_ops, f64_ops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = f32_ops / PEAK_F32_S + f64_ops / PEAK_F64_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _grid_sample(batch, grid):
    """The library yardstick of the sampler (timed only; the port never
    calls it): torch's bilinear grid_sample with align_corners=True."""
    import torch

    return torch.nn.functional.grid_sample(batch, grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True)


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
        if "entry function" in line:
            # '..13reduce_kernelILi1EE..' -> reduce_kernel<1>
            m = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d)E)?",
                          line.split("'")[1])
            print(f"  ptxas: {m.group(1)}"
                  + (f"<{m.group(2)}>" if m.group(2) else ""))
        elif "registers" in line or "spill" in line:
            print(f"    {line.replace('ptxas info    :', '').strip()}")


def _noisy_pair(device, cfg):
    import torch

    from dvo_slam_tpu_torch.ops import camera, pyramid
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

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
    return ref_pyr, cur_pyr, Ks, T


def _check_fused(ref, slab, K, T, cfg):
    """The fused linearization against linearize_reference on the same
    card tensors. Returns (max |rI, rZ| error, max abs error over A, b,
    sigma, err_mean, log1p_sum, err_raw, max A/b error over max|.|)."""
    import torch

    from dvo_slam_tpu_torch.ops import linearize

    sigma0 = torch.tensor([[40.0, 0.01], [0.01, 1e-3]], device=slab.device)
    got = linearize.linearize_kernels(ref, slab, K, T, cfg, sigma_init=sigma0,
                                      sigma_warm=True)
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(slab.device, ref.px.numel()))
    want = linearize.linearize_reference(ref, slab, K, T, cfg,
                                         sigma_init=sigma0, sigma_warm=True)
    res = linearize.residuals_reference(ref, slab, K, T, cfg)
    torch.cuda.synchronize()
    if not torch.equal(valid, res.valid):
        raise AssertionError("K1's valid mask differs from plain")
    if float(got.n_raw) != float(want.n_raw):
        raise AssertionError(f"n_raw {float(got.n_raw)} != plain "
                             f"{float(want.n_raw)}")
    r_err = max((rI - res.rI).abs().max().item(),
                (rZ - res.rZ).abs().max().item())
    if r_err != 0.0:
        raise AssertionError(f"rI, rZ differ from plain by {r_err}")
    rel = 0.0
    abs_err = 0.0
    for field in ("A", "b"):
        a, b = getattr(got, field), getattr(want, field)
        err = (a - b).abs().max().item()
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(b.abs().max().item(), 1e-30))
        if not err <= 1e-4 * b.abs().max().item():
            raise AssertionError(f"{field}: max |fused - plain| {err} > "
                                 f"1e-4 * {b.abs().max().item()}")
    for field in ("sigma", "err_mean", "log1p_sum", "err_raw"):
        a, b = getattr(got, field), getattr(want, field)
        err = (a - b).abs().max().item()
        abs_err = max(abs_err, err)
        if not err <= 1e-4 * b.abs().max().item():
            raise AssertionError(f"{field}: fused {a.tolist()} plain "
                                 f"{b.tolist()} beyond rtol 1e-4")
    return r_err, abs_err, rel


def phase_kernel_vs_plain(device):
    import dataclasses

    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import linearize, sampler

    cfg = TrackerConfig()
    ref_pyr, cur_pyr, Ks, T = _noisy_pair(device, cfg)
    levels = {}
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
        # The library yardstick, timed only (the port never calls it):
        # grid_sample's normalised coordinates (align_corners=True) put -1
        # and +1 on the centres of the first and last pixels. It differs
        # at the border: a footprint that leaves the image is blended with
        # zero padding, where the sampler flags it out (inb) and clamps its
        # corners. NaN propagates in both: a NaN coordinate, or a NaN corner
        # of zero weight, gives NaN.
        grid = torch.stack([u * (2.0 / (slab.shape[2] - 1)) - 1.0,
                            v * (2.0 / (slab.shape[1] - 1)) - 1.0],
                           dim=-1)[None, None]
        batch = slab[None]

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
        lib_ms = _median_ms(lambda: _grid_sample(batch, grid))
        n = u.numel()
        print(f"phase 2a sample_slab vs plain: level {lvl} "
              f"({slab.shape[2]}x{slab.shape[1]}, N={n}, "
              f"inb {int(inb.sum())}): max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"per call (events, median of {TIMED_CALLS}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms")

        # The fused linearization, over the configs it covers.
        r_err, abs_err, rel = 0.0, 0.0, 0.0
        for name, fields in CONFIGS.items():
            c = dataclasses.replace(cfg, **fields)
            ref_c = linearize.prepare_reference(ref_pyr[lvl], Ks[lvl], c)
            e = _check_fused(ref_c, slab, Ks[lvl], T, c)
            r_err, abs_err, rel = (max(r_err, e[0]), max(abs_err, e[1]),
                                   max(rel, e[2]))
        print(f"phase 2b fused linearize vs plain: level {lvl}, configs "
              f"{list(CONFIGS)}: n_raw and valid mask exact, max |rI, rZ| "
              f"error {r_err:.1e}; max A/b error / max|.| {rel:.3e} (tol "
              f"1e-4); max abs error over all outputs {abs_err:.3e}")

        def fused():
            linearize.linearize_kernels(ref, slab, Ks[lvl], T, cfg)

        def plain_lin():
            linearize.linearize_reference(ref, slab, Ks[lvl], T, cfg)

        p_ms = _median_ms(plain_lin, calls=20)
        f_ms = _median_ms(fused)
        f_ms = min(f_ms, _median_ms(fused))
        p_ms = min(p_ms, _median_ms(plain_lin, calls=20))
        print(f"phase 2c linearize per call (events, median): level {lvl}: "
              f"fused {f_ms:.4f} ms, plain {p_ms:.4f} ms")
        levels[lvl] = {"N": n, "H": slab.shape[1], "W": slab.shape[2],
                       "sampler_err": err, "r_err": r_err,
                       "lin_abs_err": abs_err, "ref": ref, "slab": slab,
                       "K": Ks[lvl], "T": T, "u": u, "v": v,
                       "batch": batch, "grid": grid}
    return cfg, levels


def phase_main_path(device):
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import linearize, sampler
    from dvo_slam_tpu_torch.utils import evaluate, synthetic

    cfg = TrackerConfig()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    frames = synthetic.render_sequence(scene, np.asarray(K_TUPLE), W, H,
                                       poses)
    tracker = OdometryTracker(K_TUPLE, cfg, device=device)
    iters, frame_ms = [], []
    sampler.LAUNCHES = 0
    linearize.LAUNCHES_RESIDUAL = 0
    linearize.LAUNCHES_REDUCE = 0
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
    launches = {"sample_slab": sampler.LAUNCHES,
                "K1": linearize.LAUNCHES_RESIDUAL,
                "K2": linearize.LAUNCHES_REDUCE}
    ms_frame = float(np.mean(frame_ms))
    iters = np.stack(iters)
    n_it = int(iters.sum())
    est = [T for _, T in tracker.trajectory]
    ate = evaluate.ate_rmse(est, poses)
    print(f"phase 3 main path: {N_FRAMES} frames {W}x{H}, "
          f"{ms_frame:.3f} ms/frame ({1e3 / ms_frame:.2f} fps) after "
          f"{N_WARMUP} warm-up frames (per frame median "
          f"{np.median(frame_ms):.3f}, min {min(frame_ms):.3f}, max "
          f"{max(frame_ms):.3f} ms); mean iterations per level "
          f"{cfg.tracked_levels} = {iters.mean(axis=0).round(3).tolist()}; "
          f"ATE {1e3 * ate:.4f} mm; launches K1 {launches['K1']}, K2 "
          f"{launches['K2']}, standalone sampler {launches['sample_slab']} "
          f"(IRLS iterations {n_it})")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    if not (n_it > 0 and launches["K1"] == n_it):
        raise AssertionError(f"K1 launches {launches['K1']} != IRLS "
                             f"iterations {n_it}")
    if launches["K2"] != n_it * (cfg.tdist_scale_iters + 1):
        raise AssertionError(f"K2 launches {launches['K2']} != {n_it} x "
                             f"{cfg.tdist_scale_iters + 1}")
    if launches["sample_slab"] != 0:
        raise AssertionError("the main path launched the standalone sampler")
    return launches, tracker, frames, iters.shape[0]


def phase_profile(tracker, frames, n=3):
    """n more frames of the main path (the orbit's first frames again,
    after its last) under torch.profiler. Each IRLS iteration launches K1
    once, so the records from one K1 launch up to the next belong to one
    iteration (the last iteration of a level also carries the next
    level's reference preparation, and of a frame the next frame's
    pyramid). Returns per level (K1 us per call, K2 us per launch, K2
    launches per iteration)."""
    import torch

    def body():
        levels = []  # tracked level of each IRLS iteration, in launch order
        t0 = time.perf_counter()
        for k in range(n):
            tracker.update(*frames[k], float(N_FRAMES + k))
            its = tracker.last_result.iterations.cpu().tolist()
            for lvl, it in zip(tracker.cfg.tracked_levels, its):
                levels += [lvl] * it
        torch.cuda.synchronize()
        return levels, 1e6 * (time.perf_counter() - t0)

    (levels, wall_us), prof = _traced(body, "the main path")
    recs = sorted(_device_intervals(prof), key=lambda r: r[1])
    busy = _busy_us(recs)
    by_name = {}
    for name, s, e in recs:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"phase 4 profile: {n} frames, {len(levels)} IRLS iterations, wall "
          f"{wall_us / 1e3 / n:.3f} ms/frame (profiler on), device busy "
          f"{busy / 1e3 / n:.3f} ms/frame, idle share {1 - busy / wall_us:.4f}"
          f"; {len(recs) / n:.0f} device records/frame, "
          f"{len(recs) / len(levels):.1f} per IRLS iteration")
    for name, (tot, cnt) in top:
        print(f"  {tot / n:9.1f} us/frame {cnt / n:6.1f} calls/frame  "
              f"{name[:90]}")
    kinds = [_kernel_of(r[0]) for r in recs]
    starts = [i for i, k in enumerate(kinds) if k and k.startswith("K1")]
    if len(starts) != len(levels):
        raise AssertionError(f"profiler saw {len(starts)} K1 launches, the "
                             f"tracker made {len(levels)}")
    if "sampler" in kinds:
        raise AssertionError("the main path launched the standalone sampler")
    per_level = {}
    for j, (i, lvl) in enumerate(zip(starts, levels)):
        stop = starts[j + 1] if j + 1 < len(starts) else len(recs)
        k2 = [recs[m][2] - recs[m][1] for m in range(i, stop)
              if kinds[m] and kinds[m].startswith("K2")]
        acc = per_level.setdefault(lvl, [0.0, 0.0, 0, 0.0, 0, 0])
        acc[0] += recs[i][2] - recs[i][1]
        acc[1] += sum(k2)
        acc[2] += len(k2)
        acc[3] += _busy_us(recs[i:stop])
        acc[4] += stop - i
        acc[5] += 1
    out = {}
    for lvl in tracker.cfg.tracked_levels:
        k1, k2, n_k2, it_us, n_rec, cnt = per_level[lvl]
        out[lvl] = (k1 / cnt, k2 / n_k2, n_k2 / cnt)
        print(f"phase 4 device time (profiler): level {lvl}, {cnt} "
              f"iterations: K1 {k1 / cnt:.2f} us per call, K2 "
              f"{k2 / n_k2:.2f} us per launch ({n_k2 / cnt:.1f} launches, "
              f"{k2 / cnt:.2f} us per iteration); device busy "
              f"{it_us / cnt / 1e3:.4f} ms and {n_rec / cnt:.1f} device "
              f"records per IRLS iteration")
    return out


def phase_device_times(cfg, levels):
    """Per level, device time per call (profiler) of every kernel, its
    plain version and the library call, and the bounds. One profiler
    session holds every level, each function a labelled segment."""
    from functools import partial

    import torch

    from dvo_slam_tpu_torch.ops import linearize, sampler

    segments, n_valid = {}, {}
    for lvl, L in levels.items():
        ref, slab, K, T, u, v = (L[k] for k in ("ref", "slab", "K", "T",
                                                "u", "v"))
        res = linearize.residuals_reference(ref, slab, K, T, cfg)
        sII, sIZ, sZZ = res.rI * res.rI, res.rI * res.rZ, res.rZ * res.rZ
        a = sII.sum() / res.n + cfg.min_intensity_sigma**2
        bq = sIZ.sum() / res.n
        c = sZZ.sum() / res.n + cfg.min_depth_sigma**2
        n_valid[lvl] = float(res.n_raw)

        # Each function is bound to this level's tensors by its defaults
        # (it runs after the loop).
        def k1_plain(ref=ref, slab=slab, K=K, T=T):
            r = linearize.residuals_reference(ref, slab, K, T, cfg)
            (r.rI * r.rI).sum(), (r.rI * r.rZ).sum(), (r.rZ * r.rZ).sum()

        def k2_step_plain(a=a, bq=bq, c=c, sII=sII, sIZ=sIZ, sZZ=sZZ,
                          res=res):
            linearize.tdist_step_reference(a, bq, c, sII, sIZ, sZZ, res.vF,
                                           res.n, cfg)

        def k2_normal_plain(a=a, bq=bq, c=c, sII=sII, sIZ=sIZ, sZZ=sZZ,
                            res=res, K=K):
            det, p00, p01, p11, maha, w = linearize.tdist_weights_reference(
                a, bq, c, sII, sIZ, sZZ, res.vF, cfg)
            (torch.log1p(maha / cfg.tdist_dof) * res.vF).sum()
            (w * maha).sum()
            linearize.normal_equations_reference(res, w, p00, p01, p11, K,
                                                 cfg)

        for name, f in (
            ("sampler", partial(sampler.sample_slab, slab, u, v)),
            ("sampler plain", partial(sampler.sample_slab_reference, slab, u,
                                      v)),
            ("grid_sample", partial(_grid_sample, L["batch"], L["grid"])),
            ("K1 plain", k1_plain),
            ("K2 step plain", k2_step_plain),
            ("K2 normal plain", k2_normal_plain),
            ("linearize plain", partial(linearize.linearize_reference, ref,
                                        slab, K, T, cfg)),
            ("linearize", partial(linearize.linearize_kernels, ref, slab, K,
                                  T, cfg)),
        ):
            segments[f"smoke {name} @{lvl}"] = f
    recs = _profile_segments(segments, "the per-level device times")
    out = {}
    for lvl in levels:
        d = {"n_valid": n_valid[lvl]}
        for label, r in recs.items():
            name, at = label[len("smoke "):].rsplit(" @", 1)
            if int(at) == lvl:
                d[name] = _busy_us(r) / PROFILED_CALLS / 1e3
        # The fused linearization's kernels, per launch.
        by = {}
        for name, s, e in recs[f"smoke linearize @{lvl}"]:
            kind = _kernel_of(name)
            if kind:
                tot, cnt = by.get(kind, (0.0, 0))
                by[kind] = (tot + e - s, cnt + 1)
        for kind in ("K1", "K2 step", "K2 normal"):
            tot, cnt = by[kind]
            d[kind] = tot / cnt / 1e3
        out[lvl] = d
        print(f"phase 4 device time per call (profiler, {PROFILED_CALLS} "
              f"calls): level {lvl}: sample_slab {1e3 * d['sampler']:.2f} us "
              f"(plain {1e3 * d['sampler plain']:.2f}, grid_sample "
              f"{1e3 * d['grid_sample']:.2f}); K1 {1e3 * d['K1']:.2f} us "
              f"(plain {1e3 * d['K1 plain']:.2f}); K2 step "
              f"{1e3 * d['K2 step']:.2f} us (plain "
              f"{1e3 * d['K2 step plain']:.2f}); K2 normal equations "
              f"{1e3 * d['K2 normal']:.2f} us (plain "
              f"{1e3 * d['K2 normal plain']:.2f}); whole linearization "
              f"{1e3 * d['linearize']:.2f} us (plain "
              f"{1e3 * d['linearize plain']:.2f})")
        bounds = _bounds(cfg, levels[lvl], d["n_valid"])
        print(f"phase 4 bounds: level {lvl} ({int(d['n_valid'])} valid "
              f"points): " + ", ".join(
                  f"{k} {1e3 * ms:.4f} us ({by})"
                  for k, (ms, by) in bounds.items()))
    return out


def _bounds(cfg, L, n_valid):
    """Per kernel at one level: (ms, "bytes" or "operations"), the least
    time the card could take. Bytes: each input read once, each output
    written once; operations: counted per point from the sources, the
    normal equations' and Sigma steps' over the valid points only. K1 is
    bound on what the residual pass needs (reference points, the slab
    once, rI, rZ and valid out); the normal equations read rI, rZ, valid
    and the 28 B per point of Jacobian inputs that K1 stores for them."""
    N, HW = L["N"], L["H"] * L["W"]
    steps = cfg.tdist_scale_iters
    ne_bytes = 9 * N + 28 * N
    out = {
        "sampler": _bound_ms(8 * N + 24 * HW + 24 * N + N,
                             SAMPLER_F32_PER_CHANNEL * 6 * N, 0),
        "K1": _bound_ms(17 * N + 24 * HW + 80 + 9 * N,
                        K1_OPS[0] * N, K1_OPS[1] * n_valid),
        "K2 step": _bound_ms(9 * N, K2_STEP_OPS[0] * n_valid,
                             K2_STEP_OPS[1] * n_valid),
        "K2 normal": _bound_ms(ne_bytes, K2_NE_OPS[0] * n_valid,
                               K2_NE_OPS[1] * n_valid),
    }
    # K2 as the mean over one linearization's launches.
    out["K2"] = _bound_ms(
        (steps * 9 * N + ne_bytes) / (steps + 1),
        (steps * K2_STEP_OPS[0] + K2_NE_OPS[0]) * n_valid / (steps + 1),
        (steps * K2_STEP_OPS[1] + K2_NE_OPS[1]) * n_valid / (steps + 1))
    return out


def kernel_rows(cfg, levels, launches, main_trace, dev_times):
    """The kernels' JSON rows, at the finest tracked level."""
    lvl = cfg.tracked_levels[-1]
    d = dev_times[lvl]
    bound = _bounds(cfg, levels[lvl], d["n_valid"])
    steps = cfg.tdist_scale_iters
    k1_ms, k2_ms, _ = (x / 1e3 for x in main_trace[lvl])
    k2_plain = (steps * d["K2 step plain"] + d["K2 normal plain"]) \
        / (steps + 1)
    rows = []
    for name, src, replaces, n_launch, err, ms, plain_ms, b, lib_ms in (
        ("sample_slab", "dvo_slam_tpu_torch/csrc/sampler.cu",
         "dvo_slam_tpu/ops/pallas/sampler.py:226", launches["sample_slab"],
         max(x["sampler_err"] for x in levels.values()), d["sampler"],
         d["sampler plain"], bound["sampler"], d["grid_sample"]),
        ("linearize_residual (K1)", "dvo_slam_tpu_torch/csrc/linearize.cu",
         "dvo_slam_tpu/ops/pallas/sampler.py:226", launches["K1"],
         max(x["r_err"] for x in levels.values()), k1_ms, d["K1 plain"],
         bound["K1"], None),
        ("linearize_reduce (K2)", "dvo_slam_tpu_torch/csrc/linearize.cu",
         "dvo_slam_tpu/ops/linearize.py:416", launches["K2"],
         max(x["lin_abs_err"] for x in levels.values()), k2_ms, k2_plain,
         bound["K2"], None),
    ):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": lib_ms})
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this smoke test needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    phase_device()
    cfg, levels = phase_kernel_vs_plain(device)
    launches, tracker, frames, _ = phase_main_path(device)
    main_trace = phase_profile(tracker, frames)
    dev_times = phase_device_times(cfg, levels)
    print(json.dumps({"kernels": kernel_rows(cfg, levels, launches,
                                             main_trace, dev_times)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

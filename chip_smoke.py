#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dvo_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit (nvcc). It imports nothing of JAX or of dvo_slam_tpu and
exits non-zero, printing no result, when there is no card or any phase
fails. The port's kernels: the standalone slab sampler (csrc/sampler.cu),
the cluster kernel of csrc/linearize.cu in its two modes, (a) one
IRLS linearization per batch row and (b) a pyramid level's whole IRLS loop
per batch row (the tracker's route on the card), and the pose-graph
kernel (csrc/pose_graph.cu: a dense Levenberg-Marquardt solve of up to
128 vertices per launch, the graph solves' route on the card). Phases:

  1. device: the card's name and power limit (nvidia-smi), the build of
     the port's kernels from csrc/ (libdvo_kernels.so, one nvcc per
     source in parallel) and ptxas's register and spill lines per kernel;
  2. kernels against plain, at the three tracked levels of a noisy
     640x480 synthetic pair (points warped by a perturbed ground-truth
     pose):
     a. the standalone sampler against its plain version: inb and NaN
        pattern identical, values within 1e-5 * max|slab|; kernel, plain
        and torch grid_sample (the library yardstick, timed only) per call
        with CUDA events;
     b. mode (a) against linearize_reference on the same card tensors,
        for the configs tdist (default), photometric, reference_gradients
        and tdist_warm: n_raw, the valid mask and rI, rZ exact; A, b
        within 1e-4*max|.|; sigma, err_mean, log1p_sum, err_raw rtol 1e-4;
     c. one linearization per call with CUDA events (median of 50 after a
        warm-up; a call's time includes its host dispatch when that is
        longer than its device work), mode (a) beside plain;
     d. mode (b) against its plain version, the host loop over
        linearize_batched_reference, per level at B = 1 on the noise-free
        orbit pair (T within 1e-5; same decisions: iterations, termination
        codes and valid counts equal, A within 1e-4*max|A|, b within a
        step of precision, ||A^-1 db||; rows whose paths part must part at an
        error or precision tie, and are listed) and on the noisy pair
        (gates: T within 1e-3, final valid counts within 1 %); device us
        per launch and per IRLS iteration (CUDA events), cluster sizes;
  5a. the cluster kernel over a batch (B = 2 against one shared current
     slab, as the dual alignment; B = 8 against one slab per row, as a
     validation batch), noisy frames, per level: mode (a) against the plain
     version row by row (every row's valid mask, rI and rZ exact, A and b
     within 1e-4 * max|.|, every row bit-identical to a B = 1 call) and
     mode (b) against the plain host loop (gates as 2d's noisy pair);
  3. main path: OdometryTracker.update over a 24-frame 640x480 synthetic
     orbit with the default TrackerConfig: ms/frame after 4 warm-up
     frames, mean IRLS iterations per level, ATE against the ground truth
     (must be < 5 mm) and the launch counts, reset just before the run
     and read just after it: level-kernel launches must equal the tracked
     levels (3 a tracked frame), mode (a) and standalone sampler launches
     0;
  5b. the SLAM path (KeyframeSlam, default TrackerConfig and SlamConfig,
     loop closure on), JAX bench.py's slam-lc loop: the 8-frame 640x480
     ring (orbit_trajectory(9, radius=0.06)[:8], two_plane_scene
     (sharpness=2.0)), force_keyframe() every 16 frames, 160 warm-up
     frames on one instance, then 160 timed frames on a fresh one (the
     launch counts reset just before and read just after): ms/frame,
     keyframes and loop edges (must be >= 1), ATE of finish() against the
     ring's ground truth (must be < 5 mm), level-kernel launches per frame
     and by batch size (mode (a) and the sampler: 0), the LM steps each
     pose-graph solve ran (pose_graph.LAST_STEPS, read after the run),
     the pose-graph kernel's launches (must be > 0, one per solve on its
     route) and the host loop's LM steps (must be 0), the host ms per
     switch of each part, and two runs of the final graph solve (must be
     bit-identical);
  5d. mode (b) at the validation batches B = 16 and 32 (up to
     SlamConfig.validation_batch_max), one current slab per row of a noisy
     640x480 orbit, per tracked level, against the plain host loop with
     5a's gates; device us per launch;
  5e. KeyframeSlam forced past resident_keyframes = 64 (a keyframe every
     frame, 68 frames of the ring at 160x120, loop closure on): pyramids
     evicted to pinned host memory and re-uploaded for validation; the run
     must equal one whose budget holds every pyramid (keyframes, edges,
     trajectory); its solves counted by vertex slots and route (graphs of
     64 and 128 slots take the graph kernel's clusters);
  6. the offline surface over bench/accuracy.py's full-scale protocol
     rendered with the freiburg-1 intrinsics (noisy 640x480 frames, two
     laps of a 0.5 m orbit, cut from 240 frames to 160; written as a TUM
     directory by the port's write_tum_dataset):
     a. both PNG decoders on the first and last 3 frames (identical
        arrays), decode ms/frame of each and of the native prefetch loader;
     b. `cli benchmark --fr 1` (slam) and run_tum_dataset in keyframe mode:
        fps, keyframes, loop edges, ATE, RPE; the protocol's gates (ATE(slam)
        < 20 mm, >= 1 loop edge, ATE(slam) <= 0.7 ATE(keyframe)); launches
        by batch size, counted from 0 around the benchmark run (level
        kernel > 0, mode (a) and sampler 0);
     i. the protocol's budget run: slam mode again at
        point_budget_fraction 0.25 (point compaction): fps, keyframes, loop
        edges, ATE beside 6b's, and gate_budget (ATE < 20 mm, >= 1 loop
        edge, ATE <= 0.7 ATE(keyframe)); launches as 6b's;
     c. `cli odometry` with a covariance file (one 37-field line a frame);
     d. `python -m dvo_slam_tpu_torch.cli evaluate` in a subprocess: the
        benchmark's ATE within 1e-6; `evaluate --rpe-seconds`;
     e. keyframe mode through run_sequence's checkpoint_out and resume,
        split at the middle frame, against 6b's uninterrupted keyframe
        run: the same keyframes, trajectories within 1e-6 m;
     f. `cli optimize-graph` on the benchmark's graph, and dense against
        CG on a 2560-vertex noisy two-lap ring (past graph_cg_threshold),
        5 LM steps without the robust kernel: ms and chi2 before and
        after (finite, no worse);
     g. `cli odometry --scale-estimator normal --influence huber` (24
        frames): one standalone sampler launch per linearization, no
        cluster-kernel launch;
  5f. (after 6, whose graph it takes) the pose-graph kernel against the
     plain host loop (optimize_reference, cuSOLVER's Cholesky) on the card:
     the ring's final keyframe graph (M = 16), 5b's last window graph,
     6b's benchmark graph (cropped to M = 32) and _ring_graph at 64 and
     128 vertices (clusters of 4 and 16 CTAs): steps on each route, max
     |dpose| (tol 1e-4), chi2 (rtol 1e-4), weights and chi2 against the
     plain formula at the kernel's poses (1e-4), the same accept
     decisions up to a parting at a tie (at the parting step neither
     trial moves the chi2 by more than 1e-4 relative); the
     kernel's device us per solve and per step (CUDA events), the host
     loop's ms, cuSOLVER's cholesky_ex + cholesky_solve on the damped
     system, the bound;
  7. the three cells through the host loop (dense_tracker._track_level,
     one mode (a) launch per lockstep iteration, called directly in
     place of track_level) and through the level kernel, in turns (host,
     kernel, kernel, host): odometry (24 frames), SLAM (96 frames after
     32; both routes must give the same keyframes and graph edges, with a
     loop edge), offline (run_sequence, 96 frames of phase 6's sequence);
     then the SLAM and offline cells with the graph solves through the
     host loop (optimize_reference in place of optimize) and through the
     graph kernel, in turns: ms/frame, on the ring switch-frame and other
     frames' ms and the host ms per switch of KeyframeSlam._optimize and
     LocalMap.optimize_async;
  8. the chunked engine (ChunkedKeyframeSlam, default configs, loop
     closure on) over 5b's loop in chunks of 16 with a depth-2
     submit/collect pipeline, 160 warm-up frames then 160 timed: ms/frame,
     submit host ms, keyframes, loop edges, ATE of finish() (< 5 mm),
     level-kernel launches per frame by batch size; chunk 3's submit_chunk
     under torch.cuda.set_sync_debug_mode("error") (must not raise);
     against 5b's per-frame KeyframeSlam on the same frames: the same
     keyframe timestamps and edge endpoints (outlier-pruning masks may
     differ, see phase_chunked), trajectories within 1e-4 where the masks
     agree;
  9. the live node: node.serve on a unix socket in a thread and a client
     streaming 96 ring frames at 640x480, as JAX bench.py's live modes do
     (odometry and slam per frame, slam in chunks of 16 over the f32, raw
     and raw12 wire encodings, and paced at 30 Hz with raw frames, per
     frame and chunked): fps, pose latency p50 / p99 (send to arrival);
     every session's finish() trajectory must equal the engine's direct
     run on the same frames;
  10. point compaction (ops/linearize.compact_reference) at
     intensity_grad_threshold 1.0: odometry over phase 3's orbit on the
     full grid and at budget 0.5 (ms/frame, ATE < 5 mm, one level-kernel
     launch per tracked level); per tracked level at N = budget, mode (b)
     against the plain host loop (2d's gates) at B = 1 and 2, mode (a)
     against plain row by row (5a's), the level kernel's us per launch at
     N = budget and on the full grid and whether the points are kept in
     shared memory; compaction on the card bit-equal to the CPU's and
     across runs;
  11. parallel/ (torch.distributed) at 640x480 with the default config:
     4 ranks over nccl with 4 cards or more, 2 with 2 or 3, or 2 ranks
     sharing one card over gloo,
     on the default (batch, pixel) mesh: sharded_track_pairs at B = 8, the
     validation fleet at 8 candidates, the edge-sharded graph assembly at
     SlamConfig's capacities, track_sequences_sharded over 8 ring
     sequences; every rank's results equal, held to single-process runs
     on the card (the level kernel, and the host loop over the plain
     linearization); times, the backend and the standalone sampler's
     launches per tracked pair on the pixel route; that sampler against
     its plain version at a pixel shard's shape, its device time (CUDA
     events) beside plain and grid_sample, its bound from the distinct
     slab pixels the shard's points read;
  12. device times by CUDA events (a spin kernel holds the card while the
     host queues the calls, so a call shorter than its dispatch is timed
     by the card): per level, every kernel, its plain version (the two
     modes' plain versions sync, so theirs count host time) and the
     library call, at B = 1 and at 5a's batches, with the bounds;
  4. profiles (after every host timing above: no profiler has run before
     them in the process): a few more frames of the odometry main path
     under torch.profiler through each route: busy and idle share, device
     records per frame and per IRLS iteration, heaviest kernels, per level
     the level kernel's device time per launch and per iteration. Every
     profiler session (here, 5c and 6h) must hold one device record for
     each kernel launch the wrappers counted in it, or it is run again
     (up to 3 times, then the phase fails);
  5c. a short profile of the SLAM path through each route: a few more
     frames with one forced keyframe switch, each frame a labelled
     segment: busy and idle share, device records and launches per frame;
  6h. last, a short profile of the offline cell through each route: a
     fresh KeyframeSlam with 6b's configs tracks the sequence's first 12
     frames, then its next 12 under the profiler: busy and idle share,
     device records and launches per frame.

The line before the last is a JSON object describing each kernel (the
cluster kernel's modes at B = 1, with the odometry path's launches, at
B = 2 and 8, with the SLAM path's, mode (b) at B = 2 with the chunked
engine's, at B = 16 and 32 (5d), and at N = budget with phase 10's
compacted odometry launches; the standalone sampler on phase 11's
pixel-sharded route; the pose-graph kernel on 5f's five graphs, with
5b's, 6b's and 5e's launches); the last line is {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import functools
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
# The SLAM path: JAX bench.py's slam-lc loop (its default is 400 frames;
# 160 keeps the smoke inside its time limit).
RING, SLAM_FRAMES, FORCE_EVERY = 8, 160, 16
SLAM_PROFILED_FRAMES = 6
BATCHES = {2: False, 8: True}  # B -> one current slab per row
ATE_LIMIT_M = 5e-3
TIMED_CALLS = 50
PROFILER_ATTEMPTS = 3
# Cycles a second of torch.cuda._sleep's spin: the H100 SXM's top clock
# (1.98 GHz) rounded up, so a spin lasts at least the time asked.
SPIN_HZ = 2e9
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; f32 FLOP/s outside the tensor
# cores, and f64 at half that rate (34 TFLOP/s).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 33.5e12
# Operations per point, counted from csrc/linearize.cu: f32 and f64.
SAMPLER_F32_PER_CHANNEL = 9  # three lerps of sub, mul, add
RESIDUAL_OPS = (88, 4)  # warp 18, 1/Z 1, projection 6, 6-channel lerp
#                         58+4, residuals 2, moments 3 (f32); sums (f64)
STEP_OPS = (18, 3)  # maha 9, weight 3, weighted moments 6; sums
NORMAL_OPS = (210, 29)  # weight 12, Jacobian 62, A 63, b 18, rest; sums
# The offline surface: bench/accuracy.py's full-scale protocol (its ATE
# bound and seed), rendered with the freiburg-1 intrinsics, cut from 240
# frames to 160 (the same two laps) to keep the phase near 150 s; a ring
# graph past the pose graph's dense-to-CG switch (graph_cg_threshold =
# 2048), solved for 5 LM steps (CG: ~3 000-4 600 host-synced CG steps
# each).
OFFLINE_FRAMES, OFFLINE_RADIUS, OFFLINE_SEED = 160, 0.5, 11
OFFLINE_ATE_LIMIT_M = 0.02
OFFLINE_GRAPH_VERTICES, OFFLINE_GRAPH_ITERATIONS = 2560, 5
OFFLINE_PROFILED_FRAMES = 12
# 6i: the protocol's budget run (bench/accuracy.py --point-budget 0.25).
OFFLINE_BUDGET = 0.25
# Phase 7: the cells again, through the host loop and the level kernel in
# turns, each run shorter than its phase above.
TURN_SLAM_WARMUP, TURN_SLAM_FRAMES = 32, 96
TURN_OFFLINE_FRAMES = 96
# 5d: validation batches past 5a's 8, up to SlamConfig.validation_batch_max.
VALIDATION_BATCHES = (16, 32)
# 5e: a keyframe every frame past SlamConfig.resident_keyframes (64), at
# 160x120 (the eviction path does not depend on the width; the switch
# frames' graph solves set the time).
EVICT_FRAMES, EVICT_W, EVICT_H = 68, 160, 120
# 8: the chunked engine, bench.py's --chunk default; chunk 3's submit runs
# under set_sync_debug_mode("error").
CHUNK, SYNC_CHUNK = 16, 3
# 9: the live node, bench.py's live modes (its default is 400 frames).
LIVE_FRAMES, LIVE_TIMEOUT_S = 96, 300.0
LIVE_RUNS = (("odometry", 0, "f32", 0), ("slam", 0, "f32", 0),
             ("slam", CHUNK, "f32", 0), ("slam", CHUNK, "raw", 0),
             ("slam", CHUNK, "raw12", 0), ("slam", 0, "raw", 30),
             ("slam", CHUNK, "raw", 30))
# 5f: the graph kernel against the host loop; _ring_graph sizes that take
# the kernel's cluster route.
# Operations per LM step, counted from csrc/pose_graph.cu: per edge
# (residual, chi2 and blocks in f32; the Jacobian in f64), per edge of a
# residual-only pass (f32), per vertex (exp and the pose product, f32).
GRAPH_RING_VERTICES = (64, 128)
GRAPH_EDGE_OPS = (2110, 1070)
GRAPH_RESIDUAL_OPS = 530
GRAPH_VERTEX_OPS = 230
# 10: compaction on the main path's orbit (phase 3's frames).
COMPACT_THRESHOLD, COMPACT_BUDGET = 1.0, 0.5
# 11: parallel/ at 640x480: pairs and fleet candidates, sequences of the
# ring and their length; the world's timeout.
PARALLEL_B, PARALLEL_T, PARALLEL_TIMEOUT_S = 8, 6, 400.0
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
    """Which of the port's kernels a device record is, or None: the
    standalone sampler, the cluster kernel's mode (a) ("linearize") or
    mode (b) ("track_level"), or the pose-graph kernel ("pose_graph")."""
    for kernel, what in (("sample_slab_kernel", "sampler"),
                         ("track_level_kernel", "track_level"),
                         ("linearize_kernel", "linearize"),
                         ("pose_graph_kernel", "pose_graph")):
        if kernel in name:
            return what
    return None


def _traced(body, what):
    """Run body() under torch.profiler; return (body's result, the
    profiler). The session must hold one device record of each kernel for
    every launch its wrapper counted during body(): a session on the card
    now and then loses device records (all of them in 2 sessions of ~340
    in the smoke's runs, some of them in others), and one that falls short
    is run again, up to PROFILER_ATTEMPTS times, and said so; if every
    attempt falls short, the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels = ("sample_slab", "linearize", "track_level", "pose_graph")
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = _launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = body()
            torch.cuda.synchronize()
        after = _launches()
        recs = _device_intervals(prof)
        kinds = [_kernel_of(r[0]) for r in recs]
        launched = {k: after[k] - before[k] for k in kernels}
        recorded = {k: kinds.count("sampler" if k == "sample_slab" else k)
                    for k in kernels}
        if recs and recorded == launched:
            return out, prof
        print(f"phase 4: the profiler recorded {len(recs)} device records, "
              f"kernel records {recorded} for launches {launched}, for "
              f"{what} (attempt {attempt} of {PROFILER_ATTEMPTS})")
        time.sleep(1.0)
    raise AssertionError(f"the profiler lost device records of {what} in "
                         f"{PROFILER_ATTEMPTS} attempts")


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
            # '..18track_level_kernelENS_6ParamsE..' -> track_level_kernel
            m = re.search(r"\d+([a-z_]+_kernel)", line.split("'")[1])
            print(f"  ptxas: {m.group(1)}")
        elif "registers" in line or "spill" in line:
            print(f"    {line.replace('ptxas info    :', '').strip()}")


def _noisy_pair(device, cfg, noisy=True):
    """Frames 0 and 1 of the orbit (with sensor noise and depth holes, or
    noise-free), their pyramids and intrinsics, and the reference ->
    current pose perturbed off the optimum."""
    import torch

    from dvo_slam_tpu_torch.ops import camera, pyramid
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    rng = np.random.default_rng(0)
    frames = [scene.render(np.asarray(K_TUPLE), W, H, T) for T in poses[:2]]
    if noisy:
        frames = [synthetic.add_sensor_noise(i, z, rng, dropout=0.02)
                  for i, z in frames]
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
    """Mode (a) (one linearization) against linearize_reference on the
    same card tensors. Returns (max |rI, rZ| error, max abs error over A, b,
    sigma, err_mean, log1p_sum, err_raw, max A/b error over max|.|)."""
    import torch

    from dvo_slam_tpu_torch.ops import linearize

    sigma0 = torch.tensor([[40.0, 0.01], [0.01, 1e-3]], device=slab.device)
    got = linearize.linearize(ref, slab, K, T, cfg, sigma_init=sigma0,
                              sigma_warm=True)
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(slab.device, ref.px.numel()))
    want = linearize.linearize_reference(ref, slab, K, T, cfg,
                                         sigma_init=sigma0, sigma_warm=True)
    res = linearize.residuals_reference(ref, slab, K, T, cfg)
    torch.cuda.synchronize()
    if not torch.equal(valid, res.valid):
        raise AssertionError("mode (a)'s valid mask differs from plain")
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

        # Mode (a), over the configs it covers.
        r_err, abs_err, rel = 0.0, 0.0, 0.0
        for name, fields in CONFIGS.items():
            c = dataclasses.replace(cfg, **fields)
            ref_c = linearize.prepare_reference(ref_pyr[lvl], Ks[lvl], c)
            e = _check_fused(ref_c, slab, Ks[lvl], T, c)
            r_err, abs_err, rel = (max(r_err, e[0]), max(abs_err, e[1]),
                                   max(rel, e[2]))
        print(f"phase 2b linearize (mode a) vs plain: level {lvl}, configs "
              f"{list(CONFIGS)}: n_raw and valid mask exact, max |rI, rZ| "
              f"error {r_err:.1e}; max A/b error / max|.| {rel:.3e} (tol "
              f"1e-4); max abs error over all outputs {abs_err:.3e}")

        def fused():
            linearize.linearize(ref, slab, Ks[lvl], T, cfg)

        def plain_lin():
            linearize.linearize_reference(ref, slab, Ks[lvl], T, cfg)

        p_ms = _median_ms(plain_lin, calls=20)
        f_ms = _median_ms(fused)
        f_ms = min(f_ms, _median_ms(fused))
        p_ms = min(p_ms, _median_ms(plain_lin, calls=20))
        print(f"phase 2c linearize per call (events, median): level {lvl}: "
              f"mode (a) {f_ms:.4f} ms, plain {p_ms:.4f} ms")
        levels[lvl] = {"N": n, "H": slab.shape[1], "W": slab.shape[2],
                       "sampler_err": err, "r_err": r_err,
                       "lin_abs_err": abs_err, "ref": ref, "slab": slab,
                       "K": Ks[lvl], "T": T, "u": u, "v": v,
                       "batch": batch, "grid": grid}
    return cfg, levels


def _events_us(fn, n=20, reps=5):
    """Device microseconds per call of fn: n calls back to back between two
    CUDA events, the median over reps runs. A spin kernel queued before the
    first event holds the card while the host queues the n calls (for
    twice the host time of one call times n, at most 0.1 s), so a call
    that is shorter than its host dispatch is timed by the card, not by
    the host; a call's time then includes the card's gap between two
    launches (~1 us). A fn that syncs is timed with its host time: the
    plain versions of the cluster kernel's two modes are."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(SPIN_HZ * min(2.0 * n * host_s, 0.1))
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(1e3 * start.elapsed_time(end) / n)
    return float(np.median(runs))


def _parted(acc, acc_h, err, err_h, dn, dn_h, n, n_h, precision):
    """Where two IRLS paths of one row part, and whether at a tie: None if
    they take the same accept decisions and iteration count; else (k,
    tie). At an accept decision k: a tie if the step's error is within
    1e-5 (relative) of the best error before it on either side. At a stop
    (same decisions, other counts): a tie if the last common increment
    norm is within a factor 2 of the precision on either side."""
    for k in range(min(n, n_h)):
        if acc[k] != acc_h[k]:
            j = max(i for i in range(k) if acc[i])
            tie = any(abs(e[k] - e[j]) <= 1e-5 * abs(e[j])
                      for e in (err, err_h))
            return k, tie
    if n == n_h:
        return None
    k = min(n, n_h) - 1
    return k, any(0.5 * precision <= d[k] <= 2.0 * precision
                  for d in (dn, dn_h))


def _compare_level(got, want, cfg, what):
    """The level kernel's (T, Linearization, stats) against the host
    loop's on the same rows. T within 1e-5 on every row. A row whose two
    paths take the same decisions: iterations, termination codes, valid
    counts and accepted flags equal, the final A within 1e-4 * max|A|, b
    (the gradient, f32 evaluation noise at the optimum) by the step it
    asks for: ||A^-1 (b - b_host)|| <= cfg.precision. A row whose paths
    part must part at a tie (_parted). Returns (max |dT|, max A error /
    max|A|, parted rows as (row, iterations kernel / host, iteration
    where they part))."""
    (T, fin, st), (T_h, fin_h, st_h) = got, want
    d_T = (T - T_h).abs().max().item()
    if not d_T <= 1e-5:
        raise AssertionError(f"{what}: |T - T_host| {d_T} > 1e-5")
    host = [[x.cpu().numpy() for x in s["per_iter"]] + [
        s["iterations"].cpu().numpy()] for s in (st, st_h)]
    (valid, err, dn, acc, term, its), (valid_h, err_h, dn_h, acc_h, term_h,
                                        its_h) = host
    a_rel, parted = 0.0, []
    for b in range(T.shape[0]):
        n, n_h = int(its[b]), int(its_h[b])
        part = _parted(acc[b], acc_h[b], err[b], err_h[b], dn[b], dn_h[b], n,
                       n_h, cfg.precision)
        if part is not None:
            if not part[1]:
                raise AssertionError(
                    f"{what} row {b}: paths part at iteration {part[0]} "
                    f"without a tie (iterations {n} / {n_h}, errors "
                    f"{err[b][:n].tolist()} / {err_h[b][:n_h].tolist()})")
            parted.append((b, f"{n}/{n_h}", part[0]))
            continue
        if term[b] != term_h[b] or not np.array_equal(valid[b], valid_h[b]):
            raise AssertionError(f"{what} row {b}: termination or valid "
                                 f"counts differ")
        if float(fin_h.n_raw[b]) < 6:
            continue  # too few constraints: no system to compare
        A, A_h = (x.A[b].double().cpu().numpy() for x in (fin, fin_h))
        e = np.abs(A - A_h).max() / max(np.abs(A_h).max(), 1e-30)
        a_rel = max(a_rel, e)
        step = np.linalg.norm(np.linalg.solve(
            A_h, (fin.b[b] - fin_h.b[b]).double().cpu().numpy()))
        if not (e <= 1e-4 and step <= cfg.precision):
            raise AssertionError(f"{what} row {b}: final A error {e}, the "
                                 f"gradients' steps {step} apart")
    return d_T, a_rel, parted


def phase_level_vs_plain(device, cfg):
    """2d: the level kernel (mode b, one launch per level) against its
    plain version, the host loop over linearize_batched_reference, at each
    tracked level of the noise-free orbit pair (held by _compare_level)
    and of the noisy pair (gates: T within 1e-3, final valid counts within
    1 %), from the perturbed pose at B = 1; device time per launch and per
    IRLS iteration by CUDA events, and each level's cluster size."""
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize

    out = {}
    for pair, noisy in (("orbit", False), ("noisy", True)):
        ref_pyr, cur_pyr, Ks, T = _noisy_pair(device, cfg, noisy)
        for lvl in cfg.tracked_levels:
            ref = linearize.prepare_reference(ref_pyr[lvl][None], Ks[lvl],
                                              cfg)
            args = (ref, cur_pyr[lvl], Ks[lvl], T[None], cfg)
            got = dense_tracker.track_level(*args)
            want = dense_tracker._track_level(
                *args, linearize=linearize.linearize_batched_reference)
            its = (int(got[2]["iterations"][0]),
                   int(want[2]["iterations"][0]))
            if noisy:
                d_T = (got[0] - want[0]).abs().max().item()
                n_k, n_h = float(got[1].n_raw[0]), float(want[1].n_raw[0])
                if not (d_T <= 1e-3 and abs(n_k - n_h) <= 0.01 * n_h):
                    raise AssertionError(f"noisy pair level {lvl}: |dT| "
                                         f"{d_T}, valid {n_k} / {n_h}")
                check = (f"|dT| {d_T:.2e} (gate 1e-3), final valid {n_k:.0f}"
                         f" / {n_h:.0f}")
            else:
                d_T, a_rel, parted = _compare_level(got, want, cfg,
                                                    f"orbit level {lvl}")
                check = (f"|dT| {d_T:.2e}, A error / max|A| {a_rel:.2e}, "
                         f"paths parted at a tie: {parted or 'none'}")
            us = _events_us(lambda: linearize.track_level_kernels(*args))
            C, P, stored, smem = linearize.level_plan(device,
                                                      ref.px.shape[1])
            print(f"phase 2d track_level (mode b) vs host loop: {pair} "
                  f"pair level {lvl}: iterations {its[0]} / {its[1]}, "
                  f"termination {int(got[2]['per_iter'][4][0])} / "
                  f"{int(want[2]['per_iter'][4][0])}; {check}; cluster of "
                  f"{C} CTAs, {P} points each, "
                  f"{'kept in' if stored else 'recomputed, not in'} shared "
                  f"memory ({smem} B); device {us:.2f} us per launch, "
                  f"{us / its[0]:.2f} us per iteration (events)")
            out[(pair, lvl)] = {"us": us, "iterations": its[0], "C": C,
                                "err": d_T}
    return out


def phase_main_path(device):
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.utils import evaluate, synthetic

    cfg = TrackerConfig()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    frames = synthetic.render_sequence(scene, np.asarray(K_TUPLE), W, H,
                                       poses)
    tracker = OdometryTracker(K_TUPLE, cfg, device=device)
    iters, frame_ms = [], []
    _reset_launches()
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
    launches = _launches()
    ms_frame = float(np.mean(frame_ms))
    iters = np.stack(iters)
    n_it = int(iters.sum())
    est = [T for _, T in tracker.trajectory]
    ate = evaluate.ate_rmse(est, poses)
    levels = len(cfg.tracked_levels) * iters.shape[0]
    print(f"phase 3 main path: {N_FRAMES} frames {W}x{H}, "
          f"{ms_frame:.3f} ms/frame ({1e3 / ms_frame:.2f} fps) after "
          f"{N_WARMUP} warm-up frames (per frame median "
          f"{np.median(frame_ms):.3f}, min {min(frame_ms):.3f}, max "
          f"{max(frame_ms):.3f} ms); mean iterations per level "
          f"{cfg.tracked_levels} = {iters.mean(axis=0).round(3).tolist()}; "
          f"ATE {1e3 * ate:.4f} mm; launches track_level "
          f"{launches['track_level']} (tracked levels {levels}; IRLS "
          f"iterations {n_it}), linearize {launches['linearize']}, "
          f"standalone sampler {launches['sample_slab']}")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    if not (n_it > 0 and launches["track_level"] == levels):
        raise AssertionError(f"level-kernel launches "
                             f"{launches['track_level']} != tracked levels "
                             f"{levels}")
    if launches["linearize"] != 0 or launches["sample_slab"] != 0:
        raise AssertionError(f"the main path launched {launches}")
    return launches, tracker, frames, iters


def _batch_inputs(device, cfg, B, paired, level):
    """B reference rows from the first B frames of the noisy orbit, each
    at its own perturbed pose, against frame B (shared) or frames 1..B
    (one per row); per-row Sigma seeds, row 1's NaN (that row's device
    state takes the cold start)."""
    import torch

    from dvo_slam_tpu_torch.ops import camera, linearize, pyramid
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    rng = np.random.default_rng(1)
    frames = [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K_TUPLE), W, H, poses[k]), rng,
        dropout=0.02) for k in range(B + 1)]
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE, device=device),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=device),
                                  torch.as_tensor(z, device=device),
                                  cfg.num_levels)[level] for i, z in frames]
    cur = torch.stack(pyrs[1:B + 1]) if paired else pyrs[B]
    T = np.stack([
        (se3_np.inverse(poses[b + 1] if paired else poses[B]) @ poses[b])
        @ se3_np.exp(rng.normal(scale=2e-3, size=6)) for b in range(B)])
    T = torch.as_tensor(T, dtype=torch.float32, device=device)
    sigma = torch.tensor([[[40.0 + b, 0.01], [0.01, 1e-3]]
                          for b in range(B)], device=device)
    sigma[1] = float("nan")
    ref = linearize.prepare_reference(torch.stack(pyrs[:B]), Ks[level], cfg)
    return ref, cur, Ks[level], T, sigma


def _row(ref, b, keep=False):
    """Row b of batched reference points: (N,) views, or (1, N)."""
    from dvo_slam_tpu_torch.ops import linearize

    s = slice(b, b + 1) if keep else b
    return linearize.RefData(*(None if f is None else f[s] for f in ref))


def _check_batched(ref, cur, K, T, sigma, cfg):
    """The batched kernels against the plain version row by row, and each
    row against a B = 1 call on its inputs. Returns (max |rI, rZ| error,
    max abs error over A, b, sigma, err_mean, log1p_sum, err_raw, max A/b
    error over max|.|)."""
    import torch

    from dvo_slam_tpu_torch.ops import linearize

    B, N = ref.px.shape
    got = linearize.linearize_kernels_batched(ref, cur, K, T, cfg, sigma,
                                              True)
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(cur.device, N, B))
    r_err = abs_err = rel = 0.0
    for b in range(B):
        slab = cur[b] if cur.dim() == 4 else cur
        res = linearize.residuals_reference(_row(ref, b), slab, K, T[b], cfg)
        want = linearize.linearize_reference(_row(ref, b), slab, K, T[b],
                                             cfg, sigma[b], True)
        one = linearize.linearize_kernels_batched(
            _row(ref, b, keep=True), slab, K, T[b:b + 1], cfg,
            sigma[b:b + 1], True)
        torch.cuda.synchronize()
        if not torch.equal(valid[b], res.valid):
            raise AssertionError(f"B={B} row {b}: valid mask differs")
        err = max((rI[b] - res.rI).abs().max().item(),
                  (rZ[b] - res.rZ).abs().max().item())
        if err != 0.0:
            raise AssertionError(f"B={B} row {b}: rI, rZ differ by {err}")
        if float(got.n_raw[b]) != float(want.n_raw):
            raise AssertionError(f"B={B} row {b}: n_raw differs")
        for field in ("A", "b", "sigma", "err_mean", "log1p_sum", "err_raw"):
            a, w = getattr(got, field)[b], getattr(want, field)
            e = (a - w).abs().max().item()
            scale = w.abs().max().item()
            abs_err = max(abs_err, e)
            if field in ("A", "b"):
                rel = max(rel, e / max(scale, 1e-30))
            if not e <= 1e-4 * scale:
                raise AssertionError(f"B={B} row {b}: {field} error {e} > "
                                     f"1e-4 * {scale}")
        for field, x, y in zip(got._fields, got[:-1], one[:-1]):
            if not torch.equal(x[b], y[0]):
                raise AssertionError(f"B={B} row {b}: {field} differs from "
                                     f"a B = 1 call")
        r_err = max(r_err, err)
    return r_err, abs_err, rel


def phase_batched_vs_plain(device, cfg):
    """5a: the cluster kernel over a batch, B = 2 (shared slab) and 8
    (paired), on noisy frames: mode (a) against the plain version row by
    row; mode (b) against the host loop over the plain version (gates: T
    within 1e-3, final valid counts within 1 %), device time per launch by
    CUDA events."""
    from functools import partial

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize

    out = {}
    for B, paired in BATCHES.items():
        for lvl in cfg.tracked_levels:
            ref, cur, K, T, sigma = _batch_inputs(device, cfg, B, paired, lvl)
            r_err, abs_err, rel = _check_batched(ref, cur, K, T, sigma, cfg)
            kernel = partial(linearize.linearize_kernels_batched, ref, cur,
                             K, T, cfg)
            plain = partial(linearize.linearize_batched_reference, ref, cur,
                            K, T, cfg)
            p_ms = _median_ms(plain, calls=10)
            k_ms = _median_ms(kernel)
            k_ms = min(k_ms, _median_ms(kernel))
            p_ms = min(p_ms, _median_ms(plain, calls=10))
            got = dense_tracker.track_level(ref, cur, K, T, cfg)
            want = dense_tracker._track_level(
                ref, cur, K, T, cfg,
                linearize=linearize.linearize_batched_reference)
            d_T = (got[0] - want[0]).abs().max().item()
            d_n = ((got[1].n_raw - want[1].n_raw).abs()
                   / want[1].n_raw.clamp(min=1.0)).max().item()
            if not (d_T <= 1e-3 and d_n <= 0.01):
                raise AssertionError(f"B={B} level {lvl}: track_level vs "
                                     f"host loop |dT| {d_T}, valid {d_n}")
            its = got[2]["iterations"]
            level_us = _events_us(partial(linearize.track_level_kernels, ref,
                                          cur, K, T, cfg))
            print(f"phase 5a batch B={B} "
                  f"({'one slab per row' if paired else 'shared slab'}) "
                  f"level {lvl}: linearize (mode a): every row's valid mask "
                  f"exact, max |rI, rZ| error {r_err:.1e}, max A/b error / "
                  f"max|.| {rel:.3e} (tol 1e-4), every row bit-identical to "
                  f"a B = 1 call; per call (events, median) {k_ms:.4f} ms, "
                  f"plain row by row {p_ms:.4f} ms. track_level (mode b) vs "
                  f"host loop: |dT| {d_T:.2e}, final valid counts within "
                  f"{d_n:.2e}; iterations {its.tolist()} / "
                  f"{want[2]['iterations'].tolist()}; device {level_us:.2f} us "
                  f"per launch, {level_us / int(its.max()):.2f} us per "
                  f"iteration of the longest row (events)")
            out[(B, lvl)] = {"ref": ref, "cur": cur, "K": K, "T": T,
                             "r_err": r_err, "abs_err": abs_err,
                             "level_err": d_T, "N": ref.px.shape[1],
                             "H": cur.shape[-2], "W": cur.shape[-1],
                             "paired": paired}
    return out


def _ring():
    from dvo_slam_tpu_torch.utils import synthetic

    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(RING + 1, radius=0.06)[:RING]
    return synthetic.render_sequence(scene, np.asarray(K_TUPLE), W, H,
                                     poses), poses


def _slam_frames(slam, frames, n, t_base, on_frame=None):
    """bench.py's slam-lc loop: the ring over and over, a forced keyframe
    every FORCE_EVERY frames."""
    for k in range(n):
        i, z = frames[k % len(frames)]
        if k > 0 and k % FORCE_EVERY == 0:
            slam.force_keyframe()
        before = len(slam.keyframes)
        if on_frame is None:
            slam.update(i, z, t_base + k / 30.0)
        else:
            on_frame(k, lambda: slam.update(i, z, t_base + k / 30.0),
                     lambda: len(slam.keyframes) > before)


def _host_timed(owner, names, spent):
    """Wrap owner's methods so each call adds its host milliseconds to
    spent[name]; returns a function that restores them."""
    saved = {n: getattr(owner, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] = spent.get(name, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
        return timed

    for n, fn in saved.items():
        setattr(owner, n, wrap(n, fn))
    return lambda: [setattr(owner, n, fn) for n, fn in saved.items()]


def _lm_counted(solves, host_steps, copy=False):
    """Wrap pose_graph.optimize so each solve appends (LM steps asked, its
    LAST_STEPS tensor, the host graph, its keyword arguments) to solves
    (the step counts are read after the run: reading one is a host sync),
    and count the host loop's LM steps in host_steps[0] (_total_chi2 runs
    once per step of optimize_reference, never on the kernel route);
    returns a function that restores both. The engine's host graph is a
    view of arrays it rewrites later: with copy, a copy of it is kept."""
    from dvo_slam_tpu_torch.models import pose_graph

    optimize, total = pose_graph.optimize, pose_graph._total_chi2

    def counting_total(*args, **kwargs):
        host_steps[0] += 1
        return total(*args, **kwargs)

    def counting_optimize(graph, iterations=20, **kwargs):
        out = optimize(graph, iterations=iterations, **kwargs)
        if copy:
            graph = type(graph)(*(np.array(x) for x in graph))
        solves.append((iterations, pose_graph.LAST_STEPS, graph, kwargs))
        return out

    pose_graph._total_chi2 = counting_total
    pose_graph.optimize = counting_optimize

    def restore():
        pose_graph._total_chi2 = total
        pose_graph.optimize = optimize
    return restore


def _graph_route(graph, kwargs):
    """The route pose_graph.optimize takes for a solve of `graph` with
    `kwargs`: "kernel" (one launch) or "host loop"."""
    from dvo_slam_tpu_torch.models import pose_graph

    return ("kernel" if pose_graph.graph_route(
        kwargs.get("solver", "dense"), graph.poses.shape[0],
        kwargs.get("device", "cuda")) else "host loop")


def _lm_summary(solves):
    """'asked N: k solves, LM steps run mean / min / max' per N."""
    by = {}
    for asked, ran, *_ in solves:
        by.setdefault(asked, []).append(int(ran))
    return "; ".join(f"asked {a}: {len(r)} solves, run {np.mean(r):.2f} "
                     f"mean, {min(r)} min, {max(r)} max"
                     for a, r in sorted(by.items()))


def phase_slam(device):
    """5b: KeyframeSlam over bench.py's slam-lc loop."""
    import torch

    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import local_map, pose_graph
    from dvo_slam_tpu_torch.ops import linearize
    from dvo_slam_tpu_torch.utils import evaluate

    cfg, slam_cfg = TrackerConfig(), SlamConfig()
    frames, poses = _ring()
    warm = KeyframeSlam(K_TUPLE, cfg, slam_cfg, enable_loop_closure=True,
                        device=device)
    warm.init()
    _slam_frames(warm, frames, SLAM_FRAMES, 0.0)
    warm.finish()
    slam = KeyframeSlam(K_TUPLE, cfg, slam_cfg, enable_loop_closure=True,
                        device=device)
    slam.init()
    frame_ms, per_frame = [], []

    def timed(k, update, switched):
        tl, li = linearize.LAUNCHES_TRACK_LEVEL, linearize.LAUNCHES_LINEARIZE
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_w = update()
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(T_w).all():
            raise AssertionError(f"SLAM frame {k}: non-finite pose")
        per_frame.append((switched(), linearize.LAUNCHES_TRACK_LEVEL - tl,
                          linearize.LAUNCHES_LINEARIZE - li))

    # Host milliseconds spent in each part of a switch (queued work only:
    # the drains include waiting for the device).
    spent = {}
    restore = [_host_timed(slam, ("_dispatch_loop_search", "_optimize",
                                  "_drain_device_reads", "_sync_poses"),
                           spent),
               _host_timed(local_map.LocalMap, ("optimize_async",), spent)]
    solves, host_steps = [], [0]
    restore.append(_lm_counted(solves, host_steps))
    _reset_launches()
    _slam_frames(slam, frames, SLAM_FRAMES, 100.0, timed)
    launches = _launches()
    for undo in restore:
        undo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = slam.finish()
    finish_ms = 1e3 * (time.perf_counter() - t0)
    est = [T for _, T in traj]
    gt = [poses[k % RING] for k in range(SLAM_FRAMES)]
    ate = evaluate.ate_rmse(est, gt)
    sw = [p for p in per_frame if p[0]]
    plain = [p for p in per_frame if not p[0]]
    ms = np.asarray(frame_ms)
    sw_ms = [m for m, p in zip(frame_ms, per_frame) if p[0]]
    pl_ms = [m for m, p in zip(frame_ms, per_frame) if not p[0]]
    print(f"phase 5b SLAM path: {SLAM_FRAMES} frames {W}x{H} after "
          f"{SLAM_FRAMES} warm-up frames on another instance: "
          f"{ms.mean():.3f} ms/frame ({1e3 / ms.mean():.2f} fps; median "
          f"{np.median(ms):.3f}, min {ms.min():.3f}, max {ms.max():.3f}); "
          f"frames without a switch {np.mean(pl_ms):.3f} ms, with a "
          f"switch {np.mean(sw_ms) if sw_ms else float('nan'):.3f} ms; "
          f"finish() {finish_ms:.1f} ms; keyframes {len(slam.keyframes)}, "
          f"loop edges accepted {slam.num_loop_edges}; ATE "
          f"{1e3 * ate:.4f} mm")
    print(f"phase 5b launches: track_level {launches['track_level']} "
          f"({launches['track_level'] / SLAM_FRAMES:.2f} per frame), "
          f"linearize {launches['linearize']}, standalone sampler "
          f"{launches['sample_slab']}; launches by (kernel, batch size) "
          f"{launches['by B']}; track_level per frame without a switch "
          f"{np.mean([p[1] for p in plain]):.2f}, per switch frame "
          f"({len(sw)}) {np.mean([p[1] for p in sw]) if sw else 0:.2f}; "
          f"validation cache {slam.validation_cache_stats}")
    n_sw = max(len(sw), 1)
    print("phase 5b host ms per switch frame (" + str(len(sw)) + " switches; "
          "time spent in each call, summed, over the switch count): "
          + ", ".join(f"{k} {v / n_sw:.3f}" for k, v in sorted(spent.items())))
    print(f"phase 5b pose-graph LM solves in the timed frames (window "
          f"solves ask {slam_cfg.local_map_iterations}, graph solves "
          f"{slam_cfg.optimization_iterations}; LAST_STEPS): "
          f"{_lm_summary(solves)}; pose-graph kernel launches "
          f"{launches['pose_graph']} ({launches['pose_graph'] / n_sw:.2f} "
          f"per switch frame), routes "
          f"{sorted({_graph_route(g, kw) for _, _, g, kw in solves})}, host "
          f"loop LM steps {host_steps[0]}")
    if slam.num_loop_edges < 1:
        raise AssertionError("the SLAM path accepted no loop edge")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"SLAM ATE {ate} m >= {ATE_LIMIT_M} m")
    if (launches["track_level"] == 0 or launches["linearize"] != 0
            or launches["sample_slab"] != 0 or launches["pose_graph"] == 0
            or host_steps[0] != 0):
        raise AssertionError(f"SLAM path launches {launches}, host loop LM "
                             f"steps {host_steps[0]}")
    window = [(g, dict(kw, iterations=it)) for it, _, g, kw in solves
              if not kw.get("use_robust")]
    on_kernel = [kw.get("use_robust", True) for _, _, g, kw in solves
                 if _graph_route(g, kw) == "kernel"]
    if len(on_kernel) != launches["pose_graph"]:
        raise AssertionError(f"{len(on_kernel)} solves on the kernel's "
                             f"route, {launches['pose_graph']} launches")
    # The final graph solve, twice on the same graph: the same bits.
    view = slam._solve_view()
    runs, solve_ms, final_solves = [], [], []
    undo = _lm_counted(final_solves, [0])
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(pose_graph.optimize(
            view, iterations=slam_cfg.final_optimization_iterations,
            use_robust=slam_cfg.use_robust_kernel,
            cauchy_c=slam_cfg.cauchy_c, gnc_init=16.0, gnc_adaptive=True,
            solver=slam._solver_for(view), device=device))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        solve_ms.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)))
    undo()
    same = (torch.equal(runs[0][0].poses, runs[1][0].poses)
            and torch.equal(runs[0][1], runs[1][1])
            and torch.equal(runs[0][2], runs[1][2]))
    print(f"phase 5b final graph solve ({view.poses.shape[0]} vertices, "
          f"{view.edge_i.shape[0]} edge slots, {slam._solver_for(view)}, "
          f"at most {slam_cfg.final_optimization_iterations} LM steps, "
          f"ran {[int(r) for _, r, *_ in final_solves]}): two runs "
          f"bit-identical: "
          f"{same}; host ms to its return / to its end: "
          + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in solve_ms))
    if not same:
        raise AssertionError("two runs of the final graph solve differ")
    return {"slam": slam, "frames": frames, "launches": launches,
            "ms_frame": float(ms.mean()), "ate": ate, "window": window[-1],
            "graph_launches": {
                "ring": sum(on_kernel), "window": on_kernel.count(False)}}


def _top_records(recs, n, k=6):
    """The k device-record names with the most device time: (us per frame,
    calls per frame, name)."""
    by_name = {}
    for name, s, e in recs:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:k]
    return [(tot / n, cnt / n, name) for name, (tot, cnt) in top]


def phase_profile(device, frames, host, n=3):
    """4: frames 1..n of the odometry main path under torch.profiler, on a
    fresh tracker given frame 0 unprofiled, through the level kernel or
    (host) the host loop: wall and device busy per frame, idle share,
    device records per frame and per IRLS iteration, the heaviest
    records; through the kernel, each level's device time per launch and
    per IRLS iteration. Returns the cell's numbers."""
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker

    tracker = OdometryTracker(K_TUPLE, TrackerConfig(), device=device)
    tracker.update(*frames[0], 0.0)

    def body():
        its = []
        t0 = time.perf_counter()
        for k in range(1, n + 1):
            tracker.update(*frames[k], float(k))
            its.append(tracker.last_result.iterations.cpu().tolist())
        torch.cuda.synchronize()
        return its, 1e6 * (time.perf_counter() - t0)

    with _host_loop(host):
        (its, wall_us), prof = _traced(body, "the main path")
    recs = sorted(_device_intervals(prof), key=lambda r: r[1])
    busy = _busy_us(recs)
    n_it = sum(map(sum, its))
    kinds = [_kernel_of(r[0]) for r in recs]
    route = "host loop" if host else "level kernel"
    print(f"phase 4 profile ({route}): {n} frames, {n_it} IRLS iterations, "
          f"wall {wall_us / 1e3 / n:.3f} ms/frame (profiler on), device "
          f"busy {busy / 1e3 / n:.3f} ms/frame, idle share "
          f"{1 - busy / wall_us:.4f}; {len(recs) / n:.1f} device records per "
          f"frame, {len(recs) / n_it:.1f} per IRLS iteration")
    for us, calls, name in _top_records(recs, n):
        print(f"  {us:9.1f} us/frame {calls:6.1f} calls/frame  {name[:90]}")
    if "sampler" in kinds:
        raise AssertionError("the main path launched the standalone sampler")
    levels = tracker.cfg.tracked_levels
    per_level = {}
    if host:
        if kinds.count("linearize") != n_it or "track_level" in kinds:
            raise AssertionError("the host loop's launches do not match its "
                                 "iterations")
    else:
        launches = [r for r, k in zip(recs, kinds) if k == "track_level"]
        if len(launches) != n * len(levels) or "linearize" in kinds:
            raise AssertionError(f"profiler saw {len(launches)} level-kernel "
                                 f"launches for {n * len(levels)} levels")
        for j, (_, s0, e0) in enumerate(launches):
            acc = per_level.setdefault(levels[j % len(levels)], [0.0, 0, 0])
            acc[0] += e0 - s0
            acc[1] += 1
            acc[2] += its[j // len(levels)][j % len(levels)]
        for lvl, (us, cnt, it) in per_level.items():
            print(f"phase 4 device time (profiler): level {lvl}, {cnt} "
                  f"launches, {it} IRLS iterations: track_level "
                  f"{us / cnt:.2f} us per launch, {us / it:.2f} us per "
                  f"iteration")
    return {"ms_frame": wall_us / 1e3 / n, "busy_ms": busy / 1e3 / n,
            "idle": 1 - busy / wall_us, "records": len(recs) / n,
            "per_level": per_level}


def _level_args(L, B=None):
    """A level's inputs as a batch (B None: phase 2's single pair as
    B = 1)."""
    from dvo_slam_tpu_torch.ops import linearize

    if B is None:
        return (linearize.RefData(*(None if f is None else f[None]
                                    for f in L["ref"])),
                L["slab"], L["K"], L["T"][None])
    return L["ref"], L["cur"], L["K"], L["T"]


def phase_device_times(cfg, levels, batched):
    """12: per level, device time per call by CUDA events (``_events_us``) of
    the standalone sampler, its plain version and the library call, and of
    the cluster kernel's two modes and their plain versions (mode (a):
    linearize_reference; mode (b): the host loop over
    linearize_batched_reference; both sync, so their times count the
    host's), at B = 1 (phase 2's noisy pair) and at the batches of phase
    5a; with the iterations each mode (b) call takes and the bounds."""
    from functools import partial

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize, sampler

    out = {}
    cases = [(1, lvl, L) for lvl, L in levels.items()] + [
        (B, lvl, L) for (B, lvl), L in batched.items()]
    for B, lvl, L in cases:
        args = _level_args(L, None if B == 1 else B)
        _, fin, st = dense_tracker.track_level(*args, cfg)
        d = {"its": st["iterations"].tolist(),
             "n_valid": float(fin.n_raw.sum()),
             "paired": L.get("paired", False)}
        d["linearize"] = _events_us(partial(
            linearize.linearize_kernels_batched, *args, cfg)) / 1e3
        d["linearize plain"] = _events_us(partial(
            linearize.linearize_batched_reference, *args, cfg), n=5) / 1e3
        d["track_level"] = _events_us(partial(
            linearize.track_level_kernels, *args, cfg)) / 1e3
        d["track_level plain"] = _events_us(partial(
            dense_tracker._track_level, *args, cfg,
            linearize=linearize.linearize_batched_reference),
            n=1, reps=3) / 1e3
        if B == 1:
            slab, u, v = L["slab"], L["u"], L["v"]
            d["sampler"] = _events_us(partial(sampler.sample_slab, slab, u,
                                              v)) / 1e3
            d["sampler plain"] = _events_us(partial(
                sampler.sample_slab_reference, slab, u, v), n=5) / 1e3
            d["grid_sample"] = _events_us(partial(
                _grid_sample, L["batch"], L["grid"])) / 1e3
        d["bounds"] = _bounds(cfg, L, B, d)
        if B == 1:
            d["bounds"]["sampler"] = _sampler_bound(slab, u, v)
        out[(B, lvl)] = d
    for (B, lvl), d in sorted(out.items()):
        its = d["its"]
        line = (f"phase 12 device time per call (CUDA events): B={B} level "
                f"{lvl}: linearize (mode a) {1e3 * d['linearize']:.2f} us "
                f"(plain {1e3 * d['linearize plain']:.2f}); track_level "
                f"(mode b) {1e3 * d['track_level']:.2f} us per launch for "
                f"{max(its)} iterations of the longest row, "
                f"{1e3 * d['track_level'] / max(its):.2f} us per iteration "
                f"(plain host loop {1e3 * d['track_level plain']:.2f} us "
                f"per call, host time included)")
        if B == 1:
            line += (f"; sample_slab {1e3 * d['sampler']:.2f} us (plain "
                     f"{1e3 * d['sampler plain']:.2f}, grid_sample "
                     f"{1e3 * d['grid_sample']:.2f})")
        print(line + "; bounds " + ", ".join(
            f"{k} {1e3 * ms:.4f} us ({by})"
            for k, (ms, by) in d["bounds"].items()))
    return out


def phase_slam_profile(slam_out, host, n=SLAM_PROFILED_FRAMES):
    """5c: n more frames of the SLAM path (the ring again, one of them a
    forced keyframe switch) under torch.profiler, through the level kernel
    or (host) the host loop, each frame a labelled segment: busy and idle
    share, device records and launches per frame without a switch, the
    switch frame's device busy time. Returns the cell's numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    slam, frames = slam_out["slam"], slam_out["frames"]
    switched = {}

    def body():
        t0 = time.perf_counter()
        for k in range(n):
            if k == n // 2:
                slam.force_keyframe()
            before = len(slam.keyframes)
            with record_function(f"smoke slam frame {k}"):
                slam.update(*frames[k % RING], 1000.0 + k / 30.0)
                torch.cuda.synchronize()
            switched[k] = len(slam.keyframes) > before
        return 1e6 * (time.perf_counter() - t0)

    with _host_loop(host):
        wall_us, prof = _traced(body, "the SLAM path")
    spans = {e.name: e.time_range for e in prof.events()
             if e.device_type == DeviceType.CPU
             and e.name.startswith("smoke slam frame")}
    # The device-side copies of the frame ranges are not device work.
    recs = sorted((r for r in _device_intervals(prof) if r[0] not in spans),
                  key=lambda r: r[1])
    busy = _busy_us(recs)
    kind = "linearize" if host else "track_level"
    plain_recs, plain_launch, sw_busy = 0, 0, []
    for k in range(n):
        span = spans[f"smoke slam frame {k}"]
        mine = [r for r in recs if span.start <= r[1] <= span.end]
        if switched[k]:
            sw_busy.append(_busy_us(mine))
        else:
            plain_recs += len(mine)
            plain_launch += sum(_kernel_of(r[0]) == kind for r in mine)
    n_plain = max(sum(not v for v in switched.values()), 1)
    print(f"phase 5c SLAM profile ({'host loop' if host else 'level kernel'})"
          f": {n} frames ({n - n_plain} with a switch), wall "
          f"{wall_us / 1e3 / n:.3f} ms/frame (profiler on), device busy "
          f"{busy / 1e3 / n:.3f} ms/frame, idle share {1 - busy / wall_us:.4f}"
          f"; frames without a switch: {plain_recs / n_plain:.1f} device "
          f"records and {plain_launch / n_plain:.2f} {kind} launches per "
          f"frame; switch frames: device busy "
          f"{np.mean(sw_busy) / 1e3 if sw_busy else float('nan'):.3f} ms")
    if not switched[n // 2]:
        raise AssertionError("the forced keyframe switch did not happen")
    if plain_launch == 0:
        raise AssertionError(f"the SLAM profile saw no {kind} launch")
    return {"ms_frame": wall_us / 1e3 / n, "idle": 1 - busy / wall_us,
            "records": plain_recs / n_plain}


def _bounds(cfg, L, B, d):
    """Per kernel at one level and batch: (ms, "bytes" or "operations"),
    the least time the card could take. Bytes: each input read once, each
    output written once: per linearization each row's reference points
    (17 B a point) and the current slab (24 B a pixel; once per distinct
    slab), mode (a)'s outputs (204 B a row and 9 B a point of rI, rZ,
    valid); mode (b) repeats a linearization's reads once per iteration
    this run's rows took. Operations: counted per point from the source,
    the Sigma steps' and the normal equations' over the valid points only
    (the final valid count standing for every iteration's)."""
    N, HW = L["N"], L["H"] * L["W"]
    steps = cfg.tdist_scale_iters
    its, n_valid = d["its"], d["n_valid"]
    f32_row = RESIDUAL_OPS[0] * N
    f32_valid = steps * STEP_OPS[0] + NORMAL_OPS[0]
    f64_valid = RESIDUAL_OPS[1] + steps * STEP_OPS[1] + NORMAL_OPS[1]
    slab_reads = sum(its) if d["paired"] else max(its)
    out = {
        "linearize": _bound_ms(
            B * (17 * N + 204 + 9 * N) + (B if d["paired"] else 1) * 24 * HW,
            B * f32_row + f32_valid * n_valid, f64_valid * n_valid),
        "track_level": _bound_ms(
            sum(its) * 17 * N + slab_reads * 24 * HW,
            sum(its) * f32_row + f32_valid * n_valid * sum(its) / B,
            f64_valid * n_valid * sum(its) / B),
    }
    return out


def _sampler_bound(slab, u, v):
    """The standalone sampler's bound at these inputs: u, v read (8 B a
    point), the (6, N) output and the in-bounds mask written (25 B a
    point), and of the slab only the distinct pixels that the points'
    bilinear corners fall on (24 B a pixel); 9 f32 operations a channel
    and point."""
    import torch

    H_, W_ = slab.shape[-2:]
    fin = torch.isfinite(u) & torch.isfinite(v)
    x0, y0 = u[fin].floor().long(), v[fin].floor().long()
    corners = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            ok = (x >= 0) & (x < W_) & (y >= 0) & (y < H_)
            corners.append((y * W_ + x)[ok])
    pixels = torch.unique(torch.cat(corners)).numel()
    N = u.numel()
    return _bound_ms(8 * N + 24 * pixels + 24 * N + N,
                     SAMPLER_F32_PER_CHANNEL * 6 * N, 0)


def kernel_rows(cfg, levels, launches, dev_times, slam_out,
                level_pairs, batched, chunked_launches, val_batches,
                compaction, par, graph, offline):
    """The kernels' JSON rows at the finest tracked level: the standalone
    sampler, and the cluster kernel's two modes at B = 1 (the odometry
    main path's launches), at the SLAM path's batch sizes (its launches at
    that B), and mode (b) at B = 2 on the chunked engine's scan (phase 8's
    launches; the same launch as the SLAM path's B = 2 row, timed there),
    timed in phase 12; mode (b) at the validation batches B = 16 and 32
    (5d; the SLAM path's launches at that B), at N = budget (10b; phase
    10a's compacted odometry run's launches), and the standalone sampler
    on the pixel-sharded route (11; rank 0's launches in the sharded pairs
    run); the pose-graph kernel on the ring's final keyframe graph and
    window graph (5b's graph and window solves' launches), on the offline
    benchmark's graph (6b's launches) and on _ring_graph at 64 and 128
    vertices (5e's launches at those sizes), timed in 5f. Every time by
    CUDA events."""
    slam_launches = slam_out["launches"]
    lvl = cfg.tracked_levels[-1]
    lin_err = max(max(x["r_err"], x["lin_abs_err"]) for x in levels.values())
    level_err = max([v["err"] for v in level_pairs.values()]
                    + [v["level_err"] for v in batched.values()])
    rows = []

    def row(name, src, replaces, n_launch, err, ms, plain_ms, bound, lib):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib})

    d = dev_times[(1, lvl)]
    row("sample_slab", "dvo_slam_tpu_torch/csrc/sampler.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226", launches["sample_slab"],
        max(x["sampler_err"] for x in levels.values()), d["sampler"],
        d["sampler plain"], d["bounds"]["sampler"], d["grid_sample"])
    by_b = slam_launches["by B"]
    for B in (1, *BATCHES):
        d = dev_times[(B, lvl)]
        tag = "" if B == 1 else f", batched B={B}"
        row(f"linearize (mode a){tag}", "dvo_slam_tpu_torch/csrc/linearize.cu",
            "dvo_slam_tpu/ops/pallas/sampler.py:226",
            launches["linearize"] if B == 1 else by_b.get(("linearize", B), 0),
            lin_err, d["linearize"], d["linearize plain"],
            d["bounds"]["linearize"], None)
        row(f"track_level (mode b){tag}",
            "dvo_slam_tpu_torch/csrc/linearize.cu",
            "dvo_slam_tpu/ops/pallas/sampler.py:226",
            launches["track_level"] if B == 1
            else by_b.get(("track_level", B), 0),
            level_err, d["track_level"], d["track_level plain"],
            d["bounds"]["track_level"], None)
    d = dev_times[(2, lvl)]
    row("track_level (mode b), batched B=2, chunked scan",
        "dvo_slam_tpu_torch/csrc/linearize.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226",
        chunked_launches["by B"].get(("track_level", 2), 0), level_err,
        d["track_level"], d["track_level plain"], d["bounds"]["track_level"],
        None)
    for B in VALIDATION_BATCHES:
        d = val_batches[(B, lvl)]
        row(f"track_level (mode b), validation batch B={B}",
            "dvo_slam_tpu_torch/csrc/linearize.cu",
            "dvo_slam_tpu/ops/pallas/sampler.py:226",
            by_b.get(("track_level", B), 0), d["err"], d["us"] / 1e3,
            d["plain_ms"], d["bound"], None)
    d = compaction[lvl]
    row(f"track_level (mode b), compacted to N = budget "
        f"({COMPACT_BUDGET:g})", "dvo_slam_tpu_torch/csrc/linearize.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226",
        compaction["launches"]["track_level"], compaction["err"],
        d["us"] / 1e3, d["plain_ms"], d["bound"], None)
    row("sample_slab, pixel-sharded route (parallel/)",
        "dvo_slam_tpu_torch/csrc/sampler.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226", par["launches"],
        par["err"], par["ms"], par["plain_ms"], par["bound"], par["lib_ms"])
    # No Pallas kernel: the JAX package's LM while_loop, compiled by XLA.
    for name, what, n_launch in (
            ("ring", "SLAM ring keyframe graph",
             slam_out["graph_launches"]["ring"]),
            ("window", "SLAM ring window graph",
             slam_out["graph_launches"]["window"]),
            ("offline", "offline benchmark graph",
             offline["launches"]["pose_graph"]),
            *((f"evict{v}", "5e's last solve at this M",
               slam_out["eviction"]["launches"][v])
              for v in GRAPH_RING_VERTICES)):
        d = graph[name]
        row(f"pose_graph (one dense LM solve), {what}, M={d['M']}, "
            f"cluster of {d['C']}",
            "dvo_slam_tpu_torch/csrc/pose_graph.cu",
            "dvo_slam_tpu/models/pose_graph.py:463", n_launch, d["err"],
            d["us"] / 1e3, d["plain_ms"], d["bound"], None)
    return rows


def _render_offline(out_dir, frames, width, height):
    """bench/accuracy.py's sequence, rendered with the freiburg-1
    intrinsics (the CLI's --fr 1) and written through the port's
    write_tum_dataset one frame at a time."""
    from dvo_slam_tpu_torch.ops import camera
    from dvo_slam_tpu_torch.utils import synthetic

    K = np.asarray(camera.TUM_FR1)
    rng = np.random.default_rng(OFFLINE_SEED)
    scene = synthetic.two_plane_scene(sharpness=1.0)
    poses = synthetic.orbit_trajectory(frames, radius=OFFLINE_RADIUS,
                                       yaw_amplitude=0.6, cycles=2.0)

    def stream():
        for T_wc in poses:
            i, z = scene.render(K, width, height, T_wc)
            yield synthetic.add_sensor_noise(i, z, rng, intensity_std=10.0,
                                             depth_rel_std=0.05,
                                             dropout=0.25)

    synthetic.write_tum_dataset(out_dir, stream(), poses)


def _cli(args):
    """cli.main(args) with its standard output captured: (rc, text)."""
    import contextlib
    import io

    from dvo_slam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def _reset_launches():
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.ops import linearize, sampler

    pose_graph.LAUNCHES = 0
    pose_graph.LAUNCHES_BY_M.clear()
    sampler.LAUNCHES = 0
    linearize.LAUNCHES_LINEARIZE = 0
    linearize.LAUNCHES_TRACK_LEVEL = 0
    linearize.LAUNCHES_BY_BATCH.clear()


def _launches():
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.ops import linearize, sampler

    return {"sample_slab": sampler.LAUNCHES,
            "linearize": linearize.LAUNCHES_LINEARIZE,
            "track_level": linearize.LAUNCHES_TRACK_LEVEL,
            "pose_graph": pose_graph.LAUNCHES,
            "by B": dict(sorted(linearize.LAUNCHES_BY_BATCH.items()))}


@contextlib.contextmanager
def _host_loop(on=True):
    """With on: the tracker runs each level as its host loop
    (dense_tracker._track_level over linearize_batched, i.e. one mode (a)
    launch per lockstep iteration), called directly in place of
    track_level; otherwise as shipped (one level-kernel launch)."""
    from dvo_slam_tpu_torch.models import dense_tracker

    saved = dense_tracker.track_level
    if on:
        dense_tracker.track_level = dense_tracker._track_level
    try:
        yield
    finally:
        dense_tracker.track_level = saved


@contextlib.contextmanager
def _host_graph(on=True):
    """With on: every graph solve runs the plain host loop
    (pose_graph.optimize_reference: ~200 eager ops and a host sync a LM
    step), swapped in for pose_graph.optimize as _lm_counted swaps it;
    otherwise as shipped (graph_route: one kernel launch a dense solve of
    up to pose_graph.KERNEL_MAX_VERTICES (128) vertices)."""
    from dvo_slam_tpu_torch.models import pose_graph

    saved = pose_graph.optimize
    if on:
        pose_graph.optimize = pose_graph.optimize_reference
    try:
        yield
    finally:
        pose_graph.optimize = saved


def _ring_graph(path, vertices):
    """A noisy two-lap ring of `vertices` poses (radius 5 m) written as
    .g2o: odometry edges with 1 cm / 0.005 rad noise chained into the
    initial poses (drift), and an edge from every 8th vertex of the second
    lap to the same place on the first."""
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import g2o_io, se3_np

    rng = np.random.default_rng(OFFLINE_SEED)
    lap = vertices // 2
    gt = []
    for k in range(vertices):
        a = 2 * np.pi * k / lap
        gt.append(se3_np.exp(np.array([5 * np.sin(a), 5 * (1 - np.cos(a)),
                                       0.2 * np.sin(2 * a), 0, 0, a])))
    noise = np.array([0.01] * 3 + [0.005] * 3)
    edges, T_est = [], [gt[0]]
    for k in range(vertices - 1):
        Z = (se3_np.inverse(gt[k]) @ gt[k + 1]
             @ se3_np.exp(rng.normal(size=6) * noise))
        edges.append((k, k + 1, Z, np.diag(1.0 / noise**2)))
        T_est.append(T_est[-1] @ Z)
    for k in range(lap, vertices, 8):
        Z = (se3_np.inverse(gt[k]) @ gt[k - lap]
             @ se3_np.exp(rng.normal(size=6) * noise))
        edges.append((k, k - lap, Z, np.diag(1.0 / noise**2)))
    g = pose_graph.empty_graph_host(vertices, len(edges))
    g.poses[:] = np.stack(T_est)
    for e, (i, j, Z, info) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = i, j
        g.measurements[e], g.information[e] = Z, info
        g.edge_mask[e] = True
    g = g._replace(num_vertices=np.asarray(vertices, np.int32),
                   num_edges=np.asarray(len(edges), np.int32))
    g2o_io.save_g2o(path, g)
    return len(edges)


def _initial_chi2(path, device, use_robust=True):
    """chi2 of a .g2o file's graph as loaded (zero LM steps; Cauchy c = 1,
    the CLI's default, unless use_robust is False)."""
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import g2o_io

    _, chi2, _ = pose_graph.optimize(g2o_io.load_g2o(path), iterations=0,
                                     use_robust=use_robust, device=device)
    return float(chi2)


def phase_offline(device, width=W, height=H, frames=OFFLINE_FRAMES,
                  graph_vertices=OFFLINE_GRAPH_VERTICES):
    """6: the offline surface over an on-disk TUM-layout sequence
    (bench/accuracy.py's protocol with the freiburg-1 intrinsics): the
    decoders, the CLI's benchmark / odometry / evaluate / optimize-graph
    commands, keyframe odometry through the benchmark harness, checkpoint
    resume, and the standalone sampler's route."""
    import dataclasses
    import itertools
    import os
    import tempfile

    import torch

    from dvo_slam_tpu_torch import benchmark, cli, native
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.ops import camera, linearize
    from dvo_slam_tpu_torch.utils import g2o_io, tum

    dev = ["--device", str(device)]
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    with tempfile.TemporaryDirectory(prefix="dvo_offline_") as tmp:
        seq = os.path.join(tmp, "seq")
        t0 = time.perf_counter()
        _render_offline(seq, frames, width, height)
        print(f"phase 6 dataset: {frames} frames {width}x{height} rendered, "
              f"noised and written as PNG in "
              f"{time.perf_counter() - t0:.1f} s")

        # 6a: the decoders (the native one built, or reused, first: its
        # g++ build is not decode time).
        t0 = time.perf_counter()
        built = not native.library_path().is_file()
        native.load()
        build_s = time.perf_counter() - t0
        ds = tum.TumDataset(seq)
        picks = [*range(3), *range(frames - 3, frames)]
        ms = {}
        for decoder in tum.DECODERS:
            t0 = time.perf_counter()
            got = [tum.load_image_pair(seq, ds.pairs[k][1], ds.pairs[k][3],
                                       decoder) for k in picks]
            ms[decoder] = (1e3 * (time.perf_counter() - t0) / len(picks), got)
        for (i_a, z_a), (i_b, z_b) in zip(ms["native"][1], ms["numpy"][1]):
            if not (np.array_equal(i_a, i_b)
                    and np.array_equal(z_a, z_b, equal_nan=True)):
                raise AssertionError("the native and numpy decoders differ")
        t0 = time.perf_counter()
        n_pref = sum(1 for _ in ds.prefetch_iter())
        pref_ms = 1e3 * (time.perf_counter() - t0) / n_pref
        print(f"phase 6a decoders: libdvo_native.so "
              f"{'built' if built else 'reused'} in {build_s:.2f} s; frames "
              f"{picks} identical from native and "
              f"numpy; decode ms/frame (rgb + depth) native "
              f"{ms['native'][0]:.2f}, numpy {ms['numpy'][0]:.2f}; native "
              f"prefetch loader over {n_pref} frames {pref_ms:.2f} ms/frame")
        if n_pref != frames:
            raise AssertionError(f"prefetch gave {n_pref} of {frames} frames")

        # 6b: `benchmark` (slam), then keyframe mode with the same configs.
        traj = os.path.join(tmp, "slam.txt")
        graph = os.path.join(tmp, "slam.g2o")
        cov = os.path.join(tmp, "slam_cov.txt")
        radius = f"{0.35 * OFFLINE_RADIUS:g}"
        flags = ["--fr", "1", "--min-entropy-ratio", "0.96",
                 "--search-radius", radius, "--min-constraint-distance", "3"]
        _reset_launches()
        rc, out = _cli(["benchmark", seq, *flags, "--trajectory-out", traj,
                        "--graph-out", graph, "--covariance-out", cov, *dev])
        launches = _launches()
        if rc != 0:
            raise AssertionError(f"benchmark exited {rc}")
        slam = json.loads(out)
        args = cli._parser().parse_args(["benchmark", seq, *flags])
        tracker_cfg, slam_cfg = cli._tracker_cfg(args), cli._slam_cfg(args)
        traj_kf = os.path.join(tmp, "keyframe.txt")
        kf = benchmark.run_tum_dataset(seq, tracker_cfg, slam_cfg,
                                       mode="keyframe",
                                       intrinsics=camera.TUM_FR1,
                                       trajectory_out=traj_kf, device=device)
        for name, r in (("slam (cli benchmark)", slam),
                        ("keyframe (run_tum_dataset)",
                         dataclasses.asdict(kf))):
            print(f"phase 6b {name}: {r['num_frames']} frames, "
                  f"{r['fps']:.3f} fps ({r['elapsed_s']:.3f} s engine "
                  f"time), keyframes {r['num_keyframes']}, loop edges "
                  f"{r['num_loop_edges']}, ATE {1e3 * r['ate_rmse_m']:.4f} "
                  f"mm, RPE {1e3 * r['rpe_trans_m']:.4f} mm / "
                  f"{r['rpe_rot_rad']:.6f} rad")
        print(f"phase 6b benchmark launches: track_level "
              f"{launches['track_level']}, linearize {launches['linearize']}, "
              f"standalone sampler {launches['sample_slab']}; by (kernel, "
              f"batch size) {launches['by B']}; pose-graph kernel "
              f"{launches['pose_graph']} "
              f"({launches['pose_graph'] / slam['num_frames']:.3f} per "
              f"frame)")
        ate_slam, ate_kf = slam["ate_rmse_m"], kf.ate_rmse_m
        if not ate_slam < OFFLINE_ATE_LIMIT_M:
            raise AssertionError(f"ATE(slam) {ate_slam} m >= "
                                 f"{OFFLINE_ATE_LIMIT_M} m")
        if slam["num_loop_edges"] < 1:
            raise AssertionError("the benchmark accepted no loop edge")
        if not ate_slam <= 0.7 * ate_kf:
            raise AssertionError(f"ATE(slam) {ate_slam} > 0.7 x ATE"
                                 f"(keyframe) {ate_kf}")
        if (launches["track_level"] == 0 or launches["linearize"] != 0
                or launches["sample_slab"] != 0
                or launches["pose_graph"] == 0):
            raise AssertionError(f"benchmark launches {launches}")
        bench_launches = launches
        # The benchmark's graph, cropped as the engine crops it to solve.
        saved = g2o_io.load_g2o(graph)
        bench_graph = pose_graph.crop(
            saved, pose_graph.bucket(int(saved.num_vertices), 16),
            pose_graph.bucket(int(saved.num_edges), 64))

        # 6i: the protocol's budget run (bench/accuracy.py --point-budget):
        # slam mode again with point compaction, beside 6b's runs.
        _reset_launches()
        budget = benchmark.run_tum_dataset(
            seq, dataclasses.replace(tracker_cfg,
                                     point_budget_fraction=OFFLINE_BUDGET),
            slam_cfg, mode="slam", intrinsics=camera.TUM_FR1, device=device)
        b_launches = _launches()
        ate_b = budget.ate_rmse_m
        gate_budget = bool(ate_b < OFFLINE_ATE_LIMIT_M
                           and budget.num_loop_edges >= 1
                           and ate_b <= 0.7 * ate_kf)
        print(f"phase 6i slam at point_budget_fraction {OFFLINE_BUDGET}: "
              f"{budget.num_frames} frames, {budget.fps:.3f} fps "
              f"({budget.elapsed_s:.3f} s engine time; 6b's un-budgeted "
              f"{slam['fps']:.3f}), keyframes {budget.num_keyframes}, loop "
              f"edges {budget.num_loop_edges}, ATE {1e3 * ate_b:.4f} mm "
              f"(6b {1e3 * ate_slam:.4f}, keyframe mode {1e3 * ate_kf:.4f}); "
              f"gate_budget {gate_budget} (ATE < "
              f"{1e3 * OFFLINE_ATE_LIMIT_M:g} mm, >= 1 loop edge, <= 0.7 x "
              f"ATE(keyframe)); launches track_level "
              f"{b_launches['track_level']}, linearize "
              f"{b_launches['linearize']}, standalone sampler "
              f"{b_launches['sample_slab']}")
        if not gate_budget:
            raise AssertionError("the budget run fails gate_budget")
        if (b_launches["track_level"] == 0 or b_launches["linearize"] != 0
                or b_launches["sample_slab"] != 0):
            raise AssertionError(f"budget run launches {b_launches}")

        # 6c: `odometry` with covariances.
        cov_odo = os.path.join(tmp, "odo_cov.txt")
        rc, out = _cli(["odometry", seq, "--fr", "1", "--covariance-out",
                        cov_odo, *dev])
        odo = json.loads(out)
        rows = [line.split() for line in open(cov_odo)]
        print(f"phase 6c odometry: {odo['num_frames']} frames, "
              f"{odo['fps']:.3f} fps, ATE {1e3 * odo['ate_rmse_m']:.4f} mm; "
              f"covariance file {len(rows)} lines of "
              f"{sorted({len(r) for r in rows})} fields")
        if rc != 0 or len(rows) != frames or any(len(r) != 37 for r in rows):
            raise AssertionError("odometry or its covariance file is wrong")

        # 6d: `evaluate` through the module entry point, in a subprocess,
        # then with --rpe-seconds in this process.
        gt_file = os.path.join(seq, "groundtruth.txt")
        proc = subprocess.run(
            [sys.executable, "-m", "dvo_slam_tpu_torch.cli", "evaluate", traj,
             gt_file], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"evaluate exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        rc, per_s = _cli(["evaluate", traj, gt_file, "--rpe-seconds"])
        outs = [dict(line.split() for line in text.strip().splitlines())
                for text in (proc.stdout, per_s)]
        ate_eval = float(outs[0]["ate_rmse_m"])
        print(f"phase 6d evaluate (python -m dvo_slam_tpu_torch.cli): "
              f"{outs[0]}; with --rpe-seconds {outs[1]}; |ATE - benchmark's| "
              f"{abs(ate_eval - ate_slam):.2e} m")
        if not (rc == 0 and abs(ate_eval - ate_slam) <= 1e-6):
            raise AssertionError(f"evaluate's ATE {ate_eval} != benchmark's "
                                 f"{ate_slam}")

        # 6e: keyframe mode through the harness's checkpoint_out / resume,
        # split at the middle frame, against 6b's uninterrupted keyframe
        # run (the same initial pose, from the ground truth).
        half = frames // 2
        ck = os.path.join(tmp, "state.npz")
        traj_res = os.path.join(tmp, "resumed.txt")
        kw = dict(groundtruth=ds.groundtruth_pose, mode="keyframe", warmup=0,
                  device=device)
        benchmark.run_sequence(itertools.islice(ds.prefetch_iter(), half),
                               camera.TUM_FR1, tracker_cfg, slam_cfg,
                               checkpoint_out=ck, **kw)
        mb = os.path.getsize(ck) / 1e6
        res = benchmark.run_sequence(
            itertools.islice(ds.prefetch_iter(), half, None), camera.TUM_FR1,
            tracker_cfg, slam_cfg, resume=ck, trajectory_out=traj_res, **kw)
        ta, tb = tum.read_trajectory(traj_res), tum.read_trajectory(traj_kf)
        diff = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(ta, tb))
        same = open(traj_res).read() == open(traj_kf).read()
        print(f"phase 6e checkpoint: {half} frames, save ({mb:.1f} MB), "
              f"resume, {frames - half} more against the uninterrupted "
              f"keyframe run: keyframes {res.num_keyframes} / "
              f"{kf.num_keyframes}, trajectory files identical {same}, max "
              f"|difference| {diff:.3e}")
        if (len(ta) != len(tb) or len(ta) != frames
                or res.num_keyframes != kf.num_keyframes
                or not diff <= 1e-6):
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one")

        # 6f: `optimize-graph` on the benchmark's graph and on a large ring.
        solved = os.path.join(tmp, "solved.g2o")
        before = _initial_chi2(graph, device)
        rc, out = _cli(["optimize-graph", graph, "--out", solved, *dev])
        print(f"phase 6f optimize-graph on the benchmark's graph: chi2 "
              f"before {before:.6g}; {out.strip()}")
        ring = os.path.join(tmp, "ring.g2o")
        n_edges = _ring_graph(ring, graph_vertices)
        # Plain least squares: with the CLI's Cauchy c = 1 every noisy
        # edge (chi2 ~ 6 at the truth) would weigh ~0.1 and the solve
        # barely moves.
        ring_before = _initial_chi2(ring, device, use_robust=False)
        for solver in ("dense", "cg"):
            sync()
            t0 = time.perf_counter()
            rc, out = _cli(["optimize-graph", ring, "--out", solved,
                            "--solver", solver, "--iterations",
                            str(OFFLINE_GRAPH_ITERATIONS),
                            "--no-robust-kernel", *dev])
            sync()
            ms_solve = 1e3 * (time.perf_counter() - t0)
            final = float(out.split()[-1])
            print(f"phase 6f optimize-graph --solver {solver} "
                  f"--no-robust-kernel on the "
                  f"{graph_vertices}-vertex ring ({n_edges} edges, "
                  f"{OFFLINE_GRAPH_ITERATIONS} LM iterations at most, "
                  f"graph_cg_threshold {slam_cfg.graph_cg_threshold}): "
                  f"{ms_solve:.1f} ms (load, solve, save), chi2 "
                  f"{ring_before:.6g} -> {final:.6g}")
            # (final is printed to 6 digits)
            if rc != 0 or not (np.isfinite(final)
                               and final <= ring_before * (1 + 1e-5)):
                raise AssertionError(f"{solver} solve: chi2 {final}")

        # 6g: a scale estimator off the kernels' route: the plain
        # linearization with the standalone sampler kernel.
        rows_seen = [0]
        batched = linearize.linearize_batched

        def counting(ref, cur_slab, K, T, *a, **kw):
            rows_seen[0] += T.shape[0]
            return batched(ref, cur_slab, K, T, *a, **kw)

        linearize.linearize_batched = counting
        _reset_launches()
        try:
            rc, out = _cli(["odometry", seq, "--fr", "1", "--max-frames",
                            "24", "--scale-estimator", "normal",
                            "--influence", "huber", *dev])
        finally:
            linearize.linearize_batched = batched
        launches = _launches()
        r = json.loads(out)
        print(f"phase 6g odometry --scale-estimator normal --influence huber "
              f"(24 frames): {r['fps']:.3f} fps, ATE "
              f"{1e3 * r['ate_rmse_m']:.4f} mm; linearizations "
              f"{rows_seen[0]}, standalone sampler launches "
              f"{launches['sample_slab']}, linearize {launches['linearize']}, "
              f"track_level {launches['track_level']}")
        if not (rc == 0 and rows_seen[0] > 0
                and launches["sample_slab"] == rows_seen[0]
                and launches["linearize"] == 0
                and launches["track_level"] == 0):
            raise AssertionError(f"off-route launches {launches}, "
                                 f"linearizations {rows_seen[0]}")
        return {"frames": [ds[k] for k in range(
                    max(2 * OFFLINE_PROFILED_FRAMES, TURN_OFFLINE_FRAMES))],
                "groundtruth": ds.groundtruth_pose,
                "tracker_cfg": tracker_cfg, "slam_cfg": slam_cfg,
                "graph": bench_graph, "launches": bench_launches,
                "frames_run": slam["num_frames"]}


def _graph_parted(run, run_h):
    """Where two LM runs of one graph part: None if they take the same
    accept decisions and the same number of steps; else (p, tie): p the
    first step whose accept decision differs, or the last step of the run
    that stopped first; a tie if at step p neither run's trial moved the
    chi2 by more than 1e-4 relative (atol 1e-6), the final chi2's
    tolerance: the two routes' f32 factorizations give steps that differ
    with the system's conditioning, and a decision on a trial within that
    tolerance of the current chi2 is one the comparison cannot resolve."""
    (steps, st), (steps_h, st_h) = run, run_h
    n = min(steps, steps_h)
    p = next((k for k in range(n) if st[k, 3] != st_h[k, 3]), None)
    if p is None:
        if steps == steps_h:
            return None
        p = n - 1
    tie = p >= 0 and all(abs(s[p, 1] - s[p, 0]) <= 1e-4 * s[p, 0] + 1e-6
                         for s in (st, st_h))
    return p, tie


def _graph_bound(graph, steps, iterations, gnc_adaptive):
    """The graph kernel's bound for one solve: the packed upload (graph and
    sum plans, padding included) read once, the outputs written once; the
    operations of `steps` LM steps over the graph's nv real vertices and
    ne edges of the mask (inactive slots are decoupled identity blocks
    and masked edges add zero): per edge, per vertex, the assembly's
    adds, n^3 / 3 for the factorization and 2 n^2 for the solves at
    n = 6 nv, the adaptive start's and the final pass's residuals."""
    from dvo_slam_tpu_torch.models import pose_graph

    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    nv, ne = int(graph.num_vertices), int(np.asarray(graph.edge_mask).sum())
    n = 6 * nv
    buf, _ = pose_graph._pack(graph)
    step_f32 = (ne * (GRAPH_EDGE_OPS[0] + GRAPH_RESIDUAL_OPS)
                + 18 * (4 * ne + nv) + 12 * ne + n**3 / 3 + 2 * n * n
                + nv * GRAPH_VERTEX_OPS)
    f32 = steps * step_f32 + (1 + int(gnc_adaptive)) * ne * GRAPH_RESIDUAL_OPS
    return _bound_ms(4 * buf.size + 4 * (16 * M + 1 + E + 4 * iterations) + 4,
                     f32, steps * ne * GRAPH_EDGE_OPS[1])


def _graph_f64(graph, device, upload=None):
    """A graph of tensors on `device` (uploaded by `upload`, by default
    pose_graph.to_device) with f64 poses, measurements and information."""
    from dvo_slam_tpu_torch.models import pose_graph

    g = (upload or pose_graph.to_device)(graph, device)
    return g._replace(poses=g.poses.double(),
                      measurements=g.measurements.double(),
                      information=g.information.double())


def _graph_on_cpu(graph, kw):
    """The host loop on the CPU in f32 and in f64 (to_device swapped for
    _graph_f64, as _host_graph swaps optimize): ((steps, chi2) in f32,
    (steps, chi2) in f64)."""
    from dvo_slam_tpu_torch.models import pose_graph

    out, upload = [], pose_graph.to_device
    for f64 in (False, True):
        if f64:
            pose_graph.to_device = functools.partial(_graph_f64,
                                                     upload=upload)
        try:
            _, chi2, _ = pose_graph.optimize_reference(graph, device="cpu",
                                                       **kw)
        finally:
            pose_graph.to_device = upload
        out.append((int(pose_graph.LAST_STEPS), float(chi2)))
    return out


def phase_graph(device, slam_out, offline):
    """5f: the pose-graph kernel (csrc/pose_graph.cu, one launch a dense
    solve) against the plain host loop (optimize_reference, cuSOLVER's
    Cholesky) on the card, on the SLAM ring's final keyframe graph (as its
    final solve), the last window graph of 5b's timed run, 6b's benchmark
    graph (cropped as the engine crops it, as its final solve), 5e's last
    solve at each of GRAPH_RING_VERTICES (as 5e ran it) and _ring_graph
    at GRAPH_RING_VERTICES (as an interleaved graph solve):
    steps on each route, max |dpose|, the chi2's relative difference, where
    the two runs' decisions part (only at a tie: _graph_parted);
    the kernel's device us per solve and per step (CUDA events behind a
    spin kernel), the host loop's ms (host clock to a sync), cuSOLVER's
    factor and solve (cholesky_ex + cholesky_solve) on the graph's damped
    system at its first step (events), the bound. The f32 resolution of
    each graph: the plain formula (_build_blocks) at the kernel's poses in
    f32 against the same in f64. Where its own f32 error passes a
    tolerance (weights or chi2, 1e-4), f32 cannot resolve that tolerance
    on the graph, and the checks of the two routes against each other
    that rest on it (weights, chi2, decisions) are printed, not held,
    beside the host loop on the CPU in f32 and f64; the poses are held on
    every graph, and every graph but 5e's must be resolved. Returns
    {name: row numbers}."""
    import functools
    import os
    import shutil
    import tempfile

    import torch

    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import g2o_io

    def final_kw(slam_cfg):
        return dict(iterations=slam_cfg.final_optimization_iterations,
                    use_robust=slam_cfg.use_robust_kernel,
                    cauchy_c=slam_cfg.cauchy_c, gnc_init=16.0,
                    gnc_adaptive=True)

    window, window_kw = slam_out["window"]
    cases = [("ring", slam_out["slam"]._solve_view(),
              final_kw(SlamConfig())),
             ("window", window,
              {k: v for k, v in window_kw.items() if k != "device"}),
             ("offline", offline["graph"], final_kw(offline["slam_cfg"]))]
    cases += [(f"evict{M}", *slam_out["eviction"]["graphs"][M])
              for M in GRAPH_RING_VERTICES]
    tmp = tempfile.mkdtemp(prefix="dvo_graph_")
    for vertices in GRAPH_RING_VERTICES:
        path = os.path.join(tmp, f"ring{vertices}.g2o")
        n_edges = _ring_graph(path, vertices)
        g = pose_graph.crop(g2o_io.load_g2o(path, max_vertices=vertices),
                            vertices, pose_graph.bucket(n_edges, 64))
        cases.append((f"ring{vertices}", g, dict(
            final_kw(SlamConfig()),
            iterations=SlamConfig().optimization_iterations)))
    shutil.rmtree(tmp)
    out = {}
    for name, g, kw in cases:
        M, E = g.poses.shape[0], g.edge_i.shape[0]
        if _graph_route(g, {"device": device}) != "kernel":
            raise AssertionError(f"5f {name}: M = {M} is off the kernel's "
                                 f"route")
        before = pose_graph.LAUNCHES
        got = pose_graph.optimize(g, device=device, **kw)
        run = (int(pose_graph.LAST_STEPS), pose_graph.LAST_STATS.cpu().numpy())
        if pose_graph.LAUNCHES != before + 1:
            raise AssertionError(f"5f {name}: not one kernel launch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pose_graph.optimize_reference(g, device=device, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        run_h = (int(pose_graph.LAST_STEPS),
                 pose_graph.LAST_STATS.cpu().numpy())
        d_pose = (got[0].poses - want[0].poses).abs().max().item()
        # The weights are far more sensitive to the poses than the poses'
        # own tolerance (a loop edge's Cauchy weight moves ~1e-3 for a
        # 2e-6 pose change): they are held to the plain formula at the
        # kernel's own poses, and their route-to-route difference printed.
        g_k = pose_graph.to_device(g, device)._replace(poses=got[0].poses)
        _, _, chi2_at, w_at = pose_graph._build_blocks(
            g_k, pose_graph._topology(g, device), kw.get("use_robust", True),
            kw.get("cauchy_c", 1.0))
        d_w = (got[2] - w_at).abs().max().item()
        d_w_route = (got[2] - want[2]).abs().max().item()
        d_chi2_at = abs(float(got[1]) - float(chi2_at)) / max(
            abs(float(chi2_at)), 1e-30)
        _, _, chi2_64, w_64 = pose_graph._build_blocks(
            _graph_f64(g, device)._replace(poses=got[0].poses.double()),
            pose_graph._topology(g, device), kw.get("use_robust", True),
            kw.get("cauchy_c", 1.0))
        res_w = (w_at.double() - w_64).abs().max().item()
        res_c = abs(float(chi2_at) - float(chi2_64)) / float(chi2_64)
        resolved = res_w <= 1e-4 and res_c <= 1e-4
        c, c_h = float(got[1]), float(want[1])
        d_chi2 = abs(c - c_h) / max(abs(c_h), 1e-30)
        parted = _graph_parted(run, run_h)
        # Past one CTA a solve takes 10-750 ms: fewer calls a run.
        us = _events_us(functools.partial(pose_graph.optimize, g,
                                          device=device, **kw),
                        *((20, 5) if M <= 32 else (4, 3)))
        # cuSOLVER on the first step's damped system (the plain loop's).
        g0 = pose_graph.to_device(g, device)
        topo = pose_graph._topology(g, device)
        H, grad, _, _ = pose_graph._build_system(
            g0, topo, kw.get("use_robust", True), kw.get("cauchy_c", 1.0))
        damped = (H + 1e-6 * torch.diag(torch.diagonal(H))
                  + pose_graph._JITTER * torch.eye(6 * M, device=device))
        cusolver_us = _events_us(lambda: torch.cholesky_solve(
            -grad[:, None], torch.linalg.cholesky_ex(damped)[0]))
        bound = _graph_bound(g, run[0], kw["iterations"],
                             kw.get("gnc_adaptive", False))
        print(f"phase 5f pose graph, {name} graph (M = {M}, E = {E}, "
              f"cluster of {pose_graph.kernel_plan(M)[1]} CTAs, "
              f"{int(g.num_vertices)} vertices, {int(g.num_edges)} edges; "
              f"{kw['iterations']} LM steps at most): steps kernel {run[0]}, "
              f"host loop {run_h[0]}; "
              + ("same decisions" if parted is None else
                 f"decisions part at step {parted[0]} (chi2 moved by "
                 f"{(run[1][parted[0], 1] - run[1][parted[0], 0]) / run[1][parted[0], 0]:.3e}"
                 f" / {(run_h[1][parted[0], 1] - run_h[1][parted[0], 0]) / run_h[1][parted[0], 0]:.3e}"
                 f" relative, step norms {run[1][parted[0], 2]:.3e} / "
                 f"{run_h[1][parted[0], 2]:.3e}; tie {parted[1]})")
              + f"; max |dpose| {d_pose:.3e} (tol 1e-4), chi2 {c:.7g} / "
              f"{c_h:.7g} (rel {d_chi2:.3e}, tol 1e-4); at the kernel's "
              f"poses the plain chi2 within {d_chi2_at:.3e} (tol 1e-4) and "
              f"weights within {d_w:.3e} (tol 1e-4), weights route to route "
              f"{d_w_route:.3e}; kernel {us:.2f} us per solve (events), "
              f"{us / max(run[0], 1):.2f} per step; host loop "
              f"{plain_ms:.3f} ms ({plain_ms / max(run_h[0], 1):.3f} per "
              f"step); cholesky_ex + cholesky_solve on the damped "
              f"{6 * M}x{6 * M} system {cusolver_us:.2f} us; bound "
              f"{1e3 * bound[0]:.4f} us ({bound[1]}); f32 resolution at "
              f"the kernel's poses (plain formula f32 against f64): weights "
              f"{res_w:.3e}, chi2 {res_c:.3e}: "
              + ("resolved" if resolved else
                 "beyond f32, only the poses held; host loop on the CPU "
                 + ", ".join(f"{t} {n} steps, chi2 {x:.7g}" for t, (n, x)
                             in zip(("f32", "f64"), _graph_on_cpu(g, kw)))))
        close = (d_w <= 1e-4 and d_chi2_at <= 1e-4
                 and abs(c - c_h) <= 1e-4 * abs(c_h) + 1e-6
                 and (parted is None or parted[1]))
        if not (d_pose <= 1e-4 and (close or not resolved)):
            raise AssertionError(f"5f {name}: the graph kernel disagrees "
                                 f"with the host loop")
        if not (resolved or name.startswith("evict")):
            raise AssertionError(f"5f {name}: beyond f32 resolution")
        out[name] = {"M": M, "C": pose_graph.kernel_plan(M)[1], "us": us,
                     "plain_ms": plain_ms, "err": d_pose,
                     "bound": bound, "steps": run[0],
                     "cusolver_us": cusolver_us}
    return out


def phase_offline_profile(offline, device, host, n=OFFLINE_PROFILED_FRAMES):
    """6h: the offline cell's SLAM path under torch.profiler, through the
    level kernel or (host) the host loop. A fresh KeyframeSlam with the
    benchmark's configs (loop closure on) tracks the sequence's first n
    frames unprofiled, then its next n in one profiler session: busy and
    idle share, device records per frame, and level-kernel launches (or,
    through the host loop, mode (a) launches: lockstep IRLS iterations,
    the validation batches' included) per frame. Returns the cell's
    numbers."""
    import torch

    from dvo_slam_tpu_torch import KeyframeSlam
    from dvo_slam_tpu_torch.ops import camera

    frames = offline["frames"]
    with _host_loop(host):
        slam = KeyframeSlam(camera.TUM_FR1, offline["tracker_cfg"],
                            offline["slam_cfg"], enable_loop_closure=True,
                            device=device)
        slam.init(offline["groundtruth"](frames[0][0]))
        for ts, intensity, depth in frames[:n]:
            slam.update(intensity, depth, ts)

        def body():
            before = len(slam.keyframes)
            t0 = time.perf_counter()
            for ts, intensity, depth in frames[n:2 * n]:
                slam.update(intensity, depth, ts)
            torch.cuda.synchronize()
            return (1e6 * (time.perf_counter() - t0),
                    len(slam.keyframes) - before)

        (wall_us, switches), prof = _traced(body, "the offline cell")
    recs = _device_intervals(prof)
    busy = _busy_us(recs)
    kind = "linearize" if host else "track_level"
    launched = sum(_kernel_of(r[0]) == kind for r in recs)
    print(f"phase 6h offline profile ({'host loop' if host else 'level kernel'}"
          f"): {n} frames ({switches} keyframe switches), wall "
          f"{wall_us / 1e3 / n:.3f} ms/frame (profiler on), device busy "
          f"{busy / 1e3 / n:.3f} ms/frame, idle share "
          f"{1 - busy / wall_us:.4f}; {len(recs) / n:.1f} device records and "
          f"{launched / n:.2f} {kind} launches per frame")
    if launched == 0:
        raise AssertionError(f"the offline profile saw no {kind} launch")
    return {"ms_frame": wall_us / 1e3 / n, "idle": 1 - busy / wall_us,
            "records": len(recs) / n}


def _loop_graph(slam):
    """A SLAM run's discrete result: keyframe indices, the graph's edges
    (i, j, mask) and the loop-edge count."""
    g = slam.graph
    return ([kf.idx for kf in slam.keyframes],
            [(int(g.edge_i[e]), int(g.edge_j[e]), bool(g.edge_mask[e]))
             for e in range(int(g.num_edges))], slam.num_loop_edges)


def phase_turns(device, odo_frames, slam_out, offline):
    """7: the three cells timed through the host loop and through the
    level kernel in one process, in turns (host, kernel, kernel, host):
    odometry (a fresh OdometryTracker over phase 3's 24-frame orbit,
    ms/frame after N_WARMUP frames; every (frame, level) whose iteration
    count differs between the routes is listed), SLAM (a fresh
    KeyframeSlam over the ring, TURN_SLAM_WARMUP frames, then
    TURN_SLAM_FRAMES timed; the two routes must give the same keyframes
    and graph edges), offline
    (run_sequence in slam mode over the first TURN_OFFLINE_FRAMES frames
    of phase 6's sequence: engine ms/frame). Then the SLAM and offline
    cells through the level kernel with every graph solve on the host loop
    (optimize_reference swapped in for optimize) and as shipped (the graph
    kernel), in turns (host loop, kernel, kernel, host loop): on the ring
    per frame with and without a switch, and the host ms per switch of
    KeyframeSlam._optimize and LocalMap.optimize_async."""
    import torch

    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch import benchmark
    from dvo_slam_tpu_torch.models import local_map
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import camera

    graphs, odo_iters, switches = {}, {}, {True: [], False: []}

    def odometry(host):
        tracker = OdometryTracker(K_TUPLE, TrackerConfig(), device=device)
        ms, its = [], []
        for k, (i, z) in enumerate(odo_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.update(i, z, float(k))
            torch.cuda.synchronize()
            if k >= N_WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
            if k > 0:
                its.append(tracker.last_result.iterations.tolist())
        odo_iters.setdefault(host, its)
        return float(np.mean(ms))

    def slam(host):
        run = KeyframeSlam(K_TUPLE, TrackerConfig(), SlamConfig(),
                           enable_loop_closure=True, device=device)
        run.init()
        _slam_frames(run, slam_out["frames"], TURN_SLAM_WARMUP, 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _slam_frames(run, slam_out["frames"], TURN_SLAM_FRAMES,
                     TURN_SLAM_WARMUP / 30.0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TURN_SLAM_FRAMES
        graphs.setdefault(host, _loop_graph(run))
        return ms

    def slam_graph(host):
        run = KeyframeSlam(K_TUPLE, TrackerConfig(), SlamConfig(),
                           enable_loop_closure=True, device=device)
        run.init()
        _slam_frames(run, slam_out["frames"], TURN_SLAM_WARMUP, 0.0)
        frame_ms, switched, spent = [], [], {}

        def timed(k, update, sw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            update()
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            switched.append(sw())

        restore = (_host_timed(run, ("_optimize",), spent),
                   _host_timed(local_map.LocalMap, ("optimize_async",),
                               spent))
        try:
            _slam_frames(run, slam_out["frames"], TURN_SLAM_FRAMES,
                         TURN_SLAM_WARMUP / 30.0, timed)
        finally:
            for undo in restore:
                undo()
        n_sw = max(sum(switched), 1)
        switches[host].append((
            np.mean([m for m, s in zip(frame_ms, switched) if s]),
            np.mean([m for m, s in zip(frame_ms, switched) if not s]),
            spent.get("_optimize", 0.0) / n_sw,
            spent.get("optimize_async", 0.0) / n_sw, sum(switched)))
        graphs.setdefault(("graph", host), _loop_graph(run))
        return float(np.mean(frame_ms))

    def offline_cell(host):
        res = benchmark.run_sequence(
            iter(offline["frames"][:TURN_OFFLINE_FRAMES]), camera.TUM_FR1,
            offline["tracker_cfg"], offline["slam_cfg"],
            groundtruth=offline["groundtruth"], mode="slam", device=device)
        return 1e3 / res.fps

    out = {}
    for cell, fn in (("odometry", odometry), ("slam", slam),
                     ("offline", offline_cell)):
        times = {True: [], False: []}
        for host in (True, False, False, True):
            with _host_loop(host):
                times[host].append(fn(host))
        out[cell] = times
        h, k = times[True], times[False]
        print(f"phase 7 {cell} cell in turns (host, kernel, kernel, host): "
              f"host loop {h[0]:.3f}, {h[1]:.3f} ms/frame; level kernel "
              f"{k[0]:.3f}, {k[1]:.3f} ms/frame; host / kernel "
              f"{np.mean(h) / np.mean(k):.2f}x")
    for cell, fn in (("slam", slam_graph), ("offline", offline_cell)):
        times = {True: [], False: []}
        for host in (True, False, False, True):
            with _host_graph(host):
                times[host].append(fn(host))
        out[cell + " graph"] = times
        h, k = times[True], times[False]
        print(f"phase 7 {cell} cell, graph solves in turns (host loop, "
              f"graph kernel, graph kernel, host loop; the level kernel "
              f"throughout): host loop {h[0]:.3f}, {h[1]:.3f} ms/frame; "
              f"graph kernel {k[0]:.3f}, {k[1]:.3f} ms/frame; host / kernel "
              f"{np.mean(h) / np.mean(k):.2f}x")
    for host in (True, False):
        print(f"phase 7 slam cell, graph solves through the "
              f"{'host loop' if host else 'graph kernel'}: "
              + "; ".join(f"{n} switches, switch frames {a:.3f} ms, other "
                          f"frames {b:.3f} ms, host ms per switch: _optimize "
                          f"{c:.3f}, optimize_async {d:.3f}"
                          for a, b, c, d, n in switches[host]))
    kf_g, edges_g, loops_g = graphs[("graph", False)]
    kf_gh, edges_gh, loops_gh = graphs[("graph", True)]
    print(f"phase 7 slam graph turns: keyframes "
          f"{'the same' if kf_g == kf_gh else f'{kf_g} / {kf_gh}'} on both "
          f"graph routes; graph edges "
          f"{'identical' if edges_g == edges_gh else 'differ'} (loop edges "
          f"{loops_g} through the kernel, {loops_gh} through the host loop)")
    if min(loops_g, loops_gh) < 1:
        raise AssertionError("the SLAM graph turns accepted no loop edge")
    levels = TrackerConfig().tracked_levels
    differ = [(k + 1, lvl, a, b)
              for k, (its_h, its_k) in enumerate(zip(odo_iters[True],
                                                     odo_iters[False]))
              for lvl, a, b in zip(levels, its_k, its_h) if a != b]
    print(f"phase 7 odometry iterations per (frame, level), level kernel "
          f"against host loop: {len(differ)} of "
          f"{len(odo_iters[True]) * len(levels)} differ"
          + (": " + ", ".join(f"frame {k} level {lvl} {a} / {b}"
                              for k, lvl, a, b in differ) if differ else ""))
    kf_h, edges_h, loops_h = graphs[True]
    kf_k, edges_k, loops_k = graphs[False]
    print(f"phase 7 SLAM turns: keyframes {kf_k} through the level kernel, "
          f"{'the same' if kf_k == kf_h else kf_h} through the host loop; "
          f"graph edges {'identical' if edges_k == edges_h else 'differ'} "
          f"({len(edges_k)} edges; loop edges {loops_k} / {loops_h})")
    if kf_k != kf_h or edges_k != edges_h or loops_k < 1:
        raise AssertionError(f"the SLAM turns part: keyframes {kf_k} / "
                             f"{kf_h}, edges {edges_k} / {edges_h}")
    return out


def phase_validation_batches(device, cfg):
    """5d: mode (b) at the validation batches past 5a's B = 8, up to
    validation_batch_max = 32: B rows of a noisy 640x480 orbit, one current
    slab per row, per tracked level, against the host loop over the plain
    linearization with 5a's gates; device us per launch (CUDA events), the
    host loop's ms (CUDA events around one call) and the bound. Returns
    {(B, level): {"us", "plain_ms", "bound", "err"}}."""
    from functools import partial

    import torch

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import camera, linearize, pyramid
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

    scene = synthetic.two_plane_scene(sharpness=2.0)
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE, device=device),
                                   cfg.num_levels)
    out = {}
    for B in VALIDATION_BATCHES:
        poses = synthetic.orbit_trajectory(B + 1, radius=0.06)
        rng = np.random.default_rng(5)
        pyrs = [pyramid.build_pyramid(
            *(torch.as_tensor(x, device=device)
              for x in synthetic.add_sensor_noise(
                  *scene.render(np.asarray(K_TUPLE), W, H, poses[k]), rng,
                  dropout=0.02)), cfg.num_levels) for k in range(B + 1)]
        T0 = torch.as_tensor(np.stack([
            (se3_np.inverse(poses[b + 1]) @ poses[b])
            @ se3_np.exp(rng.normal(scale=2e-3, size=6)) for b in range(B)]),
            dtype=torch.float32, device=device)
        for lvl in cfg.tracked_levels:
            ref = linearize.prepare_reference(
                torch.stack([p[lvl] for p in pyrs[:B]]), Ks[lvl], cfg)
            cur = torch.stack([p[lvl] for p in pyrs[1:]])
            key = ("track_level", B)
            before = linearize.LAUNCHES_BY_BATCH.get(key, 0)
            got = dense_tracker.track_level(ref, cur, Ks[lvl], T0, cfg)
            if linearize.LAUNCHES_BY_BATCH.get(key, 0) - before != 1:
                raise AssertionError(f"B={B}: not one level-kernel launch")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = dense_tracker._track_level(
                ref, cur, Ks[lvl], T0, cfg,
                linearize=linearize.linearize_batched_reference)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            d_T = (got[0] - want[0]).abs().max().item()
            d_n = ((got[1].n_raw - want[1].n_raw).abs()
                   / want[1].n_raw.clamp(min=1.0)).max().item()
            us = _events_us(partial(linearize.track_level_kernels, ref, cur,
                                    Ks[lvl], T0, cfg))
            its = got[2]["iterations"]
            L = {"N": ref.px.shape[1], "H": cur.shape[-2], "W": cur.shape[-1]}
            bound = _bounds(cfg, L, B, {
                "its": its.tolist(), "n_valid": float(got[1].n_raw.sum()),
                "paired": True})["track_level"]
            print(f"phase 5d validation batch B={B} (one slab per row) level "
                  f"{lvl}: track_level (mode b) vs host loop |dT| "
                  f"{d_T:.2e} (tol 1e-3), final valid counts within "
                  f"{d_n:.2e} (tol 1e-2); iterations {its.tolist()}; device "
                  f"{us:.2f} us per launch (events), cluster size "
                  f"{linearize.cluster_size(ref.px.shape[1])}; host loop "
                  f"over plain {plain_ms:.3f} ms (events, one call); bound "
                  f"{1e3 * bound[0]:.4f} us ({bound[1]})")
            if not (d_T <= 1e-3 and d_n <= 0.01):
                raise AssertionError(f"B={B} level {lvl}: track_level vs "
                                     f"host loop |dT| {d_T}, valid {d_n}")
            out[(B, lvl)] = {"us": us, "plain_ms": plain_ms, "bound": bound,
                             "err": d_T}
    return out


def phase_eviction(device):
    """5e: KeyframeSlam forced past resident_keyframes = 64 (a keyframe
    every frame, EVICT_FRAMES frames of the ring at EVICT_W x EVICT_H, loop
    closure on): the oldest pyramids spill to pinned host memory and
    re-upload for validation. The run must equal one whose budget holds
    every pyramid: the same keyframes and edges, the same trajectory. Its
    graph and window solves reach M = 64 and 128 vertex slots: the first
    run's graph-kernel launches by M (pose_graph.LAUNCHES_BY_M) must be
    one per solve on the kernel's route. Returns {"launches": {M: n},
    "graphs": {M: (the last such solve's host graph, its keyword
    arguments)}} for GRAPH_RING_VERTICES."""
    import torch

    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import synthetic

    K = (525.0 * EVICT_W / 640.0, 525.0 * EVICT_H / 480.0,
         (EVICT_W - 1) / 2.0, (EVICT_H - 1) / 2.0)
    scene = synthetic.two_plane_scene(sharpness=2.0)
    ring = synthetic.orbit_trajectory(RING + 1, radius=0.06)[:RING]
    frames = synthetic.render_sequence(scene, np.asarray(K), EVICT_W, EVICT_H,
                                       ring)
    cfg = TrackerConfig(num_levels=3, first_level=2, last_level=0)
    out, solves = {}, []
    for resident in (64, 256):
        slam = KeyframeSlam(K, cfg, SlamConfig(resident_keyframes=resident),
                            device=device)
        slam.init()
        undo = _lm_counted(solves if resident == 64 else [], [0],
                           copy=True)
        _reset_launches()
        t0 = time.perf_counter()
        try:
            for k in range(EVICT_FRAMES):
                if k > 0:
                    slam.force_keyframe()
                slam.update(*frames[k % RING], k / 30.0)
            traj = np.stack([T for _, T in slam.finish()])
        finally:
            undo()
        torch.cuda.synchronize()
        out[resident] = (slam, traj, time.perf_counter() - t0)
        if resident == 64:
            launched = dict(pose_graph.LAUNCHES_BY_M)
    by_m = {}
    for _, _, g, kw in solves:
        key = (g.poses.shape[0], _graph_route(g, kw))
        by_m[key] = by_m.get(key, 0) + 1
    (small, traj_s, s_s), (large, traj_l, s_l) = out[64], out[256]
    evicted = sum(not k.resident for k in small.keyframes)
    diff = float(np.abs(traj_s - traj_l).max())
    same = _loop_graph(small) == _loop_graph(large)
    print(f"phase 5e eviction: {EVICT_FRAMES} keyframes at {EVICT_W}x"
          f"{EVICT_H}, resident_keyframes 64: {evicted} pyramids evicted, "
          f"validation cache {small.validation_cache_stats}; against "
          f"resident_keyframes 256 (none evicted: "
          f"{all(k.resident for k in large.keyframes)}): keyframes and edges "
          f"{'identical' if same else 'differ'} (loop edges "
          f"{small.num_loop_edges}), max trajectory difference {diff:.3e}; "
          f"{s_s:.1f} s / {s_l:.1f} s; graph and window solves of the "
          f"first run by (vertex slots M, route): {dict(sorted(by_m.items()))}"
          f", graph-kernel launches by M {dict(sorted(launched.items()))}")
    if not (len(small.keyframes) == EVICT_FRAMES and evicted > 0 and same
            and small.validation_cache_stats["misses"] > 0
            and small.num_loop_edges >= 1 and diff <= 1e-6):
        raise AssertionError("the evicting SLAM run differs from the "
                             "resident one")
    on_kernel = {M: n for (M, route), n in by_m.items() if route == "kernel"}
    if launched != on_kernel or not set(GRAPH_RING_VERTICES) <= set(launched):
        raise AssertionError(f"5e graph-kernel launches by M {launched}, "
                             f"solves on its route by M {on_kernel}")
    graphs = {g.poses.shape[0]: (g, {k: v for k, v in kw.items()
                                     if k != "device"} | {"iterations": it})
              for it, _, g, kw in solves if _graph_route(g, kw) == "kernel"}
    return {"launches": launched,
            "graphs": {M: graphs[M] for M in GRAPH_RING_VERTICES}}


def _chunks(frames, n, t_base):
    """bench.py's slam-lc loop in chunks of CHUNK frames: the ring over and
    over, timestamps t_base + k / 30."""
    for c in range(n // CHUNK):
        sel = [frames[(c * CHUNK + j) % len(frames)] for j in range(CHUNK)]
        yield (c, np.stack([s[0] for s in sel]), np.stack([s[1] for s in sel]),
               [t_base + (c * CHUNK + j) / 30.0 for j in range(CHUNK)])


def phase_chunked(device, slam_out):
    """8: ChunkedKeyframeSlam over 5b's loop (640x480, default configs,
    loop closure on) in chunks of CHUNK frames, force_keyframe() before
    every chunk but the first (5b's every FORCE_EVERY frames), with a
    depth-2 submit/collect pipeline: SLAM_FRAMES warm-up frames on one
    instance, then SLAM_FRAMES timed on a fresh one (the launch counts
    reset just before and read just after). The submit of chunk SYNC_CHUNK
    runs under torch.cuda.set_sync_debug_mode("error"). Against 5b's
    per-frame KeyframeSlam over the same frames: the same keyframe
    timestamps and graph edges, trajectories within 1e-4."""
    import torch

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.utils import evaluate

    frames = slam_out["frames"]
    _, poses = _ring()

    def run(t_base, timed):
        slam = ChunkedKeyframeSlam(K_TUPLE, TrackerConfig(), SlamConfig(),
                                   enable_loop_closure=True, device=device)
        slam.init()
        in_flight, submit_ms = 0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, ii, zz, ts in _chunks(frames, SLAM_FRAMES, t_base):
            if c > 0:
                slam.force_keyframe()
            t_s = time.perf_counter()
            if timed and c == SYNC_CHUNK:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    slam.submit_chunk(ii, zz, ts)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                slam.submit_chunk(ii, zz, ts)
            submit_ms.append(1e3 * (time.perf_counter() - t_s))
            in_flight += 1
            if in_flight == 2:
                slam.collect_chunk()
                in_flight -= 1
        while in_flight:
            slam.collect_chunk()
            in_flight -= 1
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / SLAM_FRAMES
        return slam, ms, submit_ms

    run(0.0, False)
    _reset_launches()
    slam, ms, submit_ms = run(100.0, True)
    launches = _launches()
    traj = slam.finish()
    est = [T for _, T in traj]
    ate = evaluate.ate_rmse(est, [poses[k % RING] for k in range(SLAM_FRAMES)])
    ref = slam_out["slam"]
    ref_traj = ref.trajectory()
    kf_t = [k.timestamp for k in slam.keyframes]
    ref_kf_t = [k.timestamp for k in ref.keyframes]
    edges, ref_edges = _loop_graph(slam)[1], _loop_graph(ref)[1]
    diff = max(float(np.abs(a - b).max())
               for (_, a), (_, b) in zip(traj, ref_traj))
    by_b = {b: n / SLAM_FRAMES for (kind, b), n in launches["by B"].items()
            if kind == "track_level"}
    print(f"phase 8 chunked engine: {SLAM_FRAMES} frames {W}x{H} in chunks "
          f"of {CHUNK} (depth-2 pipeline) after {SLAM_FRAMES} warm-up "
          f"frames on another instance: {ms:.3f} ms/frame "
          f"({1e3 / ms:.2f} fps; 5b per-frame {slam_out['ms_frame']:.3f}); "
          f"submit_chunk host ms median {np.median(submit_ms):.3f}, max "
          f"{max(submit_ms):.3f}; keyframes {len(slam.keyframes)}, loop "
          f"edges {slam.num_loop_edges}; ATE of finish() {1e3 * ate:.4f} mm")
    print(f"phase 8 launches: track_level {launches['track_level']} "
          f"({launches['track_level'] / SLAM_FRAMES:.2f} per frame), per "
          f"frame by batch size {by_b}, linearize {launches['linearize']}, "
          f"standalone sampler {launches['sample_slab']}; chunk "
          f"{SYNC_CHUNK}'s submit_chunk under set_sync_debug_mode(\"error\"):"
          f" no synchronizing call")
    # Outlier pruning judges the loop edges when a graph solve is applied:
    # the per-frame engine applies it at the next frame, the chunked one at
    # the next chunk's collect (as in the JAX package), so an edge's mask
    # may differ; its endpoints may not.
    ends = [e[:2] for e in edges] == [e[:2] for e in ref_edges]
    masks = [e for e, r in zip(edges, ref_edges) if e[2] != r[2]]
    print(f"phase 8 against 5b's per-frame KeyframeSlam on the same frames: "
          f"keyframe timestamps {'identical' if kf_t == ref_kf_t else 'differ'}"
          f" ({len(kf_t)} / {len(ref_kf_t)}), graph edges "
          f"{'identical' if edges == ref_edges else 'differ'} ({len(edges)} "
          f"edges; endpoints {'identical' if ends else 'differ'}, masks "
          f"differ at {[e[:2] for e in masks]}), max trajectory difference "
          f"{diff:.3e} (tol 1e-4 where the masks agree)")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"chunked SLAM ATE {ate} m >= {ATE_LIMIT_M} m")
    if slam.num_loop_edges < 1:
        raise AssertionError("the chunked engine accepted no loop edge")
    if kf_t != ref_kf_t or not ends or (not masks and not diff <= 1e-4):
        raise AssertionError("the chunked and per-frame engines differ")
    if (launches["track_level"] == 0 or launches["linearize"] != 0
            or launches["sample_slab"] != 0):
        raise AssertionError(f"chunked path launches {launches}")
    return {"launches": launches, "ms_frame": ms}


def _live_frames(frames, enc):
    """The ring in a wire encoding: f32, raw (u8 + u16 ticks) or raw12 (u8
    + 12-bit-packed ticks), as bench.py's live modes send it."""
    from dvo_slam_tpu_torch.ops.pyramid import pack_depth12

    if enc == "f32":
        return frames
    out = []
    for ii, zz in frames:
        raw_z = np.nan_to_num(zz * 5000.0, nan=0.0).astype(np.uint16)
        out.append((np.clip(ii, 0, 255).astype(np.uint8),
                    pack_depth12(raw_z) if enc == "raw12" else raw_z))
    return out


def _live_session(device, mode, chunk, send_frames, enc, rate):
    """bench.py's _bench_live: serve() on a unix socket in a thread, a
    client streams LIVE_FRAMES frames of the ring (paced at rate Hz, or
    unpaced), one reader thread timestamps every pose message; latency =
    arrival - send of the frame with the same timestamp. Returns (seconds
    from the first send to the trajectory, pose messages, trajectory,
    latencies)."""
    import json as json_mod
    import tempfile
    import threading

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig, node

    path = tempfile.mktemp(suffix=".dvo.sock")
    server = threading.Thread(target=node.serve, args=(path, K_TUPLE), kwargs=dict(
        tracker_cfg=TrackerConfig(), slam_cfg=SlamConfig(), mode=mode,
        unix=True, max_sessions=1, chunk=chunk, stall_timeout=60.0,
        device=device), daemon=True)
    server.start()
    client = None
    for _ in range(400):
        try:
            client = node.StreamClient.connect_unix(path)
            break
        except (FileNotFoundError, ConnectionRefusedError):
            time.sleep(0.05)
    if client is None:
        raise AssertionError("the node did not come up")
    client.sock.settimeout(LIVE_TIMEOUT_S)
    recv = []

    def reader():
        while True:
            line = client._rfile.readline()
            if not line:
                return
            msg = json_mod.loads(line)
            recv.append((time.perf_counter(), msg))
            if "trajectory" in msg:
                return

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    send_t = {}
    period = 1.0 / rate if rate else 0.0
    t0 = time.perf_counter()
    for i in range(LIVE_FRAMES):
        if period:
            due = t0 + i * period
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
        ii, zz = send_frames[i % len(send_frames)]
        ts = 100.0 + i / 30.0
        send_t[ts] = time.perf_counter()
        client.send_frame_nowait(ts, ii, zz, enc=enc)
    client.sock.sendall(b'{"cmd": "finish"}\n')
    th.join(timeout=LIVE_TIMEOUT_S)
    server.join(timeout=LIVE_TIMEOUT_S)
    client.close()
    if not recv or "trajectory" not in recv[-1][1] or server.is_alive():
        raise AssertionError(f"live {mode} chunk {chunk} {enc}: no "
                             "trajectory reply")
    poses = [m for _, m in recv if "pose" in m]
    lat = sorted(at - send_t[m["t"]] for at, m in recv if "pose" in m)
    return recv[-1][0] - t0, poses, recv[-1][1]["trajectory"], lat


def _direct(device, mode, chunk, send_frames):
    """The node's engine run directly on the frames the session sent
    (chunked: benchmark's depth-2 submit/collect loop, as the node runs
    it): the trajectory, (t, 4x4) pairs."""
    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig, benchmark
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeSlam
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker

    stream = [(100.0 + i / 30.0, *send_frames[i % len(send_frames)])
              for i in range(LIVE_FRAMES)]
    if mode == "odometry":
        engine = OdometryTracker(K_TUPLE, TrackerConfig(), device=device)
        engine.init()
        for t, ii, zz in stream:
            engine.update(ii, zz, t)
        return engine.trajectory
    cls = ChunkedKeyframeSlam if chunk else KeyframeSlam
    engine = cls(K_TUPLE, TrackerConfig(), SlamConfig(),
                 enable_loop_closure=(mode == "slam"), device=device)
    engine.init()
    if chunk:
        benchmark._run_chunked(engine, iter(stream), chunk)
    else:
        for t, ii, zz in stream:
            engine.update(ii, zz, t)
    return engine.finish()


def phase_live(device, slam_out):
    """9: the live node (node.serve) over a unix socket, as JAX bench.py's
    live modes drive it, LIVE_FRAMES frames of the 640x480 ring a session:
    the runs of LIVE_RUNS (mode, chunk, wire encoding, rate; rate 0 =
    unpaced), after one warm-up session. Each prints fps (first send to
    the trajectory reply) and pose latency p50 / p99; each session's pose
    messages (one a frame, in order) and finish() trajectory are checked,
    the trajectory against the engine's direct run on the same frames
    (within 1e-6)."""
    from dvo_slam_tpu_torch.utils import evaluate

    frames = slam_out["frames"]
    _, poses = _ring()
    gt = [poses[k % RING] for k in range(LIVE_FRAMES)]
    _live_session(device, "slam", CHUNK, frames, "f32", 0)  # warm-up
    out = {}
    for mode, chunk, enc, rate in LIVE_RUNS:
        send = _live_frames(frames, enc)
        elapsed, msgs, traj, lat = _live_session(device, mode, chunk, send,
                                                 enc, rate)
        direct = _direct(device, mode, chunk, send)
        ts = [100.0 + i / 30.0 for i in range(LIVE_FRAMES)]
        est = [np.asarray(e["pose"]).reshape(4, 4) for e in traj]
        diff = max(float(np.abs(a - np.asarray(b)).max())
                   for a, (_, b) in zip(est, direct))
        ate = evaluate.ate_rmse(est, gt)
        p50, p99 = (1e3 * lat[len(lat) // 2],
                    1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))])
        n_kf = sum(bool(m.get("keyframe")) for m in msgs)
        print(f"phase 9 live {mode} chunk={chunk} enc={enc} "
              f"rate={rate or 'unpaced'}: {LIVE_FRAMES / elapsed:.2f} fps "
              f"({1e3 * elapsed / LIVE_FRAMES:.3f} ms/frame, first send to "
              f"the trajectory); pose latency p50 {p50:.2f} ms, p99 "
              f"{p99:.2f} ms; {len(msgs)} pose messages, {n_kf} keyframe "
              f"flags; ATE {1e3 * ate:.4f} mm; finish() against the "
              f"engine's direct run: max difference {diff:.3e}")
        if ([m["t"] for m in msgs] != ts or [e["t"] for e in traj] != ts
                or not diff <= 1e-6
                or (mode != "odometry" and not ate < ATE_LIMIT_M)):
            raise AssertionError(f"live {mode} chunk {chunk} {enc}: the "
                                 "session's result is wrong")
        out[(mode, chunk, enc, rate)] = {"fps": LIVE_FRAMES / elapsed,
                                         "p50": p50, "p99": p99}
    return out


def phase_compaction(device, frames):
    """10: point compaction on the card (TrackerConfig.point_budget_fraction;
    ops/linearize.compact_reference), at intensity_grad_threshold
    COMPACT_THRESHOLD:
    a. odometry over phase 3's 24-frame orbit on the full grid and at
       budget COMPACT_BUDGET, in turns (full, budget, budget, full), each
       run on a fresh tracker: ms/frame, ATE (< 5 mm), launches per frame
       (counts reset just before and read just after each run: track_level
       one per tracked level, linearize and sampler 0);
    b. per tracked level, the noise-free orbit pair at N = budget: mode (b)
       against the host loop over the plain linearization at B = 1 and 2
       (2d's _compare_level gates), mode (a) against the plain version row
       by row (5a's _check_batched), the level kernel's us per launch at
       N = budget and on the full grid (CUDA events), whether the points
       are kept in shared memory (level_plan), the host loop's ms and the
       bound;
    c. compaction itself: each level's compacted points on the card equal,
       bit for bit, the CPU's from the same slab, and five card runs equal.
    Returns what the kernels line needs (its error: mode (b)'s largest
    |T - T_host|, as the other mode (b) rows)."""
    import dataclasses
    from functools import partial

    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import linearize
    from dvo_slam_tpu_torch.utils import evaluate, se3_np, synthetic

    full_cfg = TrackerConfig(intensity_grad_threshold=COMPACT_THRESHOLD)
    cfg = dataclasses.replace(full_cfg, point_budget_fraction=COMPACT_BUDGET)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    levels = len(cfg.tracked_levels) * (N_FRAMES - 1)
    runs = {}
    for name, c in (("full grid", full_cfg), ("budget", cfg), ("budget", cfg),
                    ("full grid", full_cfg)):
        tracker = OdometryTracker(K_TUPLE, c, device=device)
        frame_ms = []
        _reset_launches()
        for k, (i, z) in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.update(i, z, float(k))
            torch.cuda.synchronize()
            if k >= N_WARMUP:
                frame_ms.append(1e3 * (time.perf_counter() - t0))
        launches = _launches()
        ate = evaluate.ate_rmse([T for _, T in tracker.trajectory], poses)
        res = tracker.last_result
        runs[name] = {"launches": launches}
        print(f"phase 10a odometry, {name} (intensity_grad_threshold "
              f"{COMPACT_THRESHOLD:g}, point_budget_fraction "
              f"{c.point_budget_fraction:g}): {N_FRAMES} frames "
              f"{W}x{H}, {np.mean(frame_ms):.3f} ms/frame after {N_WARMUP} "
              f"warm-up frames; ATE {1e3 * ate:.4f} mm; last frame valid "
              f"{float(res.valid_pixels):.0f}, valid ratio "
              f"{float(res.valid_ratio):.4f}; launches per frame track_level "
              f"{launches['track_level'] / (N_FRAMES - 1):.3f} "
              f"({launches['track_level']} for {levels} tracked levels), "
              f"linearize {launches['linearize']}, standalone sampler "
              f"{launches['sample_slab']}")
        if not ate < ATE_LIMIT_M:
            raise AssertionError(f"{name}: ATE {ate} m >= {ATE_LIMIT_M} m")
        if (launches["track_level"] != levels or launches["linearize"] != 0
                or launches["sample_slab"] != 0):
            raise AssertionError(f"{name}: launches {launches}")

    ref_pyr, cur_pyr, Ks, T = _noisy_pair(device, cfg, noisy=False)
    T2 = torch.stack([T, T @ torch.as_tensor(
        se3_np.exp(np.array([-1e-3, 2e-3, -1e-3, 2e-3, -1e-3, 1e-3])),
        dtype=torch.float32, device=device)])
    out = {"launches": runs["budget"]["launches"], "err": 0.0}
    for lvl in cfg.tracked_levels:
        h, w = ref_pyr[lvl].shape[-2:]
        for B in (1, 2):
            ref = linearize.prepare_reference(
                torch.stack([ref_pyr[lvl]] * B), Ks[lvl], cfg)
            N = ref.px.shape[1]
            if N != linearize.compact_budget(h * w, COMPACT_BUDGET, 128):
                raise AssertionError(f"level {lvl}: {N} compacted slots")
            args = (ref, cur_pyr[lvl], Ks[lvl], T2[:B].contiguous(), cfg)
            before = linearize.LAUNCHES_TRACK_LEVEL
            got = dense_tracker.track_level(*args)
            if linearize.LAUNCHES_TRACK_LEVEL - before != 1:
                raise AssertionError("not one level-kernel launch")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = dense_tracker._track_level(
                *args, linearize=linearize.linearize_batched_reference)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            d_T, a_rel, parted = _compare_level(
                got, want, cfg, f"budget level {lvl} B={B}")
            sigma = torch.tensor([[40.0, 0.01], [0.01, 1e-3]],
                                 device=device).expand(B, 2, 2).contiguous()
            r_err, abs_err, rel = _check_batched(
                ref, cur_pyr[lvl], Ks[lvl], T2[:B].contiguous(), sigma, cfg)
            out["err"] = max(out["err"], d_T)
            its = got[2]["iterations"].tolist()
            line = (f"phase 10b level {lvl} B={B} at N = budget {N} of "
                    f"{h * w} (selected {int(ref.selected.sum())}): "
                    f"track_level (mode b) vs host loop |dT| {d_T:.2e}, A "
                    f"error / max|A| {a_rel:.2e}, parted at a tie: "
                    f"{parted or 'none'}; linearize (mode a) vs plain: rI, "
                    f"rZ error {r_err:.1e}, A/b error / max|.| {rel:.2e}; "
                    f"iterations {its}")
            if B == 1:
                us = _events_us(partial(linearize.track_level_kernels,
                                        *args))
                ref_f = linearize.prepare_reference(ref_pyr[lvl][None],
                                                    Ks[lvl], full_cfg)
                full_args = (ref_f, cur_pyr[lvl], Ks[lvl], T[None], full_cfg)
                its_f = int(dense_tracker.track_level(*full_args)[2][
                    "iterations"][0])
                us_f = _events_us(partial(linearize.track_level_kernels,
                                          *full_args))
                C, P, kept, smem = linearize.level_plan(device, N)
                C_f, P_f, kept_f, _ = linearize.level_plan(device, h * w)
                bound = _bounds(cfg, {"N": N, "H": h, "W": w}, 1, {
                    "its": its, "n_valid": float(got[1].n_raw.sum()),
                    "paired": False})["track_level"]
                line += (f"; device {us:.2f} us per launch ({us / its[0]:.2f}"
                         f" per iteration; cluster of {C} CTAs, {P} points "
                         f"each, {'kept in' if kept else 'not in'} shared "
                         f"memory) against the full grid's {us_f:.2f} us "
                         f"({its_f} iterations; {C_f} CTAs of {P_f} points, "
                         f"{'kept' if kept_f else 'not kept'}); host loop "
                         f"over plain {plain_ms:.3f} ms (events, one call); "
                         f"bound {1e3 * bound[0]:.4f} us ({bound[1]})")
                out[lvl] = {"us": us, "plain_ms": plain_ms, "bound": bound,
                            "kept": kept}
            print(line)

        # c: compaction on the card against the CPU, and run to run.
        slab = ref_pyr[lvl]
        got = linearize.prepare_reference(slab, Ks[lvl], cfg)
        want = linearize.prepare_reference(slab.cpu(), Ks[lvl].cpu(), cfg)
        again = [linearize.prepare_reference(slab, Ks[lvl], cfg)
                 for _ in range(5)]
        for f, a, b in zip(got._fields, got, want):
            if a is None:
                continue
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"level {lvl}: compacted {f} on the "
                                     "card differs from the CPU's")
            if not all(torch.equal(a, getattr(x, f)) for x in again):
                raise AssertionError(f"level {lvl}: compacted {f} differs "
                                     "between runs")
        print(f"phase 10c level {lvl}: compaction to {got.px.shape[0]} "
              f"slots on the card equal to the CPU's bit for bit, and in 5 "
              f"more runs")
    return out


def _parallel_rank(rank, world_size, device, inp):
    """11, one rank: parallel/'s four workloads on a default mesh of the
    world (pixel axis 2), each timed (host clock around work that ends in
    a device sync, after one warm-up call of the tracker) with the launch
    counts of its run. Returns numpy results, every one gathered whole."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig, convert
    from dvo_slam_tpu_torch.parallel import batch_slam, sharded

    cfg = TrackerConfig()
    mesh = sharded.make_mesh(world_size)
    refs, curs, new, Ks, T0, Tf, seq_i, seq_z, K = _parallel_inputs(
        inp, device)
    g = {k: torch.as_tensor(v, device=device)
         for k, v in inp["graph"].items()}
    out = {"coordinate": tuple(mesh.get_coordinate()),
           "backend": dist.get_backend(), "device": str(device)}

    def timed(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        _reset_launches()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name + " s"] = time.perf_counter() - t0
        out[name + " launches"] = _launches()
        return r

    pairs = sharded.sharded_track_pairs(mesh, cfg)
    local = (sharded.shard_pyramid(refs, mesh),
             sharded.shard_pyramid(curs, mesh, pixel=False), Ks,
             sharded.shard_rows(T0, mesh).contiguous())
    pairs(*local)
    res = timed("pairs", lambda: pairs(*local))
    out["pairs"] = convert.result_to_numpy(sharded.gather_rows(res, mesh))
    fleet = sharded.sharded_validation_fleet(mesh, cfg)
    out["fleet"] = tuple(convert.result_to_numpy(r) for r in timed(
        "fleet", lambda: fleet(refs, new, Ks, Tf)))
    build = sharded.sharded_pose_graph_build(mesh)
    H, gv = timed("graph", lambda: build(g["poses"], *(
        sharded.shard_rows(g[k], mesh)
        for k in ("ei", "ej", "Z", "info", "mask"))))
    out["graph"] = (H.cpu().numpy(), gv.cpu().numpy())
    out["sequences"] = {k: v.cpu().numpy() for k, v in timed(
        "sequences", lambda: batch_slam.track_sequences_sharded(
            mesh, seq_i, seq_z, K, cfg)).items()}
    return out


def _parallel_inputs(inp, device):
    """The parallel phase's tensors on `device` from the ring's frames:
    PARALLEL_B pairs (ring frame b against b + 1), the validation fleet's
    candidates (ring frames 0..B-1) and new frame (a view beside the
    ring's first: no candidate is the new frame itself), the initial
    poses from the ground truth perturbed, and PARALLEL_B sequences of
    PARALLEL_T frames (sequence s starts at ring frame s)."""
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import camera, pyramid

    L = TrackerConfig().num_levels
    frames = inp["frames"]
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=device),
                                  torch.as_tensor(z, device=device), L)
            for i, z in frames]
    B, n = PARALLEL_B, len(frames)
    refs = tuple(torch.stack([pyrs[b % n][lvl] for b in range(B)])
                 for lvl in range(L))
    curs = tuple(torch.stack([pyrs[(b + 1) % n][lvl] for b in range(B)])
                 for lvl in range(L))
    K = camera.intrinsics(*K_TUPLE, device=device)
    Ks = camera.pyramid_intrinsics(K, L)
    T0 = torch.as_tensor(inp["T0"], device=device)
    Tf = torch.as_tensor(inp["Tf"], device=device)
    seq_i = torch.stack([torch.stack([
        torch.as_tensor(frames[(s + t) % n][0], device=device)
        for t in range(PARALLEL_T)]) for s in range(B)])
    seq_z = torch.stack([torch.stack([
        torch.as_tensor(frames[(s + t) % n][1], device=device)
        for t in range(PARALLEL_T)]) for s in range(B)])
    new = pyramid.build_pyramid(torch.as_tensor(inp["new"][0], device=device),
                                torch.as_tensor(inp["new"][1], device=device),
                                L)
    return refs, curs, new, Ks, T0, Tf, seq_i, seq_z, K


def phase_parallel(device):
    """11: parallel/ at 640x480 with the default TrackerConfig in a world of
    4 ranks over nccl with 4 cards or more, 2 with 2 or 3 (an even world,
    so the default mesh has a pixel axis), or, with one card, 2 ranks
    sharing it over gloo (parallel.spawn picks and prints the backend), on
    the default mesh (pixel axis 2, so the pixel route runs either way):
    sharded_track_pairs at B = PARALLEL_B (ring frame b against b + 1), the
    validation fleet at PARALLEL_B candidates (2 B rows), the edge-sharded
    graph assembly at SlamConfig()'s capacities (256 vertices, 1 024 edges,
    a noisy ring with loop edges), and track_sequences_sharded over
    PARALLEL_B sequences of PARALLEL_T ring frames. Every rank must return
    the same whole results, held to single-process runs on card 0: the
    shipped route (the level kernel: T within 1e-4, valid counts within
    0.1 %) and the host loop over the plain linearization (the pixel
    route's arithmetic unsharded: T within 5e-5, valid counts within
    0.1 %); the graph's H and g within 2e-3 and 1e-3 of its own
    single-process build (the gauge block's diagonal excluded). Prints
    each workload's time on rank 0 beside the single-process one and the
    standalone sampler's launches per tracked pair on the pixel route, and
    holds that sampler to its plain version at a pixel shard's shape.
    Returns the kernels line's row inputs: that sampler's launches, error,
    bound and device times (CUDA events)."""
    import torch

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig, convert
    from dvo_slam_tpu_torch import parallel
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models import pose_graph as pg
    from dvo_slam_tpu_torch.ops import linearize, sampler, se3
    from dvo_slam_tpu_torch.parallel import batch_slam
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2
    frames, poses = _ring()
    rng = np.random.default_rng(7)
    n = len(frames)
    T0 = np.stack([(se3_np.inverse(poses[(b + 1) % n]) @ poses[b % n])
                   @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                   for b in range(PARALLEL_B)]).astype(np.float32)
    T_new = poses[0] @ se3_np.exp(np.array([0.01, -0.01, 0.005, 0.01, -0.02,
                                            0.01]))
    new = synthetic.two_plane_scene(sharpness=2.0).render(
        np.asarray(K_TUPLE), W, H, T_new)
    Tf = np.stack([(se3_np.inverse(T_new) @ poses[b % n])
                   @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                   for b in range(PARALLEL_B)]).astype(np.float32)
    slam_cfg = SlamConfig()
    M, E = slam_cfg.max_keyframes, slam_cfg.max_edges
    verts = [se3_np.exp(np.concatenate([
        0.5 * np.array([np.cos(a), np.sin(a), 0.0]), [0.0, 0.0, a]]))
        for a in np.linspace(0.0, 2 * np.pi, M, endpoint=False)]
    ei = np.concatenate([np.arange(M), rng.integers(0, M, E - M)])
    ej = np.concatenate([(np.arange(M) + 1) % M,
                         (ei[M:] + rng.integers(2, M - 1, E - M)) % M])
    Z = np.stack([se3_np.inverse(verts[i]) @ verts[j]
                  @ se3_np.exp(rng.normal(scale=0.01, size=6))
                  for i, j in zip(ei, ej)])
    poses_g = np.stack([v @ se3_np.exp(rng.normal(scale=0.02, size=6))
                        for v in verts])
    mask = np.ones(E, bool)
    mask[rng.integers(0, E, 16)] = False
    graph = {"poses": poses_g.astype(np.float32),
             "ei": ei.astype(np.int64), "ej": ej.astype(np.int64),
             "Z": Z.astype(np.float32),
             "info": np.broadcast_to(np.eye(6, dtype=np.float32) * 100.0,
                                     (E, 6, 6)).copy(),
             "mask": mask}
    inp = {"frames": frames, "new": new, "T0": T0, "Tf": Tf, "graph": graph}

    t0 = time.perf_counter()
    ranks = parallel.spawn(_parallel_rank, world, "cuda", (inp,),
                           timeout_s=PARALLEL_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    backend = r0["backend"]
    shared = (f"{world} ranks sharing 1 card over {backend}" if cards == 1
              else f"{world} ranks on {world} cards over {backend}")
    for r in ranks[1:]:
        for key in ("pairs", "fleet", "graph", "sequences"):
            a_l, b_l = _leaves(r[key]), _leaves(r0[key])
            if not all(np.array_equal(a, b, equal_nan=True)
                       for a, b in zip(a_l, b_l)):
                raise AssertionError(f"rank {r['coordinate']}: {key} differs"
                                     " from rank 0's")

    # The single-process references on card 0.
    cfg = TrackerConfig()
    refs, curs, new, Ks, T0_t, Tf_t, seq_i, seq_z, K = _parallel_inputs(
        inp, device)
    single = {}
    for route in ("kernel", "host"):
        with _host_loop(route == "host"), _plain_linearize(route == "host"):
            dense_tracker.track_batched(refs, curs, Ks, T0_t, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pairs = dense_tracker.track_batched(refs, curs, Ks, T0_t, cfg)
            torch.cuda.synchronize()
            pairs_s = time.perf_counter() - t0
            news = tuple(x.expand(PARALLEL_B, *x.shape).contiguous()
                         for x in new)
            fleet = (dense_tracker.track_batched(refs, news, Ks, Tf_t, cfg),
                     dense_tracker.track_batched(
                         news, refs, Ks, se3.inverse(Tf_t).contiguous(), cfg))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seqs = batch_slam.track_sequences_batched(seq_i, seq_z, K, cfg)
            torch.cuda.synchronize()
            seq_s = time.perf_counter() - t0
        single[route] = {
            "pairs": convert.result_to_numpy(pairs), "pairs s": pairs_s,
            "fleet": tuple(convert.result_to_numpy(f) for f in fleet),
            "sequences": {k: v.cpu().numpy() for k, v in seqs.items()},
            "sequences s": seq_s}
    gg = pg.PoseGraph(poses=graph["poses"], num_vertices=np.int32(M),
                      edge_i=graph["ei"], edge_j=graph["ej"],
                      measurements=graph["Z"], information=graph["info"],
                      edge_mask=graph["mask"], num_edges=np.int32(E))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H1, g1, _, _ = pg._build_system(pg.to_device(gg, device),
                                    pg._topology(gg, device), False, 1.0)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0

    err = {}
    for route, tol in (("kernel", 1e-4), ("host", 5e-5)):
        s = single[route]
        pairs_w = [(r0["pairs"], s["pairs"]),
                   *zip(r0["fleet"], s["fleet"])]
        d_T = max(float(np.abs(a.transformation - b.transformation).max())
                  for a, b in pairs_w)
        d_n = max(float((np.abs(a.valid_pixels - b.valid_pixels)
                         / np.maximum(b.valid_pixels, 1.0)).max())
                  for a, b in pairs_w)
        d_seq = float(np.abs(r0["sequences"]["rel_poses"]
                             - s["sequences"]["rel_poses"]).max())
        err[route] = max(d_T, d_seq)
        print(f"phase 11 parallel ({shared}) against the single-process "
              f"{'level-kernel route' if route == 'kernel' else 'host loop over the plain linearization'}"
              f": pairs and fleet |dT| {d_T:.2e}, valid counts within "
              f"{d_n:.2e}; sequences |d rel_poses| {d_seq:.2e} (tol: poses "
              f"{tol:g}, valid counts 1e-3 relative)")
        if not (d_T <= tol and d_seq <= tol and d_n <= 1e-3):
            raise AssertionError(f"parallel results against the {route} "
                                 "route")
    H_sh, g_sh = (np.array(x, np.float64) for x in r0["graph"])
    H_1 = H1.double().cpu().numpy()
    H_sh[:6, :6] = 0.0
    H_1[:6, :6] = 0.0
    d_H = float(np.abs(H_sh - H_1).max())
    d_g = float(np.abs(g_sh - g1.double().cpu().numpy()).max())
    la = r0["pairs launches"]
    per_pair = la["sample_slab"] / PARALLEL_B
    print(f"phase 11 parallel: {shared} ({world_s:.1f} s for the world, "
          f"start-up included), mesh coordinates "
          f"{[r['coordinate'] for r in ranks]}, devices "
          f"{[r['device'] for r in ranks]}; rank 0 times: pairs B="
          f"{PARALLEL_B} {1e3 * r0['pairs s']:.1f} ms (single process: level "
          f"kernel {1e3 * single['kernel']['pairs s']:.1f}, host loop "
          f"{1e3 * single['host']['pairs s']:.1f}), validation fleet "
          f"{PARALLEL_B} candidates {1e3 * r0['fleet s']:.1f} ms, graph "
          f"build {M} vertices {E} edges {1e3 * r0['graph s']:.1f} ms "
          f"(single process {1e3 * graph_s:.1f}; |dH| {d_H:.2e}, |dg| "
          f"{d_g:.2e}), sequences {PARALLEL_B} x {PARALLEL_T} frames "
          f"{1e3 * r0['sequences s']:.1f} ms (single process: level kernel "
          f"{1e3 * single['kernel']['sequences s']:.1f}); pixel route: "
          f"standalone sampler launches per tracked pair {per_pair:.2f} "
          f"({la['sample_slab']} on rank 0 for {PARALLEL_B} pairs), "
          f"track_level {la['track_level']}, linearize {la['linearize']}")
    if not (d_H <= 2e-3 and d_g <= 1e-3):
        raise AssertionError(f"graph build |dH| {d_H}, |dg| {d_g}")
    if (la["sample_slab"] == 0 or la["track_level"] != 0
            or la["linearize"] != 0):
        raise AssertionError(f"pixel route launches {la}")

    # The standalone sampler at a pixel shard's shape (rank 0's rows of
    # the finest tracked level, warped by pair 0's pose): kernel against
    # plain, and timed beside plain and grid_sample.
    lvl = cfg.tracked_levels[-1]
    rows = refs[lvl].shape[-2] // 2
    ref = linearize.prepare_reference(refs[lvl][0, :, :rows], Ks[lvl], cfg)
    slab = curs[lvl][0]
    u, v = linearize.warp(ref, Ks[lvl], T0_t[0])[4:]
    got, inb = sampler.sample_slab(slab, u, v)
    want, want_inb = sampler.sample_slab_reference(slab, u, v)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    s_err = (got[fin] - want[fin]).abs().max().item()
    if not (torch.equal(inb, want_inb) and s_err <= 1e-5 * slab.nan_to_num(
            posinf=0.0, neginf=0.0).abs().max().item()):
        raise AssertionError(f"sampler at the shard's shape: error {s_err}")
    grid = torch.stack([u * (2.0 / (slab.shape[2] - 1)) - 1.0,
                        v * (2.0 / (slab.shape[1] - 1)) - 1.0],
                       dim=-1)[None, None]
    N = u.numel()
    bound = _sampler_bound(slab, u, v)
    ms, plain_ms, lib_ms = (_events_us(fn, n=n) / 1e3 for fn, n in (
        (functools.partial(sampler.sample_slab, slab, u, v), 20),
        (functools.partial(sampler.sample_slab_reference, slab, u, v), 5),
        (functools.partial(_grid_sample, slab[None], grid), 20)))
    print(f"phase 11 sample_slab at a pixel shard's shape (level {lvl}, "
          f"{rows} of {refs[lvl].shape[-2]} rows, N={N}): max_abs_err "
          f"{s_err:.3e}; device {1e3 * ms:.2f} us per call (CUDA events; "
          f"plain {1e3 * plain_ms:.2f}, grid_sample {1e3 * lib_ms:.2f}); "
          f"bound {1e3 * bound[0]:.4f} us ({bound[1]})")
    return {"launches": la["sample_slab"], "err": s_err, "bound": bound,
            "ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms}


def _leaves(x):
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, dict):
        return [y for v in x.values() for y in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [np.asarray(x)]


@contextlib.contextmanager
def _plain_linearize(on=True):
    """With on: the tracker's host loop linearizes with the plain version
    (linearize_batched_reference, gathering with the standalone sampler on
    the card), the arithmetic of the pixel route in one process."""
    from dvo_slam_tpu_torch.ops import linearize, sampler

    saved = linearize.linearize_batched
    if on:
        linearize.linearize_batched = functools.partial(
            linearize.linearize_batched_reference,
            sample=sampler.sample_slab)
    try:
        yield
    finally:
        linearize.linearize_batched = saved


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this smoke test needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    phase_device()
    cfg, levels = phase_kernel_vs_plain(device)
    level_pairs = phase_level_vs_plain(device, cfg)
    batched = phase_batched_vs_plain(device, cfg)
    launches, _, frames, _ = phase_main_path(device)
    slam_out = phase_slam(device)
    t0 = time.perf_counter()
    val_batches = phase_validation_batches(device, cfg)
    slam_out["eviction"] = phase_eviction(device)
    print(f"phases 5d-5e took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    offline = phase_offline(device)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graph = phase_graph(device, slam_out, offline)
    print(f"phase 5f took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_turns(device, frames, slam_out, offline)
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chunked = phase_chunked(device, slam_out)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_live(device, slam_out)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    compaction = phase_compaction(device, frames)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    par = phase_parallel(device)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dev_times = phase_device_times(cfg, levels, batched)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    # Profiles only from here on.
    for host in (True, False):
        phase_profile(device, frames, host)
    for host in (True, False):
        phase_slam_profile(slam_out, host)
    for host in (True, False):
        phase_offline_profile(offline, device, host)
    print(json.dumps({"kernels": kernel_rows(
        cfg, levels, launches, dev_times, slam_out, level_pairs, batched,
        chunked["launches"], val_batches, compaction, par, graph, offline)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

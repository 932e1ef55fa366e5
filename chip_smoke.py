#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dvo_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit (nvcc). It imports nothing of JAX or of dvo_slam_tpu and
exits non-zero, printing no result, when there is no card or any phase
fails. The port's kernels: the standalone slab sampler (csrc/sampler.cu),
the cluster kernel of csrc/linearize.cu in its two modes, (a) one
IRLS linearization per batch row and (b) a pyramid level's whole IRLS loop
per batch row (the tracker's route on the card; on the kernel front it
reads the reference points from the reference slabs and writes the track
result), the pose-graph kernels (csrc/pose_graph.cu: a dense
Levenberg-Marquardt solve of up to 128 vertices per launch of one
cluster; csrc/pose_graph_grid.cu: every other solve, dense past 128
vertices or CG at any size, per cooperative launch of one CTA an SM:
every graph solve on the card is one launch), the pyramid kernel
(csrc/pyramid.cu:
every level of a frame's pyramid in one launch) and the chunked keyframe
scan's step (csrc/keyframe_scan.cu: a frame's keyframe decisions, one
launch a frame after its level launches). Phases:

  1. device: the card's name and power limit (nvidia-smi), the build of
     the port's kernels from csrc/ (libdvo_kernels.so, one nvcc per
     source in parallel) and ptxas's register and spill lines per kernel;
  2. kernels against plain, at the three tracked levels of a noisy
     640x480 synthetic pair (points warped by a perturbed ground-truth
     pose):
     a. the standalone sampler against its plain version: inb, NaN
        pattern and every sample's bits identical; kernel, plain and torch
        grid_sample (the library yardstick, timed only) per call with CUDA
        events;
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
     levels (3 a tracked frame), pyramid launches the frames (one a
     frame), mode (a) and standalone sampler launches and prepare_reference
     calls 0;
  13. (after 3, whose orbit it takes) the cluster kernel under every scale
     estimator the CLI offers, each under another influence function
     (ESTIMATOR_CONFIGS: mad + huber, normal + tukey, unit + tdist,
     unweighted) and with the motion prior (PRIOR_CONFIGS: mu = MU, GN
     and LM), at 640x480 (phase_estimators):
     a. per tracked level, mode (a) against linearize_reference (2b's
        gates, and the MAD elements bit for bit against the plain sort's)
        and mode (b) against the host loop over the plain linearization
        (2d's gates); the prior (GN and LM) also at mu = c x the data's
        largest diagonal entry (PRIOR_SCALES), pose, posterior and entropy
        against the host loop; mode (b)'s device us a launch on the noisy
        pair beside the t-distribution's;
     b. the 24-frame odometry orbit under each config through the level
        kernel and through the host loop (in turns for mad + huber and
        mu = MU): a frame on the kernel route must show 1 pyramid and 3
        level launches (0 on the first frame), no mode (a) or standalone
        sampler launch and no host-loop level; world poses within 1e-4 of
        the host loop's, paths parting only at a tie (_parted); ms/frame;
     c. a 16-frame chunk of ChunkedKeyframeSlam under mad + huber: 1
        pyramid, 3 level and 1 scan-step launch a frame inside
        submit_chunk, under set_sync_debug_mode("error");
  3a. the front against its plain versions: the pyramid kernel against
     build_pyramid_reference bit for bit (640x480 f32, u8 + u16 and
     u8 + packed-12 inputs, the TMA fill; 642x482 at 4 and 5 levels, the
     scalar fill; 2 % depth dropout) and timed beside the plain chain, with
     its phase split (the kernel's phase stamps); the level kernel's slab
     route against its RefData route bit for bit in both modes (FRONT_CONFIGS:
     CONFIGS and the gradient thresholds; B = 1, 2 by row pointers, 8;
     every tracked level), mode (b) at B = 1 timed on both routes; the
     kernel front's TrackResult against the eager front's (every field bit
     for bit but the log-likelihood, LOGLIK_RTOL, and the entropy,
     ENTROPY_ATOL);
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
     64 and 128 slots take the graph kernel's clusters), one launch a
     solve (pose_graph.LAUNCHES_BY_M);
  5g. KeyframeSlam past 128 keyframes (a keyframe every frame, 136 frames
     of the ring at 160x120, loop closure on): its solves by (vertex slots
     M, route), the grid kernel's launches at M = 256 (> 0), the host
     loop's LM steps (0), loop edges (>= 1), a finite trajectory and its
     ATE against the ring's ground truth (printed); its last 256-slot
     solve once more on the grid kernel and on the host loop: why each LM
     step came out zero (pose_graph.LAST_ZEROED: used, a failed pivot or
     not finite);
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
        edge, ATE <= 0.7 ATE(keyframe)); launches as 6b's, and no
        prepare_reference call;
     c. `cli odometry` with a covariance file (one 37-field line a frame);
     d. `python -m dvo_slam_tpu_torch.cli evaluate` in a subprocess: the
        benchmark's ATE within 1e-6; `evaluate --rpe-seconds`;
     e. keyframe mode through run_sequence's checkpoint_out and resume,
        split at the middle frame, against 6b's uninterrupted keyframe
        run: the same keyframes, trajectories within 1e-6 m;
     f. `cli optimize-graph` on the benchmark's graph, and dense against
        CG on a 2560-vertex noisy two-lap ring (past graph_cg_threshold),
        5 LM steps without the robust kernel: ms and chi2 before and
        after (finite, no worse), each solve one grid-kernel launch and no
        host-loop step; both solves again through the grid kernel and
        through the host loop (optimize_reference called directly): both
        ms, the poses (1e-4, or where f32 cannot resolve that on the
        graph, within twice the host loop's own distance to the same loop
        in f64: _ring_solves), the chi2 (1e-4) and the decisions (5f's tie
        rule); cuSOLVER's factor and solve of the ring's first damped
        system beside the kernel's dense step; the dense-to-CG crossing:
        _ring_graph at 1 024 and 2 048 vertices beside the 2 560 ring,
        dense and CG on the grid kernel (device ms by the launch's stamps;
        graph_cg_threshold printed, not changed);
     g. `cli odometry --scale-estimator normal --influence huber` (24
        frames): one level-kernel launch a tracked level, no mode (a) or
        standalone sampler launch;
  5f. (after 6, whose graph it takes) the pose-graph kernels against the plain
     host loop (optimize_reference, cuSOLVER's Cholesky, torch's CG) on the
     card: the ring's final keyframe graph (M = 16), 5b's last window graph,
     6b's benchmark graph (cropped to M = 32), 5e's last solves at 64 and 128
     slots and _ring_graph at 64 and 128 vertices (clusters of 4 and 16 CTAs);
     on the grid kernel _ring_graph at 256, 512 and 1 024 vertices (dense), at
     512 (CG, 5 LM steps) and 5g's last solve at 256 slots: steps on each
     route, max |dpose| (tol 1e-4), chi2 (rtol 1e-4; in f64 at each route's own
     poses where the two routes' own f32 errors add up past it), weights and
     chi2 against the plain formula at the kernel's poses (1e-4), the same
     accept decisions up to a parting at a tie (at the parting step neither
     trial moves the chi2 by more than 1e-4 relative); the kernel's device us
     per solve and per step (CUDA events) and per step by phase (the kernel's
     phase-timing buffer) beside the first version's as recorded, the host
     loop's ms, cuSOLVER's cholesky_ex + cholesky_solve on the damped system,
     the bound;
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
     LocalMap.optimize_async; then the three cells through the eager front
     (_eager_front: the plain pyramid, prepare_reference and the eager
     assembly around the level kernel) and the kernel front, in turns
     (eager, kernel, kernel, eager): ms/frame; the same odometry
     iterations, SLAM keyframes and graph edges, and offline keyframes and
     loop edges on both;
  8a. the scan step (csrc/keyframe_scan.cu) against its plain version
     (ops/scan_step.py scan_step_plain, scan_step_reference on the same
     buffers) on every decision's cases (STEP_CASES) and 64 random
     frames, without and with the statistics: the decisions and copied
     fields bit for bit, the poses within STEP_POSE_ATOL; its device us
     by CUDA events without the statistics (the main path) and with them,
     each beside the plain version's, the launch floor, its bound and the
     kernel's phase split (its timing buffer);
  8. the chunked engine (ChunkedKeyframeSlam, default configs, loop
     closure on) over 5b's loop in chunks of 16 with a depth-2
     submit/collect pipeline, 160 warm-up frames then 160 timed: ms/frame,
     submit host ms, keyframes, loop edges, ATE of finish() (< 5 mm),
     level-kernel launches per frame by batch size, and the launches
     inside submit_chunk per scanned frame by kernel (must be pyramid 1,
     track_level 3, scan_step 1, nothing else); chunk 3's submit_chunk
     under torch.cuda.set_sync_debug_mode("error") (must not raise);
     against 5b's per-frame KeyframeSlam on the same frames: the same
     keyframe timestamps and edge endpoints (outlier-pruning masks may
     differ, see phase_chunked), trajectories within 1e-4 where the masks
     agree; then a 16-frame chunk's device time on the kernel route
     behind a spin that outlasts the host's issue time (_chunk_device_us);
  9. the live node: node.serve on a unix socket in a thread and a client
     streaming 96 ring frames at 640x480, as JAX bench.py's live modes do
     (odometry and slam per frame, slam in chunks of 16 over the f32, raw
     and raw12 wire encodings, and paced at 30 Hz with raw frames, per
     frame and chunked): fps, pose latency p50 / p99 (send to arrival);
     every session's finish() trajectory must equal the engine's direct
     run on the same frames;
  10. point compaction at intensity_grad_threshold 1.0, on the kernel
     front (each level launch picks its slots' pixels from the reference
     slab, csrc/linearize.cu select_slots; ops/linearize.compact_reference
     is its plain version): a. odometry over phase 3's orbit on the full
     grid and at budget 0.5 in turns (ms/frame, ATE < 5 mm, a pyramid and
     three level launches a frame, no prepare_reference call; records by
     layer in the profiles, "10a"); b. per tracked level at N = budget,
     the slab route against the RefData route over prepare_reference's
     compacted points bit for bit (both modes, B = 1, 2, 8), mode (b)
     against the plain host loop (2d's gates) at B = 1 and 2, mode (a)
     against plain row by row (5a's), the level kernel's us per launch on
     the slab route and the RefData route at the budget and on the full
     grid, mode (a)'s on both routes (the prologue's cost), whether the
     points and slot tables are kept in shared memory, the bound with the
     prologue's bytes; c. compaction on the card bit-equal to the CPU's
     and across runs; d. phase 8's chunked engine at the budget: five
     launches a scanned frame, no host sync in submit_chunk, no
     prepare_reference or scan_step_reference call, the same keyframes
     and edges as the per-frame engine at the budget, ms/frame beside
     phase 8's;
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
     its plain version bit for bit at a pixel shard's shape, its device
     time (CUDA events) beside plain and grid_sample, its bound from the
     distinct slab pixels the shard's points read;
  12. device times by CUDA events (a spin kernel holds the card while the
     host queues the calls, so a call shorter than its dispatch is timed
     by the card): per level, every kernel, its plain version (the two
     modes' plain versions sync, so theirs count host time) and the
     library call, at B = 1 and at 5a's batches, with the bounds; the
     launch floor (an empty kernel's time a call) beside the sampler's and
     the pyramid's times and bounds;
  4. profiles (after every host timing above: no profiler has run before
     them in the process): a few more frames of the odometry main path
     under torch.profiler through each route: busy and idle share, device
     records per frame and per IRLS iteration and by layer of the front
     (FRONT_LAYERS; on the kernel front at most MAX_RECORDS_FRAME a frame,
     of them at most MAX_FRONT_RECORDS_FRAME of the pyramid, the
     reference points and the assembly), heaviest kernels, per level
     the level kernel's device time per launch and per iteration. Every
     profiler session (here, 5c and 6h) must hold one device record for
     each kernel launch the wrappers counted in it, or it is run again
     (up to 3 times, then the phase fails);
  5c. a short profile of the SLAM path through each route: a few more
     frames with one forced keyframe switch, each frame a labelled
     segment: busy and idle share, device records and launches per frame
     (by layer on frames without a switch);
  6h. a short profile of the offline cell through each route: a
     fresh KeyframeSlam with 6b's configs tracks the sequence's first 12
     frames, then its next 12 under the profiler: busy and idle share,
     device records and launches per frame (by layer);
  8p. last, the chunked scan under the profiler: two chunks' submit_chunk
     on a fresh engine, the device records they launch per frame by kind
     (the five kernels a frame and the chunks' copies; anything else
     fails).

The line before the last is a JSON object describing each kernel (the
cluster kernel's modes at B = 1, with the odometry path's launches, at B
= 2 and 8, with the SLAM path's, mode (b) at B = 2 with the chunked
engine's, at B = 16 and 32 (5d), and on the slab route at N = budget
with phase 10a's compacted odometry launches, and mode (b) on the slab
route with phase
3's launches; the standalone sampler on phase 11's pixel-sharded route;
the pose-graph kernel on 5f's five graphs, with 5b's, 6b's and 5e's
launches; the grid kernel on 5g's last solve and _ring_graph at 256 (5f,
with 5g's launches at 256) and on 6f's 2 560-vertex ring, dense and CG
(with the CLI's launches); the pyramid kernel at 640x480, f32 and raw
inputs, with phase 3's launches; the scan step, with phase 8's
launches; mode (b) under each of phase 13's configs, with 13b's
odometry launches); the last line is {"ok": true,
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
# Phase 4 on the kernel front: device records a frame, and those of the
# pyramid, the reference points and the result's assembly among them.
MAX_RECORDS_FRAME, MAX_FRONT_RECORDS_FRAME = 16, 4
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
# The CLI flags of the offline cell's `benchmark` run (bench/accuracy.py's
# protocol with the freiburg-1 intrinsics).
OFFLINE_FLAGS = ["--fr", "1", "--min-entropy-ratio", "0.96",
                 "--search-radius", f"{0.35 * OFFLINE_RADIUS:g}",
                 "--min-constraint-distance", "3"]
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
# The chunked scan's launches a frame on the kernel route (phase 8, 8p).
SCAN_LAUNCHES = {"pyramid": 1.0, "track_level": 3.0, "scan_step": 1.0,
                 "linearize": 0.0, "sample_slab": 0.0, "pose_graph": 0.0,
                 "pose_graph_grid": 0.0}
# 9: the live node, bench.py's live modes (its default is 400 frames).
LIVE_FRAMES, LIVE_TIMEOUT_S = 96, 300.0
LIVE_RUNS = (("odometry", 0, "f32", 0), ("slam", 0, "f32", 0),
             ("slam", CHUNK, "f32", 0), ("slam", CHUNK, "raw", 0),
             ("slam", CHUNK, "raw12", 0), ("slam", 0, "raw", 30),
             ("slam", CHUNK, "raw", 30))
# 5f: the graph kernels against the host loop; _ring_graph sizes, on the
# cluster kernel's route (64, 128) and the grid kernel's (256, 512, 1 024
# dense; 512 CG, a few LM steps: the host loop's CG reads its stop test
# back once a CG iteration); 5e's solves reach EVICT_VERTICES.
# Operations per LM step, counted from csrc/pose_graph.cu: per edge
# (residual, chi2 and blocks in f32; the Jacobian in f64), per edge of a
# residual-only pass (f32), per vertex (exp and the pose product, f32);
# per CG iteration (csrc/pose_graph_grid.cu): per edge of the matvec (its
# two vertices' rows, 4 x 36 FMA) and per vertex (the preconditioner,
# the updates and the dots).
GRAPH_RING_VERTICES = (64, 128, 256, 512, 1024)
GRAPH_CG_VERTICES, GRAPH_CG_ITERATIONS = (512,), 5
# 6f's dense-to-CG crossing: _ring_graph at these vertex counts beside its
# 2 560-vertex ring, dense and CG on the grid kernel.
GRAPH_CROSSING_VERTICES = (1024, 2048)
EVICT_VERTICES = (64, 128)
# 5f's graphs from the runs with a keyframe every frame (5e, 5g): their
# weights lie beyond f32 (~1e-3), so only their poses are held.
GRAPH_KEYFRAME_EVERY_FRAME = ("evict64", "evict128", "slam256")
GRAPH_EDGE_OPS = (2110, 1070)
GRAPH_RESIDUAL_OPS = 530
GRAPH_VERTEX_OPS = 230
GRAPH_CG_EDGE_OPS, GRAPH_CG_VERTEX_OPS = 288, 120
# 5g: KeyframeSlam past 128 keyframes (a keyframe every frame at 160x120,
# as 5e): its solves take 256 vertex slots, the grid kernel's route.
PAST128_FRAMES = 136
# 10: compaction on the main path's orbit (phase 3's frames).
COMPACT_THRESHOLD, COMPACT_BUDGET = 1.0, 0.5
# 11: parallel/ at 640x480: pairs and fleet candidates, sequences of the
# ring and their length; the world's timeout.
PARALLEL_B, PARALLEL_T, PARALLEL_TIMEOUT_S = 8, 6, 400.0
SPLIT_SPIN_S = 1e-3  # the spin ahead of a timed split launch
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


# The host ranges a frame's device records are counted by (phases 4, 5c
# and 6h, tests/torch_front_records.py): each wraps a function of the
# port (its module, of ops.pyramid, ops.linearize and
# models.dense_tracker, and its name), looked up while the ranges are on
# (a name a tree of the port lacks is skipped), in a torch.profiler range
# "front <layer>". A record falls in the innermost range whose host span holds
# the runtime call that launched it; "assembly" is what track_batched
# launches outside the others. Records outside every range are host <->
# device copies or other work.
FRONT_LAYERS = (
    ("pyramid", "build_pyramid", "pyramid"),
    ("linearize", "prepare_reference", "reference"),
    ("dense_tracker", "track_level", "levels"),
    ("linearize", "track_level_kernels", "levels"),
    ("linearize", "linearize_batched", "levels"),
    ("dense_tracker", "track_batched", "assembly"),
)
LAYER_ORDER = ("pyramid", "reference", "levels", "assembly", "copies",
               "other")
# Names of the profiler's own device-side copies of host ranges: not
# device work. "ProfilerStep" is the schedule's step range (_traced's
# warm-up cycle), which spans the whole session on the device side.
_RANGE_PREFIXES = ("front ", "smoke ", "ProfilerStep")


@contextlib.contextmanager
def _front_ranges():
    """FRONT_LAYERS' ranges around the port's functions while on."""
    from torch.profiler import record_function

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize, pyramid

    modules = {"pyramid": pyramid, "linearize": linearize,
               "dense_tracker": dense_tracker}
    saved = []
    for mod_name, name, layer in FRONT_LAYERS:
        mod = modules[mod_name]
        fn = getattr(mod, name, None)
        if fn is None:
            continue

        def ranged(*args, _fn=fn, _label=f"front {layer}", **kwargs):
            with record_function(_label):
                return _fn(*args, **kwargs)

        saved.append((mod, name, fn))
        setattr(mod, name, ranged)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side record (kernels,
    copies, fills) in a profiler run."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(_RANGE_PREFIXES)]


def _records_by_layer(prof, window=None):
    """{layer: device records} of a profiler run under _front_ranges, the
    layers of LAYER_ORDER; with window (start_us, end_us) only records
    launched inside that host span. A record is placed by the runtime
    call that launched it (the same correlation id)."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name[6:])
                     for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith("front ")),
                    key=lambda r: r[1] - r[0])
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cu") and e.id}
    counts = dict.fromkeys(LAYER_ORDER, 0)
    for e in events:
        if (e.device_type != DeviceType.CUDA
                or e.name.startswith(_RANGE_PREFIXES)):
            continue
        t = launched.get(e.id)
        if window is not None and (t is None
                                   or not window[0] <= t <= window[1]):
            continue
        layer = next((r[2] for r in ranges
                      if t is not None and r[0] <= t <= r[1]), None)
        if layer is None:
            layer = "copies" if "memcpy" in e.name.lower() else "other"
        counts[layer] += 1
    return counts


def _layer_line(counts, n):
    return ", ".join(f"{k} {counts[k] / n:.1f}" for k in LAYER_ORDER)


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
    mode (b) ("track_level"), the pose-graph kernels ("pose_graph", the
    cluster kernel; "pose_graph_grid", the grid kernel), the pyramid
    kernel ("pyramid") or the scan step ("scan_step")."""
    for kernel, what in (("sample_slab_kernel", "sampler"),
                         ("scan_step_kernel", "scan_step"),
                         ("track_level_kernel", "track_level"),
                         ("linearize_kernel", "linearize"),
                         ("pose_graph_grid_kernel", "pose_graph_grid"),
                         ("pose_graph_kernel", "pose_graph"),
                         ("pyramid_kernel", "pyramid")):
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
    attempt falls short, the phase fails. The session opens with a
    warm-up cycle (one device op, its records dropped), so body() starts
    once the tracer is live: launches in the first few ms of a session
    have lost their device records (the first pyramid launch of 12, in
    three attempts in a row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    kernels = ("sample_slab", "linearize", "track_level", "pose_graph",
               "pose_graph_grid", "pyramid", "scan_step")
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
            before = _launches()
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
              f"{what} (attempt {attempt} of {PROFILER_ATTEMPTS}); "
              f"{_unrecorded_launches(prof)}")
        time.sleep(1.0)
    raise AssertionError(f"the profiler lost device records of {what} in "
                         f"{PROFILER_ATTEMPTS} attempts")


def _unrecorded_launches(prof):
    """The kernel launches of a profiler session (runtime calls with
    "Launch" in their name) whose correlation id has no device record:
    their names, the front range holding each and its start (us into the
    session)."""
    from torch.autograd import DeviceType

    events = prof.events()
    recorded = {e.id for e in events if e.device_type == DeviceType.CUDA}
    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("front ")]
    lost = []
    for e in events:
        if (e.device_type == DeviceType.CPU and "Launch" in e.name
                and e.id not in recorded):
            t = e.time_range.start
            held = [r.name for r in ranges
                    if r.time_range.start <= t <= r.time_range.end]
            lost.append(f"{e.name} id {e.id} at {t:.0f} us in {held}")
    return f"launches without a device record: {lost or 'none'}"


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
        bad = _same_bits(out, want)
        if bad:
            raise AssertionError(f"level {lvl}: {bad} samples differ from "
                                 f"plain in their bits (max |kernel - "
                                 f"plain| {err})")
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
              f"inb {int(inb.sum())}): bit for bit, inb and NaN pattern "
              f"equal (max_abs_err {err:.3e}); "
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


def _events_us(fn, n=20, reps=5, cap_s=0.1):
    """Device microseconds per call of fn: n calls back to back between two
    CUDA events, the median over reps runs. A spin kernel queued before the
    first event holds the card while the host queues the n calls (for
    twice the host time of one call times n, at most cap_s), so a call
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
    spin = int(SPIN_HZ * min(2.0 * n * host_s, cap_s))
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


# 13a and the card tests: the motion prior at weights scaled to the data,
# mu = c x the largest diagonal entry of the free level's record. At
# 640x480 that diagonal is so large that a mu of 0.1 or 0.5 lies below one
# f32 ulp of it and cannot tell a kernel that drops the prior, or adds the
# posterior's mu I twice, from a right one. c = 1e-2 leaves the pose
# mostly to the data, c = 1 holds it near T_init, c = 1e4 pins it there.
PRIOR_SCALES = (1e-2, 1.0, 1e4)


def _prior_check(ref, cur, K, T0, cfg, what):
    """Mode (b) under priors scaled to the data (mu = c x the largest
    diagonal entry of the free level's record A over the rows, c in
    PRIOR_SCALES, cfg's other fields as they are) against the host loop
    over linearize_batched_reference on the same rows: _compare_level's
    gates (T within 1e-5; where the paths do not part, the records'
    posterior A within 1e-4 * max|A|), the kernel's record A within 1e-4 *
    max|A| of the plain linearization at the kernel's pose plus mu I (the
    posterior, mu I added once), and the kernel's entropy (mode (b)'s
    extras, from its record) within ENTROPY_ATOL of pose_entropy of both.
    The prior must move the pose: every row's pose at c = 1 at least 1e-4
    (ten times the pose gate) from the free pose, and at c = 1e4 at most a
    fifth as far from T_init as the free pose. Returns (max |dT|, max
    entropy error, {c: mu}, {c (0 for the free level): max |T - T_init|
    over rows and entries})."""
    import dataclasses

    import torch

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize

    T_free, fin_free, _ = dense_tracker.track_level(
        ref, cur, K, T0, dataclasses.replace(cfg, mu=0.0))
    scale = fin_free.A.diagonal(dim1=-2, dim2=-1).max().item()
    moved = {0.0: (T_free - T0).abs().amax(dim=(-2, -1))}
    poses = {}
    d_T = d_H = 0.0
    mus = {}
    eye = torch.eye(6, device=T0.device)
    entropy_at = (linearize._LEVEL_STATS + linearize._STAT_PLANES
                  * cfg.max_iterations + linearize._EXTRA_ENTROPY)
    for c in PRIOR_SCALES:
        cfg_c = dataclasses.replace(cfg, mu=c * scale)
        mus[c] = cfg_c.mu
        got = dense_tracker.track_level(ref, cur, K, T0, cfg_c)
        want = dense_tracker._track_level(
            ref, cur, K, T0, cfg_c,
            linearize=linearize.linearize_batched_reference)
        tag = f"{what} mu = {c:g} x {scale:.4g}"
        d_T = max(d_T, _compare_level(got, want, cfg_c, tag)[0])
        T, fin, _ = got
        post = (linearize.linearize_batched_reference(ref, cur, K, T, cfg_c).A
                + cfg_c.mu * eye)
        a_err = (fin.A - post).abs().amax(dim=(-2, -1))
        if not bool((a_err <= 1e-4 * post.abs().amax(dim=(-2, -1))).all()):
            raise AssertionError(f"{tag}: the record's A is {a_err.tolist()} "
                                 f"from the plain linearization + mu I")
        out, _ = linearize.track_level_kernels(ref, cur, K, T0, cfg_c)
        h = out[:, entropy_at]
        for h_want in (dense_tracker.pose_entropy(want[1].A),
                       dense_tracker.pose_entropy(post)):
            d_H = max(d_H, (h - h_want).abs().max().item())
        if not d_H <= ENTROPY_ATOL:
            raise AssertionError(f"{tag}: entropy {h.tolist()} is {d_H} from "
                                 f"the host loop's / the plain posterior's")
        poses[c] = T
        moved[c] = (T - T0).abs().amax(dim=(-2, -1))
    apart = (poses[1.0] - T_free).abs().amax(dim=(-2, -1))
    if not (bool((apart >= 1e-4).all())
            and bool((5.0 * moved[1e4] <= moved[0.0]).all())):
        raise AssertionError(f"{what}: the prior does not move the pose as it "
                             f"must: |T(c = 1) - T_free| {apart.tolist()}, "
                             f"|T - T_init| free {moved[0.0].tolist()}, at "
                             f"c = 1e4 {moved[1e4].tolist()}")
    return d_T, d_H, mus, {c: m.max().item() for c, m in moved.items()}


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
            C, P, stored, smem, _ = linearize.level_plan(device,
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


def _same_bits(a, b):
    """The count of entries of two float tensors whose bits differ (NaN
    against NaN counts as equal, whatever its payload)."""
    import torch

    an, bn = torch.isnan(a), torch.isnan(b)
    bits = (a.contiguous().view(torch.int32)
            != b.contiguous().view(torch.int32)) & ~(an & bn)
    return int(bits.sum().item())


# 3a: the level kernel's slab route against its RefData route in CONFIGS
# and with the selection's gradient thresholds on.
FRONT_CONFIGS = {**CONFIGS, "thresholds": {"intensity_grad_threshold": 1.0,
                                           "depth_grad_threshold": 0.005}}
FRONT_BATCHES = (1, 2, 8)
# 3a: the eager assembly's own f32 error bounds the kernel's f64 fields:
# the log-likelihood (relative) and the entropy (absolute; f32 slogdet).
LOGLIK_RTOL, ENTROPY_ATOL = 1e-5, 1e-3


def _front_frames(device, n, num_levels):
    """The first n frames of the noisy orbit (sensor noise, 2 % depth
    dropout) as kernel-built pyramids, the per-level intrinsics and the
    ground-truth poses."""
    import torch

    from dvo_slam_tpu_torch.ops import camera, pyramid
    from dvo_slam_tpu_torch.utils import synthetic

    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.06)
    rng = np.random.default_rng(1)
    pyrs = [pyramid.build_pyramid(*(torch.as_tensor(x, device=device)
                                    for x in synthetic.add_sensor_noise(
                                        *scene.render(np.asarray(K_TUPLE), W,
                                                      H, poses[k]), rng,
                                        dropout=0.02)), num_levels)
            for k in range(n)]
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE, device=device),
                                   num_levels)
    return pyrs, Ks, poses


# 13: every scale estimator, influence function and weighting the CLI
# offers (each estimator under another influence) and the motion prior,
# on the cluster kernel; MU is the prior's weight on the odometry orbit.
MU = 0.1
ESTIMATOR_CONFIGS = {
    "mad_huber": {"scale_estimator": "mad", "influence": "huber"},
    "normal_tukey": {"scale_estimator": "normal", "influence": "tukey"},
    "unit_tdist": {"scale_estimator": "unit", "influence": "tdist"},
    "unweighted": {"use_weighting": False},
}
PRIOR_CONFIGS = {"mu_gn": {"mu": MU},
                 "mu_lm": {"mu": MU, "lm_lambda_init": 1e-4}}
# 13b: the configs whose odometry runs are timed in turns against the host
# loop; the others run once on each route.
TURN_CONFIGS = ("mad_huber", "mu_gn")


def _mad_elements(res):
    """The plain MAD scale's elements of a residual pass (robust.scale_mad
    reads them from its sort): |rI|, |rZ| at index min(n // 2, n - 1) of
    the sorted values over the n valid points, +inf without one."""
    import torch

    n = int(res.valid.sum())
    out = []
    for r in (res.rI, res.rZ):
        absr = torch.where(res.valid, r.abs(), torch.full_like(r, np.inf))
        out.append(torch.sort(absr).values[min(n // 2, max(n - 1, 0))])
    return torch.stack(out)


def _odometry_run(device, cfg, frames):
    """A fresh OdometryTracker over the frames: (world poses, per frame
    after the first its (iterations, accepted, error, delta_norm) per
    level as numpy, ms/frame after N_WARMUP frames, the launches of each
    frame by kernel, the host loop's level calls)."""
    import torch

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker

    host_levels = [0]
    host_loop = dense_tracker._track_level

    def counted(*args, **kwargs):
        host_levels[0] += 1
        return host_loop(*args, **kwargs)

    tracker = OdometryTracker(K_TUPLE, cfg, device=device)
    ms, stats, per_frame = [], [], []
    dense_tracker._track_level = counted
    if dense_tracker.track_level is host_loop:  # under _host_loop
        dense_tracker.track_level = counted
    try:
        for k, (i, z) in enumerate(frames):
            before = _launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.update(i, z, float(k))
            torch.cuda.synchronize()
            if k >= N_WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
            after = _launches()
            per_frame.append({key: after[key] - before[key] for key in (
                "pyramid", "track_level", "linearize", "sample_slab")})
            if k > 0:
                s = tracker.last_result.stats
                stats.append(tuple(np.asarray(x.cpu()) for x in (
                    tracker.last_result.iterations, s.accepted, s.error,
                    s.delta_norm)))
    finally:
        if dense_tracker.track_level is counted:
            dense_tracker.track_level = host_loop
        dense_tracker._track_level = host_loop
    poses = [T for _, T in tracker.trajectory]
    return poses, stats, float(np.mean(ms)), per_frame, host_levels[0]


def phase_estimators(device, frames):
    """13: the cluster kernel under every scale estimator the CLI offers
    (ESTIMATOR_CONFIGS) and with the motion prior (PRIOR_CONFIGS, mu =
    MU), at 640x480:
    a. per tracked level of the noisy pair, mode (a) against
       linearize_reference on the same card tensors (_check_fused: n_raw,
       valid, rI and rZ exact; A, b within 1e-4 * max|.|; the rest rtol
       1e-4) and the MAD elements bit for bit against the plain sort's;
       mode (b) against the host loop over linearize_batched_reference
       (_compare_level on the noise-free orbit pair, 2d's gates on the
       noisy pair); for PRIOR_CONFIGS (GN, LM) also under priors scaled
       to the data (_prior_check: pose, the posterior A + mu I and the
       entropy against the host loop, the pose moved and pinned by the
       prior); mode (b)'s device us a launch (events) on the noisy pair
       beside the t-distribution's, and at the finest level the host
       loop's time (events, host time included) and the bound;
    b. 24-frame odometry over phase 3's orbit under each config, through
       the level kernel and through the host loop (_host_loop: the eager
       front, dense_tracker._track_level, one mode (a) launch an
       iteration), in turns (host, kernel, kernel, host) for TURN_CONFIGS,
       once each otherwise (mad + huber once more through the route it
       took before, the host loop over the plain linearization, timed
       only): on the kernel route every frame must show 1
       pyramid launch, 3 level launches (0 on the first frame), 0 mode (a)
       and standalone sampler launches and no host-loop level; the two
       routes' world poses within 1e-4 and every (frame, level) whose
       paths part parting at a tie (_parted); ms/frame;
    c. one 16-frame chunk of ChunkedKeyframeSlam under MAD + Huber after an
       8-frame one: inside submit_chunk 1 pyramid, 3 level and 1 scan-step
       launch a frame and nothing else, under
       torch.cuda.set_sync_debug_mode("error").
    Returns, per config, the kernels line's numbers."""
    import dataclasses
    from functools import partial

    import torch

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.ops import linearize

    t_start = time.perf_counter()
    base = TrackerConfig()
    configs = {name: dataclasses.replace(base, **fields) for name, fields in
               {"tdist": {}, **ESTIMATOR_CONFIGS, **PRIOR_CONFIGS}.items()}
    pairs = {noisy: _noisy_pair(device, base, noisy) for noisy in (False, True)}
    out = {name: {"err": 0.0, "us": {}} for name in configs}
    finest = base.tracked_levels[-1]
    for lvl in base.tracked_levels:
        for name, cfg in configs.items():
            d = out[name]
            if name in ESTIMATOR_CONFIGS:
                ref_pyr, cur_pyr, Ks, T = pairs[True]
                ref = linearize.prepare_reference(ref_pyr[lvl], Ks[lvl], cfg)
                r_err, abs_err, _ = _check_fused(ref, cur_pyr[lvl], Ks[lvl],
                                                 T, cfg)
                got = linearize.kernel_mad_elements(
                    device, ref.px.numel()).clone()
                want = _mad_elements(linearize.residuals_reference(
                    ref, cur_pyr[lvl], Ks[lvl], T, cfg))
                if cfg.scale_estimator == "mad" and cfg.use_weighting:
                    if _same_bits(got, want):
                        raise AssertionError(
                            f"13a {name} level {lvl}: MAD elements "
                            f"{got.tolist()} != plain {want.tolist()}")
                elif bool(got.any()):
                    raise AssertionError(f"13a {name}: MAD elements {got}")
                d["err"] = max(d["err"], r_err, abs_err)
            checks = []
            for noisy in (False, True):
                ref_pyr, cur_pyr, Ks, T = pairs[noisy]
                ref = linearize.prepare_reference(ref_pyr[lvl][None],
                                                  Ks[lvl], cfg)
                args = (ref, cur_pyr[lvl], Ks[lvl], T[None])
                got = dense_tracker.track_level(*args, cfg)
                want = dense_tracker._track_level(
                    *args, cfg, linearize=linearize.linearize_batched_reference)
                if noisy:
                    d_T = (got[0] - want[0]).abs().max().item()
                    n_k, n_h = float(got[1].n_raw[0]), float(want[1].n_raw[0])
                    if not (d_T <= 1e-3 and abs(n_k - n_h) <= 0.01 * n_h):
                        raise AssertionError(
                            f"13a {name} noisy level {lvl}: |dT| {d_T}, "
                            f"valid {n_k} / {n_h}")
                    us = _events_us(partial(linearize.track_level_kernels,
                                            *args, cfg))
                    its = int(got[2]["iterations"][0])
                    d["us"][lvl] = us
                    checks.append(f"noisy |dT| {d_T:.2e}, {its} iterations, "
                                  f"{us:.2f} us a launch")
                    if lvl == finest:
                        d["plain_ms"] = _events_us(partial(
                            dense_tracker._track_level, *args, cfg,
                            linearize=linearize.linearize_batched_reference),
                            n=1, reps=3) / 1e3
                        bound_cfg = cfg if name == "tdist" else \
                            dataclasses.replace(cfg, tdist_scale_iters=0)
                        d["bound"] = _bounds(bound_cfg, {
                            "N": ref.px.shape[1], "H": cur_pyr[lvl].shape[1],
                            "W": cur_pyr[lvl].shape[2]}, 1, {
                            "its": [its], "n_valid": float(got[1].n_raw[0]),
                            "paired": False})["track_level"]
                else:
                    d_T, a_rel, parted = _compare_level(
                        got, want, cfg, f"13a {name} orbit level {lvl}")
                    d["err"] = max(d["err"], d_T)
                    checks.append(f"orbit |dT| {d_T:.2e}, A error / max|A| "
                                  f"{a_rel:.2e}, parted at a tie "
                                  f"{parted or 'none'}")
            print(f"phase 13a {name} level {lvl}: "
                  + ("mode (a) vs plain: n_raw, valid, rI, rZ"
                     + (" and the MAD elements" if "mad" in name else "")
                     + " exact; " if name in ESTIMATOR_CONFIGS else "")
                  + "mode (b) vs host loop: " + "; ".join(checks))
    for lvl in base.tracked_levels:
        # The prior at weights scaled to the data, GN and LM, on the orbit.
        ref_pyr, cur_pyr, Ks, T = pairs[False]
        for name in PRIOR_CONFIGS:
            cfg = configs[name]
            ref = linearize.prepare_reference(ref_pyr[lvl][None], Ks[lvl], cfg)
            d_T, d_H, mus, moved = _prior_check(
                ref, cur_pyr[lvl], Ks[lvl], T[None], cfg,
                f"13a {name} orbit level {lvl}")
            out[name]["err"] = max(out[name]["err"], d_T)
            print(f"phase 13a {name} level {lvl}, the prior scaled to the "
                  f"data (mu " + ", ".join(f"{m:.4g}" for m in mus.values())
                  + f"): mode (b) vs host loop |dT| {d_T:.2e}, the "
                  f"posterior A + mu I once, entropy within {d_H:.2e}; max "
                  f"|T - T_init| free {moved[0.0]:.3e}, "
                  + ", ".join(f"c = {c:g} {moved[c]:.3e}"
                              for c in PRIOR_SCALES))
    for lvl in base.tracked_levels:
        print(f"phase 13a mode (b) device us a launch (events, noisy pair, "
              f"B = 1) level {lvl}: " + ", ".join(
                  f"{name} {out[name]['us'][lvl]:.2f}" for name in configs))

    for name, cfg in configs.items():
        if name == "tdist":
            continue
        d = out[name]
        runs = {True: [], False: []}
        order = (True, False, False, True) if name in TURN_CONFIGS \
            else (False, True)
        for host in order:
            if not host:
                _reset_launches()
            with _host_loop(host):
                runs[host].append(_odometry_run(device, cfg, frames))
            if not host:
                d["launches"] = _launches()["track_level"]
        (poses, stats, _, per_frame, host_levels) = runs[False][0]
        (poses_h, stats_h, _, _, host_levels_h) = runs[True][0]
        want = [{"pyramid": 1, "track_level": 3 * (k > 0), "linearize": 0,
                 "sample_slab": 0} for k in range(len(frames))]
        if per_frame != want or host_levels != 0:
            raise AssertionError(f"13b {name}: launches a frame {per_frame}, "
                                 f"host-loop levels {host_levels}")
        diff = max(float(np.abs(a - b).max()) for a, b in zip(poses, poses_h))
        parted = []
        for k, (s, s_h) in enumerate(zip(stats, stats_h)):
            for j, lvl in enumerate(cfg.tracked_levels):
                part = _parted(s[1][j], s_h[1][j], s[2][j], s_h[2][j],
                               s[3][j], s_h[3][j], int(s[0][j]),
                               int(s_h[0][j]), cfg.precision)
                if part is not None:
                    if not part[1]:
                        raise AssertionError(
                            f"13b {name} frame {k + 1} level {lvl}: the "
                            f"routes part at iteration {part[0]} without a "
                            f"tie")
                    parted.append((k + 1, lvl))
        if not diff <= 1e-4:
            raise AssertionError(f"13b {name}: trajectories {diff} apart")
        ms_k = [r[2] for r in runs[False]]
        ms_h = [r[2] for r in runs[True]]
        d.update(ms_frame=ms_k, host_ms_frame=ms_h, traj_err=diff)
        replaced = ""
        if name == "mad_huber":
            # The route this config took on the card before the kernel
            # took every estimator: the host loop over the plain
            # linearization (the standalone sampler and a sort).
            with _host_loop(), _plain_linearize():
                old = _odometry_run(device, cfg, frames)
            d["replaced_ms_frame"] = old[2]
            replaced = (f"; the replaced route (host loop over the plain "
                        f"linearization) {old[2]:.3f} ms/frame")
        d["err"] = max(d["err"], diff)
        print(f"phase 13b odometry {name} ({len(frames)} frames {W}x{H}): "
              f"level kernel {', '.join(f'{m:.3f}' for m in ms_k)} ms/frame, "
              f"host loop {', '.join(f'{m:.3f}' for m in ms_h)} ms/frame"
              + (" (in turns: host, kernel, kernel, host)"
                 if name in TURN_CONFIGS else "")
              + replaced
              + f"; a frame on the kernel route: pyramid 1, track_level 3, "
              f"linearize 0, standalone sampler 0, host-loop levels 0 "
              f"(host route: {host_levels_h} host-loop levels); max "
              f"|T_kernel - T_host| {diff:.3e}; (frame, level) parted at a "
              f"tie: {parted or 'none'}")

    cfg = configs["mad_huber"]
    slam = ChunkedKeyframeSlam(K_TUPLE, cfg, SlamConfig(),
                               enable_loop_closure=True, device=device)
    slam.init()

    def chunk(a, b):
        sel = [frames[k % len(frames)] for k in range(a, b)]
        return (np.stack([s[0] for s in sel]), np.stack([s[1] for s in sel]),
                [k / 30.0 for k in range(a, b)])

    slam.update_chunk(*chunk(0, 8))
    torch.cuda.synchronize()
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam.submit_chunk(*chunk(8, 8 + CHUNK))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _launches()
    slam.collect_chunk()
    per_frame = {k: (after[k] - before[k]) / CHUNK for k in SCAN_LAUNCHES}
    print(f"phase 13c a {CHUNK}-frame chunk under mad_huber: launches in "
          f"submit_chunk a frame "
          f"{', '.join(f'{k} {v:.2f}' for k, v in per_frame.items())}; "
          f"under set_sync_debug_mode(\"error\"): no synchronizing call")
    if per_frame != SCAN_LAUNCHES:
        raise AssertionError(f"13c: launches a frame {per_frame}, want "
                             f"{SCAN_LAUNCHES}")
    print(f"phase 13 took {time.perf_counter() - t_start:.1f} s")
    return out


def phase_front(device):
    """3a: the frame's front on the card against its plain versions.
    The pyramid kernel against build_pyramid_reference, bit for bit, at
    640x480 for f32, u8 + u16 and u8 + packed-12 inputs (the TMA fill) and
    at 642x482 (4 and 5 levels; the scalar fill), on depth with 2 %
    dropout; its device us a call (events) beside the plain chain's device
    us (events) and host ms, its bound, and its phase split (the median of
    three launches' phase stamps, ops/pyramid.phase_times). The level
    kernel's slab route (RefSlabs: a stacked
    tensor at B = 1 and 8, row pointers at B = 2) against its RefData
    route (prepare_reference), bit for bit, per tracked level, for
    FRONT_CONFIGS and B = 1, 2, 8: mode (a)'s Linearization and rI, rZ,
    valid; mode (b)'s whole output rows (pose, record, statistics, the
    selected count) and iterations; mode (b)'s us a launch at B = 1 on
    both routes, with the slab route's bound (this launch's iterations
    and valid points, _slab_ref_bytes) and its plain version's time
    (_slab_route_plain) on the same inputs. The kernel front's TrackResult against the eager
    front's (track_batched under _eager_front) at B = 1, 2, 8: every
    field bit for bit but the log-likelihood (rtol LOGLIK_RTOL) and the
    entropy (atol ENTROPY_ATOL). Returns the pyramid row's numbers and
    the per-level launch times."""
    import dataclasses

    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize, pyramid
    from dvo_slam_tpu_torch.utils import se3_np, synthetic

    t_phase = time.perf_counter()
    base = TrackerConfig()
    L = base.num_levels
    scene = synthetic.two_plane_scene(sharpness=2.0)
    rng = np.random.default_rng(2)
    pyr_rows, timed = [], {}
    for w, h in ((W, H), (W + 2, H + 2)):
        i, z = synthetic.add_sensor_noise(
            *scene.render(np.asarray(K_TUPLE), w, h, np.eye(4)), rng,
            dropout=0.02)
        i8 = np.clip(np.round(i), 0, 255).astype(np.uint8)
        z16 = np.where(np.isfinite(z), np.round(z * 5000.0),
                       0).astype(np.uint16)
        for enc, a, b in (("f32", i, z), ("u8+u16", i8, z16),
                          ("u8+packed12", i8, pyramid.pack_depth12(z16))):
            ti, tz = (torch.as_tensor(x, device=device) for x in (a, b))
            for levels in ((L,) if w == W else (L, L + 1)):
                got = pyramid.build_pyramid_kernel(ti, tz, levels)
                want = pyramid.build_pyramid_reference(ti, tz, levels)
                torch.cuda.synchronize()
                bad = [_same_bits(g, x) for g, x in zip(got, want)]
                nan = float(torch.isnan(want[0][pyramid.CH_Z]).float()
                            .mean())
                pyr_rows.append((f"{w}x{h} {enc} {levels} levels", bad, nan))
                if any(bad) or [g.shape for g in got] != [
                        x.shape for x in want]:
                    raise AssertionError(f"pyramid kernel at {w}x{h} {enc} "
                                         f"{levels} levels: {bad} entries "
                                         f"differ from the plain version")
            if w == W and enc != "u8+packed12":
                shapes = pyramid.level_shapes(h, w, L)
                nbytes = (ti.numel() * ti.element_size()
                          + tz.numel() * tz.element_size()
                          + 4 * pyramid.NUM_CHANNELS
                          * sum(a * b for a, b in shapes))
                plain = functools.partial(pyramid.build_pyramid_reference,
                                          ti, tz, L)
                host = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    plain()
                    torch.cuda.synchronize()
                    host.append(1e3 * (time.perf_counter() - t0))
                splits = []
                for _ in range(3):
                    buf = pyramid.timing_buffer(h, w, device)
                    pyramid.build_pyramid_kernel(ti, tz, L, timing=buf)
                    torch.cuda.synchronize()
                    splits.append(pyramid.phase_times(buf.cpu().numpy(), L))
                timed[enc] = {
                    "us": _events_us(functools.partial(
                        pyramid.build_pyramid_kernel, ti, tz, L)),
                    "plain_us": _events_us(plain, n=5),
                    "plain_host_ms": float(np.median(host)),
                    "bound": _bound_ms(nbytes, 0, 0),
                    "tma": pyramid.tma_fill(ti, tz),
                    "phases": {k: float(np.median([x[0][k] for x in splits]))
                               for k in splits[0][0]},
                    "span_us": float(np.median([x[1] for x in splits])),
                    "cta_us": float(np.median([x[2] for x in splits]))}
    print("phase 3a pyramid kernel against build_pyramid_reference, bit "
          "for bit (entries that differ per level; NaN share of level-0 "
          "depth): " + "; ".join(f"{name} {bad} ({nan:.3f})"
                                 for name, bad, nan in pyr_rows))
    for enc, t in timed.items():
        print(f"phase 3a pyramid {W}x{H} {enc} {L} levels: kernel "
              f"{t['us']:.2f} us a call (CUDA events); plain chain device "
              f"{t['plain_us']:.2f} us, host {t['plain_host_ms']:.3f} ms a "
              f"call; bound {1e3 * t['bound'][0]:.3f} us ({t['bound'][1]})")
        print(f"phase 3a pyramid {W}x{H} {enc} phase split (the kernel's "
              f"stamps, {'TMA' if t['tma'] else 'scalar'} fill; us a CTA, "
              f"median of 3 launches): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in t["phases"].items())
              + f"; a CTA {t['cta_us']:.3f} us, the launch's span "
              f"{t['span_us']:.3f} us")

    pyrs, Ks, poses = _front_frames(device, max(FRONT_BATCHES) + 1, L)
    launch_us = {}
    for name, over in FRONT_CONFIGS.items():
        cfg = dataclasses.replace(base, **over)
        for lvl in cfg.tracked_levels:
            K = Ks[lvl]
            for B in FRONT_BATCHES:
                paired = B == max(FRONT_BATCHES)
                stacked = torch.stack([p[lvl] for p in pyrs[:B]])
                rows = (tuple(p[lvl] for p in pyrs[:B]) if B == 2
                        else stacked)
                cur = (torch.stack([p[lvl] for p in pyrs[1:B + 1]])
                       if paired else pyrs[B][lvl])
                T = torch.as_tensor(np.stack([
                    (se3_np.inverse(poses[b + 1] if paired else poses[B])
                     @ poses[b]) @ se3_np.exp(rng.normal(scale=2e-3,
                                                         size=6))
                    for b in range(B)]), dtype=torch.float32, device=device)
                sigma = torch.tensor([[[40.0 + b, 0.01], [0.01, 1e-3]]
                                      for b in range(B)], device=device)
                ref = linearize.prepare_reference(stacked, K, cfg)
                slabs = linearize.RefSlabs(rows)
                N = ref.px.shape[1]
                outs = []
                for r in (slabs, ref):
                    lin = linearize.linearize_kernels_batched(
                        r, cur, K, T, cfg, sigma, True)
                    res = tuple(t.clone() for t in
                                linearize.kernel_residuals(device, N, B))
                    lvl_out = linearize.track_level_kernels(r, cur, K, T,
                                                            cfg)
                    outs.append((lin, res, lvl_out))
                torch.cuda.synchronize()
                (lin_s, res_s, (o_s, oi_s)), (lin_r, res_r, (o_r, oi_r)) = \
                    outs
                bad = {f: _same_bits(a, b) for f, a, b in
                       zip(lin_s._fields, lin_s[:-1], lin_r[:-1])}
                bad.update({f: _same_bits(a.float(), b.float()) for f, a, b
                            in zip(("rI", "rZ", "valid"), res_s, res_r)})
                bad["mode (b) rows"] = _same_bits(o_s, o_r)
                bad["mode (b) counts"] = int((oi_s != oi_r).sum().item())
                if any(bad.values()):
                    raise AssertionError(
                        f"slab route against RefData route, {name}, level "
                        f"{lvl}, B={B}: entries that differ {bad}")
                if name == "tdist" and B == 1:
                    t = {route: _events_us(functools.partial(
                        linearize.track_level_kernels, r, cur, K, T, cfg))
                        for route, r in (("slab", slabs), ("RefData", ref))}
                    # The slab route's bound and plain version from this
                    # launch: its iterations and valid points, the
                    # reference planes it reads.
                    t["its"] = int(oi_s[0, 0])
                    h, w = stacked.shape[-2:]
                    t["bound"] = _bounds(
                        cfg, {"N": N, "H": h, "W": w}, 1,
                        {"its": [t["its"]], "paired": False,
                         "n_valid": float(o_s[0, linearize._LEVEL_BEST
                                              + dense_tracker._N_RAW])},
                        ref_bytes=_slab_ref_bytes(cfg))["track_level"]
                    t["plain_ms"] = _events_us(functools.partial(
                        _slab_route_plain, stacked, cur, K, T, cfg),
                        n=1, reps=3) / 1e3
                    launch_us[lvl] = t
    print(f"phase 3a level kernel, slab route against RefData route: "
          f"bit for bit in modes (a) and (b) (Linearization, rI, rZ, valid; "
          f"pose, record, statistics, selected count, iterations) for "
          f"{list(FRONT_CONFIGS)}, levels {base.tracked_levels}, "
          f"B = {FRONT_BATCHES} (B = 2 by row pointers)")
    print("phase 3a mode (b) at B = 1, us a launch (CUDA events): "
          + "; ".join(f"level {lvl} slab route {t['slab']:.2f} for "
                      f"{t['its']} iterations (bound "
                      f"{1e3 * t['bound'][0]:.4f} us, {t['bound'][1]}; "
                      f"plain: prepare_reference and the host loop "
                      f"{1e3 * t['plain_ms']:.2f} us, host time included), "
                      f"RefData route {t['RefData']:.2f} (the reference "
                      f"points prepared beforehand)"
                      for lvl, t in launch_us.items()))

    worst = {"loglik": 0.0, "entropy": 0.0}
    for name in ("tdist", "thresholds"):
        cfg = dataclasses.replace(base, **FRONT_CONFIGS[name])
        for B in FRONT_BATCHES:
            paired = B == max(FRONT_BATCHES)
            refs = tuple(torch.stack([p[lvl] for p in pyrs[:B]])
                         if B != 2 else tuple(p[lvl] for p in pyrs[:B])
                         for lvl in range(L))
            curs = (tuple(torch.stack([p[lvl] for p in pyrs[1:B + 1]])
                          for lvl in range(L)) if paired else pyrs[B])
            T = torch.eye(4, device=device).expand(B, 4, 4)
            got = dense_tracker.track_batched(refs, curs, Ks, T, cfg)
            with _eager_front():
                want = dense_tracker.track_batched(refs, curs, Ks, T, cfg)
            torch.cuda.synchronize()
            bad = {}
            for field, a, b in zip(got._fields, got, want):
                if field == "stats":
                    for f, x, y in zip(a._fields, a, b):
                        bad[f] = _same_bits(x.float(), y.float())
                elif field not in ("log_likelihood", "entropy"):
                    bad[field] = _same_bits(torch.as_tensor(a).float(),
                                            torch.as_tensor(b).float())
            ll = ((got.log_likelihood - want.log_likelihood).abs()
                  / want.log_likelihood.abs()).max().item()
            en = (got.entropy - want.entropy).abs().max().item()
            worst = {"loglik": max(worst["loglik"], ll),
                     "entropy": max(worst["entropy"], en)}
            if any(bad.values()) or not (ll <= LOGLIK_RTOL
                                         and en <= ENTROPY_ATOL):
                raise AssertionError(
                    f"kernel front against eager front, {name}, B={B}: "
                    f"entries that differ {bad}; log-likelihood rel {ll:.2e}"
                    f" (tol {LOGLIK_RTOL:g}), entropy {en:.2e} (tol "
                    f"{ENTROPY_ATOL:g})")
    print(f"phase 3a kernel front against eager front (track_batched, "
          f"B = {FRONT_BATCHES}, tdist and thresholds): every field bit for "
          f"bit but log-likelihood (max rel {worst['loglik']:.2e}, tol "
          f"{LOGLIK_RTOL:g}) and entropy (max abs {worst['entropy']:.2e}, "
          f"tol {ENTROPY_ATOL:g}); phase 3a took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"pyramid": timed, "launch_us": launch_us}


def _slab_ref_bytes(cfg):
    """Bytes a point of the reference slab that the slab route reads: I
    and Z, Ix and Iy for the intensity threshold or reference gradients,
    Zx and Zy for the depth threshold or reference depth gradients."""
    ref_grad = cfg.gradient_source == "reference"
    return 4 * (2 + 2 * (cfg.intensity_grad_threshold > 0 or ref_grad)
                + 2 * (cfg.depth_grad_threshold > 0
                       or (ref_grad and cfg.use_depth)))


def _prologue_bytes(cfg, HW):
    """Bytes compaction's prologue reads (csrc/linearize.cu select_slots)
    for one row: its selection planes once (Z; Ix, Iy for the intensity
    threshold; Zx, Zy for the depth threshold or reference depth
    gradients). Its slot tables stay in shared memory."""
    ref_grad = cfg.gradient_source == "reference"
    planes = (1 + 2 * (cfg.intensity_grad_threshold > 0)
              + 2 * (cfg.depth_grad_threshold > 0
                     or (ref_grad and cfg.use_depth)))
    return 4 * planes * HW


def _slab_route_plain(ref_slab, cur, K, T, cfg):
    """The slab route's plain version: prepare_reference, then the host
    loop over the plain linearization."""
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize

    return dense_tracker._track_level(
        linearize.prepare_reference(ref_slab, K, cfg), cur, K, T, cfg,
        linearize=linearize.linearize_batched_reference)


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
          f"standalone sampler {launches['sample_slab']}, pyramid "
          f"{launches['pyramid']} ({N_FRAMES} frames); prepare_reference "
          f"calls {launches['prepare_reference']}")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    if (launches["pyramid"] != N_FRAMES
            or launches["prepare_reference"] != 0):
        raise AssertionError(f"the front: {launches['pyramid']} pyramid "
                             f"launches for {N_FRAMES} frames, "
                             f"{launches['prepare_reference']} "
                             "prepare_reference calls")
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
    `kwargs`: "cluster" (one launch of csrc/pose_graph.cu), "grid" (one
    launch of csrc/pose_graph_grid.cu) or "host loop"."""
    from dvo_slam_tpu_torch.models import pose_graph

    return pose_graph.graph_route(kwargs.get("solver", "dense"),
                                  graph.poses.shape[0],
                                  kwargs.get("device", "cuda"))


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
          f"per switch frame), grid kernel {launches['pose_graph_grid']}, "
          f"routes "
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
    routes = [_graph_route(g, kw) for _, _, g, kw in solves]
    on_kernel = [kw.get("use_robust", True)
                 for (_, _, g, kw), r in zip(solves, routes) if r == "cluster"]
    if (len(on_kernel) != launches["pose_graph"]
            or routes.count("grid") != launches["pose_graph_grid"]):
        raise AssertionError(f"{len(on_kernel)} / {routes.count('grid')} "
                             f"solves on the cluster / grid kernel's route, "
                             f"{launches['pose_graph']} / "
                             f"{launches['pose_graph_grid']} launches")
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


def phase_profile(device, frames, host, n=3, limits=True, cfg=None,
                  tag="4"):
    """4 (and 10a's profile, tag "10a", at a point budget): frames 1..n of
    the odometry main path under torch.profiler (the default config, or
    cfg), on a
    fresh tracker given frame 0 unprofiled, through the level kernel or
    (host) the host loop: wall and device busy per frame, idle share,
    device records per frame and per IRLS iteration, the heaviest
    records; through the kernel, each level's device time per launch and
    per IRLS iteration. With limits, the kernel front must keep to
    MAX_RECORDS_FRAME and MAX_FRONT_RECORDS_FRAME. Returns the cell's
    numbers."""
    import torch

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker

    tracker = OdometryTracker(K_TUPLE, cfg or TrackerConfig(), device=device)
    tracker.update(*frames[0], 0.0)

    def body():
        its = []
        t0 = time.perf_counter()
        for k in range(1, n + 1):
            tracker.update(*frames[k], float(k))
            its.append(tracker.last_result.iterations.cpu().tolist())
        torch.cuda.synchronize()
        return its, 1e6 * (time.perf_counter() - t0)

    with _host_loop(host), _front_ranges():
        (its, wall_us), prof = _traced(body, "the main path")
    recs = sorted(_device_intervals(prof), key=lambda r: r[1])
    busy = _busy_us(recs)
    n_it = sum(map(sum, its))
    kinds = [_kernel_of(r[0]) for r in recs]
    route = "host loop" if host else "level kernel"
    layers = _records_by_layer(prof)
    print(f"phase {tag} profile ({route}): {n} frames, {n_it} IRLS iterations, "
          f"wall {wall_us / 1e3 / n:.3f} ms/frame (profiler on), device "
          f"busy {busy / 1e3 / n:.3f} ms/frame, idle share "
          f"{1 - busy / wall_us:.4f}; {len(recs) / n:.1f} device records per "
          f"frame, {len(recs) / n_it:.1f} per IRLS iteration; per frame by "
          f"layer: {_layer_line(layers, n)}")
    for us, calls, name in _top_records(recs, n):
        print(f"  {us:9.1f} us/frame {calls:6.1f} calls/frame  {name[:90]}")
    if "sampler" in kinds:
        raise AssertionError("the main path launched the standalone sampler")
    front = sum(layers[k] for k in ("pyramid", "reference", "assembly"))
    if limits and not host and (len(recs) > MAX_RECORDS_FRAME * n
                     or front > MAX_FRONT_RECORDS_FRAME * n):
        raise AssertionError(f"the kernel front: {len(recs) / n:.1f} device "
                             f"records a frame (limit {MAX_RECORDS_FRAME}), "
                             f"{front / n:.1f} of them pyramid, reference "
                             f"and assembly (limit "
                             f"{MAX_FRONT_RECORDS_FRAME})")
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
            print(f"phase {tag} device time (profiler): level {lvl}, {cnt} "
                  f"launches, {it} IRLS iterations: track_level "
                  f"{us / cnt:.2f} us per launch, {us / it:.2f} us per "
                  f"iteration")
    return {"ms_frame": wall_us / 1e3 / n, "busy_ms": busy / 1e3 / n,
            "idle": 1 - busy / wall_us, "records": len(recs) / n,
            "per_level": per_level,
            "layers": {k: v / n for k, v in layers.items()}}


def _level_args(L, B=None):
    """A level's inputs as a batch (B None: phase 2's single pair as
    B = 1)."""
    from dvo_slam_tpu_torch.ops import linearize

    if B is None:
        return (linearize.RefData(*(None if f is None else f[None]
                                    for f in L["ref"])),
                L["slab"], L["K"], L["T"][None])
    return L["ref"], L["cur"], L["K"], L["T"]


def phase_device_times(cfg, levels, batched, front):
    """12: per level, device time per call by CUDA events (``_events_us``) of
    the standalone sampler, its plain version and the library call, and of
    the cluster kernel's two modes and their plain versions (mode (a):
    linearize_reference; mode (b): the host loop over
    linearize_batched_reference; both sync, so their times count the
    host's), at B = 1 (phase 2's noisy pair) and at the batches of phase
    5a; with the iterations each mode (b) call takes and the bounds."""
    from functools import partial

    from dvo_slam_tpu_torch import _build
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize, sampler

    out = {}
    device = next(iter(levels.values()))["slab"].device
    floor_us = _events_us(partial(_build.empty_launch, device))
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
    print(f"phase 12 launch floor: an empty kernel {floor_us:.2f} us a call "
          f"(CUDA events, as every time above), beside the sampler "
          + ", ".join(f"level {lvl} {1e3 * d['sampler']:.2f} us (bound "
                      f"{1e3 * d['bounds']['sampler'][0]:.4f})"
                      for lvl, d in ((k, out[(1, k)]) for k in sorted(levels)))
          + " and the pyramid " + ", ".join(
              f"{enc} {t['us']:.2f} us (bound {1e3 * t['bound'][0]:.3f})"
              for enc, t in front["pyramid"].items()))
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

    with _host_loop(host), _front_ranges():
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
    layers = dict.fromkeys(LAYER_ORDER, 0)
    for k in range(n):
        span = spans[f"smoke slam frame {k}"]
        mine = [r for r in recs if span.start <= r[1] <= span.end]
        if switched[k]:
            sw_busy.append(_busy_us(mine))
        else:
            plain_recs += len(mine)
            plain_launch += sum(_kernel_of(r[0]) == kind for r in mine)
            for layer, c in _records_by_layer(
                    prof, (span.start, span.end)).items():
                layers[layer] += c
    n_plain = max(sum(not v for v in switched.values()), 1)
    print(f"phase 5c SLAM profile ({'host loop' if host else 'level kernel'})"
          f": {n} frames ({n - n_plain} with a switch), wall "
          f"{wall_us / 1e3 / n:.3f} ms/frame (profiler on), device busy "
          f"{busy / 1e3 / n:.3f} ms/frame, idle share {1 - busy / wall_us:.4f}"
          f"; frames without a switch: {plain_recs / n_plain:.1f} device "
          f"records and {plain_launch / n_plain:.2f} {kind} launches per "
          f"frame (by layer: {_layer_line(layers, n_plain)}); switch "
          f"frames: device busy "
          f"{np.mean(sw_busy) / 1e3 if sw_busy else float('nan'):.3f} ms")
    if not switched[n // 2]:
        raise AssertionError("the forced keyframe switch did not happen")
    if plain_launch == 0:
        raise AssertionError(f"the SLAM profile saw no {kind} launch")
    return {"ms_frame": wall_us / 1e3 / n, "idle": 1 - busy / wall_us,
            "records": plain_recs / n_plain,
            "layers": {k: v / n_plain for k, v in layers.items()}}


def _bounds(cfg, L, B, d, ref_bytes=17, extra_bytes=0):
    """Per kernel at one level and batch: (ms, "bytes" or "operations"),
    the least time the card could take. Bytes: each input read once, each
    output written once: per linearization each row's reference points
    (ref_bytes a point: RefData's px, py, pz, i1 and selected, 17 B; the
    slab route's planes, _slab_ref_bytes) and the current slab (24 B a
    pixel; once per distinct
    slab), mode (a)'s outputs (204 B a row and 9 B a point of rI, rZ,
    valid); mode (b) repeats a linearization's reads once per iteration
    this run's rows took; extra_bytes once a launch (compaction's
    prologue, _prologue_bytes). Operations: counted per point from the
    source, the Sigma steps' and the normal equations' over the valid
    points only (the final valid count standing for every iteration's)."""
    N, HW = L["N"], L["H"] * L["W"]
    steps = cfg.tdist_scale_iters
    its, n_valid = d["its"], d["n_valid"]
    f32_row = RESIDUAL_OPS[0] * N
    f32_valid = steps * STEP_OPS[0] + NORMAL_OPS[0]
    f64_valid = RESIDUAL_OPS[1] + steps * STEP_OPS[1] + NORMAL_OPS[1]
    slab_reads = sum(its) if d["paired"] else max(its)
    out = {
        "linearize": _bound_ms(
            B * (ref_bytes * N + 204 + 9 * N)
            + (B if d["paired"] else 1) * 24 * HW + extra_bytes,
            B * f32_row + f32_valid * n_valid, f64_valid * n_valid),
        "track_level": _bound_ms(
            sum(its) * ref_bytes * N + slab_reads * 24 * HW + extra_bytes,
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
                compaction, par, graph, offline, front, scan, estimators):
    """The kernels' JSON rows at the finest tracked level: the standalone
    sampler, and the cluster kernel's two modes at B = 1 (the odometry
    main path's launches), at the SLAM path's batch sizes (its launches at
    that B), and mode (b) at B = 2 on the chunked engine's scan (phase 8's
    launches; the same launch as the SLAM path's B = 2 row, timed there),
    timed in phase 12; mode (b) at the validation batches B = 16 and 32
    (5d; the SLAM path's launches at that B), at N = budget (10b; phase
    10a's compacted odometry run's launches), the standalone sampler at a
    pixel shard's shape (11; rank 0's launches in the sharded pairs run:
    none since the split route) and the split mode (11; rank 0's split
    launches in the pairs run, the device time of rank 0's launches alone
    on the card by events, the plain pixel route's wall time, the bound
    from the bands' bytes); the pose-graph kernel on the ring's final
    keyframe graph and window graph (5b's graph and window solves'
    launches), on the offline
    benchmark's graph (6b's launches) and on _ring_graph at 64 and 128
    vertices (5e's launches at those sizes), timed in 5f; the grid kernel
    on 5g's last solve and _ring_graph at 256 (5g's launches at M = 256),
    timed in 5f, and on 6f's ring, dense and CG (the CLI's launches), timed
    in 6f; the pyramid
    kernel at 640x480 (f32 and raw u8 + u16 inputs; phase 3's launches,
    one a frame; its plain version's host ms a call) and mode (b) at B = 1
    on the slab route (phase 3's launches), timed in 3a with its bound
    and plain version from 3a's own launch; the scan step (phase 8's
    launches), timed in 8a with its bound; mode (b) under each scale
    estimator and with the motion prior (13b's kernel-route odometry
    launches, timed in 13a on the noisy pair with the bound of that
    launch's iterations and valid points). Every kernel time by CUDA
    events."""
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
    t = front["launch_us"][lvl]
    row("track_level (mode b), slab route (the kernel front)",
        "dvo_slam_tpu_torch/csrc/linearize.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226", launches["track_level"],
        0.0, t["slab"] / 1e3, t["plain_ms"], t["bound"], None)
    # No Pallas kernel: the frame's pyramid, which XLA fused; no single
    # PyTorch call computes it.
    for enc, t in front["pyramid"].items():
        row(f"pyramid (every level, one launch), {W}x{H} {enc}",
            "dvo_slam_tpu_torch/csrc/pyramid.cu",
            "dvo_slam_tpu/ops/pyramid.py:87", launches["pyramid"], 0.0,
            t["us"] / 1e3, t["plain_host_ms"], t["bound"], None)
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
    row(f"track_level (mode b), slab route compacted to N = budget "
        f"({COMPACT_BUDGET:g})", "dvo_slam_tpu_torch/csrc/linearize.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226",
        compaction["launches"]["track_level"], compaction["err"],
        d["us"] / 1e3, d["plain_ms"], d["bound"], None)
    row("sample_slab, pixel-sharded route (parallel/)",
        "dvo_slam_tpu_torch/csrc/sampler.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226", par["launches"],
        par["err"], par["ms"], par["plain_ms"], par["bound"], par["lib_ms"])
    d = par["split"]
    row(f"track_level_split (the level kernel's split mode, the pixel route: "
        f"stage launches over a rank's band, all-reduced between them), "
        f"pairs B={PARALLEL_B} on 2 pixel ranks, a pairs run's launches",
        "dvo_slam_tpu_torch/csrc/linearize.cu",
        "dvo_slam_tpu/ops/pallas/sampler.py:226", d["launches"], d["err"],
        d["ms"], d["plain_ms"], d["bound"], None)
    rows[-1]["launch_bound_ms"] = d["launch_bound_ms"]
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
              for v in EVICT_VERTICES)):
        d = graph[name]
        row(f"pose_graph (one dense LM solve), {what}, M={d['M']}, "
            f"cluster of {d['C']}",
            "dvo_slam_tpu_torch/csrc/pose_graph.cu",
            "dvo_slam_tpu/models/pose_graph.py:463", n_launch, d["err"],
            d["us"] / 1e3, d["plain_ms"], d["bound"], None)
    # No Pallas kernel: the JAX package's LM while_loop past 128 vertices
    # and _solve_cg's while_loop, compiled by XLA; no PyTorch call computes
    # a solve. 5g's run past 128 keyframes (its launches at M = 256, timed
    # in 5f on its last such solve and on _ring_graph at 256) and 6f's
    # optimize-graph runs on the 2 560-vertex ring (one launch each).
    past = slam_out["past128"]["launches"].get(256, 0)
    for name, what in (("slam256", "5g's last solve past 128 keyframes"),
                       ("ring256", "_ring_graph, interleaved")):
        d = graph[name]
        row(f"pose_graph_grid (one dense LM solve), {what}, M={d['M']}, "
            f"grid of {d['C']}", "dvo_slam_tpu_torch/csrc/pose_graph_grid.cu",
            "dvo_slam_tpu/models/pose_graph.py:463", past, d["err"],
            d["us"] / 1e3, d["plain_ms"], d["bound"], None)
    for solver, src_line in (("dense", 463), ("cg", 307)):
        d = offline["ring_solves"][solver]
        row(f"pose_graph_grid (one {solver} LM solve, optimize-graph), "
            f"{d['M']}-vertex ring, {d['steps']} steps",
            "dvo_slam_tpu_torch/csrc/pose_graph_grid.cu",
            f"dvo_slam_tpu/models/pose_graph.py:{src_line}", d["launches"],
            d["err"], d["ms"], d["plain_ms"], d["bound"], None)
    # No Pallas kernel: the JAX package's scan step after the tracker,
    # compiled by XLA inside lax.scan; no PyTorch call computes it.
    row("scan_step (the chunked keyframe scan's decisions, one launch a "
        "frame, a programmatic dependent of the finest level launch; "
        "without statistics: the main path)",
        "dvo_slam_tpu_torch/csrc/keyframe_scan.cu",
        "dvo_slam_tpu/models/keyframe_scan.py:100",
        chunked_launches["scan_step"], scan["err"], scan["us"] / 1e3,
        scan["plain_ms"], scan["bound"], None)
    for name in (*ESTIMATOR_CONFIGS, *PRIOR_CONFIGS):
        d = estimators[name]
        row(f"track_level (mode b), {name} (odometry's launches)",
            "dvo_slam_tpu_torch/csrc/linearize.cu",
            "dvo_slam_tpu/ops/pallas/sampler.py:226", d["launches"], d["err"],
            d["us"][lvl] / 1e3, d["plain_ms"], d["bound"], None)
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
    from dvo_slam_tpu_torch.ops import linearize, pyramid, sampler, scan_step

    scan_step.LAUNCHES_SCAN_STEP = 0
    pose_graph.LAUNCHES = 0
    pose_graph.LAUNCHES_GRID = 0
    pose_graph.LAUNCHES_BY_M.clear()
    sampler.LAUNCHES = 0
    linearize.LAUNCHES_LINEARIZE = 0
    linearize.LAUNCHES_TRACK_LEVEL = 0
    linearize.LAUNCHES_TRACK_LEVEL_SPLIT = 0
    linearize.COLLECTIVES_SPLIT = 0
    linearize.CAPTURES_SPLIT = 0
    linearize.REPLAYS_SPLIT = 0
    linearize.LAUNCHES_BY_BATCH.clear()
    linearize.PREPARE_REFERENCE_CALLS = 0
    pyramid.LAUNCHES_PYRAMID = 0


def _launches():
    """The kernels' launch counts, and the prepare_reference calls (no
    launch: the eager front's reference points)."""
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.ops import linearize, pyramid, sampler, scan_step

    return {"sample_slab": sampler.LAUNCHES,
            "scan_step": scan_step.LAUNCHES_SCAN_STEP,
            "linearize": linearize.LAUNCHES_LINEARIZE,
            "track_level": linearize.LAUNCHES_TRACK_LEVEL,
            "track_level_split": linearize.LAUNCHES_TRACK_LEVEL_SPLIT,
            "collectives_split": linearize.COLLECTIVES_SPLIT,
            "captures_split": linearize.CAPTURES_SPLIT,
            "replays_split": linearize.REPLAYS_SPLIT,
            "pose_graph": pose_graph.LAUNCHES,
            "pose_graph_grid": pose_graph.LAUNCHES_GRID,
            "pyramid": getattr(pyramid, "LAUNCHES_PYRAMID", 0),
            "prepare_reference": getattr(linearize,
                                         "PREPARE_REFERENCE_CALLS", 0),
            "by B": dict(sorted(linearize.LAUNCHES_BY_BATCH.items()))}


@contextlib.contextmanager
def _host_loop(on=True):
    """With on: the tracker runs the eager front (_eager_front's
    track_batched) with each level as its host loop
    (dense_tracker._track_level over linearize_batched, i.e. one mode (a)
    launch per lockstep iteration), called directly in place of
    track_level; otherwise as shipped (the kernel front: one level-kernel
    launch a level)."""
    from dvo_slam_tpu_torch.models import dense_tracker

    if not on:
        yield
        return
    saved = dense_tracker.track_level, dense_tracker.front_route
    dense_tracker.track_level = dense_tracker._track_level
    dense_tracker.front_route = lambda *args, **kwargs: False
    try:
        yield
    finally:
        dense_tracker.track_level, dense_tracker.front_route = saved


@contextlib.contextmanager
def _eager_front(on=True):
    """With on: a frame's front as eager PyTorch, the kernel front's plain
    versions (the pyramid by build_pyramid_reference, the reference points
    by prepare_reference a level, the result assembled by eager ops
    around one level-kernel launch a level); otherwise as shipped (one
    pyramid launch, the level launches on the slab route writing the
    result)."""
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import pyramid

    if not on:
        yield
        return
    saved = pyramid.build_pyramid, dense_tracker.front_route
    pyramid.build_pyramid = pyramid.build_pyramid_reference
    dense_tracker.front_route = lambda *args, **kwargs: False
    try:
        yield
    finally:
        pyramid.build_pyramid, dense_tracker.front_route = saved


@contextlib.contextmanager
def _host_graph(on=True):
    """With on: every graph solve runs the plain host loop
    (pose_graph.optimize_reference: ~200 eager ops and a host sync a LM
    step), swapped in for pose_graph.optimize as _lm_counted swaps it;
    otherwise as shipped (graph_route: one kernel launch a solve)."""
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
    from dvo_slam_tpu_torch.ops import camera
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
        flags = OFFLINE_FLAGS
        bench_host = [0]
        undo = _lm_counted([], bench_host)
        _reset_launches()
        try:
            rc, out = _cli(["benchmark", seq, *flags, "--trajectory-out",
                            traj, "--graph-out", graph, "--covariance-out",
                            cov, *dev])
        finally:
            undo()
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
              f"frame), grid kernel {launches['pose_graph_grid']}; host "
              f"loop LM steps {bench_host[0]}")
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
                or launches["pose_graph"] == 0
                or (torch.device(device).type == "cuda" and bench_host[0])):
            raise AssertionError(f"benchmark launches {launches}, host "
                                 f"loop LM steps {bench_host[0]}")
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
              f"ATE(keyframe)); launches pyramid {b_launches['pyramid']}, "
              f"track_level {b_launches['track_level']} "
              f"({b_launches['track_level'] / budget.num_frames:.3f} a "
              f"frame; 6b's {launches['track_level'] / slam['num_frames']:.3f})"
              f", by batch size {b_launches['by B']}, linearize "
              f"{b_launches['linearize']}, standalone sampler "
              f"{b_launches['sample_slab']}; prepare_reference calls "
              f"{b_launches['prepare_reference']}")
        if not gate_budget:
            raise AssertionError("the budget run fails gate_budget")
        if (b_launches["track_level"] == 0 or b_launches["linearize"] != 0
                or b_launches["sample_slab"] != 0
                or (torch.device(device).type == "cuda"
                    and b_launches["prepare_reference"] != 0)):
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
        cli_launches = {}
        for solver in ("dense", "cg"):
            cli_solves, cli_host = [], [0]
            undo = _lm_counted(cli_solves, cli_host)
            _reset_launches()
            sync()
            t0 = time.perf_counter()
            try:
                rc, out = _cli(["optimize-graph", ring, "--out", solved,
                                "--solver", solver, "--iterations",
                                str(OFFLINE_GRAPH_ITERATIONS),
                                "--no-robust-kernel", *dev])
                sync()
            finally:
                undo()
            ms_solve = 1e3 * (time.perf_counter() - t0)
            cli_launches[solver] = _launches()["pose_graph_grid"]
            routes = [_graph_route(g, kw) for _, _, g, kw in cli_solves]
            final = float(out.split()[-1])
            print(f"phase 6f optimize-graph --solver {solver} "
                  f"--no-robust-kernel on the "
                  f"{graph_vertices}-vertex ring ({n_edges} edges, "
                  f"{OFFLINE_GRAPH_ITERATIONS} LM iterations at most, "
                  f"graph_cg_threshold {slam_cfg.graph_cg_threshold}): "
                  f"{ms_solve:.1f} ms (load, solve, save), chi2 "
                  f"{ring_before:.6g} -> {final:.6g}; routes {routes}, "
                  f"grid kernel launches {cli_launches[solver]}, host loop "
                  f"LM steps {cli_host[0]}")
            # (final is printed to 6 digits)
            if rc != 0 or not (np.isfinite(final)
                               and final <= ring_before * (1 + 1e-5)):
                raise AssertionError(f"{solver} solve: chi2 {final}")
            on_card = torch.device(device).type == "cuda"
            if on_card and (routes != ["grid"] or cli_host[0] != 0
                            or cli_launches[solver] != 1):
                raise AssertionError(f"6f {solver}: routes {routes}, host "
                                     f"loop LM steps {cli_host[0]}")
        ring_solves = (_ring_solves(ring, device, cli_launches)
                       if torch.device(device).type == "cuda" else {})
        crossing = (_dense_or_cg(device, ring_solves)
                    if torch.device(device).type == "cuda" else {})

        # 6g: another scale estimator and influence function through the
        # CLI: the level kernel, one launch a tracked level, as the default.
        _reset_launches()
        rc, out = _cli(["odometry", seq, "--fr", "1", "--max-frames",
                        "24", "--scale-estimator", "normal",
                        "--influence", "huber", *dev])
        launches = _launches()
        r = json.loads(out)
        n_levels = len(tracker_cfg.tracked_levels)
        print(f"phase 6g odometry --scale-estimator normal --influence huber "
              f"({r['num_frames']} frames): {r['fps']:.3f} fps, ATE "
              f"{1e3 * r['ate_rmse_m']:.4f} mm; track_level "
              f"{launches['track_level']} ({n_levels} a tracked pair), "
              f"pyramid {launches['pyramid']}, linearize "
              f"{launches['linearize']}, standalone sampler launches "
              f"{launches['sample_slab']}")
        on_card = torch.device(device).type == "cuda"
        # One level launch a level for every tracked pair: the frames after
        # the first, and the benchmark's warm-up pair (run_sequence's own
        # tracker over the first two frames), so n_levels a frame; one
        # pyramid a frame and the warm-up's two.
        want = {"track_level": n_levels * r["num_frames"],
                "pyramid": r["num_frames"] + 2, "linearize": 0,
                "sample_slab": 0}
        if not (rc == 0 and (not on_card or all(
                launches[k] == v for k, v in want.items()))):
            raise AssertionError(f"6g launches {launches}, want {want}")
        return {"frames": [ds[k] for k in range(
                    max(2 * OFFLINE_PROFILED_FRAMES, TURN_OFFLINE_FRAMES))],
                "groundtruth": ds.groundtruth_pose,
                "tracker_cfg": tracker_cfg, "slam_cfg": slam_cfg,
                "graph": bench_graph, "launches": bench_launches,
                "frames_run": slam["num_frames"], "ring_solves": ring_solves,
                "crossing": crossing}


def _ring_solves(path, device, launches):
    """6f's 2 560-vertex ring (the .g2o at `path`), dense and CG as the CLI
    solved it, once more through the grid kernel (pose_graph.optimize) and
    once through the host loop (optimize_reference called directly): both
    ms (host clock to a sync), the steps, where the decisions part (only
    at a tie, _graph_parted), max |dpose| and the chi2 (rtol 1e-4). The
    poses are held at 1e-4 where f32 resolves that on the graph; where the
    host loop's own poses lie farther than 1e-4 from the same loop in f64
    on the card (f32 cannot resolve 1e-4 there), the 1e-4 comparison is
    printed as met or missed, the criterion of record, and the kernel's
    poses are held instead within twice the host loop's own distance to
    the f64 poses (the rule the grid kernel is held to on this graph).
    Beside the dense row, cuSOLVER's factor and solve (cholesky_ex +
    cholesky_solve, events) of the graph's first damped system. Returns
    {solver: row numbers}, `launches` the CLI run's grid launches by
    solver."""
    import torch

    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import g2o_io

    g = g2o_io.load_g2o(path)
    out = {}
    for solver in ("dense", "cg"):
        kw = dict(iterations=OFFLINE_GRAPH_ITERATIONS, use_robust=False,
                  solver=solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pose_graph.optimize(g, device=device, **kw)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        run = (int(pose_graph.LAST_STEPS), pose_graph.LAST_STATS.cpu().numpy())
        t0 = time.perf_counter()
        want = pose_graph.optimize_reference(g, device=device, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        run_h = (int(pose_graph.LAST_STEPS),
                 pose_graph.LAST_STATS.cpu().numpy())
        d_pose = (got[0].poses - want[0].poses).abs().max().item()
        c, c_h = float(got[1]), float(want[1])
        chi2_met = abs(c - c_h) <= 1e-4 * abs(c_h) + 1e-6
        parted = _graph_parted(run, run_h)
        split, span, steps, its = _graph_phases(g, kw, device, "grid")
        bound = (_graph_bound(g, run[0], kw["iterations"], False)
                 if solver == "dense" else
                 _graph_cg_bound(g, steps, its, kw["iterations"], False))
        resolution = ""
        held = d_pose <= 1e-4
        if not held:
            (n64, c64, P64), = _graph_f32_f64(g, kw, device, (True,))
            e_k = (got[0].poses.double() - P64).abs().max().item()
            e_h = (want[0].poses.double() - P64).abs().max().item()
            held = e_h > 1e-4 and e_k <= 2 * e_h
            resolution = (f"; the host loop in f64 on the card ({n64} "
                          f"steps, chi2 {c64:.9g}) lies {e_h:.3e} from the "
                          f"host loop's f32 poses and {e_k:.3e} from the "
                          f"kernel's: "
                          + (f"f32 cannot resolve 1e-4 on this graph; the "
                             f"1e-4 comparison missed (the criterion of "
                             f"record), the kernel held within twice the "
                             f"host loop's distance to f64 (the rule it is "
                             f"held to here): {'met' if held else 'missed'}"
                             if e_h > 1e-4 else
                             "f32 resolves 1e-4 on this graph: missed"))
        print(f"phase 6f ring, {solver}, grid kernel against the host loop "
              f"(optimize_reference): kernel {ms:.1f} ms ({run[0]} steps, "
              f"{span / 1e3:.1f} ms the launch by its stamps; per step us "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
              + (f"; CG iterations by LM step {its}" if any(its) else "")
              + f"), host loop {plain_ms:.1f} ms ({run_h[0]} steps); "
              + ("same decisions" if parted is None else
                 f"decisions part at step {parted[0]} (tie {parted[1]})")
              + f"; max |dpose| {d_pose:.3e} (tol 1e-4), chi2 {c:.7g} / "
              f"{c_h:.7g} (tol 1e-4: {'met' if chi2_met else 'missed'}); "
              f"bound {bound[0]:.3f} ms ({bound[1]}); CLI launches "
              f"{launches[solver]}" + resolution)
        if not (held and chi2_met and (parted is None or parted[1])):
            raise AssertionError(f"6f {solver}: the grid kernel disagrees "
                                 f"with the host loop")
        out[solver] = {"ms": ms, "plain_ms": plain_ms, "err": d_pose,
                       "bound": bound, "steps": run[0], "cg_iterations": its,
                       "launches": launches[solver], "span_ms": span / 1e3,
                       "M": g.poses.shape[0]}
    M = g.poses.shape[0]
    out["dense"]["cusolver_us"] = _cusolver_step_us(g, kw, device, 3, 3)
    step_us = 1e3 * out["dense"]["span_ms"] / max(out["dense"]["steps"], 1)
    print(f"phase 6f ring, cholesky_ex + cholesky_solve of the first damped "
          f"{6 * M}x{6 * M} system: {out['dense']['cusolver_us']:.2f} us "
          f"(events); the grid kernel's dense LM step {step_us:.2f} us (its "
          f"stamps)")
    return out


def _dense_or_cg(device, ring_solves):
    """6f's dense-to-CG crossing: _ring_graph at GRAPH_CROSSING_VERTICES
    (uncropped, as optimize-graph loads a file) solved dense and CG on the
    grid kernel as 6f solves its ring (OFFLINE_GRAPH_ITERATIONS LM steps,
    no robust kernel), each timed by the launch's own stamps (device ms),
    beside 6f's 2 560-vertex ring (`ring_solves`). The route's threshold
    (SlamConfig.graph_cg_threshold) is printed, not changed. Returns {V:
    {solver: (ms, steps)}}."""
    import os
    import shutil
    import tempfile

    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.utils import g2o_io

    tmp = tempfile.mkdtemp(prefix="dvo_crossing_")
    out = {}
    try:
        for V in GRAPH_CROSSING_VERTICES:
            path = os.path.join(tmp, f"ring{V}.g2o")
            _ring_graph(path, V)
            g = g2o_io.load_g2o(path)
            out[V] = {}
            for solver in ("dense", "cg"):
                kw = dict(iterations=OFFLINE_GRAPH_ITERATIONS,
                          use_robust=False, solver=solver)
                _, span, steps, _ = _graph_phases(g, kw, device, "grid")
                out[V][solver] = (span / 1e3, steps)
    finally:
        shutil.rmtree(tmp)
    for solver in ("dense", "cg"):
        d = ring_solves[solver]
        out.setdefault(d["M"], {})[solver] = (d["span_ms"], d["steps"])
    print("phase 6f dense against CG on _ring_graph (the grid kernel, "
          f"{OFFLINE_GRAPH_ITERATIONS} LM steps at most, no robust kernel; "
          "device ms a solve by the launch's stamps): "
          + "; ".join(f"{V} vertices dense {d['dense'][0]:.2f} "
                      f"({d['dense'][1]} steps), CG {d['cg'][0]:.2f} "
                      f"({d['cg'][1]} steps)"
                      for V, d in sorted(out.items()))
          + f"; graph_cg_threshold {SlamConfig().graph_cg_threshold} "
          "(not changed)")
    return out


def _cusolver_step_us(graph, kw, device, n=20, reps=5):
    """cuSOLVER's factor and solve (cholesky_ex + cholesky_solve) of the
    first LM step's damped system (the host loop's, with `kw`'s robust
    kernel), device us by CUDA events (_events_us with `n` and `reps`):
    the graph kernels' yardstick (library_ms)."""
    import torch

    from dvo_slam_tpu_torch.models import pose_graph

    M = graph.poses.shape[0]
    H, grad, _, _ = pose_graph._build_system(
        pose_graph.to_device(graph, device),
        pose_graph._topology(graph, device), kw.get("use_robust", True),
        kw.get("cauchy_c", 1.0))
    damped = (H + 1e-6 * torch.diag(torch.diagonal(H))
              + pose_graph._JITTER * torch.eye(6 * M, device=device))
    del H
    return _events_us(lambda: torch.cholesky_solve(
        -grad[:, None], torch.linalg.cholesky_ex(damped)[0]), n, reps)


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


def _fill_ops(graph):
    """The f32 operations of one dense factorization and solve of the
    damped system as the graph's block-level fill needs them, whatever
    kernel runs it: the symbolic Cholesky over the 6 x 6 blocks of the nv
    real vertices (inactive slots are decoupled identity blocks), where
    block (i, k) is nonzero if an unmasked edge or the diagonal puts one
    there, or if some j < k has (i, j) and (k, j) nonzero (column k's rows
    are its own and its children's in the elimination tree). Per block
    column with d nonzero blocks below the diagonal (b = 6): the diagonal
    factor (b^3 / 3), d row solves (b^3 each), d (d - 1) / 2 products into
    blocks below the diagonal (2 b^3 each) and d into the diagonal block
    (its lower triangle, b^2 (b + 1) each); the forward and backward
    solves, 4 b^2 a block below the diagonal and 2 b^2 a diagonal one."""
    nv = int(graph.num_vertices)
    on = np.asarray(graph.edge_mask, bool)
    i, j = np.asarray(graph.edge_i)[on], np.asarray(graph.edge_j)[on]
    real = (i < nv) & (j < nv) & (i != j)
    A = np.zeros((nv, nv), bool)
    A[np.maximum(i, j)[real], np.minimum(i, j)[real]] = True
    d = np.zeros(nv)
    children = [[] for _ in range(nv)]
    cols = {}
    for k in range(nv):
        col = A[:, k].copy()
        for c in children[k]:
            col |= cols.pop(c)
        col[:k + 1] = False
        below = np.flatnonzero(col)
        d[k] = below.size
        if below.size:
            cols[k] = col
            children[below[0]].append(k)
    b = 6.0
    return float(nv * b**3 / 3 + d.sum() * b**3
                 + (d * (d - 1) / 2).sum() * 2 * b**3
                 + d.sum() * b * b * (b + 1)
                 + 4 * d.sum() * b * b + 2 * nv * b * b)


def _graph_bound(graph, steps, iterations, gnc_adaptive, dense=True):
    """The graph kernel's bound for one solve: the packed upload (graph and
    sum plans, padding included) read once, the outputs written once; the
    operations of `steps` LM steps over the graph's nv real vertices and
    ne edges of the mask (inactive slots are decoupled identity blocks
    and masked edges add zero): per edge, per vertex, the assembly's
    adds, and the factorization and solves (these two dense only) as the
    graph's block-level fill needs them (_fill_ops); the adaptive start's
    and the final pass's residuals."""
    from dvo_slam_tpu_torch.models import pose_graph

    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    nv, ne = int(graph.num_vertices), int(np.asarray(graph.edge_mask).sum())
    buf, _ = pose_graph._pack(graph, dense)
    step_f32 = (ne * (GRAPH_EDGE_OPS[0] + GRAPH_RESIDUAL_OPS)
                + 12 * ne + nv * GRAPH_VERTEX_OPS
                + ((18 * (4 * ne + nv) + _fill_ops(graph)) if dense else 0))
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


def _graph_f32_f64(graph, kw, device="cpu", precisions=(False, True)):
    """The host loop on `device` (the CPU unless said) in f32 and in f64
    (to_device swapped for _graph_f64, as _host_graph swaps optimize):
    [(steps, chi2, poses)] in f32, then in f64 (`precisions`: f64 or not,
    in order)."""
    from dvo_slam_tpu_torch.models import pose_graph

    out, upload = [], pose_graph.to_device
    for f64 in precisions:
        if f64:
            pose_graph.to_device = functools.partial(_graph_f64,
                                                     upload=upload)
        try:
            g, chi2, _ = pose_graph.optimize_reference(graph, device=device,
                                                       **kw)
        finally:
            pose_graph.to_device = upload
        out.append((int(pose_graph.LAST_STEPS), float(chi2),
                    g.poses.double()))
    return out


def _graph_cg_bound(graph, steps, cg_iterations, iterations, gnc_adaptive):
    """_graph_bound for a CG solve: the LM steps' per-edge and per-vertex
    work without the factorization, and per CG iteration this run's data
    needed (cg_iterations: each step's count, from the grid kernel's
    timing buffer) the matvec over the real edges and the vertex work."""
    nv, ne = int(graph.num_vertices), int(np.asarray(graph.edge_mask).sum())
    ms, by = _graph_bound(graph, steps, iterations, gnc_adaptive, dense=False)
    cg_ops = sum(cg_iterations) * (ne * GRAPH_CG_EDGE_OPS
                                   + nv * GRAPH_CG_VERTEX_OPS)
    cg_ms = 1e3 * cg_ops / PEAK_F32_S
    return (ms, by) if ms >= cg_ms else (cg_ms, "operations")


# The first version of the graph kernel (a column Cholesky with a barrier
# a column, the sum plans walked per element of H, the solves in one warp
# or CTA by CTA), on 5f's graphs: device us per LM step of each phase from
# its phase stamps (pose_graph.PHASES) and, last, per LM step by CUDA
# events, measured once on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
GRAPH_FIRST_VERSION = {
    "ring": (6.74, 37.38, 68.83, 38.52, 1.30, 2.26, 156.77),
    "window": (6.33, 42.82, 200.56, 95.79, 1.76, 1.98, 351.94),
    "offline": (6.81, 44.25, 200.41, 95.75, 1.89, 2.46, 352.95),
    "evict64": (32.67, 428.30, 1262.74, 186.46, 2.04, 8.12, 1929.59),
    "evict128": (34.83, 2889.08, 6830.72, 552.19, 2.12, 9.43, 10322.68),
    "ring64": (11.36, 63.18, 1263.27, 201.61, 2.27, 4.57, 1548.58),
    "ring128": (18.83, 116.24, 6830.94, 465.25, 3.30, 6.37, 7443.30),
}
_KERNEL_KEYS = ("iterations", "use_robust", "cauchy_c", "gnc_init",
                "gnc_decay", "gnc_adaptive")


def _graph_phases(g, kw, device, route="cluster"):
    """One more kernel solve of `g` on `route`'s kernel with its
    phase-timing buffer: ({phase: device us per LM step}, the launch's us,
    steps, [CG iterations a step] (grid; None on the cluster kernel))."""
    import torch

    from dvo_slam_tpu_torch.models import pose_graph

    args = {k: v for k, v in kw.items() if k in _KERNEL_KEYS}
    if route == "cluster":
        buf = torch.zeros(4 + 7 * kw["iterations"], dtype=torch.int64,
                          device=device)
        pose_graph.optimize_kernel(g, device=device, timing=buf, **args)
        steps = int(pose_graph.LAST_STEPS)
        return (*pose_graph.phase_times(buf.cpu().numpy(), steps), steps,
                None)
    solver = kw.get("solver", "dense")
    buf = torch.zeros(pose_graph.grid_timing_size(kw["iterations"]),
                      dtype=torch.int64, device=device)
    pose_graph.optimize_grid(g, device=device, timing=buf, solver=solver,
                             **args)
    steps = int(pose_graph.LAST_STEPS)
    split, span, its = pose_graph.grid_phase_times(buf.cpu().numpy(), steps,
                                                   solver)
    return split, span, steps, its


def phase_graph(device, slam_out, offline):
    """5f: the pose-graph kernels (csrc/pose_graph.cu, one launch a dense solve
    of at most 128 vertices; csrc/pose_graph_grid.cu, one cooperative launch
    every other solve) against the plain host loop (optimize_reference,
    cuSOLVER's Cholesky, torch's CG) on the card, on the SLAM ring's final
    keyframe graph (as its final solve), the last window graph of 5b's timed
    run, 6b's benchmark graph (cropped as the engine crops it, as its final
    solve), 5e's last solve at each of EVICT_VERTICES (as 5e ran it),
    _ring_graph at GRAPH_RING_VERTICES (as an interleaved graph solve; 256 and
    past on the grid kernel), at GRAPH_CG_VERTICES with the CG solver
    (GRAPH_CG_ITERATIONS LM steps) and 5g's last solve past 128 keyframes (256
    slots, as 5g ran it): steps on each route, max |dpose|, the chi2's relative
    difference, where the two runs' decisions part (only at a tie:
    _graph_parted); the kernel's device us per solve and per step (CUDA events
    behind a spin kernel), the host loop's ms (host clock to a sync),
    cuSOLVER's factor and solve (cholesky_ex + cholesky_solve) on the graph's
    damped system at its first step (events), the bound. The f32 resolution of
    each graph: the plain formula (_build_blocks) in f32 against the same in
    f64, at the kernel's poses (weights and chi2) and at the host loop's
    (chi2). Where the weights' own f32 error passes 1e-4, f32 cannot resolve
    the comparison on the graph, and the checks of the two routes against each
    other that rest on it (weights, chi2, decisions) are printed, not held,
    beside the host loop in f32 and f64 (on the CPU; on the card past 128
    vertices); the poses are held on every graph, and every graph but 5e's and
    5g's (GRAPH_KEYFRAME_EVERY_FRAME: a keyframe every frame, thousands of loop
    edges) must resolve its weights. Two routes' f32 chi2 differ by their own
    f32 errors as well as by their poses: where those two errors add up past
    1e-4 (a solve that ends fitting f32 evaluation noise, as 5b's window graph
    without the robust kernel does: its f64 loop converges in 2 steps, its f32
    steps after that move the f32 chi2 by ~1e-4-5e-4 and the poses by ~1e-7),
    the two routes' chi2 are compared in f64 at their own poses (1e-4), a rule
    still to be accepted, and the f32 comparison is printed as met or missed,
    the record of the criterion; every other check stands. Returns {name: row
    numbers}."""
    import functools
    import os
    import shutil
    import tempfile

    import torch

    from dvo_slam_tpu_torch import SlamConfig, _build
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import g2o_io

    device = torch.device(device)

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
              for M in EVICT_VERTICES]
    tmp = tempfile.mkdtemp(prefix="dvo_graph_")
    interleaved = dict(final_kw(SlamConfig()),
                       iterations=SlamConfig().optimization_iterations)
    for vertices, solver in ([(v, "dense") for v in GRAPH_RING_VERTICES]
                             + [(v, "cg") for v in GRAPH_CG_VERTICES]):
        path = os.path.join(tmp, f"ring{vertices}.g2o")
        n_edges = _ring_graph(path, vertices)
        g = pose_graph.crop(g2o_io.load_g2o(path, max_vertices=vertices),
                            vertices, pose_graph.bucket(n_edges, 64))
        if solver == "dense":
            cases.append((f"ring{vertices}", g, interleaved))
        else:
            cases.append((f"ring{vertices}cg", g, dict(
                interleaved, solver="cg", iterations=GRAPH_CG_ITERATIONS)))
    shutil.rmtree(tmp)
    cases.append(("slam256", *slam_out["past128"]["graph"]))
    out = {}
    for name, g, kw in cases:
        M, E = g.poses.shape[0], g.edge_i.shape[0]
        route = _graph_route(g, {"device": device, **kw})
        if route != ("cluster" if M <= pose_graph.KERNEL_MAX_VERTICES
                     and kw.get("solver", "dense") == "dense" else "grid"):
            raise AssertionError(f"5f {name}: M = {M} takes the {route} "
                                 f"route")
        counter = "LAUNCHES" if route == "cluster" else "LAUNCHES_GRID"
        before = getattr(pose_graph, counter)
        got = pose_graph.optimize(g, device=device, **kw)
        run = (int(pose_graph.LAST_STEPS), pose_graph.LAST_STATS.cpu().numpy())
        if getattr(pose_graph, counter) != before + 1:
            raise AssertionError(f"5f {name}: not one {route} kernel launch")
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
        # The same at the host loop's poses, in f32 and f64.
        g_h = pose_graph.to_device(g, device)._replace(poses=want[0].poses)
        _, _, chi2_at_h, _ = pose_graph._build_blocks(
            g_h, pose_graph._topology(g, device), kw.get("use_robust", True),
            kw.get("cauchy_c", 1.0))
        _, _, chi2_64_h, _ = pose_graph._build_blocks(
            _graph_f64(g, device)._replace(poses=want[0].poses.double()),
            pose_graph._topology(g, device), kw.get("use_robust", True),
            kw.get("cauchy_c", 1.0))
        res_c_h = abs(float(chi2_at_h) - float(chi2_64_h)) / float(chi2_64_h)
        chi2_resolved = res_c + res_c_h <= 1e-4
        resolved = res_w <= 1e-4 and chi2_resolved
        c, c_h = float(got[1]), float(want[1])
        d_chi2 = abs(c - c_h) / max(abs(c_h), 1e-30)
        f32_met = abs(c - c_h) <= 1e-4 * abs(c_h) + 1e-6
        d_chi2_64 = (abs(float(chi2_64) - float(chi2_64_h))
                     / max(abs(float(chi2_64_h)), 1e-30))
        parted = _graph_parted(run, run_h)
        # Past one CTA a solve takes 10-750 ms: fewer calls a run.
        us = _events_us(functools.partial(pose_graph.optimize, g,
                                          device=device, **kw),
                        *((20, 5) if M <= 32 else (4, 3)))
        cusolver_us = _cusolver_step_us(g, kw, device)
        # The phase split (beside the cluster kernel's first version's).
        split, launch_us, split_steps, cg_its = _graph_phases(g, kw, device,
                                                              route)
        if kw.get("solver", "dense") == "cg":
            bound = _graph_cg_bound(g, split_steps, cg_its, kw["iterations"],
                                    kw.get("gnc_adaptive", False))
        else:
            bound = _graph_bound(g, run[0], kw["iterations"],
                                 kw.get("gnc_adaptive", False))
        if route == "cluster":
            plan = pose_graph.kernel_plan(M, E)
            layout = f"cluster of {plan[1]} CTAs, panel width {plan[4]}"
            ctas = plan[1]
        else:
            plan = pose_graph.grid_plan(M, E, kw.get("solver", "dense"),
                                        _build.sm_count(device.index or 0))
            layout = (f"grid of {plan[0]} CTAs, tile width {plan[3]}, "
                      f"{plan[4]} tiles a side")
            ctas = plan[0]
        first = GRAPH_FIRST_VERSION.get(name)
        print(f"phase 5f pose graph, {name} graph: per LM step, device us "
              f"(the kernel's phase stamps; {layout}, {split_steps} steps, "
              f"{launch_us:.2f} us the launch): "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
              + f"; by events {us / max(run[0], 1):.2f}"
              + ("" if cg_its is None or not any(cg_its) else
                 f"; CG iterations by LM step {cg_its}")
              + ("" if first is None else
                 "; the first version (column Cholesky, recorded): "
                 + ", ".join(f"{k} {v:.2f}" for k, v in
                             zip(pose_graph.PHASES, first))
                 + f"; by events {first[-1]:.2f}"))
        on_card = M > pose_graph.KERNEL_MAX_VERTICES
        ref_where = "on the card" if on_card else "on the CPU"
        print(f"phase 5f pose graph, {name} graph (M = {M}, E = {E}, "
              f"{kw.get('solver', 'dense')}, {route} route, {layout}, "
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
              f"{c_h:.7g} (rel {d_chi2:.3e}, tol 1e-4: "
              f"{'met' if f32_met else 'missed'}); at the kernel's "
              f"poses the plain chi2 within {d_chi2_at:.3e} (tol 1e-4) and "
              f"weights within {d_w:.3e} (tol 1e-4), weights route to route "
              f"{d_w_route:.3e}; kernel {us:.2f} us per solve (events), "
              f"{us / max(run[0], 1):.2f} per step; host loop "
              f"{plain_ms:.3f} ms ({plain_ms / max(run_h[0], 1):.3f} per "
              f"step); cholesky_ex + cholesky_solve on the damped "
              f"{6 * M}x{6 * M} system {cusolver_us:.2f} us; bound "
              f"{1e3 * bound[0]:.4f} us ({bound[1]}); f32 resolution at "
              f"the kernel's poses (plain formula f32 against f64): weights "
              f"{res_w:.3e}, chi2 {res_c:.3e} (at the host loop's "
              f"{res_c_h:.3e}): "
              + ("resolved" if resolved else
                 f"chi2 beyond f32: the f32 chi2 comparison "
                 f"{'met' if f32_met else 'missed'} (the criterion of "
                 f"record), held instead in f64 at each route's own poses "
                 f"(a rule still to be accepted): {float(chi2_64):.9g} / "
                 f"{float(chi2_64_h):.9g} (rel {d_chi2_64:.3e}, tol 1e-4); "
                 f"host loop {ref_where} "
                 + ", ".join(f"{t} {n} steps, chi2 {x:.7g}"
                             for t, (n, x, _) in zip(
                                 ("f32", "f64"),
                                 _graph_f32_f64(g, kw, device if on_card
                                                else "cpu")))
                 if res_w <= 1e-4 else
                 f"beyond f32, only the poses held; host loop {ref_where} "
                 + ", ".join(f"{t} {n} steps, chi2 {x:.7g}"
                             for t, (n, x, _) in zip(
                                 ("f32", "f64"),
                                 _graph_f32_f64(g, kw, device if on_card
                                                else "cpu")))))
        close = (d_w <= 1e-4 and d_chi2_at <= 1e-4
                 and (f32_met if chi2_resolved else d_chi2_64 <= 1e-4)
                 and (parted is None or parted[1]))
        if not (d_pose <= 1e-4 and (close or res_w > 1e-4)):
            raise AssertionError(f"5f {name}: the graph kernel disagrees "
                                 f"with the host loop")
        if not (res_w <= 1e-4 or name in GRAPH_KEYFRAME_EVERY_FRAME):
            raise AssertionError(f"5f {name}: beyond f32 resolution")
        out[name] = {"M": M, "C": ctas, "route": route, "us": us,
                     "split": split, "plain_ms": plain_ms, "err": d_pose,
                     "f32_met": f32_met, "bound": bound, "steps": run[0],
                     "cusolver_us": cusolver_us, "cg_iterations": cg_its}
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

        with _front_ranges():
            (wall_us, switches), prof = _traced(body, "the offline cell")
    recs = _device_intervals(prof)
    busy = _busy_us(recs)
    layers = _records_by_layer(prof)
    kind = "linearize" if host else "track_level"
    launched = sum(_kernel_of(r[0]) == kind for r in recs)
    print(f"phase 6h offline profile ({'host loop' if host else 'level kernel'}"
          f"): {n} frames ({switches} keyframe switches), wall "
          f"{wall_us / 1e3 / n:.3f} ms/frame (profiler on), device busy "
          f"{busy / 1e3 / n:.3f} ms/frame, idle share "
          f"{1 - busy / wall_us:.4f}; {len(recs) / n:.1f} device records and "
          f"{launched / n:.2f} {kind} launches per frame (by layer: "
          f"{_layer_line(layers, n)})")
    if launched == 0:
        raise AssertionError(f"the offline profile saw no {kind} launch")
    return {"ms_frame": wall_us / 1e3 / n, "idle": 1 - busy / wall_us,
            "records": len(recs) / n,
            "layers": {k: v / n for k, v in layers.items()}}


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
        graphs.setdefault(("offline", host), (res.num_keyframes,
                                              res.num_loop_edges))
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
    # The eager front (the plain versions) against the kernel front, the
    # level kernel and the graph kernel throughout.
    for cell, fn in (("odometry", odometry), ("slam", slam),
                     ("offline", offline_cell)):
        times = {True: [], False: []}
        for eager in (True, False, False, True):
            with _eager_front(eager):
                times[eager].append(fn(("front", eager)))
        out[cell + " front"] = times
        e, k = times[True], times[False]
        print(f"phase 7 {cell} cell, the front in turns (eager, kernel, "
              f"kernel, eager): eager front {e[0]:.3f}, {e[1]:.3f} "
              f"ms/frame; kernel front {k[0]:.3f}, {k[1]:.3f} ms/frame; "
              f"eager / kernel {np.mean(e) / np.mean(k):.2f}x")
    levels = TrackerConfig().tracked_levels
    its_e, its_k = odo_iters[("front", True)], odo_iters[("front", False)]
    n_diff = sum(a != b for x, y in zip(its_e, its_k)
                 for a, b in zip(x, y))
    kf_e, edges_e, loops_e = graphs[("front", True)]
    kf_f, edges_f, loops_f = graphs[("front", False)]
    off_e, off_k = graphs[("offline", ("front", True))], \
        graphs[("offline", ("front", False))]
    print(f"phase 7 front turns: odometry iterations per (frame, level) "
          f"{n_diff} of {len(its_k) * len(levels)} differ; SLAM keyframes "
          f"{'the same' if kf_e == kf_f else f'{kf_f} / {kf_e}'}, graph "
          f"edges {'identical' if edges_e == edges_f else 'differ'} (loop "
          f"edges {loops_f} kernel front, {loops_e} eager front); offline "
          f"keyframes and loop edges {off_k} kernel front, {off_e} eager "
          f"front")
    if (kf_e != kf_f or edges_e != edges_f or loops_f < 1
            or off_e != off_k):
        raise AssertionError(f"the front turns part: SLAM keyframes {kf_f} "
                             f"/ {kf_e}, edges {edges_f} / {edges_e}; "
                             f"offline {off_k} / {off_e}")
    kf_g, edges_g, loops_g = graphs[("graph", False)]
    kf_gh, edges_gh, loops_gh = graphs[("graph", True)]
    print(f"phase 7 slam graph turns: keyframes "
          f"{'the same' if kf_g == kf_gh else f'{kf_g} / {kf_gh}'} on both "
          f"graph routes; graph edges "
          f"{'identical' if edges_g == edges_gh else 'differ'} (loop edges "
          f"{loops_g} through the kernel, {loops_gh} through the host loop)")
    if min(loops_g, loops_gh) < 1:
        raise AssertionError("the SLAM graph turns accepted no loop edge")
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
    one per solve (every solve on a kernel's route). Returns {"launches":
    {M: n}, "graphs": {M: (the last such solve's host graph, its keyword
    arguments)}} for EVICT_VERTICES."""
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
    out, solves, host_steps = {}, [], [0]
    for resident in (64, 256):
        slam = KeyframeSlam(K, cfg, SlamConfig(resident_keyframes=resident),
                            device=device)
        slam.init()
        undo = _lm_counted(solves if resident == 64 else [], host_steps,
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
          f", graph-kernel launches by M {dict(sorted(launched.items()))}"
          f", host loop LM steps {host_steps[0]}")
    if not (len(small.keyframes) == EVICT_FRAMES and evicted > 0 and same
            and small.validation_cache_stats["misses"] > 0
            and small.num_loop_edges >= 1 and diff <= 1e-6):
        raise AssertionError("the evicting SLAM run differs from the "
                             "resident one")
    on_kernel = {}
    for (M, route), n in by_m.items():
        if route != "host loop":
            on_kernel[M] = on_kernel.get(M, 0) + n
    if (launched != on_kernel or host_steps[0] != 0
            or not set(EVICT_VERTICES) <= set(launched)):
        raise AssertionError(f"5e graph-kernel launches by M {launched}, "
                             f"solves by (M, route) {by_m}, host loop LM "
                             f"steps {host_steps[0]}")
    graphs = {g.poses.shape[0]: (g, {k: v for k, v in kw.items()
                                     if k != "device"} | {"iterations": it})
              for it, _, g, kw in solves if _graph_route(g, kw) == "cluster"}
    return {"launches": launched,
            "graphs": {M: graphs[M] for M in EVICT_VERTICES}}


def phase_past128(device):
    """5g: KeyframeSlam past 128 keyframes (a keyframe forced every frame,
    as 5e, PAST128_FRAMES frames of the ring at EVICT_W x EVICT_H, 5e's
    tracker levels, default SlamConfig, loop closure on): past 128
    keyframes its graph solves take 256 vertex slots, the grid kernel's
    route. The solves by (vertex slots M, route) (LM steps counted per
    solve as 5b counts them), the launches by M (LAUNCHES_BY_M: one per
    solve), the grid kernel's launches (> 0 at M = 256, one per solve on
    its route), the host loop's LM steps (0), loop edges (>= 1), a finite
    trajectory and its ATE against the ring's ground truth (printed: 5e
    holds no ATE at 160x120 either). Returns {"launches": {M: n},
    "grid": grid launches, "graph": (the last M = 256 solve's host graph,
    its keyword arguments)}."""
    import torch

    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.utils import evaluate, synthetic

    K = (525.0 * EVICT_W / 640.0, 525.0 * EVICT_H / 480.0,
         (EVICT_W - 1) / 2.0, (EVICT_H - 1) / 2.0)
    scene = synthetic.two_plane_scene(sharpness=2.0)
    ring = synthetic.orbit_trajectory(RING + 1, radius=0.06)[:RING]
    frames = synthetic.render_sequence(scene, np.asarray(K), EVICT_W, EVICT_H,
                                       ring)
    cfg = TrackerConfig(num_levels=3, first_level=2, last_level=0)
    slam = KeyframeSlam(K, cfg, SlamConfig(), enable_loop_closure=True,
                        device=device)
    slam.init()
    solves, host_steps = [], [0]
    undo = _lm_counted(solves, host_steps, copy=True)
    _reset_launches()
    t0 = time.perf_counter()
    try:
        for k in range(PAST128_FRAMES):
            if k > 0:
                slam.force_keyframe()
            slam.update(*frames[k % RING], k / 30.0)
        traj = slam.finish()
        torch.cuda.synchronize()
    finally:
        undo()
    seconds = time.perf_counter() - t0
    launches = _launches()
    launched = dict(pose_graph.LAUNCHES_BY_M)
    by_m, steps = {}, {}
    mean_steps = (lambda: {k: round(float(np.mean(v)), 2)
                           for k, v in sorted(steps.items())})
    for _, ran, g, kw in solves:
        key = (g.poses.shape[0], _graph_route(g, kw))
        by_m[key] = by_m.get(key, 0) + 1
        steps.setdefault(key, []).append(int(ran))
    on_kernel = {}
    for (M, route), n in by_m.items():
        if route != "host loop":
            on_kernel[M] = on_kernel.get(M, 0) + n
    est = np.stack([T for _, T in traj])
    gt = [ring[k % RING] for k in range(PAST128_FRAMES)]
    ate = evaluate.ate_rmse(list(est), gt) if np.isfinite(est).all() \
        else float("nan")
    n_grid = sum(n for (_, r), n in by_m.items() if r == "grid")
    print(f"phase 5g SLAM past 128 keyframes: {PAST128_FRAMES} frames at "
          f"{EVICT_W}x{EVICT_H}, a keyframe every frame: "
          f"{len(slam.keyframes)} keyframes, loop edges "
          f"{slam.num_loop_edges}, ATE "
          f"{1e3 * ate:.4f} mm against the ring's ground truth, "
          f"{seconds:.1f} s; graph and window solves by (vertex slots M, "
          f"route): {dict(sorted(by_m.items()))}, LM steps a solve mean by "
          f"(M, route) "
          f"{mean_steps()}"
          f"; launches by M {dict(sorted(launched.items()))}, grid kernel "
          f"{launches['pose_graph_grid']}, cluster kernel "
          f"{launches['pose_graph']}; host loop LM steps {host_steps[0]}")
    if not (len(slam.keyframes) > 128 and slam.num_loop_edges >= 1
            and np.isfinite(est).all() and host_steps[0] == 0
            and by_m.get((256, "grid"), 0) > 0 and launched == on_kernel
            and launches["pose_graph_grid"] == n_grid):
        raise AssertionError("5g: the SLAM run past 128 keyframes failed its "
                             "checks")
    last = [(g, {k: v for k, v in kw.items() if k != "device"}
             | {"iterations": it}) for it, _, g, kw in solves
            if g.poses.shape[0] == 256 and _graph_route(g, kw) == "grid"][-1]
    # Why each step of the last 256-slot solve came out zero, on the grid
    # kernel and on the host loop (pose_graph.LAST_ZEROED).
    why = {}
    for route, solve in (("grid kernel", pose_graph.optimize),
                         ("host loop", pose_graph.optimize_reference)):
        solve(last[0], device=device, **last[1])
        steps = int(pose_graph.LAST_STEPS)
        why[route] = (steps, pose_graph.LAST_ZEROED[:steps].cpu().tolist())
    print("phase 5g last 256-slot solve, why each LM step came out zero ("
          f"{pose_graph.ZEROED_NONE} used, {pose_graph.ZEROED_PIVOT} a "
          f"failed pivot, {pose_graph.ZEROED_NOT_FINITE} not finite): "
          + "; ".join(f"{r} {n} steps {z}" for r, (n, z) in why.items()))
    return {"launches": launched, "grid": launches["pose_graph_grid"],
            "graph": last, "zeroed": why}


# The scan step's cases (8a; tests/test_torch_kernels_cuda.py takes them
# too): each decision's branches, and random rows.
STEP_CASES = ("accepted", "no_history", "kf_nan", "odo_nan", "both_nan",
              "forced", "low_valid_ratio", "low_entropy_ratio",
              "inf_entropy_with_history", "nan_entropy_without_history",
              "signs_rising", "signs_falling", "singular_information",
              "fuse_off", "pivot_tie")
STEP_RANDOM = 64
# The scan step's f32 operations a frame: the fusion's inverse, two 4x4
# products, SE(3) log, a 6x6 elimination and exp, T_alt, the ratio and
# the selects (about 1 100); and the poses' tolerance against its plain
# version (the decisions and copied fields: bit for bit).
SCAN_STEP_OPS = 1100
STEP_POSE_ATOL = 1e-5


def _pivot_tie(info):
    """Make rows 2 and 4 of column 0 of the fusion's system (the sum of
    the two (6, 6) f32 informations, in place) tie for the largest |a|,
    exactly (x and -x in each), each information still positive
    definite (its other diagonal raised by |v|^2 / a for v the rest of
    column 0: the Schur complement of a stays above the original's): the
    elimination's first pivot is row 2 under the first-maximum rule (a
    strictly larger |a| wins), row 4 under a last-maximum one."""
    for b in range(2):
        x = np.float32(2.0 * np.abs(info[b, :, 0]).max())
        info[b, 2, 0] = info[b, 0, 2] = x
        info[b, 4, 0] = info[b, 0, 4] = -x
        v = info[b, 1:, 0].astype(np.float64)
        info[b, 1:, 1:] += np.float32(v @ v / info[b, 0, 0]) * np.eye(
            5, dtype=np.float32)


def _step_inputs(case, cfg, device, seed):
    """A frame's buffers for the scan step (ops/scan_step.py scan_step) in
    one case: the two level rows of every tracked level (random
    statistics, the finest level's pose, log-likelihood, information,
    entropy and valid ratio set), their iterations, the carry slot and
    pointer table before the frame, force, the frame's slabs (small
    tensors: only their addresses are used), the scan config. "random"
    cases draw every decision's inputs, NaNs included."""
    import dataclasses

    import torch

    from dvo_slam_tpu_torch.models import keyframe_scan
    from dvo_slam_tpu_torch.ops import linearize, scan_step
    from dvo_slam_tpu_torch.utils import se3_np

    rng = np.random.default_rng(seed)
    L, M = len(cfg.tracked_levels), cfg.max_iterations
    S = linearize.level_row_size(M)
    lev = (rng.normal(size=(2, L, S)) * 10).astype(np.float32)
    st = linearize._LEVEL_STATS
    lev[..., st + 3 * M:st + 4 * M] = rng.random((2, L, M)) < 0.7
    lev_i = np.stack([rng.integers(1, M + 1, (2, L)),
                      rng.integers(0, 4, (2, L))], axis=-1).astype(np.int32)
    T = np.stack([se3_np.exp(rng.normal(scale=0.02, size=6))
                  for _ in range(2)]).astype(np.float32)
    A = rng.normal(size=(2, 6, 6))
    info = (np.einsum("bij,bkj->bik", A, A) * 1e3
            + 10 * np.eye(6)).astype(np.float32)
    ll = np.float32([-1e4, -2e4])
    h, vr = np.float32([-20.0, -19.0]), np.float32([0.8, 0.7])
    T_kf_prev, last_odo = (se3_np.exp(rng.normal(scale=0.01, size=6))
                           .astype(np.float32) for _ in range(2))
    H_first, has_first, force, fuse = -20.5, True, False, True
    if case == "random":
        h = rng.normal(scale=20.0, size=2).astype(np.float32)
        H_first = float(h[0] * rng.uniform(0.8, 1.2))
        vr = rng.uniform(0.0, 1.0, 2).astype(np.float32)
        has_first = bool(rng.random() < 0.7)
        force = bool(rng.random() < 0.1)
        for b in range(2):
            if rng.random() < 0.15:
                T[b, rng.integers(3), rng.integers(4)] = np.nan
            if rng.random() < 0.1:
                ll[b] = np.inf
        if rng.random() < 0.1:
            h[0] = np.nan
    elif case == "no_history":
        has_first, H_first = False, 0.0
    elif case in ("kf_nan", "both_nan"):
        T[0, 1, 2] = np.nan
    if case in ("odo_nan", "both_nan"):
        ll[1] = np.inf
    elif case == "forced":
        force = True
    elif case == "low_valid_ratio":
        vr[0] = 0.1
    elif case == "low_entropy_ratio":
        h[0] = -10.0
    elif case == "inf_entropy_with_history":
        h[0] = np.inf
    elif case == "nan_entropy_without_history":
        h[0], has_first, H_first = np.nan, False, 0.0
    elif case == "signs_rising":
        H_first, h[0] = 0.4, -0.3
    elif case == "signs_falling":
        H_first, h[0] = -0.4, 0.3
    elif case == "singular_information":
        info[:, 5, :] = 0.0
        info[:, :, 5] = 0.0
    elif case == "fuse_off":
        fuse = False
    elif case == "pivot_tie":
        _pivot_tie(info)
    fin = lev[:, -1]
    fin[:, linearize._LEVEL_T:linearize._LEVEL_LOGLIK] = T.reshape(2, 16)
    fin[:, linearize._LEVEL_LOGLIK] = ll
    fin[:, linearize._LEVEL_BEST:linearize._LEVEL_BEST + 36] = \
        info.reshape(2, 36)
    extra = st + linearize._STAT_PLANES * M
    fin[:, extra + linearize._EXTRA_ENTROPY] = h
    fin[:, extra + linearize._EXTRA_RATIO] = vr
    dev = torch.device(device)
    carry = {"T_kf_prev": torch.as_tensor(T_kf_prev, device=dev),
             "last_odo": torch.as_tensor(last_odo, device=dev),
             "H_first": torch.tensor(H_first, dtype=torch.float32,
                                     device=dev),
             "has_first": torch.tensor(has_first, device=dev)}
    slabs = [torch.zeros(6, 2, 2, device=dev) for _ in range(2 * L)]
    table = torch.tensor([[slabs[j].data_ptr(), slabs[L + j].data_ptr()]
                          for j in range(L)], dtype=torch.int64, device=dev)
    scan_cfg = keyframe_scan.ScanConfig(
        0.2, 0.9, fuse, bool(cfg.collect_stats))
    return {"lev": torch.as_tensor(lev, device=dev),
            "lev_i": torch.as_tensor(lev_i, device=dev),
            "state_in": scan_step.state_of(carry, cfg.use_initial_estimate),
            "table_in": table,
            "force": torch.tensor(force, device=dev),
            "cur": tuple(torch.zeros(6, 2, 2, device=dev)
                         for _ in range(L)),
            "scan_cfg": scan_cfg}


def _run_step(step, inp, cfg):
    """One scan step (the kernel or its plain version) on a case's inputs
    into new outputs: (packed row, carry slot, table)."""
    import torch

    from dvo_slam_tpu_torch.ops import scan_step

    L = len(cfg.tracked_levels)
    layout = scan_step.output_layout(
        L, cfg.max_iterations,
        bool(cfg.collect_stats and inp["scan_cfg"].with_stats))
    dev = inp["lev"].device
    out = (torch.full((scan_step.row_width(layout),), 7.0, device=dev),
           torch.full((scan_step.STATE_SIZE,), 7.0, device=dev),
           torch.full((L, 2), 7, dtype=torch.int64, device=dev))
    step(inp["lev"], inp["lev_i"], inp["state_in"], inp["table_in"],
         inp["force"], inp["cur"], *out, cfg, inp["scan_cfg"])
    return out, layout


def _step_differences(got, want, layout):
    """Where a scan step's outputs part from its plain version's: (list of
    what differs beyond the rules, the largest pose difference). The
    decisions and every copied field bit for bit; the poses (rel_pose,
    the carry's T_kf_prev, Z_switch where it is the chained odometry)
    within STEP_POSE_ATOL; the table equal."""
    import torch

    from dvo_slam_tpu_torch.ops import scan_step

    (row, state, table), (row_p, state_p, table_p) = got, want
    bad, err = [], 0.0

    def bits_differ(a, b):
        nan = torch.isnan(a) & torch.isnan(b)
        return bool(((a.view(torch.int32) != b.view(torch.int32))
                     & ~nan).any())

    def pose_err(a, b):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        return float((a - b).nan_to_num(0.0).abs().max())

    views = scan_step.field_views(row[None], layout)
    want_views = scan_step.field_views(row_p[None], layout)
    for f in layout:
        a = row[f.offset:f.offset + int(np.prod(f.shape, dtype=np.int64))]
        b = row_p[f.offset:f.offset + a.numel()]
        if f.name == "rel_pose" or (
                f.name == "Z_switch" and not bool(views["accept"][0])
                and not bool(views["is_nan"][0, 1])):
            e = pose_err(a, b)
            err = max(err, e)
            if not e <= STEP_POSE_ATOL:
                bad.append(f"{f.name} {e:.3e}")
        elif bits_differ(a, b):
            bad.append(f.name)
    for name in ("switch", "accept", "is_nan"):
        if not torch.equal(views[name], want_views[name]):
            bad.append(f"decision {name}")
    T, T_p = state[:16], state_p[:16]
    e = pose_err(T, T_p)
    err = max(err, e)
    if not e <= STEP_POSE_ATOL:
        bad.append(f"T_kf_prev {e:.3e}")
    if bits_differ(state[16:], state_p[16:]):
        bad.append("carry slot")
    if not torch.equal(table, table_p):
        bad.append("table")
    return bad, err


def _step_bytes(cfg, layout, stats):
    """Bytes the scan step must move, each input read once and each output
    written once: the two finest rows' heads and extras, lev_i, the carry
    slot, the table and force; with the statistics their planes; the
    packed row, the next carry slot and table."""
    from dvo_slam_tpu_torch.ops import scan_step

    L, M = len(cfg.tracked_levels), cfg.max_iterations
    stats_floats = 8 * L * M + 2 * L if stats else 0
    read = 4 * (2 * (16 + 1 + 36 + 2) + 2 * L + scan_step.STATE_SIZE
                + stats_floats) + 16 * L + 1
    written = 4 * (scan_step.row_width(layout) + scan_step.STATE_SIZE) \
        + 16 * L
    return read + written


def phase_scan_step(device, cfg):
    """8a: the scan step (csrc/keyframe_scan.cu) against its plain version
    (ops/scan_step.py scan_step_plain: scan_step_reference on the same
    buffers) on the card, on STEP_CASES and STEP_RANDOM random frames,
    without the statistics (the main path: no frame logger) and with them:
    the decisions and copied fields bit for bit, the poses within
    STEP_POSE_ATOL. Then, without the statistics first: device us per
    call by CUDA events beside the plain version's, the launch floor (an
    empty kernel) and the bound from its bytes and operations, and the
    kernel's phase split (its timing buffer, the median of 20 launches)."""
    import dataclasses

    import torch

    from dvo_slam_tpu_torch import _build
    from dvo_slam_tpu_torch.ops import scan_step

    cases = [(c, i) for i, c in enumerate(STEP_CASES)] + [
        ("random", 1000 + i) for i in range(STEP_RANDOM)]
    worst, switches = 0.0, 0
    for stats in (False, True):
        c_cfg = dataclasses.replace(cfg, collect_stats=stats)
        for case, seed in cases:
            inp = _step_inputs(case, c_cfg, device, seed)
            before = scan_step.LAUNCHES_SCAN_STEP
            got, layout = _run_step(scan_step.scan_step_kernel, inp, c_cfg)
            want, _ = _run_step(scan_step.scan_step_plain, inp, c_cfg)
            torch.cuda.synchronize()
            if scan_step.LAUNCHES_SCAN_STEP - before != 1:
                raise AssertionError("the scan step did not launch")
            bad, err = _step_differences(got, want, layout)
            worst = max(worst, err)
            switches += int(got[0][scan_step.output_layout(
                1, 1, False)[1].offset].view(torch.int32))
            if bad:
                raise AssertionError(f"scan step, case {case} (seed {seed},"
                                     f" stats {stats}): {bad}")
    floor_us = _events_us(functools.partial(_build.empty_launch, device))
    out = {"err": worst, "floor_us": floor_us}
    for stats in (False, True):
        c_cfg = dataclasses.replace(cfg, collect_stats=stats)
        inp = _step_inputs("accepted", c_cfg, device, 0)
        got, layout = _run_step(scan_step.scan_step_kernel, inp, c_cfg)
        args = (inp["lev"], inp["lev_i"], inp["state_in"], inp["table_in"],
                inp["force"], inp["cur"], *got, c_cfg, inp["scan_cfg"])
        us = _events_us(functools.partial(scan_step.scan_step_kernel, *args))
        plain_us = _events_us(functools.partial(scan_step.scan_step_plain,
                                                *args))
        splits = []
        for _ in range(20):
            buf = scan_step.timing_buffer(device)
            scan_step.scan_step_kernel(*args, timing=buf)
            torch.cuda.synchronize()
            splits.append(scan_step.phase_times(buf.cpu().numpy()))
        split = {k: float(np.median([x[0][k] for x in splits]))
                 for k in splits[0][0]}
        span = float(np.median([x[1] for x in splits]))
        moved = _step_bytes(c_cfg, layout, stats)
        bound = _bound_ms(moved, SCAN_STEP_OPS, 0)
        tag = "with" if stats else "without"
        print(f"phase 8a scan step {tag} statistics"
              f"{'' if stats else ' (the main path)'}: {us:.2f} us a call "
              f"(events), plain {plain_us:.2f} us, launch floor "
              f"{floor_us:.2f} us; bound {1e3 * bound[0]:.6f} us by "
              f"{bound[1]} ({moved} B, {SCAN_STEP_OPS} f32 operations); "
              f"phase split (us, median of 20 stamped launches, span "
              f"{span:.3f}): "
              f"{', '.join(f'{k} {v:.3f}' for k, v in split.items())}")
        key = "stats_" if stats else ""
        out.update({f"{key}us": us, f"{key}plain_ms": plain_us / 1e3,
                    f"{key}bound": bound, f"{key}split": split,
                    f"{key}span_us": span})
    print(f"phase 8a scan step (csrc/keyframe_scan.cu) against its plain "
          f"version: {2 * len(cases)} frames ({len(STEP_CASES)} cases and "
          f"{STEP_RANDOM} random, without and with statistics; "
          f"{switches} switch): decisions and copied fields bit for bit, "
          f"max pose difference {worst:.3e} (tol {STEP_POSE_ATOL:g})")
    return out


def _chunks(frames, n, t_base):
    """bench.py's slam-lc loop in chunks of CHUNK frames: the ring over and
    over, timestamps t_base + k / 30."""
    for c in range(n // CHUNK):
        sel = [frames[(c * CHUNK + j) % len(frames)] for j in range(CHUNK)]
        yield (c, np.stack([s[0] for s in sel]), np.stack([s[1] for s in sel]),
               [t_base + (c * CHUNK + j) / 30.0 for j in range(CHUNK)])


def _chunk_device_us(device, frames, reps=5, cfg=None):
    """A CHUNK-frame chunk of the ring (frames 1..CHUNK after an init
    frame, no forced switch) on the kernel route
    (keyframe_scan.track_keyframe_chunk: five launches a frame; the
    default config, or cfg) by
    _events_us, one chunk a run, behind a spin that outlasts the host's
    issue time for the chunk (cap 1 s): the device time of the chunk's
    launches, not the host's issue rate. Returns (device us a chunk, the
    host's issue us of one chunk)."""
    import torch

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import keyframe_scan
    from dvo_slam_tpu_torch.ops import camera, scan_step

    seq = [frames[k % len(frames)] for k in range(CHUNK + 1)]
    ii = torch.as_tensor(np.stack([f[0] for f in seq]), device=device)
    zz = torch.as_tensor(np.stack([f[1] for f in seq]), device=device)
    cfg = cfg or TrackerConfig()
    K = camera.intrinsics(*K_TUPLE, device=device)
    carry = keyframe_scan.init_carry(keyframe_scan.pyramid_from_stack(
        ii, zz, 0, cfg.num_levels))
    fn = functools.partial(keyframe_scan.track_keyframe_chunk, carry,
                           ii[1:], zz[1:], K, cfg, SlamConfig())
    before = scan_step.LAUNCHES_SCAN_STEP
    fn()
    torch.cuda.synchronize()
    if scan_step.LAUNCHES_SCAN_STEP - before != CHUNK:
        raise AssertionError("the timed chunk did not run on the kernel "
                             "route")
    t0 = time.perf_counter()
    fn()
    host_us = 1e6 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return _events_us(fn, n=1, reps=reps, cap_s=1.0), host_us


def phase_chunked(device, slam_out, cfg=None, tag="8", per_frame="5b"):
    """8 (and 10d at a point budget, tag "10d"): ChunkedKeyframeSlam over
    5b's loop (640x480, default configs or cfg, loop closure on) in chunks
    of CHUNK frames, force_keyframe() before
    every chunk but the first (5b's every FORCE_EVERY frames), with a
    depth-2 submit/collect pipeline: SLAM_FRAMES warm-up frames on one
    instance, then SLAM_FRAMES timed on a fresh one (the launch counts
    reset just before and read just after). The submit of chunk SYNC_CHUNK
    runs under torch.cuda.set_sync_debug_mode("error"). Against the
    per-frame KeyframeSlam over the same frames (slam_out["slam"], 5b's or
    10d's, with its ms/frame): the same keyframe timestamps and graph
    edges, trajectories within 1e-4. No prepare_reference call."""
    import torch

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.utils import evaluate

    frames = slam_out["frames"]
    _, poses = _ring()
    cfg = cfg or TrackerConfig()

    scan = dict.fromkeys(SCAN_LAUNCHES, 0)

    def run(t_base, timed):
        slam = ChunkedKeyframeSlam(K_TUPLE, cfg, SlamConfig(),
                                   enable_loop_closure=True, device=device)
        slam.init()
        in_flight, submit_ms = 0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, ii, zz, ts in _chunks(frames, SLAM_FRAMES, t_base):
            if c > 0:
                slam.force_keyframe()
            before = _launches()
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
            after = _launches()
            if timed:
                for k in scan:
                    scan[k] += after[k] - before[k]
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
    print(f"phase {tag} chunked engine: {SLAM_FRAMES} frames {W}x{H} in "
          f"chunks of {CHUNK} (depth-2 pipeline) after {SLAM_FRAMES} warm-up "
          f"frames on another instance: {ms:.3f} ms/frame "
          f"({1e3 / ms:.2f} fps; {per_frame} per-frame "
          f"{slam_out['ms_frame']:.3f}); "
          f"submit_chunk host ms median {np.median(submit_ms):.3f}, max "
          f"{max(submit_ms):.3f}; keyframes {len(slam.keyframes)}, loop "
          f"edges {slam.num_loop_edges}; ATE of finish() {1e3 * ate:.4f} mm")
    # The scan's frames: every frame but the engine's first (its init
    # pyramid is one more pyramid launch in the first submit_chunk).
    scanned = SLAM_FRAMES - 1
    by_kernel = {k: (n - (k == "pyramid")) / scanned for k, n in scan.items()}
    print(f"phase {tag} launches: track_level {launches['track_level']} "
          f"({launches['track_level'] / SLAM_FRAMES:.2f} per frame), per "
          f"frame by batch size {by_b}, linearize {launches['linearize']}, "
          f"standalone sampler {launches['sample_slab']}, prepare_reference "
          f"calls {launches['prepare_reference']}; in submit_chunk "
          f"(the scan, {scanned} frames) per frame by kernel: "
          f"{', '.join(f'{k} {v:.2f}' for k, v in by_kernel.items())} "
          f"(want pyramid 1, track_level 3, scan_step 1, the rest 0); chunk "
          f"{SYNC_CHUNK}'s submit_chunk under set_sync_debug_mode(\"error\"):"
          f" no synchronizing call")
    # Outlier pruning judges the loop edges when a graph solve is applied:
    # the per-frame engine applies it at the next frame, the chunked one at
    # the next chunk's collect (as in the JAX package), so an edge's mask
    # may differ; its endpoints may not.
    ends = [e[:2] for e in edges] == [e[:2] for e in ref_edges]
    masks = [e for e, r in zip(edges, ref_edges) if e[2] != r[2]]
    print(f"phase {tag} against {per_frame}'s per-frame KeyframeSlam on the "
          f"same frames: "
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
            or launches["sample_slab"] != 0
            or launches["prepare_reference"] != 0):
        raise AssertionError(f"chunked path launches {launches}")
    if by_kernel != SCAN_LAUNCHES:
        raise AssertionError(f"the scan's launches per frame {by_kernel}, "
                             f"want {SCAN_LAUNCHES}")
    chunk_us, issue_us = _chunk_device_us(device, frames, cfg=cfg)
    print(f"phase {tag} a {CHUNK}-frame chunk of the ring on the kernel route "
          f"behind a spin: {chunk_us:.2f} us of device time "
          f"({chunk_us / CHUNK:.2f} a frame; the host issues it in "
          f"{issue_us:.2f} us)")
    return {"launches": launches, "ms_frame": ms,
            "submit_ms": float(np.median(submit_ms)),
            "chunk_device_us": chunk_us}


def phase_chunk_profile(device, slam_out, chunks=2):
    """8p (last of the profiles): the chunked scan under torch.profiler: a
    fresh ChunkedKeyframeSlam (default configs) takes one chunk of the
    ring, then `chunks` more are submitted inside labelled host ranges
    (the frame loop, keyframe_scan._track_chunk_kernels, in one of its
    own) and collected. Of the device records launched inside
    submit_chunk: those of the frame loop per frame by kind, which must be
    the scan's five kernels a frame and nothing else; the rest (the
    chunk's uploads, its host copy, any set-up op) per chunk."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import keyframe_scan
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam

    slam = ChunkedKeyframeSlam(K_TUPLE, TrackerConfig(), SlamConfig(),
                               enable_loop_closure=True, device=device)
    slam.init()
    todo = list(_chunks(slam_out["frames"], CHUNK * (chunks + 1), 500.0))
    slam.submit_chunk(*todo[0][1:])
    slam.collect_chunk()
    loop = keyframe_scan._track_chunk_kernels

    def ranged(*args, **kwargs):
        with record_function("smoke frame loop"):
            return loop(*args, **kwargs)

    def body():
        for c, ii, zz, ts in todo[1:]:
            with record_function(f"smoke submit_chunk {c}"):
                slam.submit_chunk(ii, zz, ts)
        for _ in todo[1:]:
            slam.collect_chunk()

    keyframe_scan._track_chunk_kernels = ranged
    try:
        _, prof = _traced(body, "the chunked scan")
    finally:
        keyframe_scan._track_chunk_kernels = loop
    events = prof.events()

    def spans(prefix):
        return [e.time_range for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith(prefix)]

    submits, loops = spans("smoke submit_chunk"), spans("smoke frame loop")
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cu") and e.id}
    in_loop, setup = {}, {}
    for e in events:
        if (e.device_type != DeviceType.CUDA
                or e.name.startswith(_RANGE_PREFIXES)):
            continue
        t = launched.get(e.id)
        if t is None or not any(r.start <= t <= r.end for r in submits):
            continue
        kind = _kernel_of(e.name) or (
            "copies" if "memcpy" in e.name.lower() else e.name[:40])
        held = in_loop if any(r.start <= t <= r.end for r in loops) \
            else setup
        held[kind] = held.get(kind, 0) + 1
    n = CHUNK * chunks
    per_frame = {k: in_loop.get(k, 0) / n for k in SCAN_LAUNCHES}
    print(f"phase 8p chunked scan profile: {chunks} chunks of {CHUNK}, "
          f"device records launched inside submit_chunk: in the frame loop "
          f"{sum(in_loop.values()) / n:.2f} a frame, by kind "
          f"{ {k: round(v / n, 3) for k, v in sorted(in_loop.items())} }; "
          f"outside it {sum(setup.values()) / chunks:.1f} a chunk "
          f"{ {k: v / chunks for k, v in sorted(setup.items())} }")
    if per_frame != SCAN_LAUNCHES or set(in_loop) - set(SCAN_LAUNCHES):
        raise AssertionError(f"the chunked scan's frame loop issued "
                             f"{in_loop} in {chunks} chunks")
    return {"in_loop": in_loop, "setup": setup}


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


def phase_compaction(device, frames, slam_out, chunked):
    """10: point compaction on the card (TrackerConfig.point_budget_fraction;
    ops/linearize.compact_reference's slots, picked by each level launch
    on the slab route: csrc/linearize.cu select_slots), at
    intensity_grad_threshold COMPACT_THRESHOLD:
    a. odometry over phase 3's 24-frame orbit on the full grid and at
       budget COMPACT_BUDGET, in turns (full, budget, budget, full), each
       run on a fresh tracker: ms/frame, ATE (< 5 mm), launches per frame
       (counts reset just before and read just after each run: a pyramid
       a frame, track_level one per tracked level, linearize, sampler and
       prepare_reference 0); its records by layer come last, in the
       profiles (phase_profile's "10a");
    b. per tracked level, the noise-free orbit pair at N = budget: the
       slab route (the launch compacts the slab's pixels) against the
       RefData route over prepare_reference's compacted points, both
       modes, bit for bit, at B = 1, 2 and 8; mode (b) against the host
       loop over the plain linearization at B = 1 and 2 (2d's
       _compare_level gates), mode (a) against the plain version row by
       row (5a's _check_batched); at B = 1 the level kernel's us per
       launch by CUDA events on the slab route at the budget, on the
       RefData route at the budget and on the full grid (slab route), mode
       (a)'s on both routes at the budget (their difference: the
       prologue and the slab route's per-point reads), whether the points
       and the slot tables are kept in shared memory (level_plan), the
       host loop's ms and the bound (the prologue's bytes included);
    c. compaction itself (the plain version, the pixel route's): each
       level's compacted points on the card equal, bit for bit, the CPU's
       from the same slab, and five card runs equal;
    d. a budget chunk: phase 8's chunked engine at the budget against a
       per-frame KeyframeSlam at the budget on the same frames (5b's
       loop): five launches a scanned frame, no host sync in
       submit_chunk, no prepare_reference or scan_step_reference call,
       the same keyframes and edges, ms/frame beside phase 8's.
    Returns what the kernels line needs (its error: the largest of mode
    (b)'s |T - T_host| and the slab route's bit differences from the
    RefData route)."""
    import dataclasses
    from functools import partial

    import torch

    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import linearize, scan_step
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
        runs.setdefault(name, {"ms": []})["launches"] = launches
        runs[name]["ms"].append(float(np.mean(frame_ms)))
        print(f"phase 10a odometry, {name} (intensity_grad_threshold "
              f"{COMPACT_THRESHOLD:g}, point_budget_fraction "
              f"{c.point_budget_fraction:g}): {N_FRAMES} frames "
              f"{W}x{H}, {np.mean(frame_ms):.3f} ms/frame after {N_WARMUP} "
              f"warm-up frames; ATE {1e3 * ate:.4f} mm; last frame valid "
              f"{float(res.valid_pixels):.0f}, valid ratio "
              f"{float(res.valid_ratio):.4f}; launches per frame pyramid "
              f"{launches['pyramid'] / N_FRAMES:.3f}, track_level "
              f"{launches['track_level'] / (N_FRAMES - 1):.3f} "
              f"({launches['track_level']} for {levels} tracked levels), "
              f"linearize {launches['linearize']}, standalone sampler "
              f"{launches['sample_slab']}; prepare_reference calls "
              f"{launches['prepare_reference']}")
        if not ate < ATE_LIMIT_M:
            raise AssertionError(f"{name}: ATE {ate} m >= {ATE_LIMIT_M} m")
        if (launches["track_level"] != levels or launches["linearize"] != 0
                or launches["sample_slab"] != 0
                or launches["pyramid"] != N_FRAMES
                or launches["prepare_reference"] != 0):
            raise AssertionError(f"{name}: launches {launches}")

    ref_pyr, cur_pyr, Ks, T = _noisy_pair(device, cfg, noisy=False)
    T8 = torch.stack([T @ torch.as_tensor(se3_np.exp(
        1e-3 * np.array([-1.0, 2.0, -1.0, 2.0, -1.0, 1.0]) * (b % 3 - 1)
        + 5e-4 * b), dtype=torch.float32, device=device) for b in range(8)])
    T8[0] = T
    out = {"launches": runs["budget"]["launches"], "err": 0.0,
           "odometry_ms": {k: v["ms"] for k, v in runs.items()}}
    for lvl in cfg.tracked_levels:
        h, w = ref_pyr[lvl].shape[-2:]
        N = linearize.ref_budget(cfg, h, w)
        for B in (1, 2, 8):
            stacked = torch.stack([ref_pyr[lvl]] * B)
            ref = linearize.prepare_reference(stacked, Ks[lvl], cfg)
            if (ref.px.shape[1] != N
                    or N != linearize.compact_budget(h * w, COMPACT_BUDGET,
                                                     128)):
                raise AssertionError(f"level {lvl}: {N} compacted slots")
            slabs = linearize.RefSlabs(stacked)
            T_B = T8[:B].contiguous()
            sigma = torch.tensor([[40.0, 0.01], [0.01, 1e-3]],
                                 device=device).expand(B, 2, 2).contiguous()
            # The slab route against the RefData route, both modes.
            routes = []
            for r in (slabs, ref):
                calls = linearize.PREPARE_REFERENCE_CALLS
                lin = linearize.linearize_kernels_batched(
                    r, cur_pyr[lvl], Ks[lvl], T_B, cfg, sigma, True)
                res = [t.clone() for t in
                       linearize.kernel_residuals(device, N, B)]
                o, o_i = linearize.track_level_kernels(r, cur_pyr[lvl],
                                                       Ks[lvl], T_B, cfg)
                if (r is slabs
                        and linearize.PREPARE_REFERENCE_CALLS != calls):
                    raise AssertionError("the slab route called "
                                         "prepare_reference")
                routes.append((lin, res, o, o_i))
            (lin_s, res_s, o_s, oi_s), (lin_r, res_r, o_r, oi_r) = routes
            diff = (sum(_same_bits(a, b) for a, b in
                        zip(lin_s[:-1], lin_r[:-1]))
                    + sum(int((a != b).sum()) for a, b in
                          zip(res_s, res_r))
                    + _same_bits(o_s, o_r) + int((oi_s != oi_r).sum()))
            worst = float((o_s - o_r).abs().nan_to_num(0.0).max())
            out["err"] = max(out["err"], worst)
            line = (f"phase 10b level {lvl} B={B} at N = budget {N} of "
                    f"{h * w} (selected {int(ref.selected.sum())}): slab "
                    f"route against the RefData route over prepare_reference"
                    f"'s compacted points, modes (a) and (b): {diff} entries "
                    f"differ (largest |difference| {worst:.1e})")
            if diff:
                raise AssertionError(line)
            if B <= 2:
                args = (ref, cur_pyr[lvl], Ks[lvl], T_B, cfg)
                before = linearize.LAUNCHES_TRACK_LEVEL
                got = dense_tracker.track_level(linearize.RefSlabs(stacked),
                                                *args[1:])
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
                r_err, abs_err, rel = _check_batched(
                    ref, cur_pyr[lvl], Ks[lvl], T_B, sigma, cfg)
                out["err"] = max(out["err"], d_T)
                its = got[2]["iterations"].tolist()
                line += (f"; track_level (mode b) vs host loop |dT| "
                         f"{d_T:.2e}, A error / max|A| {a_rel:.2e}, parted "
                         f"at a tie: {parted or 'none'}; linearize (mode a) "
                         f"vs plain: rI, rZ error {r_err:.1e}, A/b error / "
                         f"max|.| {rel:.2e}; iterations {its}")
            if B == 1:
                cur_args = (cur_pyr[lvl], Ks[lvl], T[None], cfg)
                us = _events_us(partial(linearize.track_level_kernels,
                                        slabs, *cur_args))
                us_r = _events_us(partial(linearize.track_level_kernels,
                                          ref, *cur_args))
                a_us = _events_us(partial(
                    linearize.linearize_kernels_batched, slabs, *cur_args))
                a_us_r = _events_us(partial(
                    linearize.linearize_kernels_batched, ref, *cur_args))
                full_args = (linearize.RefSlabs(ref_pyr[lvl][None]),
                             cur_pyr[lvl], Ks[lvl], T[None], full_cfg)
                its_f = int(dense_tracker.track_level(*full_args)[2][
                    "iterations"][0])
                us_f = _events_us(partial(linearize.track_level_kernels,
                                          *full_args))
                C, P, kept, smem, slots_kept = linearize.level_plan(
                    device, N, True)
                C_f, P_f, kept_f, _, _ = linearize.level_plan(device, h * w)
                bound = _bounds(cfg, {"N": N, "H": h, "W": w}, 1, {
                    "its": its, "n_valid": float(got[1].n_raw.sum()),
                    "paired": False}, ref_bytes=_slab_ref_bytes(cfg),
                    extra_bytes=_prologue_bytes(cfg, h * w))["track_level"]
                pro = _prologue_bytes(cfg, h * w)
                line += (f"; device {us:.2f} us per launch on the slab route "
                         f"({us / its[0]:.2f} per iteration; cluster of {C} "
                         f"CTAs, {P} slots each, points "
                         f"{'kept in' if kept else 'not in'} shared memory, "
                         f"slot table {'in shared' if slots_kept else 'in global'}"
                         f" memory), {us_r:.2f} on the RefData route over "
                         f"prepared points, against the full grid's "
                         f"{us_f:.2f} us on the slab route ({its_f} "
                         f"iterations; {C_f} CTAs of {P_f} points, "
                         f"{'kept' if kept_f else 'not kept'}); mode (a) "
                         f"{a_us:.2f} us on the slab route, {a_us_r:.2f} on "
                         f"the RefData route (the prologue and the slab "
                         f"route's reads: {a_us - a_us_r:+.2f} us; the "
                         f"prologue's bytes {pro} B, "
                         f"{1e6 * pro / PEAK_BYTES_S:.4f} us at "
                         f"{PEAK_BYTES_S / 1e12:g} TB/s); host loop over plain "
                         f"{plain_ms:.3f} ms (events, one call); bound "
                         f"{1e3 * bound[0]:.4f} us ({bound[1]})")
                out[lvl] = {"us": us, "us_refdata": us_r, "us_full": us_f,
                            "a_us": a_us, "a_us_refdata": a_us_r,
                            "plain_ms": plain_ms, "bound": bound,
                            "kept": kept, "slots_kept": slots_kept}
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

    # d: a budget chunk against the per-frame engine at the budget.
    ring = slam_out["frames"]
    slam = KeyframeSlam(K_TUPLE, cfg, SlamConfig(), enable_loop_closure=True,
                        device=device)
    slam.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _slam_frames(slam, ring, SLAM_FRAMES, 100.0)
    torch.cuda.synchronize()
    per_frame_ms = 1e3 * (time.perf_counter() - t0) / SLAM_FRAMES
    plain = {"scan_step_reference": 0}
    step_reference = scan_step.scan_step_reference

    def counted(*args, **kwargs):
        plain["scan_step_reference"] += 1
        return step_reference(*args, **kwargs)

    scan_step.scan_step_reference = counted
    try:
        got = phase_chunked(device, {"frames": ring, "slam": slam,
                                     "ms_frame": per_frame_ms}, cfg,
                            tag="10d", per_frame="10d")
    finally:
        scan_step.scan_step_reference = step_reference
    print(f"phase 10d the budget chunk beside phase 8's full grid: "
          f"{got['ms_frame']:.3f} against {chunked['ms_frame']:.3f} ms/frame;"
          f" submit_chunk host ms median {got['submit_ms']:.3f} against "
          f"{chunked['submit_ms']:.3f}; a {CHUNK}-frame chunk's device time "
          f"{got['chunk_device_us']:.2f} against "
          f"{chunked['chunk_device_us']:.2f} us; scan_step_reference calls "
          f"{plain['scan_step_reference']}; the per-frame engine at the "
          f"budget {per_frame_ms:.3f} ms/frame (5b's full grid "
          f"{slam_out['ms_frame']:.3f})")
    if plain["scan_step_reference"] != 0:
        raise AssertionError("the budget chunk ran scan_step_reference")
    out["chunked"] = got
    return out


@contextlib.contextmanager
def _plain_pixel_route(on=True):
    """With on: track_batched's pixel route runs its plain version on the
    card (the eager front: prepare_reference of the band and the host loop
    over the plain linearization, every sum all-reduced over the pixel
    group, gathering with the standalone sampler), the kernel front's
    lookup swapped out as phase 7 swaps routes; otherwise as shipped."""
    from dvo_slam_tpu_torch.models import dense_tracker

    saved = dense_tracker.front_route
    if on:
        dense_tracker.front_route = lambda *args, **kwargs: False
    try:
        yield
    finally:
        dense_tracker.front_route = saved


def _split_kind(code, steps):
    from dvo_slam_tpu_torch.ops import linearize

    if code == linearize._STAGE_FINISH:
        return "finish"
    return "first" if code == 0 else "normal" if code == steps + 1 else "sigma"


def _split_stage_times(fn):
    """fn run once with every split-route stage launch issued eagerly, and
    every replay of a captured unit (nccl: kind "unit", an iteration's
    stages and all-reduces), between two CUDA events (behind a spin of
    SPLIT_SPIN_S, as _events_us queues one) and every eager all-reduce of
    the stage buffer timed on the host clock between two device syncs (so
    that neither includes the other); nothing is timed while a unit is
    captured: ({(level height, stage kind): [device us]}, [all-reduce
    s], fn's wall s, this instrumented run's)."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import _build
    from dvo_slam_tpu_torch.ops import linearize

    recs, coll, level = [], [], [0]
    saved = (_build.launch, dist.all_reduce, linearize.track_level_split,
             linearize._replay)

    def tls(ref, cur, *args, **kwargs):
        level[0] = int(cur.shape[-2])
        return saved[2](ref, cur, *args, **kwargs)

    def timed(kind, issue):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        # A spin ahead of the first event holds the card while the host
        # queues the launch, so the events time the card, not the host.
        torch.cuda._sleep(int(SPIN_HZ * SPLIT_SPIN_S))
        ev[0].record()
        issue()
        ev[1].record()
        recs.append((level[0], kind, ev))

    def launch(name, dev, args):
        if (name != "dvo_track_level_split"
                or torch.cuda.is_current_stream_capturing()):
            return saved[0](name, dev, args)
        timed(_split_kind(args[-3], args[-2]),
              lambda: saved[0](name, dev, args))

    def all_reduce(t, *args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            return saved[1](t, *args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = saved[1](t, *args, **kwargs)
        torch.cuda.synchronize()
        coll.append(time.perf_counter() - t0)
        return r

    def replay(graph):
        timed("unit", lambda: saved[3](graph))

    (_build.launch, dist.all_reduce, linearize.track_level_split,
     linearize._replay) = (launch, all_reduce, tls, replay)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (_build.launch, dist.all_reduce, linearize.track_level_split,
         linearize._replay) = saved
    times = {}
    for h, kind, ev in recs:
        times.setdefault((h, kind), []).append(
            1e3 * ev[0].elapsed_time(ev[1]))
    return times, coll, wall


def _split_phases(fn):
    """fn run once with a zeroed phase-timing buffer in every split-route
    stage launch (csrc/linearize.cu's stamps of row 0's rank-0 CTA):
    {(level height, stage kind): [({phase: device us}, the CTA's span
    us)]} (linearize.split_phase_times)."""
    import torch

    from dvo_slam_tpu_torch import _build
    from dvo_slam_tpu_torch.ops import linearize

    recs, level = [], [0]
    saved = (_build.launch, linearize.track_level_split)

    def tls(ref, cur, *args, **kwargs):
        level[0] = int(cur.shape[-2])
        return saved[1](ref, cur, *args, **kwargs)

    def launch(name, dev, args):
        if (name != "dvo_track_level_split"
                or torch.cuda.is_current_stream_capturing()):
            return saved[0](name, dev, args)
        buf = linearize.split_timing_buffer(dev)
        saved[0](name, dev, (*args[:-4], buf.data_ptr(), *args[-3:]))
        recs.append((level[0], _split_kind(args[-3], args[-2]), buf))

    _build.launch, linearize.track_level_split = launch, tls
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _build.launch, linearize.track_level_split = saved
    out = {}
    for h, kind, buf in recs:
        out.setdefault((h, kind), []).append(
            linearize.split_phase_times(buf.cpu().numpy()))
    return out


def _phase_medians(phases):
    """{key: [(phases, span)]} -> {key: ({phase: median us}, median span
    us)}."""
    return {key: ({k: float(np.median([p[0][k] for p in v]))
                   for k in v[0][0]},
                  float(np.median([p[1] for p in v])))
            for key, v in phases.items()}


def _split_issue_parts(fn):
    """fn run once with the host's time in each part of the split route's
    issue on the host clock, nothing synced between them: each eager
    stage's ctypes launch call, each eager all-reduce's dist.all_reduce
    call and its entry time (time.monotonic_ns, one clock for every
    process of the host: the ranks' skew), each graph replay of an
    iteration's unit (nccl), each iteration's read of the done flags (it
    waits for the card), and fn's wall time (to a device sync). Returns
    {"launch": [s], "all_reduce": [s], "entered": [ns], "replay": [s],
    "read": [s], "wall": s}."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import _build
    from dvo_slam_tpu_torch.ops import linearize

    got = {"launch": [], "all_reduce": [], "entered": [], "replay": [],
           "read": []}
    saved = (_build.launch, dist.all_reduce, linearize._split_flags,
             linearize._replay)

    def launch(name, dev, args):
        t0 = time.perf_counter()
        r = saved[0](name, dev, args)
        if name == "dvo_track_level_split":
            got["launch"].append(time.perf_counter() - t0)
        return r

    def all_reduce(t, *args, **kwargs):
        got["entered"].append(time.monotonic_ns())
        t0 = time.perf_counter()
        r = saved[1](t, *args, **kwargs)
        got["all_reduce"].append(time.perf_counter() - t0)
        return r

    def flags(sums):
        t0 = time.perf_counter()
        r = saved[2](sums)
        got["read"].append(time.perf_counter() - t0)
        return r

    def replay(graph):
        t0 = time.perf_counter()
        saved[3](graph)
        got["replay"].append(time.perf_counter() - t0)

    (_build.launch, dist.all_reduce, linearize._split_flags,
     linearize._replay) = (launch, all_reduce, flags, replay)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        got["wall"] = time.perf_counter() - t0
    finally:
        (_build.launch, dist.all_reduce, linearize._split_flags,
         linearize._replay) = saved
    return got


def _stage_reduce_us(B, group, device, n=50):
    """Device us of one all-reduce of a (B, 33) f64 stage buffer over
    ``group``, n back to back between two CUDA events behind a spin that
    outlasts the host's issue of the n (twice its time in a first round),
    so that the events time the card's collectives, nothing between
    them."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch.ops import linearize

    sums = torch.zeros((B, linearize._SPLIT_SUMS), dtype=torch.float64,
                       device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        dist.all_reduce(sums, group=group)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(int(SPIN_HZ * (2.0 * host_s + 1e-3)))
    ev[0].record()
    for _ in range(n):
        dist.all_reduce(sums, group=group)
    ev[1].record()
    torch.cuda.synchronize()
    return 1e3 * ev[0].elapsed_time(ev[1]) / n


def _issue_summary(parts, reduce_us, skew_us=None):
    """One line of a pairs run's issue split (_split_issue_parts) per
    stage pair (a launch and its all-reduce)."""
    def us(x):
        return (f"{1e6 * np.mean(x):.1f} us (median {1e6 * np.median(x):.1f})"
                if len(x) else "none")

    n = max(len(parts["launch"]), 1)
    pair = 1e6 * parts["wall"] / n
    line = (f"{len(parts['launch'])} eager stage launches, "
            f"{len(parts['all_reduce'])} eager all-reduces, "
            f"{len(parts['replay'])} graph replays, {len(parts['read'])} reads"
            f" in {1e3 * parts['wall']:.2f} ms ({pair:.1f} us an eager "
            f"stage pair): host ctypes launch {us(parts['launch'])}, host "
            f"dist.all_reduce call {us(parts['all_reduce'])}, host graph "
            f"replay {us(parts['replay'])}, NCCL's device time "
            f"for the stage buffer {reduce_us:.2f} us (back to back, events), "
            f"the read of the done flags {1e6 * np.mean(parts['read']):.1f} "
            f"us an iteration ({1e3 * np.sum(parts['read']):.2f} ms in all)")
    if skew_us is not None:
        line += (f", the ranks' skew at an all-reduce {np.mean(skew_us):.1f}"
                 f" us (median {np.median(skew_us):.1f}, max "
                 f"{np.max(skew_us):.1f})")
    return line


def _split_bands(refs, curs, Ks, T0, cfg, group, log=None):
    """Rank 0's bands (the top half of every tracked level's rows) of the
    pairs through track_level_split in ``group``, coarse to fine, each
    level from the one before's poses: [(out, out_i)] copies a level; with
    ``log`` a list, (level, band, the level's initial poses) appended to
    it a level."""
    from dvo_slam_tpu_torch.ops import linearize

    T, outs = T0, []
    for lvl in cfg.tracked_levels:
        h = refs[lvl].shape[-2] // 2
        band = refs[lvl][:, :, :h].contiguous()
        if log is not None:
            log.append((lvl, band, T.clone()))
        out, out_i = linearize.track_level_split(
            linearize.RefSlabs(band), curs[lvl], Ks[lvl], T, cfg, group)
        outs.append((out.clone(), out_i.clone()))
        T = out[:, linearize._LEVEL_T:linearize._LEVEL_LOGLIK].unflatten(
            -1, (4, 4))
    return outs


def _split_alone(refs, curs, Ks, T0, cfg):
    """The split route's stage launches with the card to themselves (in
    phase 11's world two ranks share it, and each launch's events also
    span the other rank's work): rank 0's bands of the pairs (the top
    half of every level's rows), every tracked level through
    track_level_split in a 1-rank gloo group, as _split_stage_times
    times them. Returns its (times, all-reduces, wall) and the launches
    it made."""
    import torch.distributed as dist

    from dvo_slam_tpu_torch import parallel
    from dvo_slam_tpu_torch.ops import linearize

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
        rank=0, world_size=1)
    try:
        def run():
            _split_bands(refs, curs, Ks, T0, cfg, dist.group.WORLD)

        run()
        before = linearize.LAUNCHES_TRACK_LEVEL_SPLIT
        timed = _split_stage_times(run)
        return timed, linearize.LAUNCHES_TRACK_LEVEL_SPLIT - before
    finally:
        parallel.destroy()


@contextlib.contextmanager
def _eager_issue():
    """The split route's issue eager under any backend (its nccl graph
    issue swapped out, as phase 7 swaps routes): the yardstick of the
    graph issue's parts."""
    from dvo_slam_tpu_torch.ops import linearize

    saved = linearize.graph_issue
    linearize.graph_issue = lambda group: False
    try:
        yield
    finally:
        linearize.graph_issue = saved


def _split_nccl_alone(refs, curs, Ks, T0, cfg, device):
    """The split route's graph issue in a 1-rank nccl group in this
    process (rank 0's bands of phase 11's pairs, every tracked level at
    B = PARALLEL_B): three runs held bit for bit to the eager issue (a
    1-rank gloo group beside it: the same sums), each level to the level
    kernel over the same band's points from the same pose (poses 1e-4,
    valid counts 1e-3 relative); the captures of the first run, the
    launches, all-reduces and replays of a later one; a pairs run's issue
    split (_split_issue_parts) with the graph and with the eager issue;
    and the stage launches by phase (_split_phases, eager in the gloo
    group). Returns the figures."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import parallel
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
        rank=0, world_size=1)
    try:
        gloo = dist.new_group([0], backend="gloo")

        def run(group, log=None):
            return _split_bands(refs, curs, Ks, T0, cfg, group, log)

        def counts():
            return {k: v for k, v in _launches().items()
                    if k.endswith("_split")}

        levels = []
        eager = run(gloo, levels)
        runs, issued = [], []
        for _ in range(3):
            before = counts()
            runs.append(run(dist.group.WORLD))
            after = counts()
            issued.append({k: after[k] - before[k] for k in after})
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for r in runs
                   for x, y in zip(r, eager) for a, b in zip(x, y))
        d_T = d_n = 0.0
        M = cfg.max_iterations
        for (lvl, band, T), (out, out_i) in zip(levels, runs[0]):
            got = linearize.unpack_level(out, out_i, M)
            o2, i2 = linearize.track_level_kernels(
                linearize.prepare_reference(band, Ks[lvl], cfg), curs[lvl],
                Ks[lvl], T, cfg)
            want = linearize.unpack_level(o2, i2, M)
            d_T = max(d_T, float((got.T - want.T).abs().max()))
            n_g = got.best[:, dense_tracker._N_RAW]
            n_w = want.best[:, dense_tracker._N_RAW]
            d_n = max(d_n, float(((n_g - n_w).abs()
                                  / n_w.clamp(min=1.0)).max()))
        parts = {"graph": _split_issue_parts(lambda: run(dist.group.WORLD))}
        with _eager_issue():
            run(dist.group.WORLD)
            parts["eager"] = _split_issue_parts(
                lambda: run(dist.group.WORLD))
        reduce_us = _stage_reduce_us(T0.shape[0], dist.group.WORLD, device)
        phases = _phase_medians(_split_phases(lambda: run(gloo)))
    finally:
        parallel.destroy()
    return {"same": same, "d_T": d_T, "d_n": d_n, "issued": issued,
            "parts": parts, "reduce_us": reduce_us, "phases": phases}


def _split_launch_bounds(cfg, B):
    """The least time of each stage launch of a pairs run's bands (rank
    0's: half of every tracked level's rows) at B rows, from the bytes it
    must move at PEAK_BYTES_S ({(level, stage kind): us}): stage 0 reads
    the band's reference planes (_slab_ref_bytes a pixel) and the current
    slab's pixels that the band's near-identity warps gather from (about
    the band's own rows: 24 B a point) and writes the kept points (37 B a
    point); a Sigma
    step reads rI, rZ and valid (9 B a point); the normal equations all
    37; the stage buffer and the carry are ~1 KB a row."""
    out = {}
    for lv in cfg.tracked_levels:
        h, w = H >> lv, W >> lv
        n = (h // 2) * w * B
        small = 1024 * B
        for kind, nbytes in (
                ("first", n * (_slab_ref_bytes(cfg) + 37 + 24)),
                ("sigma", 9 * n), ("normal", 37 * n)):
            out[(lv, kind)] = 1e6 * (nbytes + small) / PEAK_BYTES_S
    return out


def _split_expected(res, cfg):
    """The split launches and all-reduces a sharded tracker's run on one
    rank should make from its result: per tracked level stage_plan x the
    loop's iterations (its rows' most) + 1 launches, an all-reduce after
    each but a max_iterations finish."""
    from dvo_slam_tpu_torch.ops import linearize

    plan = linearize.stage_plan(cfg)
    its = res.iterations.max(dim=0).values.cpu().numpy()
    stages = [plan.cold + (int(n) - 1) * plan.warm for n in its]
    return (sum(s + 1 for s in stages),
            sum(s + (int(n) < cfg.max_iterations)
                for s, n in zip(stages, its)))


def _parallel_rank(rank, world_size, device, inp):
    """11, one rank: parallel/'s four workloads on a default mesh of the
    world (pixel axis 2), each timed (host clock around work that ends in
    a device sync, after one warm-up call of the tracker) with the launch
    counts of its run: the pairs and the fleet on the pixel route as
    shipped (the level kernel's split mode) and on its plain version
    (_plain_pixel_route), the graph build, the sequences. Also the split
    launches and all-reduces the pairs run should make (_split_expected),
    the plain linearizations it made, and an instrumented pairs run
    (_split_stage_times). Returns numpy results, every one gathered
    whole."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig, convert
    from dvo_slam_tpu_torch.ops import linearize
    from dvo_slam_tpu_torch.parallel import batch_slam, sharded

    cfg = TrackerConfig()
    mesh = sharded.make_mesh(world_size)
    refs, curs, new, Ks, T0, Tf, seq_i, seq_z, K = _parallel_inputs(
        inp, device)
    g = {k: torch.as_tensor(v, device=device)
         for k, v in inp["graph"].items()}
    out = {"coordinate": tuple(mesh.get_coordinate()),
           "backend": dist.get_backend(), "device": str(device)}
    plain = linearize.linearize_batched_reference
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    def timed(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        _reset_launches()
        calls[0] = 0
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name + " s"] = time.perf_counter() - t0
        out[name + " launches"] = {**_launches(), "plain linearize": calls[0]}
        return r

    pairs = sharded.sharded_track_pairs(mesh, cfg)
    fleet = sharded.sharded_validation_fleet(mesh, cfg)
    local = (sharded.shard_pyramid(refs, mesh),
             sharded.shard_pyramid(curs, mesh, pixel=False), Ks,
             sharded.shard_rows(T0, mesh).contiguous())
    linearize.linearize_batched_reference = counted
    try:
        for route in ("", " plain"):
            with _plain_pixel_route(route == " plain"):
                pairs(*local)
                res = timed("pairs" + route, lambda: pairs(*local))
                out["pairs" + route] = convert.result_to_numpy(
                    sharded.gather_rows(res, mesh))
                if not route:
                    out["rows"] = int(res.transformation.shape[0])
                    out["expected"] = _split_expected(res, cfg)
                    dist.barrier()
                    out["stages"] = _split_stage_times(lambda: pairs(*local))
                out["fleet" + route] = tuple(
                    convert.result_to_numpy(r) for r in timed(
                        "fleet" + route, lambda: fleet(refs, new, Ks, Tf)))
    finally:
        linearize.linearize_batched_reference = plain
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
    PARALLEL_B sequences of PARALLEL_T ring frames. The pairs and the
    fleet run the pixel route as shipped (the level kernel's split mode:
    stage launches over each rank's band, their sums all-reduced between
    them) and its plain version in the same world (_plain_pixel_route).
    Every rank must return the same whole results; the split route is held
    to the plain pixel route (T within 1e-4, valid counts within 0.1 %:
    f64 sums against f32 ones) and to single-process runs on card 0: the
    level kernel (T within 1e-4, valid counts within 0.1 %) and the host
    loop over the plain linearization (the pixel route's arithmetic
    unsharded: T within 5e-5, valid counts within 0.1 %); the graph's H
    and g within 2e-3 and 1e-3 of its own single-process build (the gauge
    block's diagonal excluded). The split route must make no standalone
    sampler, mode (a) or (b) launch, no prepare_reference call and no
    plain linearization, and stage_plan x iterations + 1 split launches a
    level. Prints each workload's time on rank 0 beside the plain pixel
    route's and the single-process ones, the split launches and
    all-reduces per tracked pair, device us per stage launch by level
    (CUDA events; in the world and alone on the card, _split_alone) and
    the all-reduces' time apart from the launches'; holds the standalone
    sampler to its plain version at a pixel shard's shape. Returns the
    kernels line's row inputs for that sampler and for the split mode
    (its launches, error against the plain pixel route, device time of
    rank 0's pairs-run launches alone on the card, the plain route's time
    and the bound)."""
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
        for key in ("pairs", "fleet", "pairs plain", "fleet plain", "graph",
                    "sequences"):
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
            t0 = time.perf_counter()
            fleet = (dense_tracker.track_batched(refs, news, Ks, Tf_t, cfg),
                     dense_tracker.track_batched(
                         news, refs, Ks, se3.inverse(Tf_t).contiguous(), cfg))
            torch.cuda.synchronize()
            fleet_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            seqs = batch_slam.track_sequences_batched(seq_i, seq_z, K, cfg)
            torch.cuda.synchronize()
            seq_s = time.perf_counter() - t0
        single[route] = {
            "pairs": convert.result_to_numpy(pairs), "pairs s": pairs_s,
            "fleet": tuple(convert.result_to_numpy(f) for f in fleet),
            "fleet s": fleet_s,
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
    single["plain pixel"] = {"pairs": r0["pairs plain"],
                             "fleet": r0["fleet plain"]}
    for route, tol in (("plain pixel", 1e-4), ("kernel", 1e-4),
                       ("host", 5e-5)):
        s = single[route]
        pairs_w = [(r0["pairs"], s["pairs"]),
                   *zip(r0["fleet"], s["fleet"])]
        d_T = max(float(np.abs(a.transformation - b.transformation).max())
                  for a, b in pairs_w)
        d_n = max(float((np.abs(a.valid_pixels - b.valid_pixels)
                         / np.maximum(b.valid_pixels, 1.0)).max())
                  for a, b in pairs_w)
        d_seq = (0.0 if "sequences" not in s else float(np.abs(
            r0["sequences"]["rel_poses"]
            - s["sequences"]["rel_poses"]).max()))
        err[route] = d_T
        what = {"plain pixel": "plain pixel route (the same world)",
                "kernel": "single-process level-kernel route",
                "host": "single-process host loop over the plain "
                        "linearization"}[route]
        print(f"phase 11 parallel ({shared}), the split route against the "
              f"{what}: pairs and fleet |dT| {d_T:.2e}, valid counts within "
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
    la, la_p = r0["pairs launches"], r0["pairs plain launches"]
    rows_0 = r0["rows"]
    print(f"phase 11 parallel: {shared} ({world_s:.1f} s for the world, "
          f"start-up included), mesh coordinates "
          f"{[r['coordinate'] for r in ranks]}, devices "
          f"{[r['device'] for r in ranks]}; rank 0 wall times: pairs B="
          f"{PARALLEL_B} {1e3 * r0['pairs s']:.1f} ms on the split route "
          f"(plain pixel route {1e3 * r0['pairs plain s']:.1f}; single "
          f"process: level kernel {1e3 * single['kernel']['pairs s']:.1f}, "
          f"host loop {1e3 * single['host']['pairs s']:.1f}), validation "
          f"fleet {PARALLEL_B} candidates {1e3 * r0['fleet s']:.1f} ms "
          f"(plain pixel route {1e3 * r0['fleet plain s']:.1f}; single "
          f"process: level kernel {1e3 * single['kernel']['fleet s']:.1f}, "
          f"host loop {1e3 * single['host']['fleet s']:.1f}), graph "
          f"build {M} vertices {E} edges {1e3 * r0['graph s']:.1f} ms "
          f"(single process {1e3 * graph_s:.1f}; |dH| {d_H:.2e}, |dg| "
          f"{d_g:.2e}), sequences {PARALLEL_B} x {PARALLEL_T} frames "
          f"{1e3 * r0['sequences s']:.1f} ms (single process: level kernel "
          f"{1e3 * single['kernel']['sequences s']:.1f})")
    print(f"phase 11 pixel route, rank 0's {rows_0} pairs: split launches "
          f"{la['track_level_split']} ({la['track_level_split'] / rows_0:.2f} "
          f"a tracked pair; graph replays {la['replays_split']}, captures "
          f"{la['captures_split']}), all-reduces {la['collectives_split']} "
          f"({la['collectives_split'] / rows_0:.2f} a tracked pair; expected "
          f"{r0['expected']}), standalone sampler {la['sample_slab']}, "
          f"mode (a) {la['linearize']}, mode (b) {la['track_level']}, "
          f"prepare_reference {la['prepare_reference']}, plain "
          f"linearizations {la['plain linearize']}; the plain pixel route: "
          f"standalone sampler {la_p['sample_slab']} "
          f"({la_p['sample_slab'] / rows_0:.2f} a tracked pair), plain "
          f"linearizations {la_p['plain linearize']}, split launches "
          f"{la_p['track_level_split']}")
    if not (d_H <= 2e-3 and d_g <= 1e-3):
        raise AssertionError(f"graph build |dH| {d_H}, |dg| {d_g}")
    if (la["sample_slab"] != 0 or la["track_level"] != 0
            or la["linearize"] != 0 or la["prepare_reference"] != 0
            or la["plain linearize"] != 0
            or (la["track_level_split"], la["collectives_split"])
            != tuple(r0["expected"])):
        raise AssertionError(f"split route launches {la}, expected "
                             f"{r0['expected']}")
    if la_p["plain linearize"] == 0 or la_p["track_level_split"] != 0:
        raise AssertionError(f"plain pixel route launches {la_p}")

    # The split route's stage launches by level (CUDA events) and its
    # all-reduces (host clock, apart from the launches), an instrumented
    # pairs run on rank 0; its bound from the band's bytes at 3.35 TB/s.
    def by_level(times):
        lines = {}
        for (h, kind), us in sorted(times.items(), reverse=True):
            lines.setdefault(int(round(np.log2(H / h))), []).append(
                f"{kind} {np.median(us):.2f} (x{len(us)})")
        return "; ".join(f"level {lv}: " + ", ".join(v) for lv, v in
                         sorted(lines.items(), reverse=True))

    times, coll, wall = r0["stages"]
    dev_ms = sum(sum(v) for v in times.values()) / 1e3
    shares = (", so a launch's events span the other rank's work too"
              if cards == 1 else "")
    print(f"phase 11 split route stage launches, rank 0's pairs run in the "
          f"world (device us a launch, median; B = {rows_0}; "
          f"{shared}{shares}): {by_level(times)}")
    print(f"phase 11 split route, instrumented pairs run on rank 0: "
          f"{1e3 * wall:.1f} ms wall, of it launches {dev_ms:.2f} ms of "
          f"device time and {len(coll)} all-reduces {1e3 * sum(coll):.1f} ms "
          f"({1e6 * np.mean(coll):.1f} us each, median "
          f"{1e6 * np.median(coll):.1f}; {backend}, host clock between "
          f"device syncs)")
    (times_1, coll_1, wall_1), n_alone = _split_alone(refs, curs, Ks, T0_t,
                                                      cfg)
    alone_ms = sum(sum(v) for v in times_1.values()) / 1e3
    print(f"phase 11 split route stage launches alone on the card (rank "
          f"0's bands of the {PARALLEL_B} pairs in a 1-rank gloo group; "
          f"device us a launch, median): {by_level(times_1)}; {n_alone} "
          f"launches {alone_ms:.3f} ms of device time, "
          f"{1e3 * wall_1:.1f} ms wall ({len(coll_1)} one-rank all-reduces "
          f"{1e3 * sum(coll_1):.1f} ms)")
    # The graph issue (nccl) in a 1-rank group on card 0; the phase split.
    t0 = time.perf_counter()
    nc = _split_nccl_alone(refs, curs, Ks, T0_t, cfg, device)
    first, later = nc["issued"][0], nc["issued"][2]
    print(f"phase 11 split route, graph issue in a 1-rank nccl group "
          f"(rank 0's bands of the {PARALLEL_B} pairs): three runs "
          f"{'the same bits as' if nc['same'] else 'DIFFER from'} the eager "
          f"issue (1-rank gloo); against the level kernel over the same "
          f"points |dT| {nc['d_T']:.2e}, valid counts within "
          f"{nc['d_n']:.2e} (tol 1e-4, 1e-3); captures in the first run "
          f"{first['captures_split']}, in a later run "
          f"{later['captures_split']}; a later run's replays "
          f"{later['replays_split']}, launches "
          f"{later['track_level_split']} and all-reduces "
          f"{later['collectives_split']} (eager ones "
          f"{len(nc['parts']['graph']['launch'])}; "
          f"{time.perf_counter() - t0:.1f} s)")
    for name in ("graph", "eager"):
        print(f"phase 11 split issue, {name} issue, 1-rank nccl group: "
              + _issue_summary(nc["parts"][name], nc["reduce_us"]))
    bounds_1 = _split_launch_bounds(cfg, PARALLEL_B)
    for (h, kind), (ph, span) in sorted(nc["phases"].items(), reverse=True):
        lv = int(round(np.log2(H / h)))
        print(f"phase 11 split phases, level {lv} {kind} (B = {PARALLEL_B}, "
              f"row 0's first CTA, us, median): span {span:.2f}; "
              + ", ".join(f"{k} {v:.2f}" for k, v in ph.items())
              + (f"; bound {bounds_1[(lv, kind)]:.4f}"
                 if (lv, kind) in bounds_1 else ""))
    if not (nc["same"] and nc["d_T"] <= 1e-4 and nc["d_n"] <= 1e-3):
        raise AssertionError(f"the graph issue: bits {nc['same']}, |dT| "
                             f"{nc['d_T']}, valid {nc['d_n']}")
    if not (first["captures_split"] >= 1 and later["captures_split"] == 0
            and later["replays_split"] >= 1
            and later["track_level_split"] == first["track_level_split"]):
        raise AssertionError(f"the graph issue's counts {nc['issued']}")

    its = r0["pairs"].iterations[:rows_0]  # rank 0's rows, (B, levels)
    split_bytes = split_ops = 0.0
    for j, lv in enumerate(cfg.tracked_levels):
        h_l, w_l = H >> lv, W >> lv
        band = (h_l // 2) * w_l
        n_its = float(its[:, j].sum())
        # The band's planes and the current slab's pixels its warps
        # gather from (about the band's rows), each iteration.
        split_bytes += n_its * (_slab_ref_bytes(cfg) + 24) * band
        split_ops += n_its * RESIDUAL_OPS[0] * band
    split_row = {"launches": la["track_level_split"],
                 "err": err["plain pixel"], "ms": alone_ms,
                 "plain_ms": 1e3 * r0["pairs plain s"],
                 "bound": _bound_ms(split_bytes, split_ops, 0.0),
                 "launch_bound_ms": {
                     f"level {lv} {kind}": 1e-3 * us
                     for (lv, kind), us in _split_launch_bounds(
                         cfg, rows_0).items()}}
    print(f"phase 11 split route row: device {alone_ms:.3f} ms a pairs "
          f"run's launches (alone on the card), plain pixel route "
          f"{split_row['plain_ms']:.1f} ms, bound "
          f"{split_row['bound'][0]:.4f} ms ({split_row['bound'][1]}; "
          f"{split_bytes / 1e6:.1f} MB)")

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
    if not (torch.equal(inb, want_inb) and _same_bits(got, want) == 0):
        raise AssertionError(f"sampler at the shard's shape: "
                             f"{_same_bits(got, want)} samples differ in "
                             f"their bits (max error {s_err})")
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
          f"{rows} of {refs[lvl].shape[-2]} rows, N={N}): bit for bit "
          f"(max_abs_err {s_err:.3e}); device {1e3 * ms:.2f} us per call "
          f"(CUDA events; plain {1e3 * plain_ms:.2f}, grid_sample {1e3 * lib_ms:.2f}); "
          f"bound {1e3 * bound[0]:.4f} us ({bound[1]})")
    return {"launches": la["sample_slab"], "err": s_err, "bound": bound,
            "ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms,
            "split": split_row}


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

    from dvo_slam_tpu_torch import TrackerConfig

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this smoke test needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    phase_device()
    cfg, levels = phase_kernel_vs_plain(device)
    level_pairs = phase_level_vs_plain(device, cfg)
    batched = phase_batched_vs_plain(device, cfg)
    launches, _, frames, _ = phase_main_path(device)
    estimators = phase_estimators(device, frames)
    front = phase_front(device)
    slam_out = phase_slam(device)
    t0 = time.perf_counter()
    val_batches = phase_validation_batches(device, cfg)
    slam_out["eviction"] = phase_eviction(device)
    print(f"phases 5d-5e took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slam_out["past128"] = phase_past128(device)
    print(f"phase 5g took {time.perf_counter() - t0:.1f} s")
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
    scan = phase_scan_step(device, cfg)
    chunked = phase_chunked(device, slam_out)
    print(f"phases 8a-8 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_live(device, slam_out)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    compaction = phase_compaction(device, frames, slam_out, chunked)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    par = phase_parallel(device)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dev_times = phase_device_times(cfg, levels, batched, front)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    # Profiles only from here on.
    # The level kernel's sessions first: a session after the host loop's
    # (~58 000 device records in 6h's) lost one device record in three
    # attempts in a row.
    for host in (False, True):
        phase_profile(device, frames, host)
    phase_profile(device, frames, False, cfg=TrackerConfig(
        intensity_grad_threshold=COMPACT_THRESHOLD,
        point_budget_fraction=COMPACT_BUDGET), tag="10a")
    for host in (False, True):
        phase_slam_profile(slam_out, host)
    for host in (False, True):
        phase_offline_profile(offline, device, host)
    phase_chunk_profile(device, slam_out)
    print(json.dumps({"kernels": kernel_rows(
        cfg, levels, launches, dev_times, slam_out, level_pairs, batched,
        chunked["launches"], val_batches, compaction, par, graph, offline,
        front, scan, estimators)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

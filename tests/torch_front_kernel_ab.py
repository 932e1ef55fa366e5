"""The pyramid kernel (csrc/pyramid.cu), the standalone slab sampler
(csrc/sampler.cu), the cluster kernel (csrc/linearize.cu) and the chunked
scan's step (csrc/keyframe_scan.cu) of
one or more source trees, timed on the same seeded inputs in one run on
one card.

    python3 tests/torch_front_kernel_ab.py TREE [TREE ...] [--rounds 4]
        [--phases] [--sass]

A TREE is the root of a checkout of this repository: ``.``, or a ``git
archive`` of another commit unpacked into a directory that .gitignore
lists. Each round times the trees in turn, each in a child process that
imports that tree's dvo_slam_tpu_torch and chip_smoke (and builds that
tree's kernels under its own build/), and every other round takes them in
reverse order (A B, B A, ...), so a drift of the card's clock falls on
both. The child times, by chip_smoke._events_us (CUDA events behind a spin
kernel): the pyramid at 640x480 with 4 levels for f32 and u8 + u16 inputs
(phase 3a's noisy frame), and its wrapper's host time a call; the sampler on phase 2a's noisy pair at the
tracked levels 3, 2 and 1 and at phase 11's pixel-shard shape (the first
half of level 1's rows), beside torch's grid_sample; the cluster
kernel's mode (b) under the default t-distribution at B = 1 (phase 2's
noisy pair), 2 and 8 (chip_smoke._batch_inputs) at the tracked levels,
with the iterations each launch runs, and its mode (a) at B = 1; where
the tree runs other scale estimators on the kernel, mode (b) under normal
+ Tukey and MAD + Huber at B = 1; where the tree compacts on the slab
route, both modes at B = 1 at phase 10b's budget on the slab route and
on the RefData route over the prepared compacted points; where the tree
has it, an empty kernel (the launch floor); and where the tree has the step
kernel: the step held to its plain version on chip_smoke's STEP_CASES and
8 random rows, with and without the statistics, then timed a call
without them (the main path) and with them on the "accepted" case; where
the tree has the test primary dvo_late_copy, the step behind it (it
triggers its dependents at its start and spins 20 us, as the finest
level launch triggers the step: us a pair, beside the primary alone);
and a 16-frame chunk of the ring at 640x480 on the kernel route
(keyframe_scan.track_keyframe_chunk, five launches a frame) behind a spin
that outlasts the host's issue time for the chunk (twice it, at most
1 s), so that the device time of the chunk's launches is timed and not
the host's issue rate (the median of 11 chunks).

--phases: where the tree's build_pyramid_kernel takes ``timing=``, the
pyramid kernel's phase split (ops/pyramid.phase_times: mean us a CTA per
phase, the launch's span) for both encodings; where its scan_step_kernel
does, the step's (ops/scan_step.phase_times, the median of 20 launches)
with and without the statistics. --sass [DIR]: the SASS of
every sample_slab_kernel of the tree's library (cuobjdump), written to
DIR/<tree>.sass (default build/front_ab), and per function the order of
its global loads, stores and float operations, compressed. Prints the card's
name and power limit, a line per tree and round, then per case each
tree's median us. Needs a card. Not a test: pytest does not collect it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import dataclasses, functools, inspect, json, re, subprocess, sys, time
from pathlib import Path
import numpy as np
import torch
import chip_smoke as s
from dvo_slam_tpu_torch import SlamConfig, TrackerConfig, _build
from dvo_slam_tpu_torch.models import keyframe_scan
from dvo_slam_tpu_torch.ops import camera, linearize, pyramid, sampler, scan_step
from dvo_slam_tpu_torch.utils import synthetic

phases, sass, tag = sys.argv[1] == "1", sys.argv[2] == "1", sys.argv[3]
dev = torch.device("cuda", 0)
lib = _build.load()
out = {}

# The pyramid: phase 3a's noisy 640x480 frame.
scene = synthetic.two_plane_scene(sharpness=2.0)
i, z = synthetic.add_sensor_noise(
    *scene.render(np.asarray(s.K_TUPLE), s.W, s.H, np.eye(4)),
    np.random.default_rng(2), dropout=0.02)
i8 = np.clip(np.round(i), 0, 255).astype(np.uint8)
z16 = np.where(np.isfinite(z), np.round(z * 5000.0), 0).astype(np.uint16)
timed_ok = "timing" in inspect.signature(
    pyramid.build_pyramid_kernel).parameters
for enc, a, b in (("f32", i, z), ("u8+u16", i8, z16)):
    ti, tz = (torch.as_tensor(x, device=dev) for x in (a, b))
    got = pyramid.build_pyramid_kernel(ti, tz, 4)
    want = pyramid.build_pyramid_reference(ti, tz, 4)
    torch.cuda.synchronize()
    bad = [s._same_bits(g, w) for g, w in zip(got, want)]
    if any(bad):
        sys.exit(f"pyramid {enc}: entries that differ {bad}")
    out[f"pyramid {enc}"] = s._events_us(
        functools.partial(pyramid.build_pyramid_kernel, ti, tz, 4))
    # The wrapper's host time a call: 200 calls queued without a sync
    # (the card runs each in a few us, so the host sets the pace); where
    # the tree has two fill paths, also with the scalar fill forced.
    fills = {"": None}
    if hasattr(pyramid, "tma_fill"):
        fills[", scalar fill"] = lambda i, z: False
    for tag, forced in fills.items():
        saved = getattr(pyramid, "tma_fill", None)
        if forced is not None:
            pyramid.tma_fill = forced
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            pyramid.build_pyramid_kernel(ti, tz, 4)
        out[f"pyramid {enc} host{tag}"] = (
            (time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
        if forced is not None:
            pyramid.tma_fill = saved
    if phases and timed_ok:
        splits = []
        for _ in range(5):
            buf = pyramid.timing_buffer(s.H, s.W, dev)
            pyramid.build_pyramid_kernel(ti, tz, 4, timing=buf)
            torch.cuda.synchronize()
            splits.append(pyramid.phase_times(buf.cpu().numpy(), 4))
        names = list(splits[0][0])
        # The last launch's CTAs: start skew, and mean us a CTA by how many
        # CTAs shared its SM (the stamp row's last slot).
        st = buf.cpu().numpy()
        st = st[st[:, 1] != 0]  # the CTAs the launch had
        share = np.bincount(st[:, -1])[st[:, -1]]
        print(json.dumps({"phases": enc, "us_a_cta": {
            k: float(np.median([x[0][k] for x in splits])) for k in names},
            "span_us": float(np.median([x[1] for x in splits])),
            "cta_us": float(np.median([x[2] for x in splits])),
            "ctas": int(st.shape[0]),
            "start_skew_us": float(st[:, 0].max() - st[:, 0].min()) / 1e3,
            "cta_us_by_sm_share": {int(k): float(
                (st[share == k, 1] - st[share == k, 0]).mean()) / 1e3
                for k in np.unique(share)}}), flush=True)

# The sampler: phase 2a's noisy pair, levels 3, 2, 1; phase 11's shard.
cfg = TrackerConfig()
ref_pyr, cur_pyr, Ks, T = s._noisy_pair(dev, cfg)
cases = {}
for lvl in cfg.tracked_levels:
    ref = linearize.prepare_reference(ref_pyr[lvl], Ks[lvl], cfg)
    cases[f"level {lvl}"] = (cur_pyr[lvl],
                             *linearize.warp(ref, Ks[lvl], T)[4:])
lvl = cfg.tracked_levels[-1]
rows = ref_pyr[lvl].shape[-2] // 2
ref = linearize.prepare_reference(ref_pyr[lvl][:, :rows], Ks[lvl], cfg)
cases["pixel shard"] = (cur_pyr[lvl], *linearize.warp(ref, Ks[lvl], T)[4:])
for name, (slab, u, v) in cases.items():
    for C in (6, 1):
        got, inb = sampler.sample_slab(slab[:C], u, v)
        want, want_inb = sampler.sample_slab_reference(slab[:C], u, v)
        torch.cuda.synchronize()
        if not (torch.equal(inb, want_inb) and s._same_bits(got, want) == 0):
            sys.exit(f"sampler {name} C={C}: differs from plain")
    grid = torch.stack([u * (2.0 / (slab.shape[2] - 1)) - 1.0,
                        v * (2.0 / (slab.shape[1] - 1)) - 1.0],
                       dim=-1)[None, None]
    out[f"sampler {name} (N={u.numel()})"] = s._events_us(
        functools.partial(sampler.sample_slab, slab, u, v))
    out[f"grid_sample {name}"] = s._events_us(
        functools.partial(s._grid_sample, slab[None], grid))

# The cluster kernel (csrc/linearize.cu): mode (b) under the default
# t-distribution at B = 1 (phase 2's noisy pair), 2 (a shared slab) and 8
# (a slab a row; chip_smoke._batch_inputs) at each tracked level, and mode
# (a) at B = 1; where the tree runs other estimators on the kernel, mode
# (b) under normal + Tukey and MAD + Huber at B = 1. Each launch's
# iterations (of the longest row) beside its us.
lin_cfgs = {"tdist": cfg}
if hasattr(linearize, "_ESTIMATORS"):
    lin_cfgs["normal_tukey"] = dataclasses.replace(
        cfg, scale_estimator="normal", influence="tukey")
    lin_cfgs["mad_huber"] = dataclasses.replace(
        cfg, scale_estimator="mad", influence="huber")
for lvl in cfg.tracked_levels:
    ref = linearize.prepare_reference(ref_pyr[lvl][None], Ks[lvl], cfg)
    batches = {1: (ref, cur_pyr[lvl], Ks[lvl], T[None])}
    for B, paired in ((2, False), (8, True)):
        batches[B] = s._batch_inputs(dev, cfg, B, paired, lvl)[:4]
    for B, args in batches.items():
        for name, c in lin_cfgs.items():
            if B > 1 and name != "tdist":
                continue
            its = linearize.unpack_level(*linearize.track_level_kernels(
                *args, c), c.max_iterations).iterations.max().item()
            case = f"mode (b) {name} B={B} level {lvl}"
            out[case] = s._events_us(
                functools.partial(linearize.track_level_kernels, *args, c))
            out[case + " iterations"] = float(its)
    out[f"mode (a) B=1 level {lvl}"] = s._events_us(functools.partial(
        linearize.linearize_kernels_batched, *batches[1], cfg))

# Where the tree compacts on the slab route (linearize.ref_budget): both
# modes at B = 1 at the budget of chip_smoke's phase 10b (its noise-free
# orbit pair) on the slab route, whose launches pick the slots' pixels,
# and on the RefData route over prepare_reference's compacted points.
if hasattr(linearize, "ref_budget"):
    b_cfg = TrackerConfig(intensity_grad_threshold=s.COMPACT_THRESHOLD,
                          point_budget_fraction=s.COMPACT_BUDGET)
    b_ref, b_cur, b_Ks, b_T = s._noisy_pair(dev, b_cfg, noisy=False)
    for lvl in b_cfg.tracked_levels:
        slab = b_ref[lvl][None]
        for route, r in (("slab", linearize.RefSlabs(slab)), (
                "RefData", linearize.prepare_reference(slab, b_Ks[lvl],
                                                       b_cfg))):
            args = (r, b_cur[lvl], b_Ks[lvl], b_T[None], b_cfg)
            out[f"budget mode (b) {route} level {lvl}"] = s._events_us(
                functools.partial(linearize.track_level_kernels, *args))
            out[f"budget mode (a) {route} level {lvl}"] = s._events_us(
                functools.partial(linearize.linearize_kernels_batched, *args))
if hasattr(_build, "empty_launch"):
    out["empty kernel"] = s._events_us(
        functools.partial(_build.empty_launch, dev))

# The chunked scan's step, where the tree has it.
if hasattr(s, "STEP_CASES"):
    step_timed = "timing" in inspect.signature(
        scan_step.scan_step_kernel).parameters
    cases = [(c, i) for i, c in enumerate(s.STEP_CASES)] + [
        ("random", 1000 + i) for i in range(8)]
    for stats in (False, True):
        cfg = dataclasses.replace(TrackerConfig(), collect_stats=stats)
        for case, seed in cases:
            inp = s._step_inputs(case, cfg, dev, seed)
            got, layout = s._run_step(scan_step.scan_step_kernel, inp, cfg)
            want, _ = s._run_step(scan_step.scan_step_plain, inp, cfg)
            torch.cuda.synchronize()
            bad, err = s._step_differences(got, want, layout)
            if bad:
                sys.exit(f"step {case} (seed {seed}, stats {stats}): {bad}")
        inp = s._step_inputs("accepted", cfg, dev, 0)
        got, _ = s._run_step(scan_step.scan_step_kernel, inp, cfg)
        args = (inp["lev"], inp["lev_i"], inp["state_in"], inp["table_in"],
                inp["force"], inp["cur"], *got, cfg, inp["scan_cfg"])
        what = "with statistics" if stats else "without statistics"
        out[f"step {what}"] = s._events_us(
            functools.partial(scan_step.scan_step_kernel, *args))
        if phases and step_timed:
            splits = []
            for _ in range(20):
                buf = scan_step.timing_buffer(dev)
                scan_step.scan_step_kernel(*args, timing=buf)
                torch.cuda.synchronize()
                splits.append(scan_step.phase_times(buf.cpu().numpy()))
            names = list(splits[0][0])
            print(json.dumps({"phases": f"step {what}", "us_a_phase": {
                k: float(np.median([x[0][k] for x in splits])) for k in names},
                "span_us": float(np.median([x[1] for x in splits]))}),
                flush=True)
    if "dvo_late_copy" in _build._entry_points():
        # The step behind a primary that triggers its dependents at its
        # start and spins for 20 us (dvo_late_copy, copying nothing), as
        # the step follows the finest level launch: us a pair.
        cfg = TrackerConfig()
        inp = s._step_inputs("accepted", cfg, dev, 0)
        got, _ = s._run_step(scan_step.scan_step_kernel, inp, cfg)
        args = (inp["lev"], inp["lev_i"], inp["state_in"], inp["table_in"],
                inp["force"], inp["cur"], *got, cfg, inp["scan_cfg"])
        primary = (0, 0, 0, 0, 0, 0, 0, 20_000)

        def pair():
            _build.launch("dvo_late_copy", dev, primary)
            scan_step.scan_step_kernel(*args)

        out["step behind a 20 us primary (a pair)"] = s._events_us(pair)
        out["20 us primary alone"] = s._events_us(functools.partial(
            _build.launch, "dvo_late_copy", dev, primary))

    # A 16-frame chunk of the ring on the kernel route, behind a spin.
    frames, _ = s._ring()
    seq = [frames[k % len(frames)] for k in range(s.CHUNK + 1)]
    ii = torch.as_tensor(np.stack([f[0] for f in seq]), device=dev)
    zz = torch.as_tensor(np.stack([f[1] for f in seq]), device=dev)
    cfg, slam_cfg = TrackerConfig(), SlamConfig()
    K = camera.intrinsics(*s.K_TUPLE, device=dev)
    carry = keyframe_scan.init_carry(keyframe_scan.pyramid_from_stack(
        ii, zz, 0, cfg.num_levels))
    before = scan_step.LAUNCHES_SCAN_STEP

    def chunk():
        return keyframe_scan.track_keyframe_chunk(carry, ii[1:], zz[1:], K,
                                                  cfg, slam_cfg)

    for _ in range(2):
        chunk()
    torch.cuda.synchronize()
    if scan_step.LAUNCHES_SCAN_STEP - before != 2 * s.CHUNK:
        sys.exit("the chunk did not run on the kernel route")
    t0 = time.perf_counter()
    chunk()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    runs = []
    for _ in range(11):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(s.SPIN_HZ * min(2.0 * host_s, 1.0)))
        start.record()
        chunk()
        end.record()
        torch.cuda.synchronize()
        runs.append(1e3 * start.elapsed_time(end))
    out["chunk of 16 (device us)"] = float(np.median(runs))
    out["chunk host issue us"] = 1e6 * host_s

if sass:
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    dest = Path(sys.argv[4])
    dest.mkdir(parents=True, exist_ok=True)
    blocks = re.split(r"\n(?=\s*Function : )", text)
    keep = [b for b in blocks if "sample_slab_kernel" in b.split("\n")[0]]
    (dest / f"{tag}.sass").write_text("\n".join(keep))
    for b in keep:
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9_]*)"
                         r"(?:\.[A-Z0-9_.]+)?", b)
        kinds = [("LDG" if o.startswith("LDG") else "STG" if o.startswith(
            "STG") else "F" if o in ("FADD", "FMUL", "FFMA") else "BRA"
            if o == "BRA" else None) for o in ops]
        seq = []
        for k in kinds:
            if k is None:
                continue
            if seq and seq[-1][0] == k:
                seq[-1][1] += 1
            else:
                seq.append([k, 1])
        print(json.dumps({"sass": b.split("\n")[0].strip(),
                          "instructions": len(ops),
                          "order": " ".join(f"{k}x{n}" for k, n in seq)}),
              flush=True)
print(json.dumps({"us": out}), flush=True)
"""


def _run(tree, phases, sass):
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    tag = os.path.basename(root.rstrip("/")) or "tree"
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(int(phases)), str(int(bool(sass))),
         tag, os.path.abspath(sass or ".")], cwd=root, env=env,
        capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"{tree}: exit {out.returncode}\n{out.stdout[-4000:]}\n"
                 f"{out.stderr[-4000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    for r in rows:
        if "us" not in r:
            print(f"{tree}: {json.dumps(r)}", flush=True)
    return next(r["us"] for r in rows if "us" in r)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--sass", nargs="?", const="build/front_ab",
                    metavar="DIR")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0
          else "nvidia-smi: not available", flush=True)
    times = {}
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            first = r == 0
            us = _run(tree, args.phases and first, args.sass if first else None)
            for case, t in us.items():
                times.setdefault(case, {}).setdefault(tree, []).append(t)
            print(f"round {r} {tree}: " + ", ".join(
                f"{case} {t:.2f}" for case, t in us.items()), flush=True)
    for case, by_tree in times.items():
        print(f"{case}: device us a call, median over rounds: " + ", ".join(
            f"{tree} {statistics.median(ts):.2f}"
            for tree, ts in by_tree.items()), flush=True)


if __name__ == "__main__":
    main()

"""A server tracking a fleet of cameras: frame-to-frame odometry of S
streams at once, one batched call a segment.

Each stream is a ring of ``ring_frames`` frames of the synthetic
protocol, starting ``phase_step`` frames further along the orbit than the
stream before it, rendered on the card in set-up and held there as 8-bit
intensity and 16-bit depth. The rings tile into segments of
``frames_per_call`` frames, consecutive segments sharing one frame. The
window runs closed loop, one call in flight: each call is
``parallel.batch_slam.track_sequences_batched`` over one segment of every
stream, on views into the rings (no copy), visiting the segments in an
order drawn from the run's seed and starting over when all are done.
After each call the poses are read back to the host. Every frame of a
call has the same latency, from the start of the call to the end of the
read-back.

The frames are one set for every run, but for the checked segments: the
noise is drawn from the mix's ``frames_seed``. The IRLS iterations, and
so the work of a call, follow the noise, and a ring holds too few
segments to average it out (on an H100, one seed's noise against
another's moved a run's rate by up to 2 %, where two runs of one seed
differed by about 0.5 %). The run's seed orders the segments; the first
``check_calls`` of that order are the checked segments, rendered again
with noise drawn from the run's seed, so that every seed checks fresh
noise while its work stays within a few segments of every other seed's.

The check, after the window: one call on each checked segment, drawn
from the seed, is tracked again by the reference from its raw frames,
each frame of each stream from the pose the program started it at (the
identity at a call's first frame; after that the program's own previous
answer: the check follows the program's warm starts, so that each
frame's answer is judged on its own, and the call's first frame checks
the start). A frame the program marks failed, or returns non-finite,
reads an infinite gap.

- ``pose_gap_stream_p50_max``: the median twist norm between a pose the
  program returned and the reference's over each stream's checked
  frames, the largest over the streams: a fault on most of one stream's
  frames shows, whatever the program reports of its iterations;
- ``off_path_share``: the share of checked frames whose iteration
  counts, level by level, are not the reference's (or that failed);
- ``pose_gap_same_path``: the largest gap over the frames whose
  iteration counts are the reference's. Where a level's Gauss-Newton
  loop stops on a step that raises the error at the float32 noise floor,
  the last bits of a sum decide it, and two sound trackers part by up to
  a millimetre; where both took the same steps they agree to rounding.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import pyramid, se3, tracker
from portbench.trace import null_span
from portbench.traffic import scene

SLAB_MODEL = "own_pairs"


class Driver:
    def __init__(self, cell, device="cuda"):
        from dvo_slam_tpu_torch import TrackerConfig
        from dvo_slam_tpu_torch.parallel import batch_slam

        cfg, p = cell["config"], cell["params"]
        self.cell, self.p = cell, p
        self.device = dev = torch.device(device)
        cam, proto = cfg["camera"], cfg["protocol"]
        S, L, step = p["streams"], p["ring_frames"], p["phase_step"]
        lap = proto["orbit"]["frames_per_lap"]
        total = (S - 1) * step + L
        poses = scene.orbit(total, proto["orbit"]["radius"],
                            proto["orbit"]["yaw_amplitude"], total / lap)
        shape = (S, L, cam["height"], cam["width"])
        self.ring_i = torch.empty(shape, dtype=torch.uint8, device=dev)
        self.ring_z = torch.empty(shape, dtype=torch.uint16, device=dev)
        gen = scene.generator(p["frames_seed"], dev)
        for s in range(S):
            scene.frames(proto, cam, poses[s * step:s * step + L].to(dev),
                         gen, self.ring_i[s], self.ring_z[s])
        F = p["frames_per_call"]
        self.rng = np.random.default_rng(cell["seed"])
        starts = range(0, L - F + 1, F - 1)
        self.starts = [starts[k] for k in self.rng.permutation(len(starts))]
        self.check_starts = sorted(self.starts[:p["check_calls"]])
        gen = scene.generator(cell["seed"], dev)
        for start in self.check_starts:
            for s in range(S):
                at = s * step + start
                scene.frames(proto, cam, poses[at:at + F].to(dev), gen,
                             self.ring_i[s, start:start + F],
                             self.ring_z[s, start:start + F])
        self.K = torch.tensor(cam["intrinsics"], dtype=torch.float32,
                              device=dev)
        self.cfg = TrackerConfig(**cfg["tracker"])
        self.track = batch_slam.track_sequences_batched
        # Warm-up: the window's call, at its one shape.
        for start in self.starts[:2]:
            self._call(start, null_span)

    def _call(self, start, span):
        F = self.p["frames_per_call"]
        with span("fleet.track"):
            out = self.track(self.ring_i[:, start:start + F],
                             self.ring_z[:, start:start + F], self.K,
                             self.cfg)
        with span("fleet.readback"):
            rel = out["rel_poses"].cpu().numpy()
            nan = out["is_nan"].cpu().numpy()
            iters = out["iterations"].cpu().numpy()
        return rel, nan, iters

    def run(self, seconds, tracer):
        p = self.p
        lat, calls = [], []
        per_call = p["streams"] * (p["frames_per_call"] - 1)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while (not calls or tracer.owed
               or time.perf_counter() < deadline):
            if len(calls) == p["trace_from"]:
                tracer.start()
            start = self.starts[len(calls) % len(self.starts)]
            t = time.perf_counter()
            rel, nan, iters = self._call(start, tracer.span)
            lat.extend([time.perf_counter() - t] * per_call)
            calls.append((start, rel, nan, iters))
            if tracer.active and len(calls) == p["trace_from"] + p[
                    "trace_calls"]:
                self._stop(tracer, p["trace_calls"] * per_call)
        window_s = time.perf_counter() - t0
        failed = sum(int((n | ~np.isfinite(r).all((-1, -2))).sum())
                     for _, r, n, _ in calls)
        attempted = per_call * len(calls)
        return {"window_s": window_s, "latencies_s": lat,
                "attempted": attempted, "returned": attempted - failed,
                "failed": failed, "calls": calls}

    def _stop(self, tracer, frames):
        cfg = self.cell["config"]
        tracer.stop(frames=frames, slab_model=SLAB_MODEL,
                    camera=cfg["camera"],
                    tracked_levels=list(range(
                        cfg["tracker"]["last_level"],
                        cfg["tracker"]["first_level"] + 1)))

    def check(self, window, sums=torch.float64):
        calls = window["calls"]
        self.checked = []
        for start in self.check_starts:
            on = [c for c in calls if c[0] == start]
            if on:
                self.checked.append(on[self.rng.integers(len(on))])
        self.notes = {"calls": len(calls),
                      "checked_calls": len(self.checked)}
        return self._judge(sums)

    def control(self, window):
        """The control's readings: the reference one step below the
        configuration's precision (``reference.precision.control``: its
        sums in float32, its products in TF32) in the program's place, on
        the calls ``check`` drew, judged by the reference."""
        from portbench.reference import precision

        with precision.control():
            answers = [self.replay(c[0], c[1], torch.float32)
                       for c in self.checked]
        return self._judge(torch.float64, answers)

    def _judge(self, sums, answers=None):
        """The check's numbers for the drawn calls: the program's answers,
        or ``answers`` ((rel, iterations) a call) in their place."""
        gaps, path = [], []
        for n, (start, rel, nan, iters) in enumerate(self.checked):
            want, want_it = self.replay(start, rel, sums)
            if answers is not None:
                rel, iters = answers[n]
                nan = np.zeros(nan.shape, bool)
            g = se3.gap(torch.as_tensor(rel), want.cpu()).numpy()
            ok = ~nan & np.isfinite(g)
            gaps.append(np.where(ok, g, np.inf))
            path.append(ok & (np.asarray(iters)
                              == want_it.cpu().numpy()).all(-1))
        # (streams, checked frames of each)
        gaps, path = np.concatenate(gaps, 1), np.concatenate(path, 1)
        stream_p50 = np.median(gaps, axis=1)
        self.notes.update(frames=int(gaps.size), same_path=int(path.sum()),
                          stream_p50=stream_p50.tolist())
        return {"pose_gap_stream_p50_max": float(stream_p50.max()),
                "off_path_share": float(1.0 - path.mean()),
                "pose_gap_same_path": float(gaps[path].max(initial=0.0))}

    def replay(self, start, rel, sums=torch.float64):
        """The reference's answers for one call's frames of every stream,
        each frame started where the program started it (``rel``: the
        program's (S, F - 1, 4, 4) answers): (rel (S, F - 1, 4, 4)
        float64, iterations (S, F - 1, levels))."""
        cfg = self.cell["config"]
        st = tracker.Settings.of(cfg["tracker"])
        F = self.p["frames_per_call"]
        Ks = [k.to(self.device) for k in tracker.level_intrinsics(
            cfg["camera"]["intrinsics"], st.num_levels)]
        S = self.ring_i.shape[0]
        eye = torch.eye(4, dtype=torch.float32)
        inits = torch.as_tensor(np.asarray(rel, np.float32))
        if not cfg["tracker"]["use_initial_estimate"]:
            inits = eye.expand_as(inits)
        inits = torch.cat([eye.expand(S, 1, 4, 4), inits[:, :-1]], 1)
        rows = [(s, k) for s in range(S) for k in range(1, F)]
        out_T = torch.empty(S, F - 1, 4, 4, dtype=torch.float64)
        out_it = torch.empty(S, F - 1, len(st.levels), dtype=torch.int64)
        for b in range(0, len(rows), self.p["check_rows"]):
            chunk = rows[b:b + self.p["check_rows"]]
            s_idx = torch.tensor([r[0] for r in chunk])
            k_idx = torch.tensor([r[1] for r in chunk])
            ring_i = self.ring_i[:, start:start + F]
            # The card indexes no 16-bit unsigned tensor: gather the
            # depth's bits as 16-bit signed ones.
            ring_z = self.ring_z[:, start:start + F].view(torch.int16)

            def frames(k):
                return (ring_i[s_idx, k],
                        ring_z[s_idx, k].view(torch.uint16))

            ref = pyramid.pyramid(*frames(k_idx - 1), st.num_levels)
            cur = pyramid.pyramid(*frames(k_idx), st.num_levels)
            res = tracker.track(ref, cur, Ks,
                                inits[s_idx, k_idx - 1].to(self.device), st,
                                sums)
            out_T[s_idx, k_idx - 1] = res["T"].double().cpu()
            out_it[s_idx, k_idx - 1] = res["iterations"].cpu()
        return out_T, out_it

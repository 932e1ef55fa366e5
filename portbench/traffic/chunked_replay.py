"""Offline DVO-SLAM replay, the frames handed over in chunks.

One sequence of the synthetic protocol is rendered on the card in set-up
and held as 8-bit intensity and 16-bit depth in pinned host memory. The
window replays it again and again, closed loop, each time through a new
``ChunkedKeyframeSlam`` (a replay service starts every recording on a
fresh map): chunks of ``chunk`` frames go to ``submit_chunk`` with
``depth`` chunks in flight, are collected in order with
``collect_chunk``, and the sequence ends with ``finish()``, which collects
the last chunk and runs the final graph solve. The uploads from pinned
memory are the program's own staging, inside the window. Once the window
is due, no further chunk is submitted: the sequence in hand is finished,
and the window closes when ``finish()`` returns. The first sequence runs
whole, however short the window.

A frame's latency runs from the start of the call that handed it over to
the return of the call that gave its pose back: ``collect_chunk``, or
``finish()`` for the frames of a sequence's last chunk.

The check, after the window (the system's state freed first):

- ``pyramid_max_abs``: the keyframe pyramids kept from each sequence (two
  a sequence, drawn from the seed) against the reference's pyramids of
  the same raw frames; a NaN where the other has none counts as inf.
- ``switch_mismatches``: the reference replays the keyframe front end over
  ``check_frames`` frames from a keyframe switch drawn from the seed, with
  no state of the system (the new keyframe is the whole of the front
  end's state there, but for the odometry warm start, which starts from
  the identity); every replayed frame of every sequence at which the
  system's keyframe decision differs from the reference's, except at a
  tie (within 1e-4 of a threshold: there the replay follows the
  system's decision).
- ``frame_pose_gap_p50``: for every two consecutive frames returned by
  one ``collect_chunk`` (same keyframe, no switch between them; the poses
  ``finish()`` returns are refined by the back end and left out), the
  motion between their returned world poses against the reference's, as
  the twist norm of the difference; the median over every sequence. (A
  level's Gauss-Newton loop that stops on a step raising the error at the
  float32 noise floor is decided by the last bits of a sum; two sound
  trackers then part by up to a few millimetres on a few frames, and the
  warm starts carry it to the next: the largest gap swings from run to
  run, the median does not.)
- ``graph_polish_gap``: the reference's pose-graph solve, in float64, of
  that sequence's final graph (its edges, informations and masks as the
  system left them), started from the keyframe poses ``finish()``
  returned; the largest move of a keyframe.
"""

from __future__ import annotations

import math
import time
from collections import deque

import numpy as np
import torch

from portbench.reference import evaluate, pose_graph, pyramid, scan, se3
from portbench.reference import tracker
from portbench.trace import null_span
from portbench.traffic import scene

SLAB_MODEL = "shared_side"


class Driver:
    def __init__(self, cell, device="cuda"):
        from dvo_slam_tpu_torch import SlamConfig, TrackerConfig
        from dvo_slam_tpu_torch.models.chunked_slam import \
            ChunkedKeyframeSlam

        cfg, p = cell["config"], cell["params"]
        self.cell, self.p = cell, p
        self.device = torch.device(device)
        cam, proto = cfg["camera"], cfg["protocol"]
        n, lap = p["frames"], proto["orbit"]["frames_per_lap"]
        self.n = n
        self.poses_gt = scene.orbit(n, proto["orbit"]["radius"],
                                    proto["orbit"]["yaw_amplitude"],
                                    n / lap)
        pin = self.device.type == "cuda"
        shape = (n, cam["height"], cam["width"])
        self.intensity = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
        self.depth = torch.empty(shape, dtype=torch.uint16, pin_memory=pin)
        scene.frames(proto, cam, self.poses_gt.to(self.device),
                     scene.generator(cell["seed"], self.device),
                     self.intensity, self.depth)
        if pin:
            torch.cuda.synchronize()
        self.stamps = [k / cam["hz"] for k in range(n)]
        K = np.asarray(cam["intrinsics"], np.float32)
        tcfg, scfg = TrackerConfig(**cfg["tracker"]), SlamConfig(**cfg["slam"])

        def make():
            return ChunkedKeyframeSlam(K, tcfg, scfg, device=str(device))

        self.make = make
        self.rng = np.random.default_rng(cell["seed"])
        # Warm-up: one whole sequence, the window's own work and shapes.
        self._sequence(null_span, math.inf, [])

    def _sequence(self, span, deadline, lat):
        """One pass over the sequence (cut short at the deadline): returns
        what the check reads, and appends each frame's latency to lat."""
        p = self.p
        c, depth_q = p["chunk"], p["depth"]
        with span("engine.new"):
            eng = self.make()
        poses = [None] * self.n
        call_of = [-1] * self.n
        inflight = deque()
        calls = 0

        def collect():
            nonlocal calls
            s, m, t = inflight.popleft()
            with span("engine.collect_chunk"):
                out = eng.collect_chunk()
            t1 = time.perf_counter()
            calls += 1
            for k, P in enumerate(out):
                poses[s + k] = P
                call_of[s + k] = calls
            lat.extend([t1 - t] * m)

        end = 0
        for s in range(0, self.n, c):
            if s and time.perf_counter() >= deadline:
                break
            m = min(c, self.n - s)
            t = time.perf_counter()
            with span("engine.submit_chunk"):
                eng.submit_chunk(self.intensity[s:s + m], self.depth[s:s + m],
                                 self.stamps[s:s + m])
            inflight.append((s, m, t))
            end = s + m
            if len(inflight) >= depth_q:
                collect()
        while len(inflight) > 1:
            collect()
        s, m, t = inflight.popleft()
        with span("engine.finish"):
            traj = eng.finish()
        t1 = time.perf_counter()
        lat.extend([t1 - t] * m)
        for k in range(s, s + m):
            # finish() returns the last chunk's poses refined by the window
            # and graph solves: no pair of them is the front end's.
            poses[k] = traj[k][1]
            call_of[k] = -1 - k
        kf_frames = [int(round(kf.timestamp * self.cell["config"]["camera"]
                               ["hz"])) for kf in eng.keyframes]
        keep = self.rng.choice(len(eng.keyframes),
                               size=min(2, len(eng.keyframes)),
                               replace=False)
        return {
            "frames": end, "poses": poses[:end], "call_of": call_of[:end],
            "trajectory": [P for _, P in traj], "kf_frames": kf_frames,
            "graph": eng.graph, "loop_edges": eng.num_loop_edges,
            "pyramids": [(kf_frames[i], eng.keyframes[i].pyramid)
                         for i in sorted(keep)],
        }

    def run(self, seconds, tracer):
        """The measured window: returns its record."""
        p = self.p
        lat, seqs = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if len(seqs) == p["trace_from"]:
                tracer.start()
            # The first sequence runs whole, whatever the window's length,
            # and so does each traced one.
            whole = not seqs or tracer.active
            seqs.append(self._sequence(tracer.span,
                                       math.inf if whole else deadline, lat))
            if tracer.active and len(seqs) == p["trace_from"] + p[
                    "trace_sequences"]:
                self._stop(tracer, seqs[p["trace_from"]:])
            if time.perf_counter() >= deadline and not tracer.owed:
                break
        window_s = time.perf_counter() - t0
        attempted = sum(s["frames"] for s in seqs)
        failed = sum(1 for s in seqs for P in s["poses"]
                     if P is None or not np.isfinite(P).all())
        return {"window_s": window_s, "latencies_s": lat,
                "attempted": attempted, "returned": attempted - failed,
                "failed": failed, "sequences": seqs}

    def _stop(self, tracer, seqs):
        cfg = self.cell["config"]
        tracer.stop(frames=sum(s["frames"] for s in seqs),
                    sequences=sum(s["frames"] == self.n for s in seqs),
                    slab_model=SLAB_MODEL, camera=cfg["camera"],
                    tracked_levels=list(range(
                        cfg["tracker"]["last_level"],
                        cfg["tracker"]["first_level"] + 1)))

    # -- the check ------------------------------------------------------

    def check(self, window, sums=torch.float64):
        """The numbers compared with their limits (module docstring)."""
        seqs = window["sequences"]
        cfg = self.cell["config"]
        st = tracker.Settings.of(cfg["tracker"])
        dev = self.device
        out = {"pyramid_max_abs": self._pyramids(seqs, st)}
        for s in seqs:
            s["pyramids"] = None
        full = [s for s in seqs if s["frames"] == self.n] or seqs
        # The replay starts at a keyframe switch drawn from the seed, where
        # the front end's state is the new keyframe alone (its odometry
        # warm start starts from the identity there).
        kf = full[0]["kf_frames"]
        a = int(self.rng.choice([f for f in kf if f + 1 < full[0]["frames"]]
                                or [0]))
        b = min(a + self.p["check_frames"], max(s["frames"] for s in seqs))
        ref = scan.replay(self.intensity[a:b].to(dev),
                          self.depth[a:b].to(dev),
                          cfg["camera"]["intrinsics"], st, cfg["slam"], sums,
                          follow=[f - a for f in kf if a <= f < b])
        ref["first"] = a
        out["switch_mismatches"], out["frame_pose_gap_p50"] = \
            self._front(seqs, ref)
        self._replayed = ref
        pick = self._pick = full[int(self.rng.integers(len(full)))]
        out["graph_polish_gap"] = self._polish(pick)
        ate = evaluate.ate_rmse(pick["trajectory"],
                                self.poses_gt[:len(pick["trajectory"])])
        self.notes = {"ate_m": ate, "keyframes": len(pick["kf_frames"]),
                      "loop_edges": pick["loop_edges"],
                      "sequences": len(seqs), "ties": ref["ties"],
                      "pairs": self.pairs}
        return out

    def control(self, window):
        """The control's readings: the reference one step below the
        configuration's precision (``reference.precision.control``: its
        sums in float32, its products in TF32) in the program's place,
        judged as the program is. Its front end replays the checked frames
        on its own decisions; its graph is its own solve, in float32, of
        the system's final graph from the poses ``finish()`` returned. Run
        after ``check`` (its replay and its drawn sequence)."""
        from portbench.reference import precision

        cfg = self.cell["config"]
        st = tracker.Settings.of(cfg["tracker"])
        ref = self._replayed
        a, n = ref["first"], ref["rel"].shape[0]
        pick = self._pick
        g = pick["graph"]
        ne = int(g.num_edges)
        P = np.stack([pick["trajectory"][f] for f in pick["kf_frames"]])
        with precision.control():
            ctl = scan.replay(self.intensity[a:a + n].to(self.device),
                              self.depth[a:a + n].to(self.device),
                              cfg["camera"]["intrinsics"], st, cfg["slam"],
                              torch.float32)
            P_c = pose_graph.polish(
                P, g.edge_i[:ne], g.edge_j[:ne], g.measurements[:ne],
                g.information[:ne], g.edge_mask[:ne],
                cauchy_c=cfg["slam"]["cauchy_c"], dtype=torch.float32,
                device=self.device)
        mismatches = int(((ctl["own"] != ref["own"]) & ~ref["tie"]).sum())
        parted = np.flatnonzero(ctl["switch"] != ref["switch"])
        stop = int(parted[0]) if len(parted) else n
        k = torch.as_tensor([k for k in range(1, stop)
                             if not ref["switch"][k]])
        gap = 0.0
        if len(k):
            got = ctl["rel"][k - 1] @ se3.inverse(ctl["rel"][k])
            want = ref["rel"][k - 1] @ se3.inverse(ref["rel"][k])
            gap = float(se3.gap(got, want).median())
        return {"pyramid_max_abs": 0.0, "switch_mismatches": mismatches,
                "frame_pose_gap_p50": gap,
                "graph_polish_gap": self._polish(pick, P_c.double().cpu())}

    def _raw(self, frames):
        return (self.intensity[frames].to(self.device),
                self.depth[frames].to(self.device))

    def _pyramids(self, seqs, st):
        worst = 0.0
        for s in seqs:
            for f, pyr in s["pyramids"] or ():
                i, z = self._raw([f])
                ref = pyramid.pyramid(i[0], z[0], st.num_levels)
                for a, b in zip(pyr, ref):
                    worst = max(worst, _max_abs(torch.as_tensor(a), b))
        return worst

    def _front(self, seqs, ref):
        """(switch mismatches, median frame-pair gap) over every
        sequence's frames that the reference replayed (frame ``first``
        on, the replay's frame 0)."""
        own, tie, followed = ref["own"], ref["tie"], ref["switch"]
        rel, a = ref["rel"].cpu(), ref["first"]
        mismatches, gaps = 0, []
        for s in seqs:
            m = min(len(own), s["frames"] - a)
            if m < 2:
                continue
            sw = np.zeros(m, bool)
            sw[[f - a for f in s["kf_frames"] if a <= f < a + m]] = True
            for k in range(1, m):
                if sw[k] != bool(own[k]) and not bool(tie[k]):
                    mismatches += 1
            # Compare pairs until this sequence leaves the followed keyframes.
            parted = np.flatnonzero(sw != followed[:m])
            stop = int(parted[0]) if len(parted) else m
            P = torch.as_tensor(np.stack(s["poses"][a:a + stop]))
            calls = s["call_of"][a:a + stop]
            pairs = [k for k in range(1, stop)
                     if not sw[k] and calls[k] == calls[k - 1]]
            if not pairs:
                continue
            k = torch.as_tensor(pairs)
            prog = se3.inverse(P[k - 1]) @ P[k]
            want = rel[k - 1] @ se3.inverse(rel[k])
            gaps.append(se3.gap(prog, want).numpy())
        gaps = np.concatenate(gaps) if gaps else np.zeros(1)
        self.pairs = int(gaps.size)
        return mismatches, float(np.median(gaps))

    def _polish(self, seq, P=None):
        """The largest move of a keyframe in the reference's solve of the
        sequence's final graph from the poses ``finish()`` returned (or
        from ``P``)."""
        g = seq["graph"]
        ne = int(g.num_edges)
        if P is None:
            P = np.stack([seq["trajectory"][f] for f in seq["kf_frames"]])
        slam = self.cell["config"]["slam"]
        out = pose_graph.polish(P, g.edge_i[:ne], g.edge_j[:ne],
                                g.measurements[:ne], g.information[:ne],
                                g.edge_mask[:ne],
                                cauchy_c=slam["cauchy_c"])
        return float(se3.gap(torch.as_tensor(P), out).max())


def _max_abs(a, b):
    """Largest |a - b| of two float tensors, inf where one is NaN and the
    other not."""
    a = a.to(b.device, torch.float32)
    na, nb = torch.isnan(a), torch.isnan(b)
    if bool((na != nb).any()):
        return math.inf
    d = torch.where(na, 0.0, (a - b).abs())
    return float(d.max())

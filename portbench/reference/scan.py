"""Plain keyframe front end of DVO-SLAM (Kerl, Sturm, Cremers, IROS 2013):
each new frame is tracked against the active keyframe and against the
previous frame (warm-started from the last frame-to-frame motion), the
two estimates are fused by their information, and the frame becomes the
new keyframe when the keyframe alignment fails, tracks too few points, or
its pose entropy degrades past the threshold relative to the first frame
tracked against that keyframe.

``replay`` runs the whole front end over a sequence with no state from
the system under test, except at a tie: where the entropy ratio or the
valid-point ratio lies within ``tie`` of its threshold, the decision
follows the system's own (``follow``) and is counted as a tie, not as a
mismatch, since the last bits of a sum decide it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import pyramid, se3, tracker
from portbench.reference.precision import mm

_ENTROPY_FLOOR = 1.0


def fuse(T_a, info_a, T_b, info_b):
    """Information-weighted fusion of two estimates of one pose: one
    Gauss-Newton step from T_a, in the informations' dtype."""
    dt = info_a.dtype
    T_a, T_b = T_a.to(dt), T_b.to(dt)
    xi = se3.log(mm(T_b, se3.inverse(T_a)))
    L = (info_a + info_b).cpu().numpy()
    try:
        delta = np.linalg.solve(L, mm(info_b, xi[:, None])[:, 0]
                                .cpu().numpy())
    except np.linalg.LinAlgError:
        delta = np.zeros(6)
    if not np.isfinite(delta).all():
        delta = np.zeros(6)
    return mm(se3.exp(torch.as_tensor(delta, dtype=dt, device=T_a.device)),
              T_a)


def replay(intensity, depth, K, st: tracker.Settings, slam: dict,
           sums=torch.float64, follow=None, tie=1e-4):
    """The front end over a (T, H, W) sequence of raw frames on one
    device, its frame 0 the first keyframe. ``follow``: the frame indices at which the system
    under test switched keyframes (or None). Returns a dict: rel (T, 4, 4)
    float64, each frame's pose relative to its keyframe (frame-camera <-
    keyframe-camera; the identity at a switch); as (T,) bool numpy arrays
    the switches the replay made (``switch``: its own decisions, or the
    followed ones where they part), its own decisions (``own``) and the
    frames whose decision was a tie (``tie``); and the counts of
    mismatched and tied decisions against ``follow``."""
    n = intensity.shape[0]
    dev = intensity.device
    Ks = tracker.level_intrinsics(K, st.num_levels)
    Ks = [k.to(dev) for k in Ks]
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    min_er = slam["min_entropy_ratio"]
    min_cr = slam["min_constraint_ratio"]
    follow = None if follow is None else set(int(f) for f in follow)

    def pyr(k):
        return pyramid.pyramid(intensity[k], depth[k], st.num_levels)

    kf = prev = pyr(0)
    T_kf_prev, last_odo = eye, eye
    H_first, has_first = 0.0, False
    rel = [torch.eye(4, dtype=torch.float64, device=dev)]
    switch, own, tied = [True], [True], [False]
    mismatches = ties = 0
    for k in range(1, n):
        cur = pyr(k)
        ref = [torch.stack([a, b]) for a, b in zip(kf, prev)]
        res = tracker.track(ref, cur, Ks, torch.stack([T_kf_prev, last_odo]),
                            st, sums)
        kf_nan, odo_nan = (bool(x) for x in res["nan"].tolist())
        T_kf, T_odo = res["T"][0], res["T"][1]
        if not odo_nan:
            last_odo = T_odo
        vr = float(res["valid_ratio"][0])
        h = float(res["entropy"][0])
        accept = (not kf_nan) and vr >= min_cr
        ratio = 1.0
        if accept and has_first:
            ratio = (1.0 - (h - H_first) / max(abs(H_first), _ENTROPY_FLOOR)
                     if math.isfinite(h) else -math.inf)
        sw = (not accept) or ratio < min_er
        near = ((not kf_nan) and abs(vr - min_cr) < tie) or (
            accept and has_first and abs(ratio - min_er) < tie)
        own.append(sw)
        tied.append(near)
        if follow is not None and sw != (k in follow):
            if near:
                ties += 1
            else:
                mismatches += 1
            sw = k in follow
        T_alt = mm(T_odo, T_kf_prev)
        fused = (T_kf.double() if odo_nan else
                 fuse(T_kf, res["information"][0], T_alt,
                      res["information"][1]))
        if accept and not has_first and math.isfinite(h):
            H_first, has_first = h, True
        if sw:
            kf = cur
            T_kf_prev = eye
            H_first, has_first = 0.0, False
            rel.append(torch.eye(4, dtype=torch.float64, device=dev))
        else:
            T_kf_prev = fused.to(torch.float32)
            rel.append(fused.double())
        switch.append(sw)
        prev = cur
    return {"rel": torch.stack(rel), "switch": np.array(switch),
            "own": np.array(own), "tie": np.array(tied),
            "mismatches": mismatches, "ties": ties}

"""Trajectory evaluation: ATE and RPE.

Reimplements the TUM RGB-D benchmark's de-facto oracles (evaluate_ate.py /
evaluate_rpe.py from the dataset website — the reference repo's only
validation mechanism, SURVEY.md §5): absolute trajectory error RMSE after
rigid Horn/Umeyama alignment, and relative pose error over a fixed frame
delta. Host-side NumPy, double precision.

Numpy-only copy of ``dvo_slam_tpu/utils/evaluate.py`` for the PyTorch
port, which must run where JAX is not installed: importing anything
from ``dvo_slam_tpu`` imports jax through its ``__init__``. The code
below is the original; tests/test_torch_utils.py holds it
to the original function by function.
"""

from __future__ import annotations

import numpy as np

from dvo_slam_tpu_torch.utils import se3_np


def umeyama_alignment(src, dst, with_scale=False):
    """Least-squares rigid alignment src -> dst.

    src, dst: (N, 3). Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(estimated, groundtruth, with_scale=False):
    """Absolute trajectory error RMSE (meters) after rigid alignment.

    estimated/groundtruth: lists or arrays of 4x4 camera-to-world poses
    (already associated 1:1).
    """
    est_t = np.array([T[:3, 3] for T in estimated])
    gt_t = np.array([T[:3, 3] for T in groundtruth])
    s, R, t = umeyama_alignment(est_t, gt_t, with_scale=with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = aligned - gt_t
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(estimated, groundtruth, delta=1, timestamps=None, per_second=False,
        max_pairs=10000, seed=0):
    """Relative pose error (TUM evaluate_rpe.py semantics).

    Default: fixed FRAME delta (`delta` an integer index offset) over all
    consecutive pairs — the quick sanity metric.

    per_second=True reproduces the TUM tool's published protocol
    (evaluate_rpe.py --fixed_delta --delta 1 --delta_unit s): `delta` is
    in SECONDS, the pair for index i is the pose whose timestamp is
    closest to t_i + delta, and at most `max_pairs` pairs are used
    (random downsampling with a fixed seed, matching the tool's
    max_pairs behaviour deterministically). Requires `timestamps`.
    The result is the raw error over one `delta`-second interval — NOT
    divided by delta, matching evaluate_rpe.py. At the published
    protocol's delta = 1 s it therefore reads directly as translational
    drift in m/s / rotational drift in rad/s (IROS13 tables).

    Returns (trans_rmse, rot_rmse).
    """
    n = len(estimated)
    if per_second:
        if timestamps is None:
            raise ValueError("per_second RPE requires timestamps")
        ts = np.asarray(timestamps, np.float64)
        targets = ts + float(delta)
        # Closest-timestamp pairing (TUM find_closest_index), vectorized.
        js = np.searchsorted(ts, targets)
        # Tolerance: drop pairs whose realized gap deviates >20% from the
        # requested delta (the sequence tail, association holes). The TUM
        # script keeps the clamped tail pairs; on its long sequences the
        # difference is negligible, and dropping them is more faithful to
        # "drift per second" on short ones.
        tol = 0.2 * float(delta)
        pairs = []
        for i in range(n):
            j = js[i]
            best = None
            for cand in (j - 1, j):
                if 0 <= cand < n and cand > i:
                    d = abs(ts[cand] - targets[i])
                    if best is None or d < best[1]:
                        best = (cand, d)
            if best is not None and best[1] <= tol:
                pairs.append((i, best[0]))
        if not pairs:
            raise ValueError("no pose pairs span the requested time delta")
        if max_pairs and len(pairs) > max_pairs:
            rng = np.random.default_rng(seed)
            keep = rng.choice(len(pairs), size=max_pairs, replace=False)
            pairs = [pairs[k] for k in sorted(keep)]
    else:
        delta = int(delta)
        if delta < 1 or n - delta < 1:
            raise ValueError(
                f"rpe needs at least delta+1 poses (got {n} poses, delta={delta})"
            )
        pairs = [(i, i + delta) for i in range(n - delta)]

    trans_err, rot_err = [], []
    for i, j in pairs:
        est_rel = se3_np.inverse(estimated[i]) @ estimated[j]
        gt_rel = se3_np.inverse(groundtruth[i]) @ groundtruth[j]
        e = se3_np.inverse(gt_rel) @ est_rel
        trans_err.append(np.linalg.norm(e[:3, 3]))
        cos_r = np.clip((np.trace(e[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        rot_err.append(np.arccos(cos_r))
    trans_err = np.asarray(trans_err)
    rot_err = np.asarray(rot_err)
    return float(np.sqrt((trans_err**2).mean())), float(np.sqrt((rot_err**2).mean()))

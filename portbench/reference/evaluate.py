"""Absolute trajectory error (the TUM RGB-D benchmark's evaluate_ate.py):
RMSE of the camera positions after the rigid Horn/Umeyama alignment of
the estimate to the ground truth, in float64 numpy. Printed beside a
run's result for orientation; ``correct`` does not read it."""

from __future__ import annotations

import numpy as np


def ate_rmse(estimated, groundtruth):
    """estimated, groundtruth: (N, 4, 4) camera-to-world poses, associated
    one to one. Metres."""
    src = np.asarray(estimated, np.float64)[:, :3, 3]
    dst = np.asarray(groundtruth, np.float64)[:, :3, 3]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    err = (R @ xs.T).T + mu_d - dst
    return float(np.sqrt((err ** 2).sum(1).mean()))

"""Host-side double-precision SE(3) (NumPy).

The reference keeps all pose bookkeeping in Eigen doubles; on TPU the device
runs f32, so global pose chains (trajectory accumulation, keyframe poses,
TUM serialization) stay on the host in f64 (SURVEY.md §8.1 / §8.3.3). Same
(v, w) translation-first twist convention as ops/se3.py.

Numpy-only copy of ``dvo_slam_tpu/utils/se3_np.py`` for the PyTorch
port, which must run where JAX is not installed: importing anything
from ``dvo_slam_tpu`` imports jax through its ``__init__``. The code
below is the original; tests/test_torch_utils.py holds it
to the original function by function.
"""

from __future__ import annotations

import numpy as np


def hat(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], dtype=np.float64
    )


def exp(xi):
    """se(3) exp: (6,) -> (4, 4), translation-first twist."""
    xi = np.asarray(xi, dtype=np.float64)
    v, w = xi[:3], xi[3:]
    theta_sq = float(w @ w)
    W = hat(w)
    W2 = W @ W
    if theta_sq < 1e-12:
        a = 1.0 - theta_sq / 6.0
        b = 0.5 - theta_sq / 24.0
        c = 1.0 / 6.0 - theta_sq / 120.0
    else:
        theta = np.sqrt(theta_sq)
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta_sq
        c = (theta - np.sin(theta)) / (theta_sq * theta)
    R = np.eye(3) + a * W + b * W2
    V = np.eye(3) + b * W + c * W2
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def log(T):
    """SE(3) log: (4, 4) -> (6,) twist (v, w).

    The rotation log goes through the quaternion (rot_to_quat is stable
    in every trace regime), NOT the arccos + vee(R - R^T) form: that form
    returns a ZERO rotation vector at theta = pi (R is symmetric there)
    and garbage just below it. This matters because the loop-closure
    CrossValidationVoter thresholds ||log(T_fwd @ T_bwd)|| — a maximally
    inconsistent fwd/bwd pair (~180 deg apart) must read as ~pi, not 0,
    or the voter fails open (models/constraints.py).
    """
    T = np.asarray(T, dtype=np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    q = rot_to_quat(R)
    qv, qw = q[:3], q[3]
    if qw < 0.0:  # double cover: pick the short rotation
        qv, qw = -qv, -qw
    s = np.linalg.norm(qv)
    theta = 2.0 * np.arctan2(s, qw)
    # theta/s -> 2 as s -> 0 (qw ~ 1 after the sign fix above).
    w = (theta / s) * qv if s >= 1e-9 else 2.0 * qv
    theta_sq = theta * theta
    W = hat(w)
    if theta < 1e-4:
        coef = 1.0 / 12.0 + theta_sq / 720.0
    else:
        # V^{-1} = I - W/2 + coef W^2 in the form whose denominator
        # 1 - cos(theta) -> 2 at theta = pi (the classic
        # 1/t^2 - (1+cos t)/(2 t sin t) form divides by sin(theta) = 0).
        coef = (
            1.0 - (theta * np.sin(theta)) / (2.0 * (1.0 - np.cos(theta)))
        ) / theta_sq
    V_inv = np.eye(3) - 0.5 * W + coef * (W @ W)
    return np.concatenate([V_inv @ t, w])


def inverse(T):
    T = np.asarray(T, dtype=np.float64)
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def inverse_batch(T):
    """(E, 4, 4) -> (E, 4, 4) rigid inverses."""
    T = np.asarray(T, dtype=np.float64)
    Rt = np.swapaxes(T[:, :3, :3], 1, 2)
    out = np.broadcast_to(np.eye(4), T.shape).copy()
    out[:, :3, :3] = Rt
    out[:, :3, 3] = -np.einsum("eij,ej->ei", Rt, T[:, :3, 3])
    return out


def rot_to_quat_batch(R):
    """(E, 3, 3) -> (E, 4) unit quaternions [qx, qy, qz, qw].

    Vectorized rot_to_quat: evaluates all four numerically-stable branches
    and selects per row with the scalar version's branch conditions
    (sqrt arguments are clamped so the unselected branches never produce
    NaN). Agrees with rot_to_quat to f64 rounding on every trace regime.
    """
    R = np.asarray(R, dtype=np.float64)
    E = R.shape[0]
    t = np.trace(R, axis1=1, axis2=2)
    r00, r11, r22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    a0 = R[:, 2, 1] - R[:, 1, 2]
    a1 = R[:, 0, 2] - R[:, 2, 0]
    a2 = R[:, 1, 0] - R[:, 0, 1]
    b01 = R[:, 0, 1] + R[:, 1, 0]
    b02 = R[:, 0, 2] + R[:, 2, 0]
    b12 = R[:, 1, 2] + R[:, 2, 1]

    def s_of(arg):
        return np.sqrt(np.maximum(arg, 1e-300)) * 2.0

    s0 = s_of(t + 1.0)
    q0 = np.stack([a0 / s0, a1 / s0, a2 / s0, 0.25 * s0], axis=1)
    s1 = s_of(1.0 + r00 - r11 - r22)
    q1 = np.stack([0.25 * s1, b01 / s1, b02 / s1, a0 / s1], axis=1)
    s2 = s_of(1.0 + r11 - r00 - r22)
    q2 = np.stack([b01 / s2, 0.25 * s2, b12 / s2, a1 / s2], axis=1)
    s3 = s_of(1.0 + r22 - r00 - r11)
    q3 = np.stack([b02 / s3, b12 / s3, 0.25 * s3, a2 / s3], axis=1)

    branch = np.where(
        t > 0, 0,
        np.where((r00 > r11) & (r00 > r22), 1, np.where(r11 > r22, 2, 3)),
    )
    q = np.choose(branch[:, None], [q0, q1, q2, q3])
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def log_batch(T):
    """(E, 4, 4) -> (E, 6) twists (v, w): vectorized `log`.

    Same quaternion-based rotation log and theta=pi-stable V^{-1} series
    as the scalar version (see log's docstring); used on host paths that
    touch EVERY graph edge per call (outlier-edge masking) where a Python
    per-edge loop dominates keyframe-switch time at thousands of edges.
    """
    T = np.asarray(T, dtype=np.float64)
    E = T.shape[0]
    if E == 0:
        return np.zeros((0, 6))
    q = rot_to_quat_batch(T[:, :3, :3])
    flip = q[:, 3] < 0.0
    q = np.where(flip[:, None], -q, q)
    qv, qw = q[:, :3], q[:, 3]
    s = np.linalg.norm(qv, axis=1)
    theta = 2.0 * np.arctan2(s, qw)
    w = np.where(
        (s >= 1e-9)[:, None],
        (theta / np.maximum(s, 1e-300))[:, None] * qv,
        2.0 * qv,
    )
    theta_sq = theta * theta
    W = np.zeros((E, 3, 3))
    W[:, 0, 1], W[:, 0, 2] = -w[:, 2], w[:, 1]
    W[:, 1, 0], W[:, 1, 2] = w[:, 2], -w[:, 0]
    W[:, 2, 0], W[:, 2, 1] = -w[:, 1], w[:, 0]
    small = theta < 1e-4
    denom = 2.0 * (1.0 - np.cos(theta))
    coef = np.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - (theta * np.sin(theta)) / np.maximum(denom, 1e-300))
        / np.maximum(theta_sq, 1e-300),
    )
    V_inv = np.eye(3) - 0.5 * W + coef[:, None, None] * (W @ W)
    v = np.einsum("eij,ej->ei", V_inv, T[:, :3, 3])
    return np.concatenate([v, w], axis=1)


def quat_to_rot(q):
    """Unit quaternion [qx, qy, qz, qw] (TUM order) -> rotation matrix."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def rot_to_quat(R):
    """Rotation matrix -> unit quaternion [qx, qy, qz, qw] (TUM order)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def pose_to_matrix(t, q):
    """TUM pose (translation, quaternion xyzw) -> 4x4 matrix."""
    T = np.eye(4)
    T[:3, :3] = quat_to_rot(q)
    T[:3, 3] = np.asarray(t, dtype=np.float64)
    return T


def matrix_to_pose(T):
    """4x4 matrix -> (translation (3,), quaternion xyzw (4,))."""
    return np.asarray(T[:3, 3], dtype=np.float64), rot_to_quat(T[:3, :3])


def renormalize(T):
    """Project the rotation block of a (4, 4) transform back onto SO(3)
    via SVD (f32 device solves drift off the manifold; host pose chains
    re-project before composing)."""
    T = np.asarray(T, np.float64)
    U, _, Vt = np.linalg.svd(T[:3, :3])
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = T[:3, 3]
    return out

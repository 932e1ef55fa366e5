"""SE(3) Lie-group operations (counterpart of ``dvo_slam_tpu/ops/se3.py``).

Translation-first twists xi = (v, w); exp(xi^) acts as a LEFT increment,
T <- exp(xi^) @ T. Every function works over leading batch dimensions in
the input dtype (f32 on the device). Matrix products run in full f32: the
package pins TF32 off at import.
"""

from __future__ import annotations

import torch


def hat(w):
    """so(3) hat operator: (..., 3) -> (..., 3, 3). Three device ops (one
    negation, one zero, one stack): it runs in every IRLS iteration."""
    wx, wy, wz = w.unbind(-1)
    nx, ny, nz = (-w).unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([z, nz, wy, wz, z, nx, ny, wx, z],
                       dim=-1).reshape(*w.shape[:-1], 3, 3)


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_coefficients(theta_sq):
    """Taylor-safe (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, 1.0, theta_sq)
    safe_t = torch.sqrt(safe_sq)
    sin_t = torch.sin(safe_t)
    a = torch.where(small, 1.0 - theta_sq / 6.0, sin_t / safe_t)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe_t)) / safe_sq)
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (safe_t - sin_t) / (safe_sq * safe_t),
    )
    return a, b, c


def _eye3_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _homogeneous(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4) with bottom row [0, 0, 0, 1].
    The row is made on the device: writing a Python 1.0 into a CUDA tensor
    copies it from the host, a synchronizing copy."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)


def exp(xi):
    """se(3) exponential map: (..., 6) twist (v, w) -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, c = _so3_coefficients(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., :, None])[..., 0]
    return _homogeneous(R, t)


def log_so3(R):
    """SO(3) logarithm: (..., 3, 3) -> (..., 3).

    Both branches are parameterized by u = 1 - cos(theta), as in the JAX
    package (keeps the small-angle branch's tangent polynomial at the
    identity). Near theta = pi the arccos/sin form loses ~1/sin(theta)
    digits.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    u = torch.clamp((3.0 - trace) * 0.5, 0.0, 2.0)  # u = 1 - cos(theta)
    small = u < 1e-6
    u_safe = torch.where(small, torch.ones_like(u), u)
    theta = torch.arccos(1.0 - u_safe)
    sin_theta = torch.sqrt(u_safe * (2.0 - u_safe))
    theta_sq_small = 2.0 * u + u * u / 3.0
    factor = torch.where(
        small,
        0.5 + theta_sq_small / 12.0
        + 7.0 * theta_sq_small * theta_sq_small / 720.0,
        theta / (2.0 * sin_theta),
    )
    return factor[..., None] * vee(R - R.transpose(-1, -2))


def log(T):
    """SE(3) logarithm: (..., 4, 4) -> (..., 6) twist (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(theta_sq < 1e-12,
                                   torch.ones_like(theta_sq), theta_sq))
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + coef * W^2,  coef = 1/t^2 - (1+cos t)/(2 t sin t)
    one = torch.ones_like(theta_sq)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / torch.where(small, one, theta_sq))
        - (1.0 + torch.cos(theta))
        / torch.where(small, one, 2.0 * theta * torch.sin(theta)),
    )
    V_inv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * W2
    v = (V_inv @ t[..., :, None])[..., 0]
    return torch.cat([v, w], dim=-1)


def inverse(T):
    """Rigid-transform inverse: (..., 4, 4) -> (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])[..., 0]
    return _homogeneous(Rt, ti)


def adjoint(T):
    """Adjoint of T for the (v, w) twist ordering: (..., 6, 6)."""
    R = T[..., :3, :3]
    tR = hat(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)

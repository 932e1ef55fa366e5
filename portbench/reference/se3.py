"""SE(3) maps for the plain reference, in any float dtype and over leading
batch dimensions. Twists are translation first, xi = (v, w), and exp acts
as a left increment: T <- exp(xi) @ T."""

from __future__ import annotations

import torch

from portbench.reference.precision import mm


def hat(w):
    """(..., 3) -> (..., 3, 3)."""
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(*w.shape[:-1], 3, 3)


def _vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _homogeneous(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)


def exp(xi):
    """(..., 6) -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    s = torch.sin(t)
    a = torch.where(small, 1.0 - t2 / 6.0, s / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - s) / (t2s * t))
    W = hat(w)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return _homogeneous(R, mm(V, v[..., :, None])[..., 0])


def log(T):
    """(..., 4, 4) -> (..., 6)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    u = torch.clamp((3.0 - trace) * 0.5, 0.0, 2.0)  # 1 - cos(theta)
    small = u < 1e-6
    us = torch.where(small, torch.ones_like(u), u)
    theta = torch.arccos(1.0 - us)
    sin_theta = torch.sqrt(us * (2.0 - us))
    t2_small = 2.0 * u + u * u / 3.0
    factor = torch.where(small, 0.5 + t2_small / 12.0
                         + 7.0 * t2_small * t2_small / 720.0,
                         theta / (2.0 * sin_theta))
    w = factor[..., None] * _vee(R - R.transpose(-1, -2))
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    one = torch.ones_like(t2)
    th = torch.sqrt(torch.where(t2 < 1e-12, one, t2))
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       1.0 / torch.where(small, one, t2)
                       - (1.0 + torch.cos(th))
                       / torch.where(small, one, 2.0 * th * torch.sin(th)))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    V_inv = eye - 0.5 * W + coef[..., None, None] * mm(W, W)
    return torch.cat([mm(V_inv, t[..., :, None])[..., 0], w], dim=-1)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -mm(Rt, T[..., :3, 3:4])[..., 0])


def adjoint(T):
    """(..., 4, 4) -> (..., 6, 6) for the (v, w) order."""
    R = T[..., :3, :3]
    top = torch.cat([R, mm(hat(T[..., :3, 3]), R)], dim=-1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], dim=-1)],
                     dim=-2)


def gap(T_a, T_b):
    """The twist norm of T_a^-1 T_b (metres and radians together), in
    float64: how far apart two poses are."""
    T_a, T_b = T_a.double(), T_b.double().to(T_a.device)
    return torch.linalg.vector_norm(log(inverse(T_a) @ T_b), dim=-1)

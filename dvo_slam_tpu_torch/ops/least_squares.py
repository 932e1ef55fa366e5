"""6x6 normal-equation solve (counterpart of
``dvo_slam_tpu/ops/least_squares.py::solve``)."""

from __future__ import annotations

import torch

_JITTER = 1e-8


def solve(A, b, lm_lambda=0.0):
    """Solve A dx = -b with optional Levenberg-Marquardt diagonal damping,
    over leading batch dimensions: A (..., 6, 6), b (..., 6), lm_lambda a
    float or a (...) tensor.

    Jacobi scaling (1/sqrt(diag)) keeps the f32 Cholesky well conditioned.
    A matrix that is not positive definite gives NaN, as JAX's
    ``cho_factor`` does, so the tracker's isfinite guard sees the same
    thing: ``cholesky_ex`` reports the failure in ``info`` instead of
    raising, and no host sync is needed to act on it.
    """
    if isinstance(lm_lambda, torch.Tensor):
        lm_lambda = lm_lambda[..., None]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    # A + lm * diag(A) + jitter * I, written to the diagonal only.
    damped = A.clone()
    damped.diagonal(dim1=-2, dim2=-1).copy_(diag + lm_lambda * diag + _JITTER)
    s = torch.sqrt(torch.clamp(torch.diagonal(damped, dim1=-2, dim2=-1),
                               min=_JITTER)).reciprocal()
    As = damped * s[..., :, None] * s[..., None, :]
    bs = b * s
    L, info = torch.linalg.cholesky_ex(As)
    dx = torch.cholesky_solve(-bs[..., None], L)[..., 0]
    dx = torch.where(info[..., None] == 0, dx, float("nan"))
    return dx * s

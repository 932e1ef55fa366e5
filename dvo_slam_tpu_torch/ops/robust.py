"""Scalar robust scale estimators and influence functions (counterpart of
``dvo_slam_tpu/ops/robust.py``; reference weight_calculation.{h,cpp}).

``ops/linearize.py`` uses these on its non-t-distribution branch (the
default bivariate t-distribution Sigma fixed point is inlined there). All
estimators are masked: statistics divide by the valid count, never the
array size, so fixed-shape masked arrays reproduce the reference's
compacted-array semantics.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    count = torch.clamp(m.sum(), min=1.0)
    return (x * m).sum() / count


def scale_unit(r, mask):
    return torch.ones((), dtype=r.dtype, device=r.device)


def scale_normal(r, mask):
    """Std-dev of valid residuals (NormalDistributionScaleEstimator)."""
    mean = _masked_mean(r, mask)
    var = _masked_mean((r - mean) ** 2, mask)
    return torch.sqrt(var + _EPS)


def scale_mad(r, mask):
    """Median absolute deviation x 1.4826 (MADScaleEstimator), read at
    index valid_count // 2 of the sorted |r| (the reference's
    nth_element(n/2) convention; the upper median for even counts)."""
    absr = torch.where(mask, torch.abs(r), torch.full_like(r, float("inf")))
    sorted_r = torch.sort(absr).values
    count = mask.sum()
    med_idx = torch.minimum(count // 2, torch.clamp(count - 1, min=0))
    med = sorted_r[med_idx]
    return 1.4826 * torch.where(torch.isfinite(med), med,
                                torch.ones_like(med))


def scale_tdist(r, mask, dof=5.0, iters=5):
    """Scalar t-distribution sigma fixed point (TDistributionScaleEstimator):
    sigma^2 <- mean_i [ (dof+1)/(dof + r_i^2/sigma^2) * r_i^2 ]."""
    r2 = torch.where(mask, r * r, torch.zeros_like(r))
    count = torch.clamp(mask.sum().to(r.dtype), min=1.0)
    sigma2 = (r2.sum() / count) + _EPS
    for _ in range(iters):
        w = (dof + 1.0) / (dof + r2 / torch.clamp(sigma2, min=_EPS))
        sigma2 = (w * r2).sum() / count
    return torch.sqrt(sigma2 + _EPS)


def influence_unit(x):
    return torch.ones_like(x)


def influence_huber(x, k=1.345):
    ax = torch.abs(x)
    return torch.where(ax <= k, torch.ones_like(x),
                       k / torch.clamp(ax, min=_EPS))


def influence_tukey(x, b=4.6851):
    t = 1.0 - (x / b) ** 2
    return torch.where(torch.abs(x) <= b, t * t, torch.zeros_like(x))


def influence_tdist(x, dof=5.0):
    return (dof + 1.0) / (dof + x * x)


SCALE_FNS = {
    "unit": scale_unit,
    "normal": scale_normal,
    "mad": scale_mad,
    "tdist": scale_tdist,
}

INFLUENCE_FNS = {
    "unit": influence_unit,
    "huber": influence_huber,
    "tukey": influence_tukey,
    "tdist": influence_tdist,
}

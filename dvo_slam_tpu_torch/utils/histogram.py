"""Histogram and entropy helpers (counterpart of
``dvo_slam_tpu/utils/histogram.py``; reference
dvo_core/include/dvo/util/histogram.h + src/util/histogram.cpp).

Residual histograms and entropies for diagnostics, as masked fixed-bin
histograms (a bincount over quantized values: fixed shapes, no
data-dependent control flow, no host sync) on the inputs' device.
"""

from __future__ import annotations

import torch


def histogram(values, mask, low, high, bins):
    """Masked fixed-range histogram: (N,) values -> (bins,) f32 counts.

    Out-of-range valid values are clamped into the edge bins (matching
    cv-style histogram behaviour the reference relies on for residual
    inspection)."""
    scaled = (values - low) / (high - low) * bins
    idx = torch.clamp(scaled.to(torch.int32), 0, bins - 1)
    weights = mask.to(torch.float32)
    # scatter_add, not bincount: on CUDA bincount reads the largest index
    # back to size its output (a host sync).
    return torch.zeros(bins, dtype=torch.float32,
                       device=values.device).scatter_add_(
        0, idx.to(torch.int64), weights)


def entropy(hist):
    """Shannon entropy (bits) of a histogram (reference computeEntropy)."""
    total = torch.clamp(hist.sum(), min=1e-12)
    p = hist / total
    return -torch.sum(torch.where(
        p > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
        torch.zeros_like(p)))


def median_from_histogram(hist, low, high):
    """Approximate median from a histogram (reference computeMedian)."""
    bins = hist.shape[0]
    cum = torch.cumsum(hist, 0)
    half = cum[-1] * 0.5
    idx = torch.argmax((cum >= half).to(torch.int32))
    width = (high - low) / bins
    return low + (idx.to(torch.float32) + 0.5) * width

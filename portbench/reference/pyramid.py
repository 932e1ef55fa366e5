"""Plain RGB-D pyramid of raw frames: 8-bit intensity and 16-bit depth
ticks (5 000 a metre, 0 invalid) in, one (6, H, W) float32 slab a level
out, [I, Z, dI/dx, dI/dy, dZ/dx, dZ/dy], finest first. Each level halves
the one above (a trailing odd row or column dropped): intensity by the
2x2 mean, depth by the mean of the finite texels of each 2x2 window, NaN
where none is; gradients are central differences halved, one-sided at
the borders (TUM RGB-D / dvo_core's RgbdImage). Batched over leading
dimensions."""

from __future__ import annotations

import torch

DEPTH_TICKS_PER_METRE = 5000.0


def _pool(x):
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2])


def _halve_depth(z):
    finite = torch.isfinite(z)
    total = _pool(torch.where(finite, z, torch.zeros_like(z)))
    count = _pool(finite.to(z.dtype))
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       torch.full_like(total, float("nan")))


def _gradients(img):
    left = torch.cat([img[..., :1], img[..., :-1]], dim=-1)
    right = torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    return 0.5 * (right - left), 0.5 * (down - up)


def metric_depth(raw):
    d = raw.to(torch.float32)
    return torch.where(d > 0, d / DEPTH_TICKS_PER_METRE,
                       torch.full_like(d, float("nan")))


def pyramid(intensity, depth, levels):
    """intensity: (..., H, W) uint8; depth: (..., H, W) 16-bit ticks (an
    integer dtype). Returns a list of (..., 6, H_l, W_l) float32 slabs."""
    i, z = intensity.to(torch.float32), metric_depth(depth)
    out = []
    for lvl in range(levels):
        ix, iy = _gradients(i)
        zx, zy = _gradients(z)
        out.append(torch.stack([i, z, ix, iy, zx, zy], dim=-3))
        if lvl + 1 < levels:
            i, z = _pool(i) * 0.25, _halve_depth(z)
    return out

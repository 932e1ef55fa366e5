"""RGB-D image pyramids with NaN-aware depth downsampling and gradients
(counterpart of ``dvo_slam_tpu/ops/pyramid.py``; reference
RgbdImagePyramid / RgbdImage).

Each level is one (6, H, W) channel-major f32 slab
[I, Z, dI/dx, dI/dy, dZ/dx, dZ/dy], the JAX package's layout: the tests
compare slabs like with like, and the CUDA sampler reads the first C planes
of it directly (ops/sampler.py).
"""

from __future__ import annotations

import numpy as np
import torch

# Slab channel indices.
CH_I, CH_Z, CH_IDX, CH_IDY, CH_ZDX, CH_ZDY = 0, 1, 2, 3, 4, 5
NUM_CHANNELS = 6


def _pool2x2_sum(x):
    """2x2 / stride-2 window sum over the last two dims.

    A trailing odd row or column is dropped, as XLA's "VALID"
    ``reduce_window`` in the JAX package drops it.
    """
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2] \
        + x[..., 1::2, 1::2]


def downsample_intensity(img):
    """2x2 box-average downsample."""
    return _pool2x2_sum(img) * 0.25


def downsample_depth(depth):
    """NaN-aware 2x2 average: mean of the finite texels, NaN if none."""
    finite = torch.isfinite(depth)
    total = _pool2x2_sum(torch.where(finite, depth, torch.zeros_like(depth)))
    count = _pool2x2_sum(finite.to(depth.dtype))
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       torch.full_like(total, float("nan")))


def gradients(img):
    """Central differences x0.5, one-sided at the borders (reference
    RgbdImage::calculateDerivative*). NaNs propagate to neighbouring
    gradient texels."""
    left = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    dx = 0.5 * (right - left)
    up = torch.cat([img[:1, :], img[:-1, :]], dim=0)
    down = torch.cat([img[1:, :], img[-1:, :]], dim=0)
    dy = 0.5 * (down - up)
    return dx, dy


def build_slab(intensity, depth):
    """Stack one level's [I, Z, Ix, Iy, Zx, Zy] -> (6, H, W)."""
    idx, idy = gradients(intensity)
    zdx, zdy = gradients(depth)
    return torch.stack([intensity, depth, idx, idy, zdx, zdy], dim=0)


def build_pyramid(intensity, depth, num_levels):
    """Tuple of (6, H/2^l, W/2^l) slabs, finest first, on the inputs'
    device.

    intensity: (H, W) float 0..255 or uint8; depth: (H, W) metric f32 with
    NaN = invalid, or raw uint16 ticks (convert_raw_depth), or uint8
    12-bit-packed ticks (pack_depth12).
    """
    if depth.dtype == torch.uint8:
        depth = unpack_depth12(depth, intensity.shape[-1])
    if intensity.dtype == torch.uint8:
        intensity = intensity.to(torch.float32)
    if depth.dtype == torch.uint16:
        depth = convert_raw_depth(depth)
    levels = []
    cur_i, cur_z = intensity, depth
    for lvl in range(num_levels):
        levels.append(build_slab(cur_i, cur_z))
        if lvl + 1 < num_levels:
            cur_i = downsample_intensity(cur_i)
            cur_z = downsample_depth(cur_z)
    return tuple(levels)


def convert_raw_depth(raw_u16, scale=5000.0):
    """Kinect raw uint16 -> metric float depth; 0 -> NaN (TUM: 5000/m)."""
    d = raw_u16.to(torch.float32)
    return torch.where(d > 0, d / scale, torch.full_like(d, float("nan")))


# 12-bit packed raw depth: (H, 3*W/2) uint8, three planes along the width
# (layout and rationale in dvo_slam_tpu/ops/pyramid.py).
PACK12_TICK = 16  # raw ticks per 12-bit unit


def pack_depth12(raw_u16):
    """Host-side: (..., H, W) uint16 raw depth -> (..., H, 3*W/2) uint8
    (numpy in, numpy out; W must be even)."""
    raw = np.asarray(raw_u16)
    if raw.dtype != np.uint16:
        raise TypeError(f"pack_depth12 needs uint16, got {raw.dtype}")
    w = raw.shape[-1]
    if w % 2:
        raise ValueError(f"pack_depth12 needs even width, got {w}")
    q = np.right_shift(raw.astype(np.uint32) + PACK12_TICK // 2, 4)
    q = np.minimum(q, 4095)
    q = np.where((raw > 0) & (q == 0), 1, q)  # keep validity bit-exact
    a, b = q[..., : w // 2], q[..., w // 2:]
    return np.concatenate(
        [a >> 4, ((a & 0xF) << 4) | (b >> 8), b & 0xFF], axis=-1
    ).astype(np.uint8)


def unpack_depth12(packed_u8, width, scale=5000.0):
    """Device-side: (..., H, 3*W/2) uint8 -> (..., H, W) metric f32 depth;
    0 -> NaN like convert_raw_depth."""
    w2 = width // 2
    if packed_u8.shape[-1] != 3 * w2:
        raise ValueError(f"packed width {packed_u8.shape[-1]} != 3*{w2}")
    p = packed_u8.to(torch.int32)
    p0 = p[..., :w2]
    p1 = p[..., w2: 2 * w2]
    p2 = p[..., 2 * w2:]
    a = (p0 << 4) | (p1 >> 4)
    b = ((p1 & 0xF) << 8) | p2
    q = torch.cat([a, b], dim=-1).to(torch.float32)
    return torch.where(q > 0, q * (PACK12_TICK / scale),
                       torch.full_like(q, float("nan")))

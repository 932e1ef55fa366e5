"""Pinhole intrinsics per pyramid level (counterpart of
``dvo_slam_tpu/ops/camera.py``).

Intrinsics are a flat (4,) f32 tensor [fx, fy, cx, cy]. Pixel coordinates
follow the reference/OpenCV convention: integer coordinates land on pixel
centers.
"""

from __future__ import annotations

import torch

# TUM RGB-D calibrations at 640x480 (fx, fy, cx, cy): freiburg 1, 2, 3.
TUM_FR1 = (517.3, 516.5, 318.6, 255.3)
TUM_FR2 = (520.9, 521.0, 325.1, 249.7)
TUM_FR3 = (535.4, 539.2, 320.1, 247.6)


def intrinsics(fx, fy, cx, cy, device, dtype=torch.float32):
    return torch.tensor([fx, fy, cx, cy], dtype=dtype, device=device)


def scale_intrinsics(K, factor):
    """Rescale intrinsics for a downsampled level, with the half-pixel
    correction: a full-resolution pixel center u maps to
    (u + 0.5) * s - 0.5 at scale s (reference IntrinsicMatrix::scale)."""
    fx, fy, cx, cy = K.unbind()
    return torch.stack(
        [fx * factor, fy * factor, (cx + 0.5) * factor - 0.5,
         (cy + 0.5) * factor - 0.5]
    )


def pyramid_intrinsics(K, num_levels):
    """Tuple of per-level intrinsics, level 0 = finest."""
    return tuple(scale_intrinsics(K, 0.5**lvl) for lvl in range(num_levels))

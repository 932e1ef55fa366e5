"""Device-to-host transfer of many tensors in one copy.

The SLAM orchestrator reads several small results at a time (a frame's two
poses, entropies and information matrices; a validation batch's voted
quantities; a window solve's poses). Each separate ``.cpu()`` waits for
the device and pays one copy; ``to_host`` packs them into one f64 buffer,
copies that once, and hands back numpy arrays of the original dtypes
(f32, int and bool values are exact in f64).
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(tensors):
    """numpy copies of a list of tensors (any devices, one transfer for
    those on a CUDA device)."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(
        device=tensors[0].device, dtype=torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[at:at + n].reshape(tuple(t.shape)).astype(dtype))
        at += n
    return out

"""Bilinear slab sampler: the CUDA kernel's wrapper and its plain version.

Counterpart of the TPU kernel ``dvo_slam_tpu/ops/pallas/sampler.py::
sample_slab`` and of the portable gather path it stands in for,
``dvo_slam_tpu/ops/linearize.py::_sample_gather``, whose semantics both
functions here reproduce exactly (see csrc/sampler.cu).

``sample_slab`` dispatches on the tensors' device: a CPU tensor goes to
``sample_slab_reference``; a CUDA tensor goes to the kernel, or the call
raises. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from dvo_slam_tpu_torch.ops.pyramid import NUM_CHANNELS

# Kernel launches made by sample_slab since the last reset (plain integer;
# callers reset it to 0 to count the launches of one run).
LAUNCHES = 0


def sample_slab_reference(slab, u, v):
    """Plain-PyTorch bilinear sample of a (C, H, W) slab at (N,) points.

    Returns ``(out (C, N) f32, inb (N,) bool)``. ``inb`` is true where the
    full 2x2 footprint lies inside the image; NaNs in the slab propagate to
    ``out``. Coordinates are clamped in float before any integer cast, so
    NaN or huge u, v give ``inb = False`` and an in-range address.
    """
    C, H, W = slab.shape
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    inb = (u0f >= 0) & (v0f >= 0) & (u0f <= W - 2) & (v0f <= H - 2)
    zero = torch.zeros_like(u0f)
    x0f = torch.where(u0f >= 0, torch.clamp(u0f, max=W - 2), zero)
    y0f = torch.where(v0f >= 0, torch.clamp(v0f, max=H - 2), zero)
    fu = u - x0f
    fv = v - y0f
    flat = slab.reshape(C, H * W)
    base = y0f.to(torch.int64) * W + x0f.to(torch.int64)
    s00 = flat[:, base]
    s01 = flat[:, base + 1]
    s10 = flat[:, base + W]
    s11 = flat[:, base + W + 1]
    top = s00 + fu * (s01 - s00)
    bot = s10 + fu * (s11 - s10)
    return top + fv * (bot - top), inb


def _check(slab, u, v):
    if slab.dim() != 3 or u.dim() != 1 or v.shape != u.shape:
        raise ValueError(
            f"want slab (C, H, W) and u, v (N,); got {tuple(slab.shape)}, "
            f"{tuple(u.shape)}, {tuple(v.shape)}"
        )
    C, H, W = slab.shape
    if not 1 <= C <= NUM_CHANNELS:
        raise ValueError(f"want 1 <= C <= {NUM_CHANNELS} channels, got {C}")
    if H < 2 or W < 2:
        raise ValueError(f"want H, W >= 2, got {H}x{W}")
    for name, t in (("slab", slab), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != slab.device:
            raise ValueError(f"{name} on {t.device}, slab on {slab.device}")


def sample_slab(slab, u, v):
    """Bilinear sample of the first C planes of a pyramid slab at warped
    points: ``(out (C, N) f32, inb (N,) bool)``, as
    ``sample_slab_reference``.

    slab: (C, H, W) f32 contiguous, 1 <= C <= 6 (``level[:C]`` of a
    (6, H, W) pyramid slab is such a view); u, v: (N,) f32 contiguous on
    the same device. CPU tensors take the plain version; CUDA tensors
    launch the kernel of csrc/sampler.cu on the slab's device and its
    current stream, whichever device is current.
    """
    global LAUNCHES
    _check(slab, u, v)
    if slab.device.type == "cpu":
        return sample_slab_reference(slab, u, v)
    if slab.device.type != "cuda":
        raise ValueError(f"sample_slab runs on cpu or cuda, not {slab.device}")
    from dvo_slam_tpu_torch import _build

    C, H, W = slab.shape
    N = u.shape[0]
    out = torch.empty((C, N), dtype=torch.float32, device=slab.device)
    inb = torch.empty((N,), dtype=torch.uint8, device=slab.device)
    lib = _build.load()
    # The ctypes launch runs in the current CUDA context: make it the slab's.
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dvo_sample_slab(slab.data_ptr(), C, H, W, u.data_ptr(),
                                 v.data_ptr(), N, out.data_ptr(),
                                 inb.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dvo_sample_slab launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, inb.view(torch.bool)

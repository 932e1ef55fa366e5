"""The synthetic protocol's frames, rendered on the card in PyTorch: the
two-plane scene, the orbit and the Kinect-style corruption of the repo's
accuracy protocol, quantized as a TUM RGB-D recording stores them (8-bit
intensity, 16-bit depth at 5 000 ticks a metre, 0 invalid).

A camera looking at textured planes has a closed-form raycast, so every
frame is exact for its pose. The geometry follows the port's numpy
renderer (``utils/synthetic.py``: ``PlaneScene.render``, ``_texture``,
``two_plane_scene``, ``orbit_trajectory``, ``add_sensor_noise``) in float64;
the noise is drawn on the card from a ``torch.Generator`` seeded by the
run's seed, in batches of a fixed size, so one seed gives the same frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import se3

DEPTH_TICKS_PER_METRE = 5000.0
# Frames rendered (and drawn from the generator) per batch.
BATCH = 20


def two_plane_scene():
    """Wall and floor: ((normal, offset), ...) with unit normals."""
    n1 = np.array([0.15, -0.1, 1.0])
    n2 = np.array([0.0, -1.0, 0.15])
    return ((n1 / np.linalg.norm(n1), 2.5), (n2 / np.linalg.norm(n2), 1.2))


def orbit(num_frames, radius, yaw_amplitude, cycles):
    """Camera-to-world poses (num_frames, 4, 4) float64 on the host: a
    circular translation with a yaw sweep, ``cycles`` laps."""
    a = 2.0 * math.pi * cycles * torch.arange(
        num_frames, dtype=torch.float64) / max(num_frames, 1)
    xi = torch.stack([radius * torch.sin(a), radius * (1 - torch.cos(a)),
                      0.02 * torch.sin(a), 0.02 * (1 - torch.cos(a)),
                      yaw_amplitude * torch.sin(a), 0.01 * torch.sin(2 * a)],
                     dim=-1)
    return se3.exp(xi)


def _texture(p, sharpness):
    x, y = p[..., 0], p[..., 1]
    s = sharpness
    v = (torch.sin(1.7 * s * x + 0.5) + torch.sin(2.3 * s * y + 1.1)
         + torch.sin(1.3 * s * (x + y) + 2.0)
         + torch.sin(2.9 * s * (x - 0.5 * y))
         + 0.5 * torch.sin(5.1 * s * x + 3.0 * s * y)
         + 0.5 * torch.sin(4.3 * s * y - 2.1 * s * x + 0.7))
    return (128.0 + 28.0 * v).to(torch.float32)


def render(K, width, height, poses, planes, sharpness=1.0):
    """Exact frames at camera-to-world ``poses`` (F, 4, 4): intensity and
    metric depth, (F, H, W) float32 each, on the poses' device; NaN depth
    where no plane is hit."""
    dev = poses.device
    fx, fy, cx, cy = (float(k) for k in K)
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float64,
                                       device=dev),
                          torch.arange(width, dtype=torch.float64,
                                       device=dev), indexing="ij")
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)],
                       -1)
    R, c = poses[:, :3, :3], poses[:, :3, 3]
    world = torch.einsum("hwk,fjk->fhwj", dirs, R)
    F = poses.shape[0]
    depth = torch.full((F, height, width), math.inf, dtype=torch.float64,
                       device=dev)
    hit = torch.zeros((F, height, width, 3), dtype=torch.float64, device=dev)
    for n, d in planes:
        n = torch.as_tensor(n, dtype=torch.float64, device=dev)
        denom = world @ n
        parallel = denom.abs() < 1e-9
        denom = torch.where(parallel, 1e-9, denom)
        lam = (d - c @ n)[:, None, None] / denom
        closer = (lam > 0.05) & ~parallel & (lam < depth)
        X = c[:, None, None, :] + lam[..., None] * world
        depth = torch.where(closer, lam, depth)
        hit = torch.where(closer[..., None], X, hit)
    miss = ~torch.isfinite(depth)
    intensity = torch.where(miss, 0.0, _texture(hit, sharpness))
    depth = torch.where(miss, math.nan, depth).to(torch.float32)
    return intensity.to(torch.float32), depth


def corrupt(intensity, depth, gen, intensity_std, depth_rel_std, dropout):
    """Kinect-like noise drawn from ``gen``: additive intensity noise,
    depth noise relative to range, random depth dropout; then the
    recording's quantization. Returns (uint8 intensity, uint16 ticks)."""
    kw = {"generator": gen, "device": intensity.device,
          "dtype": torch.float32}
    shape = intensity.shape
    i = intensity + intensity_std * torch.randn(shape, **kw)
    z = depth * (1.0 + depth_rel_std * torch.randn(shape, **kw))
    z = torch.where(torch.rand(shape, **kw) < dropout, math.nan, z)
    i8 = torch.round(torch.clamp(i, 0.0, 255.0)).to(torch.uint8)
    raw = torch.where(torch.isfinite(z), z * DEPTH_TICKS_PER_METRE, 0.0)
    raw = torch.where((raw < 0) | (raw > 65535), 0.0, raw)
    return i8, torch.round(raw).to(torch.int32).to(torch.uint16)


def generator(seed, device):
    """The noise's generator on ``device``, seeded with the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def frames(protocol: dict, camera: dict, poses, gen, out_i, out_z):
    """Render and corrupt every pose of ``poses`` (F, 4, 4) float64 on the
    card into ``out_i`` / ``out_z`` ((F, H, W) uint8 / uint16, on the card
    or pinned on the host), BATCH frames at a time, the noise drawn from
    ``gen`` (on the poses' device)."""
    planes = two_plane_scene()
    noise = protocol["noise"]
    for k in range(0, poses.shape[0], BATCH):
        i, z = render(camera["intrinsics"], camera["width"],
                      camera["height"], poses[k:k + BATCH], planes,
                      protocol["sharpness"])
        i8, z16 = corrupt(i, z, gen, noise["intensity_std"],
                          noise["depth_rel_std"], noise["dropout"])
        out_i[k:k + BATCH].copy_(i8, non_blocking=True)
        out_z[k:k + BATCH].copy_(z16, non_blocking=True)

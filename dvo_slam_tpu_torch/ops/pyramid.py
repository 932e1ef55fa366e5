"""RGB-D image pyramids with NaN-aware depth downsampling and gradients
(counterpart of ``dvo_slam_tpu/ops/pyramid.py``; reference
RgbdImagePyramid / RgbdImage).

Each level is one (6, H, W) channel-major f32 slab
[I, Z, dI/dx, dI/dy, dZ/dx, dZ/dy], the JAX package's layout: the tests
compare slabs like with like, and the CUDA kernels read the planes of it
directly (ops/sampler.py, ops/linearize.py).

``build_pyramid`` dispatches on the inputs' device: CPU tensors go to
``build_pyramid_reference``, the plain PyTorch version; CUDA tensors to
``build_pyramid_kernel``, one launch of csrc/pyramid.cu that writes every
level into one allocation (the levels are views of it), the same bits as
the plain version on the card. A CUDA input the kernel does not take
raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dvo_slam_tpu_torch import _build

# Slab channel indices.
CH_I, CH_Z, CH_IDX, CH_IDY, CH_ZDX, CH_ZDY = 0, 1, 2, 3, 4, 5
NUM_CHANNELS = 6

# Launches of csrc/pyramid.cu since the last reset (a plain integer;
# callers reset it to 0 to count the launches of one run).
LAUNCHES_PYRAMID = 0
# The kernel's depth encodings (csrc/pyramid.cu kDepth*) and its level
# limit (kMaxLevels).
_DEPTH_F32, _DEPTH_U16, _DEPTH_PACKED12 = 0, 1, 2
_MAX_LEVELS = 6
# The kernel's level-0 tile: kTile columns by one of _TILE_ROWS rows
# (kTile, kTallTile; the tall tile up to _TALL_LEVELS levels), its
# level-0 fill paths (kFill*) and its phase-timing buffer's int64 stamps a
# CTA (kTimingSlots).
_TILE = 32
_TILE_ROWS = (32, 40)
_TALL_LEVELS = 4
_FILL_SCALAR, _FILL_TMA = 0, 1
_TIMING_SLOTS = 24
# Names of the spans between a CTA's phase stamps, in order (csrc/
# pyramid.cu, "The phase-timing buffer"); level l's three follow the
# level-0 fill's two.
_FILL_PHASES = ("level-0 fill", "level-0 conversion and barrier")
_LEVEL_PHASES = ("downsample", "store", "barrier")


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
    device: ``build_pyramid_kernel`` for CUDA tensors,
    ``build_pyramid_reference`` for CPU tensors.

    intensity: (H, W) float 0..255 or uint8; depth: (H, W) metric f32 with
    NaN = invalid, or raw uint16 ticks (convert_raw_depth), or uint8
    12-bit-packed ticks (pack_depth12).
    """
    if intensity.device.type == "cuda" or depth.device.type == "cuda":
        return build_pyramid_kernel(intensity, depth, num_levels)
    return build_pyramid_reference(intensity, depth, num_levels)


def level_shapes(H, W, num_levels):
    """(H_l, W_l) of every level: a trailing odd row or column dropped at
    each downsample."""
    return [(H >> lvl, W >> lvl) for lvl in range(num_levels)]


@functools.lru_cache(maxsize=None)
def tile_rows(H, W, num_levels, sms):
    """The pyramid kernel's tile rows for an H x W frame on a card of `sms`
    SMs: of 32 and 40 (40 up to four levels, whose tiles halve evenly),
    the one that gives the busiest SM the fewest level-0 rows, halos
    included; 32 on a tie. Every CTA is resident at once, so the launch
    lasts as long as the busiest SM's CTAs: at 640x480 32-row tiles put 3
    of 300 CTAs on some SMs, 40-row tiles at most 2 of 240."""
    h = 1 << (num_levels - 1)

    def busiest(rows):
        gx, gy = kernel_grid(H, W, rows)
        return -(-gx * gy // sms) * (rows + 2 * h), rows

    return min((r for r in _TILE_ROWS
                if r == _TILE or num_levels <= _TALL_LEVELS), key=busiest)


def kernel_grid(H, W, rows):
    """The pyramid kernel's CTAs along x and y: one a 32-column tile of
    `rows` rows of level 0."""
    return -(-W // _TILE), -(-H // rows)


def tma_fill(intensity, depth):
    """Whether the pyramid kernel brings level 0 in by TMA: both inputs'
    base addresses 16-B aligned and their rows a multiple of 16 B, as a
    tensor map needs (640x480 in every encoding). Otherwise (642x482,
    82x61, a view at an odd offset) it takes the scalar fill; the kernel
    refuses TMA on anything else."""
    return (intensity.data_ptr() % 16 == 0 and depth.data_ptr() % 16 == 0
            and intensity.shape[-1] * intensity.element_size() % 16 == 0
            and depth.shape[-1] * depth.element_size() % 16 == 0)


def timing_buffer(H, W, device):
    """A zeroed phase-timing buffer for ``build_pyramid_kernel(...,
    timing=)``: (CTAs, _TIMING_SLOTS) int64, a row for every CTA of the
    smallest tiles (a launch of taller tiles leaves the last rows 0)."""
    gx, gy = kernel_grid(H, W, _TILE)
    return torch.zeros((gx * gy, _TIMING_SLOTS), dtype=torch.int64,
                       device=device)


def phase_times(timing, num_levels):
    """The pyramid kernel's phase split from a filled timing buffer (host
    numpy int64, (CTAs, _TIMING_SLOTS)): ({phase: mean device us a CTA},
    the launch's device us from its first CTA's start to its last CTA's
    end, the mean us a CTA). Each CTA's thread 0 stamps clock64 at its
    phase boundaries and %globaltimer at its start and end; clock64 is
    converted by the CTAs' summed %globaltimer spans."""
    t = np.asarray(timing, np.int64)
    t = t[t[:, 1] != 0]  # the CTAs the launch had
    last = 5 + 3 * (num_levels - 1) + 2
    clocks = t[:, 2:last + 1].astype(np.float64)
    ns_per_clock = (t[:, 1] - t[:, 0]).sum() / max(
        (clocks[:, -1] - clocks[:, 0]).sum(), 1.0)
    spans = np.diff(clocks, axis=1).mean(0) * ns_per_clock / 1e3
    names = list(_FILL_PHASES) + [f"level {lvl} {what}"
                                  for lvl in range(num_levels)
                                  for what in _LEVEL_PHASES]
    return (dict(zip(names, spans.tolist())),
            float(t[:, 1].max() - t[:, 0].min()) / 1e3,
            float((t[:, 1] - t[:, 0]).mean()) / 1e3)


def pyramid_size(H, W, num_levels):
    """Floats of an H x W frame's pyramid: every level's (6, H_l, W_l)
    slab, one after the other."""
    return sum(NUM_CHANNELS * h * w for h, w in level_shapes(H, W,
                                                              num_levels))


def build_pyramid_kernel(intensity, depth, num_levels, timing=None,
                         out=None):
    """``build_pyramid`` on the card: one launch of csrc/pyramid.cu on the
    current stream of the inputs' device, no host sync. Takes intensity
    f32 or uint8 (H, W) and depth f32 or uint16 (H, W) or 12-bit-packed
    uint8 (H, 3 W / 2) (W even), 1 to 6 levels of at least 1x1; raises on
    anything else. The slabs are views of one allocation, level after
    level: a new one, or ``out``, a contiguous f32 tensor of
    ``pyramid_size`` floats on the inputs' device starting 16-B aligned
    (a slot of a buffer of many frames' pyramids)."""
    global LAUNCHES_PYRAMID
    if intensity.dim() != 2 or intensity.dtype not in (torch.float32,
                                                       torch.uint8):
        raise TypeError(f"intensity must be (H, W) float32 or uint8, got "
                        f"{intensity.dtype} {tuple(intensity.shape)}")
    H, W = intensity.shape
    kind = {torch.float32: _DEPTH_F32, torch.uint16: _DEPTH_U16,
            torch.uint8: _DEPTH_PACKED12}.get(depth.dtype)
    want = (H, 3 * (W // 2)) if kind == _DEPTH_PACKED12 else (H, W)
    if (kind is None or tuple(depth.shape) != want
            or (kind == _DEPTH_PACKED12 and W % 2)):
        raise TypeError(f"depth must be float32 or uint16 (H, W), or uint8 "
                        f"(H, 3 W / 2) with W even, for a {H}x{W} frame; "
                        f"got {depth.dtype} {tuple(depth.shape)}")
    if not 1 <= num_levels <= _MAX_LEVELS or min(
            H, W) >> (num_levels - 1) < 1:
        raise ValueError(f"{num_levels} levels of a {H}x{W} frame: the "
                         f"kernel takes 1 to {_MAX_LEVELS} levels of at "
                         f"least 1x1")
    dev = intensity.device
    if depth.device != dev or dev.type != "cuda":
        raise ValueError(f"build_pyramid_kernel needs both inputs on one "
                         f"CUDA device, got {intensity.device} and "
                         f"{depth.device}")
    shapes = level_shapes(H, W, num_levels)
    size = pyramid_size(H, W, num_levels)
    if out is None:
        out = torch.empty(size, dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or out.shape != (size,)
          or not out.is_contiguous() or out.device != dev
          or out.data_ptr() % 16):
        raise ValueError(f"want out a contiguous ({size},) float32 tensor on "
                         f"{dev} starting 16-B aligned, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    intensity, depth = intensity.contiguous(), depth.contiguous()
    _build.launch("dvo_pyramid", dev, (
        intensity.data_ptr(), int(intensity.dtype == torch.uint8),
        depth.data_ptr(), kind, H, W, num_levels,
        float(np.float32(1.0) / np.float32(_RAW_SCALE)),
        float(np.float32(PACK12_TICK / _RAW_SCALE)), out.data_ptr(),
        tile_rows(H, W, num_levels, _build.sm_count(dev.index)),
        _FILL_TMA if tma_fill(intensity, depth) else _FILL_SCALAR,
        None if timing is None else timing.data_ptr()))
    LAUNCHES_PYRAMID += 1
    levels, off = [], 0
    for h, w in shapes:
        levels.append(out[off:off + NUM_CHANNELS * h * w].view(
            NUM_CHANNELS, h, w))
        off += NUM_CHANNELS * h * w
    return tuple(levels)


def build_pyramid_reference(intensity, depth, num_levels):
    """``build_pyramid`` in plain PyTorch, on any device (the JAX package's
    function op for op)."""
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


# Raw depth ticks a metre (TUM / Kinect).
_RAW_SCALE = 5000.0


def convert_raw_depth(raw_u16, scale=_RAW_SCALE):
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


def unpack_depth12(packed_u8, width, scale=_RAW_SCALE):
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

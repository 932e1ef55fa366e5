"""Device-resident keyframe odometry: the SLAM front-end as a loop over
frames with every decision on the device (counterpart of
``dvo_slam_tpu/models/keyframe_scan.py``).

The reference's KeyframeTracker front-end (dual alignment + entropy-ratio
keyframe selection + measurement fusion; dvo_slam/src/local_tracker.cpp +
tracking_result_evaluation.cpp, SURVEY.md §3.3) makes one host decision
per frame in the per-frame orchestrator (models/keyframe_tracker.py).
Here the keyframe-switch decision, the active-keyframe swap, the
constant-velocity warm start and the information fusion all stay on the
device, so a chunk of frames is issued to the card with no device-to-host
sync between frames. The JAX package runs the same step inside one
``lax.scan``. A chunk runs one of two ways:

- on a CUDA device with ``dense_tracker.front_route`` (every scale
  estimator, influence function, weighting, motion prior and point
  budget), ``_track_chunk_kernels``:
  five launches a frame and no other device op in the frame loop: the
  pyramid (into a slot of the chunk's pyramid buffer), the three level
  launches of mode (b) at B = 2 (the keyframe and the previous frame
  against the new frame), each reading its reference slabs through a
  table of row pointers in device memory (under compaction each launch
  picks its slots' pixels from those slabs itself: no index table is
  carried and no keyframe copied), and the scan step
  (ops/scan_step.py, csrc/keyframe_scan.cu), which takes the frame's
  decisions, writes its packed output row, the next carry slot (the next
  frame's initial poses) and the next frame's pointer table: the
  keyframe is chosen on the card with no copy of a slab. The outputs are
  views of the one (n, row) buffer, ready for one host copy
  (``scan_chunk``). The keyframe pyramid of the carry after such a chunk
  is a ``PendingKeyframe`` until its switch flags are read
  (``PendingKeyframe.resolve``, models/chunked_slam.py's collect);
- elsewhere (CPU tensors), ``_step`` a frame: the pyramid, the batched
  tracker, and the decisions as eager ops
  (``scan_step.scan_step_reference``, the keyframe swap a ``torch.where``
  per pyramid level), the outputs stacked after the loop. It is the
  kernel route's plain version and never runs on the card.

The backend (loop closure + global graph) stays host logic: the scan emits
what the backend consumes — per-switch relative measurements with
information matrices, per-frame keyframe-relative poses and the entropy
stream — for ``compose_keyframe_trajectory`` or ChunkedKeyframeSlam
(models/chunked_slam.py).

The TPU's windowed sampler could miss points and escalate to a gather;
the port's gather has no window, so ``window_miss_frac`` is 0 and
``escalated`` False on every frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.ops import camera, pyramid, scan_step
from dvo_slam_tpu_torch.ops import linearize as lin_ops

# ONE constant for both engines: a drift here would silently desynchronize
# the per-frame and scan engines' keyframe cadence.
_ENTROPY_FLOOR = dense_tracker._ENTROPY_DENOM_FLOOR
# The step's entropy ratio and fusion (ops/scan_step.py).
_entropy_ratio = scan_step.entropy_ratio
_fuse_relative_poses = scan_step.fuse_relative_poses
# Floats a chunk's pyramid slot is rounded up to (the pyramid kernel
# writes 16-B vectors from a 16-B aligned start).
_SLOT_ALIGN = 64


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """The SlamConfig subset the scan reads (the JAX package's jit key)."""

    min_constraint_ratio: float
    min_entropy_ratio: float
    fuse_odometry: bool
    with_stats: bool  # emit per-iteration TrackStats as scan outputs

    @classmethod
    def from_slam(cls, s: SlamConfig, with_stats: bool = False):
        return cls(s.min_constraint_ratio, s.min_entropy_ratio,
                   s.fuse_odometry, with_stats)


def init_carry(pyr0):
    """Scan carry anchored at a fresh keyframe pyramid (frame 0 / the frame
    that just switched). The carry is self-contained: chunked runs chain it
    across calls (ChunkedKeyframeSlam). Its tensors are never written in
    place (a chunk's carry stays valid while later chunks run)."""
    dev = pyr0[0].device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return {
        "kf": tuple(pyr0),
        "prev": tuple(pyr0),
        "T_kf_prev": eye,
        "last_odo": eye,
        "H_first": torch.zeros((), dtype=torch.float32, device=dev),
        "has_first": torch.zeros((), dtype=torch.bool, device=dev),
    }


class PendingKeyframe:
    """The keyframe pyramid of a carry after a chunk on the kernel route.

    The card knows it (its slabs' pointers are row 0 of the carry's
    table); the host learns which frame it is only when it reads the
    chunk's switch flags: ``resolve`` then gives the pyramid of the
    chunk's last switch, or the keyframe that was current before the
    chunk. Until then it holds every pyramid the table may point at (the
    keyframe before the chunk, resolved or pending, and the chunk's
    frames), so no slab a later chunk's level launches read through the
    table is freed and its memory reused. Resolving drops the others."""

    def __init__(self, before, frames):
        self.before = before  # a pyramid tuple, or a PendingKeyframe
        self.frames = frames  # the chunk's per-frame pyramids (views)
        self.pyramid = None

    def candidates(self):
        """Every pyramid this keyframe may be."""
        if self.pyramid is not None:
            return [self.pyramid]
        before = self.before
        first = (before.candidates() if isinstance(before, PendingKeyframe)
                 else [before])
        return first + list(self.frames)

    def resolve(self, switch):
        """The keyframe pyramid, from the chunk's switch flags (host bools,
        one a frame); the keyframe before the chunk must be resolved."""
        if self.pyramid is None:
            hits = np.flatnonzero(np.asarray(switch))
            if len(hits):
                self.pyramid = self.frames[int(hits[-1])]
            else:
                before = self.before
                self.pyramid = (before.pyramid
                                if isinstance(before, PendingKeyframe)
                                else before)
                if self.pyramid is None:
                    raise RuntimeError("resolve the chunks' keyframes in "
                                       "the order the chunks ran")
            self.before = self.frames = None
        return self.pyramid


def _step(carry, intensity, depth, force, Ks, cfg: TrackerConfig,
          scan_cfg: ScanConfig):
    """One frame: (carry, frame) -> (new carry, outputs), the kernel
    route's plain version (CPU tensors)."""
    dev = carry["T_kf_prev"].device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    cur = pyramid.build_pyramid(intensity, depth, cfg.num_levels)
    tracked = set(cfg.tracked_levels)
    refs = tuple(
        (kf_l, prev_l) if lvl in tracked else None
        for lvl, (kf_l, prev_l) in enumerate(zip(carry["kf"], carry["prev"]))
    )
    odo_init = carry["last_odo"] if cfg.use_initial_estimate else eye
    inits = torch.stack([carry["T_kf_prev"], odo_init])
    res = dense_tracker.track_batched(refs, cur, Ks, inits, cfg)
    new_carry, out = scan_step.scan_step_reference(res, carry, force, cur,
                                                   scan_cfg)
    if cfg.collect_stats and scan_cfg.with_stats:
        # Per-iteration TrackStats of both alignments (batch 2: keyframe,
        # odometry), for ChunkedKeyframeSlam's frame logger.
        out["stats"] = tuple(res.stats[:5])
    return new_carry, out


def _kernel_carry(carry, cfg: TrackerConfig, dev):
    """A carry's slot and pointer table for the kernel route: a kernel
    route carry's own (views of the previous chunk's buffers), or, for a
    carry of the per-frame route (init_carry, a checkpoint), built on the
    device (one cat; the pointers uploaded from pinned memory without a
    sync)."""
    if "_state" in carry:
        return carry["_state"], carry["_table"]
    state = scan_step.state_of(carry, cfg.use_initial_estimate)
    ptrs = torch.tensor([[carry["kf"][lvl].data_ptr(),
                          carry["prev"][lvl].data_ptr()]
                         for lvl in cfg.tracked_levels], dtype=torch.int64)
    if dev.type == "cuda":
        ptrs = ptrs.pin_memory()
    return state, ptrs.to(dev, non_blocking=True)


def _track_chunk_kernels(carry, intensities, depths, force, Ks,
                         cfg: TrackerConfig, scan_cfg: ScanConfig):
    """The chunk on the kernel route (module docstring): returns (carry,
    packed (n, row_width) f32 outputs, their layout). Carry slot k + 1 is
    a new slot, never slot k overwritten: a chunk's carry stays valid
    while later chunks run."""
    n = intensities.shape[0]
    dev = intensities.device
    levels = cfg.tracked_levels
    L, M = len(levels), cfg.max_iterations
    H, W = intensities.shape[-2:]
    layout = scan_step.output_layout(
        L, M, bool(cfg.collect_stats and scan_cfg.with_stats))
    size = pyramid.pyramid_size(H, W, cfg.num_levels)
    slot = -(-size // _SLOT_ALIGN) * _SLOT_ALIGN
    pyrs = torch.empty((n, slot), dtype=torch.float32, device=dev)
    lev = torch.empty((n, 2, L, lin_ops.level_row_size(M)),
                      dtype=torch.float32, device=dev)
    lev_i = torch.empty((n, 2, L, 2), dtype=torch.int32, device=dev)
    states = torch.empty((n, scan_step.STATE_SIZE), dtype=torch.float32,
                         device=dev)
    tables = torch.empty((n, L, 2), dtype=torch.int64, device=dev)
    packed = torch.empty((n, scan_step.row_width(layout)),
                         dtype=torch.float32, device=dev)
    state, table = _kernel_carry(carry, cfg, dev)
    kf = carry["kf"]
    frames = []
    # Every pyramid a table of this chunk may point at (the plain
    # version's map from pointers to slabs; the frames join as they come).
    known = (kf.candidates() if isinstance(kf, PendingKeyframe) else [kf])
    known.append(carry["prev"])
    # The frame loop's views, made ahead of it (one unbind each).
    per_frame = zip(intensities.unbind(0), depths.unbind(0),
                    pyrs[:, :size].unbind(0), lev.unbind(0),
                    lev_i.unbind(0), force.unbind(0), packed.unbind(0),
                    states.unbind(0), tables.unbind(0))
    for ii, zz, slot_k, lev_k, lev_i_k, force_k, row_k, state_k, \
            table_k in per_frame:
        cur = pyramid.build_pyramid_kernel(ii, zz, cfg.num_levels,
                                           out=slot_k)
        frames.append(cur)
        known.append(cur)
        slabs = tuple(cur[lvl] for lvl in levels)
        T = scan_step.inits_of(state)
        poses = lev_k[..., :16].unflatten(-1, (4, 4)).unbind(1)
        for j, (ref, out, out_i) in enumerate(zip(
                table.unbind(0), lev_k.unbind(1), lev_i_k.unbind(1))):
            lin_ops.track_level_kernels(
                lin_ops.RefSlabs(lin_ops.SlabTable(
                    ref, tuple(slabs[j].shape), known, levels[j])),
                slabs[j], Ks[levels[j]], T, cfg, out=out, out_i=out_i)
            T = poses[j]
        scan_step.scan_step(lev_k, lev_i_k, state, table, force_k, slabs,
                            row_k, state_k, table_k, cfg, scan_cfg)
        state, table = state_k, table_k
    new_carry = {
        "kf": PendingKeyframe(kf, frames),
        "prev": frames[-1],
        **scan_step.carry_of(state),
        "_state": state,
        "_table": table,
    }
    return new_carry, packed, layout


def _kernel_route(cfg: TrackerConfig, device) -> bool:
    """Whether a chunk on ``device`` runs on the kernel route: the kernel
    front's configs (``dense_tracker.front_route``, looked up at the
    call) on a CUDA device."""
    return dense_tracker.front_route(cfg, device)


def scan_chunk(carry, intensities, depths, K, cfg: TrackerConfig,
               slam_cfg: SlamConfig = SlamConfig(), force_keyframe=None,
               with_stats: bool = False, Ks=None):
    """``track_keyframe_chunk`` with its outputs packed for one host copy:
    (carry, packed (n, row_width) f32, layout) (ops/scan_step.py
    output_layout; ``scan_step.field_views`` reads the fields). On the
    kernel route the kernels write the packed rows; on the per-frame
    route the stacked outputs are packed with one cat. ``Ks``: K's
    per-level intrinsics where the caller holds them (else made here)."""
    n = intensities.shape[0]
    if force_keyframe is None:
        force_keyframe = torch.zeros(n, dtype=torch.bool,
                                     device=intensities.device)
    if Ks is None:
        Ks = camera.pyramid_intrinsics(K, cfg.num_levels)
    scan_cfg = ScanConfig.from_slam(slam_cfg, with_stats)
    if n and _kernel_route(cfg, intensities.device):
        return _track_chunk_kernels(carry, intensities, depths,
                                    force_keyframe, Ks, cfg, scan_cfg)
    carry, outs = _track_chunk_steps(carry, intensities, depths,
                                     force_keyframe, Ks, cfg, scan_cfg)
    layout = scan_step.output_layout(
        len(cfg.tracked_levels), cfg.max_iterations, "stats" in outs)
    return carry, scan_step.pack(outs, layout) if n else None, layout


def _track_chunk_steps(carry, intensities, depths, force, Ks,
                       cfg: TrackerConfig, scan_cfg: ScanConfig):
    """The chunk on the per-frame route: ``_step`` a frame, the outputs
    stacked with a leading n."""
    outs = []
    for k in range(intensities.shape[0]):
        carry, out = _step(carry, intensities[k], depths[k], force[k], Ks,
                           cfg, scan_cfg)
        outs.append(out)
    stacked = {}
    for key in outs[0] if outs else ():
        if key == "stats":
            stacked[key] = tuple(torch.stack([o[key][i] for o in outs])
                                 for i in range(5))
        else:
            stacked[key] = torch.stack([o[key] for o in outs])
    return carry, stacked


def track_keyframe_chunk(carry, intensities, depths, K, cfg: TrackerConfig,
                         slam_cfg: SlamConfig = SlamConfig(),
                         force_keyframe=None, with_stats: bool = False):
    """Run the keyframe front-end over one CHUNK of frames, chaining the
    carry: (carry, (T, H, W) frames) -> (carry, per-frame outputs stacked
    with a leading T).

    intensities / depths: (T, H, W) tensors on the carry's device (f32, or
    raw uint8 intensity and uint16 / 12-bit-packed uint8 depth, converted
    by build_pyramid); K: (4,) intrinsics tensor; force_keyframe: optional
    (T,) bool tensor on the device. Semantics are those of
    track_keyframe_sequence split at arbitrary boundaries. On the kernel
    route the outputs are views of one packed buffer and the carry's
    "kf" a ``PendingKeyframe`` (module docstring)."""
    n = intensities.shape[0]
    if n and _kernel_route(cfg, intensities.device):
        carry, packed, layout = scan_chunk(
            carry, intensities, depths, K, cfg, slam_cfg,
            force_keyframe=force_keyframe, with_stats=with_stats)
        return carry, scan_step.field_views(packed, layout)
    if force_keyframe is None:
        force_keyframe = torch.zeros(n, dtype=torch.bool,
                                     device=intensities.device)
    Ks = camera.pyramid_intrinsics(K, cfg.num_levels)
    return _track_chunk_steps(carry, intensities, depths, force_keyframe,
                              Ks, cfg, ScanConfig.from_slam(slam_cfg,
                                                            with_stats))


def track_keyframe_sequence(intensities, depths, K, cfg: TrackerConfig,
                            slam_cfg: SlamConfig = SlamConfig(),
                            force_keyframe=None, with_stats: bool = False):
    """Keyframe odometry over a whole sequence.

    Args:
      intensities / depths: (T, H, W) sequence on the device (depth NaN
        invalid, or the raw dtypes of track_keyframe_chunk).
      K: (4,) intrinsics tensor on the same device.
      cfg / slam_cfg: the entropy threshold, constraint ratio and fusion
        toggle come from slam_cfg, as in KeyframeSlam.
      force_keyframe: optional (T,) bool tensor — promote frame k to a
        keyframe (the forceKeyframe control input). Frame 0 is always the
        first keyframe.

    Returns a dict of per-frame tensors (leading dim T-1, frames 1..T-1):
      rel_pose (4,4): frame-cam <- active-keyframe-cam AFTER this frame's
        decision (identity where switch=True: the frame IS the new
        keyframe);
      switch (bool): this frame became a new keyframe;
      Z_switch (4,4): old-kf -> new-kf measurement where switch (garbage
        elsewhere); info_switch (6,6): its information;
      entropy, entropy_ratio, valid_ratio, accept, iterations, is_nan —
      the tracking-quality stream (reference Stats + evaluation signals).
    """
    T_total = intensities.shape[0]
    if force_keyframe is None:
        force_keyframe = torch.zeros(T_total, dtype=torch.bool,
                                     device=intensities.device)
    pyr0 = pyramid_from_stack(intensities, depths, 0, cfg.num_levels)
    _, outs = track_keyframe_chunk(
        init_carry(pyr0), intensities[1:], depths[1:], K, cfg, slam_cfg,
        force_keyframe=force_keyframe[1:], with_stats=with_stats,
    )
    return outs


def pyramid_from_stack(intensities, depths, k, num_levels):
    """Pyramid of frame k of a (T, H, W) stack (the chunked engine's
    keyframe-switch replay)."""
    return pyramid.build_pyramid(intensities[k], depths[k], num_levels)


def compose_keyframe_trajectory(outs, T0=None):
    """Host f64 composition of the scan outputs into world poses.

    Returns (poses, keyframe_indices): len(T) world poses (frame 0 at T0)
    and the frame indices that became keyframes (frame 0 included).
    """
    from dvo_slam_tpu_torch.utils import se3_np

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    switch = host(outs["switch"])
    rel = host(outs["rel_pose"]).astype(np.float64)
    Z = host(outs["Z_switch"]).astype(np.float64)
    T_w_kf = np.eye(4) if T0 is None else np.asarray(T0, np.float64)
    poses = [T_w_kf.copy()]
    kf_indices = [0]
    for k in range(len(switch)):
        if switch[k]:
            T_w_kf = T_w_kf @ se3_np.inverse(Z[k])
            kf_indices.append(k + 1)
            poses.append(T_w_kf.copy())
        else:
            poses.append(T_w_kf @ se3_np.inverse(rel[k]))
    return poses, kf_indices

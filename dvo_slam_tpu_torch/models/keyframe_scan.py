"""Device-resident keyframe odometry: the SLAM front-end as a loop over
frames with every decision on the device (counterpart of
``dvo_slam_tpu/models/keyframe_scan.py``).

The reference's KeyframeTracker front-end (dual alignment + entropy-ratio
keyframe selection + measurement fusion; dvo_slam/src/local_tracker.cpp +
tracking_result_evaluation.cpp, SURVEY.md §3.3) makes one host decision
per frame in the per-frame orchestrator (models/keyframe_tracker.py).
Here the keyframe-switch decision, the active-keyframe pyramid swap, the
constant-velocity warm start and the information fusion are all
``torch.where`` selections on 0-d device tensors, so a chunk of frames is
issued to the card with no device-to-host sync between frames: one
pyramid build and one batched tracker call (B = 2: the keyframe and the
previous frame against the new frame; one launch of csrc/linearize.cu's
level kernel per tracked level) per frame. The JAX package runs the same
step inside one ``lax.scan``.

No host sync holds for the configs the level kernel takes
(``ops/linearize.level_route``: the t-distribution, ``mu == 0``). Other
configs run the tracker's host loop, which reads each IRLS iteration's
stop flags back: the scan is still correct there, with those syncs.

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
from dvo_slam_tpu_torch.ops import camera, pyramid, se3

# ONE constant for both engines: a drift here would silently desynchronize
# the per-frame and scan engines' keyframe cadence.
_ENTROPY_FLOOR = dense_tracker._ENTROPY_DENOM_FLOOR


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


def _entropy_ratio(h_cur, h_ref, has_ref):
    """Sign-safe entropy ratio (dense_tracker.entropy_ratio) on 0-d
    tensors. No reference yet -> 1.0 even for non-finite h_cur (the host
    orchestrator keeps tracking until a finite first entropy establishes
    history; only WITH history does non-finite entropy force a switch)."""
    ref = torch.where(has_ref, h_ref, h_cur)
    ratio = 1.0 - (h_cur - ref) / torch.clamp(ref.abs(), min=_ENTROPY_FLOOR)
    ok = torch.isfinite(h_cur) & torch.isfinite(ref)
    return torch.where(has_ref, torch.where(ok, ratio, -torch.inf), 1.0)


def _fuse_relative_poses(T_a, info_a, T_b, info_b):
    """Information-weighted SE(3) fusion (keyframe_tracker.
    fuse_relative_poses in f32 on the device): one Gauss-Newton step from
    T_a. ``solve_ex`` does not check for errors (``solve`` would, with a
    sync); a singular system gives a non-finite step, dropped below."""
    xi = se3.log(T_b @ se3.inverse(T_a))
    L = info_a + info_b
    delta = torch.linalg.solve_ex(L, (info_b @ xi)[:, None])[0][:, 0]
    good = torch.isfinite(delta).all()
    delta = torch.where(good, delta, torch.zeros_like(delta))
    return se3.exp(delta) @ T_a


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


def _step(carry, intensity, depth, force, Ks, cfg: TrackerConfig,
          scan_cfg: ScanConfig):
    """One frame: (carry, frame) -> (new carry, outputs), all on the
    device, no host sync on the level kernel's route."""
    dev = carry["T_kf_prev"].device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    cur = pyramid.build_pyramid(intensity, depth, cfg.num_levels)
    tracked = set(cfg.tracked_levels)
    refs = tuple(
        torch.stack([kf_l, prev_l]) if lvl in tracked else None
        for lvl, (kf_l, prev_l) in enumerate(zip(carry["kf"], carry["prev"]))
    )
    odo_init = carry["last_odo"] if cfg.use_initial_estimate else eye
    inits = torch.stack([carry["T_kf_prev"], odo_init])
    res = dense_tracker.track_batched(refs, cur, Ks, inits, cfg)

    r_kf_T = res.transformation[0]
    r_odo_T = res.transformation[1]
    nan = res.is_nan()
    kf_nan, odo_nan = nan[0], nan[1]
    last_odo = torch.where(odo_nan, carry["last_odo"], r_odo_T)

    accept = (~kf_nan) & (res.valid_ratio[0] >= scan_cfg.min_constraint_ratio)
    h = res.entropy[0]
    ratio = torch.where(
        accept, _entropy_ratio(h, carry["H_first"], carry["has_first"]), 1.0)
    switch = force | (~accept) | (ratio < scan_cfg.min_entropy_ratio)

    # Non-switch pose: keyframe measurement fused with chained odometry
    # (LocalMap keyframe+odometry measurements, closed form).
    T_alt = r_odo_T @ carry["T_kf_prev"]
    if scan_cfg.fuse_odometry:
        fused = _fuse_relative_poses(r_kf_T, res.information[0], T_alt,
                                     res.information[1])
        T_kf_cur = torch.where(odo_nan, r_kf_T, fused)
    else:
        T_kf_cur = r_kf_T

    # Switch measurement old-kf -> new-kf (KeyframeSlam switch branch).
    Z_new = torch.where(accept, r_kf_T,
                        torch.where(odo_nan, carry["T_kf_prev"], T_alt))
    info_new = torch.where(
        accept, res.information[0],
        torch.where(odo_nan,
                    1e2 * torch.eye(6, dtype=torch.float32, device=dev),
                    res.information[1]))

    # First-frame entropy of the active keyframe (ratioWithFirst); after a
    # switch the new keyframe starts with no history.
    set_first = accept & (~carry["has_first"]) & torch.isfinite(h)
    H_first = torch.where(set_first, h, carry["H_first"])
    has_first = carry["has_first"] | set_first
    H_first = torch.where(switch, 0.0, H_first)
    has_first = has_first & ~switch

    new_carry = {
        "kf": tuple(torch.where(switch, c, k)
                    for c, k in zip(cur, carry["kf"])),
        "prev": cur,
        "T_kf_prev": torch.where(switch, eye, T_kf_cur),
        "last_odo": last_odo,
        "H_first": H_first,
        "has_first": has_first,
    }
    out = {
        "rel_pose": torch.where(switch, eye, T_kf_cur),
        "switch": switch,
        "Z_switch": Z_new,
        "info_switch": info_new,
        "entropy": h,
        "entropy_ratio": ratio,
        "valid_ratio": res.valid_ratio[0],
        "accept": accept,
        "iterations": res.iterations,
        "is_nan": nan,
        # Raw (pre-fusion) dual measurements + informations: the chunked
        # walk replays the windowed LocalMap solve from these.
        "T_kf_meas": r_kf_T,
        "T_odo_meas": r_odo_T,
        "info_pair": res.information,
    }
    if cfg.collect_stats and scan_cfg.with_stats:
        # Per-iteration TrackStats of both alignments (batch 2: keyframe,
        # odometry), for ChunkedKeyframeSlam's frame logger.
        out["stats"] = tuple(res.stats[:5])
    return new_carry, out


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
    track_keyframe_sequence split at arbitrary boundaries."""
    n = intensities.shape[0]
    if force_keyframe is None:
        force_keyframe = torch.zeros(n, dtype=torch.bool,
                                     device=intensities.device)
    Ks = camera.pyramid_intrinsics(K, cfg.num_levels)
    scan_cfg = ScanConfig.from_slam(slam_cfg, with_stats)
    outs = []
    for k in range(n):
        carry, out = _step(carry, intensities[k], depths[k],
                           force_keyframe[k], Ks, cfg, scan_cfg)
        outs.append(out)
    stacked = {}
    for key in outs[0] if outs else ():
        if key == "stats":
            stacked[key] = tuple(torch.stack([o[key][i] for o in outs])
                                 for i in range(5))
        else:
            stacked[key] = torch.stack([o[key] for o in outs])
    return carry, stacked


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

"""Odometry and keyframe front ends over fleets of sequences (counterpart
of ``dvo_slam_tpu/parallel/batch_slam.py``).

The JAX package vmaps its device-resident sequence scans over a batch of
sequences and shards the batch over a mesh axis. Here:

- ``track_sequences_batched`` runs S sequences frame by frame through
  ``dense_tracker.track_batched`` at B = S (row s: sequence s's previous
  frame against its current frame): on the card one level-kernel launch
  per tracked level per frame index, whatever S.
- ``keyframe_sequences_batched`` loops over the sequences, each through
  ``keyframe_scan.track_keyframe_sequence`` (its B = 2 dual alignment a
  frame): S launches per tracked level per frame index. The scan's
  keyframe swap is a per-sequence selection on the device; batching the
  sequences into its rows would only change the launch count.
- The ``_sharded`` variants give each rank of the mesh's ``batch`` axis
  its S / dp sequences (ranks along ``pixel`` repeat the same work, as
  the JAX package replicates over its pixel axis). No collective runs
  until the outputs are gathered, so every rank returns the whole batch.
"""

from __future__ import annotations

import torch

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker, keyframe_scan
from dvo_slam_tpu_torch.ops import camera, pyramid
from dvo_slam_tpu_torch.parallel import sharded


def _pyramids(intensities, depths, k, num_levels):
    """Frame k of every sequence: a pyramid of (S, 6, H, W) levels."""
    pyrs = [pyramid.build_pyramid(intensities[s, k], depths[s, k],
                                  num_levels)
            for s in range(intensities.shape[0])]
    return tuple(torch.stack(lvl) for lvl in zip(*pyrs))


def track_sequences_batched(intensities, depths, K, cfg: TrackerConfig):
    """Frame-to-frame odometry (models/odometry.track_sequence) over S
    sequences at once.

    intensities / depths: (S, T, H, W) on the device; K: (4,) intrinsics.
    Returns a dict of (S, T-1, ...) tensors: rel_poses, entropy,
    valid_ratio, iterations, is_nan (per sequence as track_sequence's)."""
    S, T = intensities.shape[:2]
    Ks = camera.pyramid_intrinsics(K, cfg.num_levels)
    eye = torch.eye(4, dtype=torch.float32,
                    device=intensities.device).expand(S, 4, 4)
    prev = _pyramids(intensities, depths, 0, cfg.num_levels)
    last_rel = eye
    outs = {k: [] for k in ("rel_poses", "entropy", "valid_ratio",
                            "iterations", "is_nan")}
    for k in range(1, T):
        cur = _pyramids(intensities, depths, k, cfg.num_levels)
        T0 = last_rel if cfg.use_initial_estimate else eye
        res = dense_tracker.track_batched(prev, cur, Ks, T0.contiguous(),
                                          cfg)
        # NaN guard per sequence: keep the constant-velocity increment.
        is_nan = res.is_nan()
        last_rel = torch.where(is_nan[:, None, None], last_rel,
                               res.transformation)
        for key, x in (("rel_poses", last_rel), ("entropy", res.entropy),
                       ("valid_ratio", res.valid_ratio),
                       ("iterations", res.iterations), ("is_nan", is_nan)):
            outs[key].append(x)
        prev = cur
    return {k: torch.stack(v, dim=1) for k, v in outs.items()}


def track_sequences_sharded(mesh, intensities, depths, K, cfg: TrackerConfig,
                            axis: str = "batch"):
    """``track_sequences_batched`` with the S sequences split over the mesh
    axis (S must split evenly): each rank tracks its own and the outputs
    are gathered, so every rank returns all S. The inputs are the whole
    batch on every rank."""
    out = track_sequences_batched(
        sharded.shard_rows(intensities, mesh, axis),
        sharded.shard_rows(depths, mesh, axis), K, cfg)
    return sharded.gather_rows(out, mesh, axis)


def keyframe_sequences_batched(intensities, depths, K, cfg: TrackerConfig,
                               slam_cfg: SlamConfig = None,
                               force_keyframe=None):
    """The keyframe front end (keyframe_scan.track_keyframe_sequence: dual
    alignment, entropy-ratio switching, measurement fusion) over S
    sequences, one after the other.

    intensities / depths: (S, T, H, W); force_keyframe: optional (S, T)
    bool. Returns a dict of (S, T-1, ...) tensors, ready for per-sequence
    backends (compose_keyframe_trajectory, ChunkedKeyframeSlam)."""
    slam_cfg = slam_cfg or SlamConfig()
    S = intensities.shape[0]
    outs = [keyframe_scan.track_keyframe_sequence(
        intensities[s], depths[s], K, cfg, slam_cfg,
        force_keyframe=None if force_keyframe is None else force_keyframe[s])
        for s in range(S)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def keyframe_sequences_sharded(mesh, intensities, depths, K,
                               cfg: TrackerConfig, slam_cfg: SlamConfig = None,
                               force_keyframe=None, axis: str = "batch"):
    """``keyframe_sequences_batched`` with the sequences split over the mesh
    axis, gathered on every rank (as ``track_sequences_sharded``)."""
    out = keyframe_sequences_batched(
        sharded.shard_rows(intensities, mesh, axis),
        sharded.shard_rows(depths, mesh, axis), K, cfg, slam_cfg,
        None if force_keyframe is None
        else sharded.shard_rows(force_keyframe, mesh, axis))
    return sharded.gather_rows(out, mesh, axis)

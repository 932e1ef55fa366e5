"""Carry state between the JAX package and this port.

The system has no weights: what crosses over is the tracker configuration,
the intrinsics, the pyramids and the poses. These helpers take plain
Python and numpy values (never JAX objects), so this module imports no
jax; callers turn JAX arrays into numpy first (``np.asarray``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models.dense_tracker import TrackResult, TrackStats

# JAX TrackerConfig fields that only shaped the TPU's windowed Pallas
# sampler; the port's gather kernel has nothing to set from them.
TPU_ONLY_FIELDS = (
    "sampler_backend",
    "pallas_rows_per_tile",
    "pallas_cols_per_tile",
    "pallas_margin",
    "pallas_miss_escalate",
    "pallas_precision",
    "pallas_compact_window_rows",
)


def tracker_config_from_fields(fields: dict) -> TrackerConfig:
    """The port's TrackerConfig from ``dataclasses.asdict`` of a JAX
    ``TrackerConfig``.

    Drops the TPU-only knobs. Raises ValueError on a field the port does
    not know, and NotImplementedError (from TrackerConfig) on values it
    cannot honour yet, such as point_budget_fraction > 0.
    """
    known = {f.name for f in dataclasses.fields(TrackerConfig)}
    kept = {k: v for k, v in fields.items() if k not in TPU_ONLY_FIELDS}
    unknown = sorted(set(kept) - known)
    if unknown:
        raise ValueError(f"TrackerConfig fields the port does not know: "
                         f"{unknown}")
    return TrackerConfig(**kept)


def pyramid_from_numpy(levels, device):
    """Tuple of (6, H, W) arrays -> tuple of contiguous f32 tensors on
    `device`."""
    return tuple(
        torch.as_tensor(np.ascontiguousarray(lvl, np.float32), device=device)
        for lvl in levels
    )


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_to_numpy(res: TrackResult) -> TrackResult:
    """A TrackResult with every tensor (stats included) as a numpy array."""
    fields = {k: _to_numpy(v) for k, v in res._asdict().items()
              if k != "stats"}
    stats = (None if res.stats is None
             else TrackStats(*[_to_numpy(x) for x in res.stats]))
    return TrackResult(stats=stats, **fields)

"""Carry state between the JAX package and this port.

The system has no weights: what crosses over is the tracker and SLAM
configurations, the intrinsics, the pyramids, the poses and the host pose
graph. These helpers take plain
Python and numpy values (never JAX objects), so this module imports no
jax; callers turn JAX arrays into numpy first (``np.asarray``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models.dense_tracker import TrackResult, TrackStats
from dvo_slam_tpu_torch.models.pose_graph import PoseGraph

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
    not know, or on a value TrackerConfig refuses (such as
    point_budget_fraction outside [0, 1]).
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


def to_numpy(x):
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_to_numpy(res: TrackResult) -> TrackResult:
    """A TrackResult with every tensor (stats included) as a numpy array."""
    fields = {k: to_numpy(v) for k, v in res._asdict().items()
              if k != "stats"}
    stats = (None if res.stats is None
             else TrackStats(*[to_numpy(x) for x in res.stats]))
    return TrackResult(stats=stats, **fields)


def slam_config_from_fields(fields: dict) -> SlamConfig:
    """The port's SlamConfig from ``dataclasses.asdict`` of a JAX
    ``SlamConfig`` (same fields). Raises ValueError on a field the port
    does not know."""
    known = {f.name for f in dataclasses.fields(SlamConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"SlamConfig fields the port does not know: "
                         f"{unknown}")
    return SlamConfig(**fields)


def pose_graph_from_numpy(graph) -> PoseGraph:
    """A host pose graph (numpy arrays, in the JAX PoseGraph's field order
    and dtypes) as the port's host PoseGraph; each array is copied."""
    dtypes = (np.float32, np.int32, np.int32, np.int32, np.float32,
              np.float32, bool, np.int32)
    return PoseGraph(*(np.array(np.asarray(x), dtype=d)
                       for x, d in zip(graph, dtypes)))


def pose_graph_to_numpy(graph: PoseGraph) -> PoseGraph:
    """Any port PoseGraph (host arrays, or tensors from ``optimize``) as
    numpy arrays with the JAX PoseGraph's dtypes; pass the result to
    ``dvo_slam_tpu.models.pose_graph.PoseGraph(*...)``."""
    return pose_graph_from_numpy(tuple(to_numpy(x) for x in graph))

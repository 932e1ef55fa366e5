"""SLAM state checkpoint / resume (counterpart of
``dvo_slam_tpu/utils/checkpoint.py``).

The reference has no mid-run checkpointing (SURVEY.md §6) — trajectories
are only serialized at the end. The full KeyframeSlam state (pose graph,
keyframe poses/metadata and pyramids, per-frame records, the pending
local-map window, tracking state) saves to one .npz in the JAX package's
format (version 3: the same keys, shapes and dtypes), so a file written by
either package resumes in the other. Keyframe pyramids are (6, H, W) f32
per level in both. A chunked engine (models/chunked_slam.py) also saves
its scan carry (``carry_*``), so a chunked checkpoint of either package
resumes in the other's chunked engine.
"""

from __future__ import annotations

import numpy as np
import torch

_FORMAT_VERSION = 3
_CARRY_STATE = ("T_kf_prev", "last_odo", "H_first", "has_first")


def save_slam(path: str, slam) -> None:
    """Serialize a models.keyframe_tracker.KeyframeSlam to .npz at exactly
    `path` (whatever its extension)."""
    from dvo_slam_tpu_torch.convert import to_numpy
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeSlam

    if not isinstance(slam, KeyframeSlam):
        raise TypeError(f"save_slam takes a KeyframeSlam, got {type(slam)}")
    chunked = isinstance(slam, ChunkedKeyframeSlam)
    if chunked:
        slam._drain_chunks()  # walk submitted chunks
    # Land every in-flight device result (window refinement, loop-closure
    # validation, async graph solve) in one combined transfer.
    slam._drain_device_reads()
    num_levels = slam.tracker_cfg.num_levels
    data = {
        "version": np.asarray(_FORMAT_VERSION),
        "engine_chunked": np.asarray(chunked),
        "num_levels": np.asarray(num_levels),
        "first_level": np.asarray(slam.tracker_cfg.first_level),
        "last_level": np.asarray(slam.tracker_cfg.last_level),
        "local_map_capacity": np.asarray(slam.slam_cfg.local_map_capacity),
        "last_odo": np.asarray(slam._last_odo),
        "force_next": np.asarray(slam._force_next),
        # The anchor pose for the next fresh keyframe: what update() uses
        # while _initialized is False (initial pose, or the pose set by
        # reset()).
        "T0": np.asarray(getattr(slam, "_T0", np.eye(4)), np.float64),
        "num_keyframes": np.asarray(len(slam.keyframes)),
        "num_loop_edges": np.asarray(slam.num_loop_edges),
        "kf_poses": (np.stack(slam.kf_poses) if slam.kf_poses
                     else np.zeros((0, 4, 4))),
        "kf_timestamps": np.asarray([k.timestamp for k in slam.keyframes]),
        "kf_entropy_first": np.asarray(
            [k.entropy_first if k.entropy_first is not None else np.nan
             for k in slam.keyframes]
        ),
        "kf_entropy_sum": np.asarray([k.entropy_sum for k in slam.keyframes]),
        "kf_entropy_count": np.asarray([k.entropy_count
                                        for k in slam.keyframes]),
        "frame_timestamps": np.asarray([f.timestamp for f in slam.frames]),
        "frame_kf_idx": np.asarray([f.keyframe_idx for f in slam.frames]),
        "frame_rel_poses": (
            np.stack([f.T_kf_frame for f in slam.frames])
            if slam.frames else np.zeros((0, 4, 4))
        ),
        "T_kf_prev": np.asarray(slam._T_kf_prev),
        "initialized": np.asarray(slam._initialized),
    }
    # Active local-map window (resume equivalence needs the pending
    # measurements so the next keyframe switch refines the same window).
    lm = slam._local_map
    n_lm = len(lm)
    eye4, eye6 = np.eye(4), np.eye(6)
    data["lm_frame_indices"] = np.asarray(lm.frame_indices,
                                          np.int64).reshape(n_lm)
    data["lm_estimates"] = (
        np.stack(lm.estimates) if n_lm else np.zeros((0, 4, 4))
    )
    for name, meas in (("kf", lm.kf_meas), ("odo", lm.odo_meas)):
        data[f"lm_{name}_valid"] = np.asarray([m is not None for m in meas],
                                              bool)
        data[f"lm_{name}_T"] = np.stack(
            [eye4 if m is None else m[0] for m in meas]
        ) if n_lm else np.zeros((0, 4, 4))
        data[f"lm_{name}_info"] = np.stack(
            [eye6 if m is None else m[1] for m in meas]
        ) if n_lm else np.zeros((0, 6, 6))
    # Pose graph (host arrays), in the JAX PoseGraph's dtypes.
    for name in ["poses", "num_vertices", "edge_i", "edge_j", "measurements",
                 "information", "edge_mask", "num_edges"]:
        data[f"graph_{name}"] = to_numpy(getattr(slam.graph, name))
    # Keyframe pyramids per level (stacked) + prev-frame pyramid; device
    # tensors and evicted host copies alike.
    for lvl in range(num_levels):
        if slam.keyframes:
            data[f"kf_pyr_{lvl}"] = np.stack(
                [to_numpy(k.pyramid[lvl]) for k in slam.keyframes]
            )
        if slam._prev_pyr is not None:
            data[f"prev_pyr_{lvl}"] = to_numpy(slam._prev_pyr[lvl])
    # Chunked engine: the device scan carry. carry_present is False for a
    # chunked engine saved before its first chunk (engine identity is
    # engine_chunked above).
    carry = slam._carry if chunked else None
    data["carry_present"] = np.asarray(carry is not None)
    if carry is not None:
        for lvl in range(num_levels):
            data[f"carry_kf_{lvl}"] = to_numpy(carry["kf"][lvl])
            data[f"carry_prev_{lvl}"] = to_numpy(carry["prev"][lvl])
        for name in _CARRY_STATE:
            data[f"carry_{name}"] = to_numpy(carry[name])
    # Through an open handle: np.savez_compressed(path_str) APPENDS ".npz"
    # to other extensions, so `--checkpoint-out state.ckpt` would write
    # state.ckpt.npz and a later `--resume state.ckpt` would not find it.
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)


def load_slam(path: str, K, tracker_cfg=None, slam_cfg=None,
              enable_loop_closure=True, chunked=False, device="cuda"):
    """Restore a KeyframeSlam from .npz on `device`; returns a
    ready-to-update instance.

    chunked=True restores a models.chunked_slam.ChunkedKeyframeSlam, from
    a checkpoint written by a chunked engine (of either package).

    Raises ValueError when the configs cannot hold the checkpoint
    (different pyramid levels, a local-map window larger than
    ``local_map_capacity``) or when ``chunked`` does not match the engine
    that wrote it."""
    from dvo_slam_tpu_torch import convert
    from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.models.keyframe_tracker import (
        FrameRecord, Keyframe, KeyframeSlam,
    )

    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format version {int(z['version'])} != "
            f"{_FORMAT_VERSION} (this reader)"
        )
    tracker_cfg = tracker_cfg or TrackerConfig()
    slam_cfg = slam_cfg or SlamConfig()
    for field in ("num_levels", "first_level", "last_level"):
        stored = int(z[field])
        passed = getattr(tracker_cfg, field)
        if stored != passed:
            raise ValueError(
                f"checkpoint was written with tracker_cfg.{field}={stored} "
                f"but loading with {field}={passed}; pass a matching "
                "TrackerConfig"
            )
    stored_lm = int(z["local_map_capacity"])
    n_lm = len(z["lm_frame_indices"])
    if n_lm + 1 > slam_cfg.local_map_capacity:
        # LocalMap.add_frame drops frames once full: a smaller capacity
        # would truncate the pending window instead of resuming it.
        raise ValueError(
            f"checkpoint has a {n_lm}-frame pending local-map window "
            f"(written with local_map_capacity={stored_lm}) but loading "
            f"with local_map_capacity={slam_cfg.local_map_capacity}; pass "
            "a SlamConfig whose window can hold it"
        )
    if bool(z["engine_chunked"]) != bool(chunked):
        raise ValueError(
            "checkpoint was written by the "
            + ("chunked" if bool(z["engine_chunked"]) else "per-frame")
            + f" engine — load with chunked={bool(z['engine_chunked'])}"
        )
    engine = ChunkedKeyframeSlam if chunked else KeyframeSlam
    slam = engine(K, tracker_cfg, slam_cfg, enable_loop_closure,
                  device=device)
    slam.init(np.asarray(z["T0"], np.float64))

    n_kf = int(z["num_keyframes"])
    num_levels = tracker_cfg.num_levels
    # The residency budget holds while restoring: only the newest
    # `resident_keyframes` pyramids go to the device; older ones stay host
    # numpy, exactly where eviction would have put them.
    first_resident = max(0, n_kf - slam_cfg.resident_keyframes)
    for k in range(n_kf):
        levels = [z[f"kf_pyr_{lvl}"][k] for lvl in range(num_levels)]
        resident = k >= first_resident
        pyr = (convert.pyramid_from_numpy(levels, slam.device) if resident
               else tuple(np.ascontiguousarray(a, np.float32)
                          for a in levels))
        ef = float(z["kf_entropy_first"][k])
        slam.keyframes.append(
            Keyframe(
                idx=k,
                timestamp=float(z["kf_timestamps"][k]),
                pyramid=pyr,
                entropy_first=None if np.isnan(ef) else ef,
                entropy_sum=float(z["kf_entropy_sum"][k]),
                entropy_count=int(z["kf_entropy_count"][k]),
                resident=resident,
            )
        )
        slam.kf_poses.append(np.asarray(z["kf_poses"][k], np.float64))

    slam.graph = convert.pose_graph_from_numpy(
        [z[f"graph_{name}"] for name in (
            "poses", "num_vertices", "edge_i", "edge_j", "measurements",
            "information", "edge_mask", "num_edges")])
    slam.num_loop_edges = int(z["num_loop_edges"])
    for i in range(len(z["frame_timestamps"])):
        slam.frames.append(
            FrameRecord(
                timestamp=float(z["frame_timestamps"][i]),
                keyframe_idx=int(z["frame_kf_idx"][i]),
                T_kf_frame=np.asarray(z["frame_rel_poses"][i], np.float64),
            )
        )
    if "prev_pyr_0" in z:
        slam._prev_pyr = convert.pyramid_from_numpy(
            [z[f"prev_pyr_{lvl}"] for lvl in range(num_levels)], slam.device)
    for i in range(n_lm):
        slam._local_map.add_frame(
            int(z["lm_frame_indices"][i]),
            np.asarray(z["lm_estimates"][i], np.float64),
            (np.asarray(z["lm_kf_T"][i], np.float64),
             np.asarray(z["lm_kf_info"][i], np.float64))
            if bool(z["lm_kf_valid"][i]) else None,
            (np.asarray(z["lm_odo_T"][i], np.float64),
             np.asarray(z["lm_odo_info"][i], np.float64))
            if bool(z["lm_odo_valid"][i]) else None,
        )
    slam._T_kf_prev = np.asarray(z["T_kf_prev"], np.float64)
    slam._last_odo = np.asarray(z["last_odo"], np.float64)
    slam._force_next = bool(z["force_next"])
    slam._initialized = bool(z["initialized"])
    if chunked and bool(z["carry_present"]):
        slam._carry = {
            "kf": convert.pyramid_from_numpy(
                [z[f"carry_kf_{lvl}"] for lvl in range(num_levels)],
                slam.device),
            "prev": convert.pyramid_from_numpy(
                [z[f"carry_prev_{lvl}"] for lvl in range(num_levels)],
                slam.device),
            **{name: torch.as_tensor(z[f"carry_{name}"], device=slam.device)
               for name in _CARRY_STATE},
        }
    slam._evict_keyframe_pyramids()  # re-apply the residency budget
    return slam

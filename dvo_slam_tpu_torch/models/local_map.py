"""Windowed local-map optimization for the active keyframe (counterpart of
``dvo_slam_tpu/models/local_map.py``; reference LocalMap,
dvo_slam/src/local_map.cpp): a small pose graph over the
active keyframe's window — the keyframe vertex (fixed) plus one vertex per
tracked frame, connected by keyframe->frame edges weighted with the dense
tracker's information matrices and frame->frame odometry edges. The
reference solves this mini-graph with g2o; here the window is solved by the
same padded Levenberg-Marquardt used for the global graph
(models/pose_graph.py), on the map's device: on a CUDA device every
window solve is one kernel launch (pose_graph.graph_route), which reads
nothing back until the caller fetches the poses.

Division of labour with the orchestrator (models/keyframe_tracker.py):
per-frame the current pose uses the cheap closed-form information fusion
(fuse_relative_poses — a single Gauss-Newton step, exact for two estimates
of the same pose); the joint window solve runs on keyframe switch (and at
finish() for the trailing window), refining ALL intermediate frame poses
with information flowing both ways along the window before the relative
poses are handed to the global graph.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from dvo_slam_tpu_torch.models import pose_graph
from dvo_slam_tpu_torch.utils import se3_np

Measurement = Tuple[np.ndarray, np.ndarray]  # ((4,4) transform, (6,6) info)


class LocalMap:
    """Measurement window for one active keyframe.

    Frame poses live in the keyframe's camera frame: vertex i+1 estimates
    T_w_frame = inv(T_kf_frame) with world == keyframe camera (vertex 0,
    gauge-fixed at identity by the solver's prior on vertex 0). The window
    is solved on ``device``, the card unless the caller asks for "cpu".
    """

    def __init__(self, capacity: int = 64, device="cuda"):
        self.capacity = capacity
        self.device = device
        self.frame_indices: List[int] = []  # orchestrator frame-record ids
        self.estimates: List[np.ndarray] = []  # fused T_kf_frame (4,4) f64
        self.kf_meas: List[Optional[Measurement]] = []  # kf -> frame
        self.odo_meas: List[Optional[Measurement]] = []  # prev -> frame

    def __len__(self) -> int:
        return len(self.frame_indices)

    @property
    def full(self) -> bool:
        # +1: the keyframe occupies vertex 0 of the padded graph.
        return len(self.frame_indices) + 1 >= self.capacity

    def add_frame(
        self,
        frame_index: int,
        T_kf_frame: np.ndarray,
        kf_meas: Optional[Measurement],
        odo_meas: Optional[Measurement],
    ) -> None:
        """Record one tracked frame (reference LocalMap::addFrame +
        addKeyframeMeasurement + addOdometryMeasurement).

        Frames beyond capacity keep their closed-form fused estimates and
        are excluded from the joint solve (the entropy-ratio keyframe
        cadence keeps windows far below any sane capacity).
        """
        if self.full:
            return
        self.frame_indices.append(frame_index)
        self.estimates.append(np.asarray(T_kf_frame, np.float64))
        self.kf_meas.append(kf_meas)
        self.odo_meas.append(odo_meas)

    def optimize(self, iterations: int = 10) -> List[np.ndarray]:
        """Jointly refine the window (reference LocalMap::optimize).

        Returns refined T_kf_frame (frame-cam <- kf-cam) for every recorded
        frame, in insertion order. Falls back to the fused estimates when
        the window is trivial (a single frame's fusion is already the
        exact two-measurement solution).

        Synchronous form of optimize_async + refined_from: orchestrators
        that also dispatch loop-closure validation at a keyframe switch
        use the split form so BOTH results ride one device->host transfer.
        """
        handle = self.optimize_async(iterations)
        if handle is None:
            return list(self.estimates)
        return self.refined_from(handle.cpu().numpy())

    def optimize_async(self, iterations: int = 10):
        """Dispatch the window solve WITHOUT fetching (on a CUDA device one
        graph-kernel launch, no host sync); returns the (cap, 4, 4) poses
        tensor on the map's device (or None when the window is trivial).
        Pass the fetched array to refined_from."""
        n = len(self.frame_indices)
        if n < 2:
            return None

        # Assemble the padded window graph on the host; the solve uploads
        # it. Pad to the active bucket, not full capacity: entropy-cadence
        # windows are ~10-20 frames, so solving inside the default 64-slot
        # pad wastes ~30x the FLOPs per switch (pose_graph.bucket).
        cap = min(self.capacity, pose_graph.bucket(n + 1, 16))
        poses = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        for i, est in enumerate(self.estimates):
            poses[i + 1] = se3_np.inverse(est).astype(np.float32)

        ei, ej, Z, info = [], [], [], []
        for i in range(n):
            if self.kf_meas[i] is not None:
                T, L = self.kf_meas[i]
                ei.append(0)
                ej.append(i + 1)
                Z.append(se3_np.inverse(np.asarray(T, np.float64)))
                info.append(np.asarray(L, np.float64))
            if self.odo_meas[i] is not None:
                T, L = self.odo_meas[i]
                ei.append(i)  # vertex 0 == keyframe is the first "previous"
                ej.append(i + 1)
                Z.append(se3_np.inverse(np.asarray(T, np.float64)))
                info.append(np.asarray(L, np.float64))
        if not ei:
            # No measurements to solve against: the window is trivial.
            # None (not the estimates list!) — callers treat any non-None
            # return as a device poses handle for refined_from.
            return None

        E = len(ei)
        cap_e = 2 * cap
        assert E <= cap_e
        edge_i = np.zeros(cap_e, np.int32)
        edge_j = np.zeros(cap_e, np.int32)
        measurements = np.tile(np.eye(4, dtype=np.float32), (cap_e, 1, 1))
        information = np.tile(np.eye(6, dtype=np.float32), (cap_e, 1, 1))
        edge_mask = np.zeros(cap_e, bool)
        edge_i[:E] = ei
        edge_j[:E] = ej
        measurements[:E] = np.stack(Z).astype(np.float32)
        information[:E] = np.stack(info).astype(np.float32)
        edge_mask[:E] = True
        graph = pose_graph.PoseGraph(
            poses=poses,
            num_vertices=np.asarray(n + 1, np.int32),
            edge_i=edge_i,
            edge_j=edge_j,
            measurements=measurements,
            information=information,
            edge_mask=edge_mask,
            num_edges=np.asarray(E, np.int32),
        )
        # Plain (non-robust) LM: window measurements already passed the
        # tracker's acceptance criteria; the reference's local g2o solve
        # runs without a robust kernel too.
        solved, _, _ = pose_graph.optimize(
            graph, iterations=iterations, use_robust=False, device=self.device
        )
        return solved.poses

    def refined_from(self, host_poses: np.ndarray) -> List[np.ndarray]:
        """Turn the fetched solve output into refined T_kf_frame poses (in
        insertion order), falling back per frame on non-finite rows."""
        refined = np.asarray(host_poses, np.float64)
        out = []
        for i in range(len(self.frame_indices)):
            T_w_frame = refined[i + 1]
            if not np.isfinite(T_w_frame).all():
                out.append(self.estimates[i])
                continue
            out.append(se3_np.inverse(se3_np.renormalize(T_w_frame)))
        return out

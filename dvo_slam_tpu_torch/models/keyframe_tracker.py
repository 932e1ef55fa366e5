"""Keyframe-based SLAM orchestration, the public SLAM entry point
(counterpart of ``dvo_slam_tpu/models/keyframe_tracker.py``).

The facade mirrors the reference's KeyframeTracker
(dvo_slam/src/keyframe_tracker.cpp: init / update / forceKeyframe /
finish), internally fusing:

  * LocalTracker (dvo_slam/src/local_tracker.cpp): the reference runs the
    current frame against the active keyframe AND the previous frame as two
    TBB tasks; here it is ONE batched tracker call with batch dim 2 (on
    the card one launch of csrc/linearize.cu's level kernel per level).
  * TrackingResultEvaluation: entropy-ratio keyframe selection
    (IROS13 §IV, SURVEY.md §4.5) with the first-frame-after-keyframe
    denominator (ratioWithFirst).
  * LocalMap (dvo_slam/src/local_map.cpp): per-frame relative poses
    against the active keyframe, handed to the global graph on keyframe
    switch.
  * KeyframeGraph (dvo_slam/src/keyframe_graph.cpp): keyframe vertices +
    odometry and validated loop-closure edges, optimized on device by
    models/pose_graph.py (the g2o replacement). The reference optimizes on
    a background thread so tracking never blocks; here the solve runs on
    the device WITHOUT reading its outputs: the optimized poses stay on
    the device and the host mirror is marked stale, refreshed at the same
    fixed points as in the JAX package (next keyframe switch, loop-closure
    search, trajectory(), finish()). Per-frame pose returns between
    switches use the stale mirror, so the poses returned per frame are the
    JAX package's.

Host responsibilities (this file) are bookkeeping only: pose chains in
f64 NumPy, keyframe records, edge lists. All dense math stays on the
device (``device``, "cuda" unless the caller asks for "cpu").

Around it: an optional per-frame logger (utils/stats.FrameLogger),
``export_graph`` (.g2o, utils/g2o_io.py) and checkpoints
(utils/checkpoint.py, the JAX package's .npz format).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models import (constraints, dense_tracker, local_map,
                                       pose_graph)
from dvo_slam_tpu_torch.ops import camera, pyramid
from dvo_slam_tpu_torch.utils import se3_np
from dvo_slam_tpu_torch.utils.transfer import to_host


# Window-miss voter threshold: the JAX TrackerConfig's pallas_miss_escalate
# default, which its KeyframeSlam hands the voter.
_WINDOW_MISS_THRESHOLD = 0.02


def _cov_from_info(info) -> np.ndarray:
    """Covariance = Information^{-1} (f64), NaN matrix when unusable —
    the reference's PoseWithCovarianceStamped payload."""
    cov = np.full((6, 6), np.nan)
    info = np.asarray(info, np.float64)
    if np.isfinite(info).all():
        try:
            cov = np.linalg.inv(info)
        except np.linalg.LinAlgError:
            pass
    return cov


def _slam_frame_step(intensity, depth, kf_pyr, prev_pyr, inits, Ks,
                     cfg: TrackerConfig):
    """One frame's device work: pyramid build + dual alignment (keyframe
    and previous frame against the new frame, one batched tracker call of
    B = 2). The two references' tracked levels go as pairs of slabs (row
    pointers on the kernel front; the eager front stacks them)."""
    pyr = pyramid.build_pyramid(intensity, depth, cfg.num_levels)
    tracked = set(cfg.tracked_levels)
    refs = tuple(
        (kf_lvl, prev_lvl) if lvl in tracked else None
        for lvl, (kf_lvl, prev_lvl) in enumerate(zip(kf_pyr, prev_pyr))
    )
    res = dense_tracker.track_batched(refs, pyr, Ks, inits, cfg)
    return pyr, res


@dataclasses.dataclass
class Keyframe:
    """Host record (reference dvo_slam/include/dvo_slam/keyframe.h)."""

    idx: int
    timestamp: float
    pyramid: tuple  # slab pyramid; device tensors while resident, numpy after eviction
    entropy_first: Optional[float] = None  # H of first frame tracked vs this kf
    entropy_sum: float = 0.0
    entropy_count: int = 0
    resident: bool = True  # pyramid currently in device memory
    # In-flight spill: (host tensors, CUDA event or None) until finalized.
    spill: Optional[tuple] = None

    @property
    def entropy_avg(self) -> Optional[float]:
        if self.entropy_count == 0:
            return self.entropy_first
        return self.entropy_sum / self.entropy_count


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    keyframe_idx: int
    T_kf_frame: np.ndarray  # (4, 4) frame-cam <- kf-cam ... stored as kf->frame


class KeyframeSlam:
    """Full SLAM pipeline: dense keyframe odometry + pose-graph backend.

    Equivalent public surface to the reference KeyframeTracker:
    init(pose) / update(intensity, depth, t) -> pose / force_keyframe() /
    finish() -> optimized trajectory.
    """

    def __init__(
        self,
        K,
        tracker_cfg: TrackerConfig = TrackerConfig(),
        slam_cfg: SlamConfig = SlamConfig(),
        enable_loop_closure: bool = True,
        frame_logger=None,
        collect_covariance: bool = False,
        device="cuda",
    ):
        """frame_logger: optional utils.stats.FrameLogger; when set, every
        update() after the first appends a structured record with the
        per-iteration tracking statistics (reference per-frame Stats +
        ROS_INFO logs), the JAX package's record. The statistics ride the
        frame's one device-to-host transfer; without a logger nothing more
        is fetched.

        device: where tracking, validation and the solves run ("cuda" by
        default; "cpu" runs the plain versions of the kernels).

        collect_covariance: keep a per-frame (timestamp, (6,6) f64)
        covariance list (Information^{-1} of the accepted keyframe
        alignment — what the reference's keyframe-tracker node publishes
        as PoseWithCovarianceStamped). The information matrix is already
        part of each frame's fetch, so this costs one host inverse."""
        self.tracker_cfg = tracker_cfg
        self.slam_cfg = slam_cfg
        self.enable_loop_closure = enable_loop_closure
        self.frame_logger = frame_logger
        self.collect_covariance = collect_covariance
        self.covariances: List[Tuple[float, np.ndarray]] = []
        self.device = torch.device(device)
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.Ks = camera.pyramid_intrinsics(self.K, tracker_cfg.num_levels)
        # Loop-closure validation configs (coarse stage tracks only the
        # coarsest levels, reference two-stage validation).
        self.coarse_cfg = dataclasses.replace(
            tracker_cfg,
            first_level=min(slam_cfg.coarse_first_level, tracker_cfg.num_levels - 1),
            last_level=min(slam_cfg.coarse_last_level, tracker_cfg.num_levels - 1),
            max_iterations=slam_cfg.coarse_max_iterations,
        )
        self.fine_cfg = tracker_cfg

        # Global graph: HOST-resident numpy arrays. Graph edits (new
        # keyframe vertices, odometry/loop edges) are host writes; the
        # padded graph is uploaded once per optimize(). Only the solve's
        # output poses live on the device (_pending_poses) until the next
        # pose read.
        self.graph = pose_graph.empty_graph_host(
            slam_cfg.max_keyframes, slam_cfg.max_edges
        )
        self._pending_poses = None  # device tensor of the in-flight solve
        self.kf_poses: List[np.ndarray] = []  # world <- keyframe, f64 host mirror
        self.keyframes: List[Keyframe] = []
        self.frames: List[FrameRecord] = []
        self.num_loop_edges = 0
        # Solve-frequency backoff state (_should_solve_interleaved).
        self._switches_since_solve = 0
        self._loop_edges_since_solve = 0

        # Per-frame tracking state.
        self._prev_pyr = None
        self._T_kf_prev = np.eye(4)  # prev-cam <- kf-cam (i.e. kf -> prev)
        self._last_odo = np.eye(4)  # last frame-to-frame increment
        self._initialized = False
        self._force_next = False

        # Async graph optimization: True while the device-side optimized
        # poses have not been mirrored to kf_poses yet.
        self._poses_stale = False
        self._pose_fetches = 0  # observability / tests

        # In-flight loop-closure validation (reference: constraint
        # validation runs on the background graph thread and its edges
        # land whenever the worker finishes — here the queued batched
        # validation is the worker, and results are collected at the next existing
        # device->host transfer or, at the latest, at the next switch /
        # finish / reset / checkpoint).
        self._pending_validation = None

        # In-flight window refinement (reference: LocalMap::optimize runs
        # on the background graph thread after MapComplete). The solve is
        # queued at the switch; its refined poses are collected at the
        # next existing transfer. Until collection the new keyframe
        # anchors on the UNREFINED scan estimate (deltas are microns; the
        # next interleaved solve consumes the refined edge measurement).
        self._pending_window = None

        # Keyframes whose pyramid spill (device -> pinned host RAM) is in
        # flight: eviction starts non-blocking copies and materializes the
        # numpy at the next combined drain, so the tracking loop never
        # blocks on a ~10 MB pyramid download.
        self._pending_evictions: List[Keyframe] = []

        # LRU device cache of re-uploaded EVICTED validation candidates
        # (level-trimmed; see constraints.dispatch_validation). Keyed by
        # (idx, timestamp) — stable across reset()'s index reuse; pyramid
        # contents are immutable so entries never go stale. Carries
        # hit/miss/byte counters (validation_cache_stats below).
        self._validation_cache = constraints.ValidationCache()

        # Windowed local map for the active keyframe (reference LocalMap).
        self._local_map = self._new_local_map()

    # ------------------------------------------------------------------
    # public API (reference KeyframeTracker)
    # ------------------------------------------------------------------

    def init(self, T0: Optional[np.ndarray] = None):
        """Set the world pose of the first camera (reference init(pose))."""
        self._T0 = np.eye(4) if T0 is None else np.asarray(T0, np.float64)

    def force_keyframe(self):
        """Promote the next frame to a keyframe (reference forceKeyframe)."""
        self._force_next = True

    @property
    def validation_cache_stats(self) -> dict:
        """Loop-closure re-upload observability: hit/miss/byte counters of
        the evicted-candidate device cache (whether switches past the
        residency budget are bound by re-uploads)."""
        return self._validation_cache.stats()

    def reset(self, T0: Optional[np.ndarray] = None):
        """Restart tracking at a given world pose, keeping the map so far.

        Equivalent of the reference odometry node's pose-reset subscriber
        (dvo_ros CameraDenseTracking reset handling): the next frame starts
        a fresh keyframe anchored at T0 (current estimate if None), with no
        odometry edge linking it to the previous keyframe.
        """
        self._drain_device_reads()
        if T0 is not None:
            self._reset_pose = np.asarray(T0, np.float64)
        elif self.frames:
            self._reset_pose = self._world_pose(
                self.frames[-1].keyframe_idx, self.frames[-1].T_kf_frame
            )
        else:
            self._reset_pose = np.eye(4)
        self._initialized = False
        self._T0 = self._reset_pose

    def update(self, intensity, depth, timestamp: float) -> np.ndarray:
        """Track one RGB-D frame; returns the current world pose (4, 4) f64."""
        if not self._initialized:
            pyr = self._build_pyramid(intensity, depth)
            if not hasattr(self, "_T0"):
                self.init()
            self._add_keyframe(pyr, timestamp, self._T0, None, None)
            self._prev_pyr = pyr
            self._T_kf_prev = np.eye(4)
            self._local_map = self._new_local_map()
            self._initialized = True
            # NOT index 0: after reset() this is a fresh anchor keyframe.
            self.frames.append(
                FrameRecord(timestamp, self.keyframes[-1].idx, np.eye(4))
            )
            if self.collect_covariance:
                self.covariances.append((timestamp, np.zeros((6, 6))))
            return self._T0.copy()

        kf = self.keyframes[-1]
        # --- LocalTracker: pyramid build + dual alignment ---
        # Keyframe alignment seeds from the last keyframe-relative pose;
        # frame-to-frame alignment from the last increment (constant
        # velocity, reference UseInitialEstimate).
        odo_init = (
            self._last_odo if self.tracker_cfg.use_initial_estimate
            else np.eye(4)
        )
        inits = torch.as_tensor(
            np.stack([self._T_kf_prev, odo_init]), dtype=torch.float32,
            device=self.device)
        pyr, res = _slam_frame_step(
            *self._upload(intensity, depth),
            kf.pyramid, self._prev_pyr, inits, self.Ks, self.tracker_cfg,
        )
        # ONE device->host transfer for everything this frame needs.
        fetch = [res.transformation, res.is_nan(), res.entropy,
                 res.valid_ratio, res.information]
        # The logger's statistics: iterations, then valid, error,
        # delta_norm, accepted and termination of both rows.
        extra = []
        if self.frame_logger is not None and res.stats is not None:
            extra = [res.iterations, *res.stats[:5]]
        # Piggyback the previous switch's in-flight validation results and
        # window refinement on this frame's transfer, and apply them here,
        # where the JAX package applies them.
        pend = self._pending_validation
        pv = pend.tensors() if pend is not None else []
        pw = self._pending_window
        pwh = [pw["handle"]] if pw is not None else []
        host = to_host(fetch + extra + pv + pwh)
        if pw is not None:
            self._collect_pending_window(host_poses=host[-1])
            host = host[:-1]
        n_own = len(fetch) + len(extra)
        if pend is not None:
            self._collect_pending_validation(
                host_results=pend.results_from(host[n_own:]))
        transforms, nans, entropies, valid_ratios, informations = \
            host[:len(fetch)]
        r_kf_T = np.asarray(transforms[0], np.float64)
        r_odo_T = np.asarray(transforms[1], np.float64)
        kf_nan = bool(nans[0])
        odo_nan = bool(nans[1])
        if not odo_nan:
            self._last_odo = r_odo_T
        kf_entropy = float(entropies[0])
        kf_valid_ratio = float(valid_ratios[0])

        # --- acceptance criteria (reference LocalTracker signals) ---
        accept = (not kf_nan) and kf_valid_ratio >= self.slam_cfg.min_constraint_ratio

        # --- entropy-ratio keyframe decision (ratioWithFirst; sign-safe
        # form, see dense_tracker.entropy_ratio) ---
        if accept and kf.entropy_first is None and np.isfinite(kf_entropy):
            kf.entropy_first = kf_entropy
        ratio = 1.0
        if accept and kf.entropy_first is not None:
            ratio = dense_tracker.entropy_ratio(kf_entropy, kf.entropy_first)
        switch = (
            self._force_next
            or not accept
            or ratio < self.slam_cfg.min_entropy_ratio
        )
        self._force_next = False

        if self.frame_logger is not None:
            # The window-miss fields are the tracker's constants here (no
            # sampler window to miss, no escalation).
            rec = dict(
                t=timestamp, frame=len(self.frames), keyframe=kf.idx,
                entropy=kf_entropy, entropy_ratio=ratio,
                valid_ratio=kf_valid_ratio, accepted=accept,
                keyframe_switch=bool(switch), window_miss_frac=0.0,
                escalated=False,
            )
            if extra:
                iters_b, *stats_b = host[len(fetch):n_own]
                rec["kf_track"] = _stats_record(stats_b, iters_b, 0)
                rec["odo_track"] = _stats_record(stats_b, iters_b, 1)
            self.frame_logger.log(**rec)

        if not switch:
            if np.isfinite(kf_entropy):
                # A finite-pose frame can still carry +inf entropy
                # (singular information); accumulating it would poison
                # entropy_avg and silently veto all future loop closures
                # against this keyframe.
                kf.entropy_sum += kf_entropy
                kf.entropy_count += 1
            T_kf_cur = r_kf_T
            if self.slam_cfg.fuse_odometry and not odo_nan:
                # LocalMap::optimize() equivalent: fuse the direct
                # keyframe alignment with the chained odometry estimate by
                # their information matrices.
                T_alt = np.asarray(transforms[1], np.float64) @ self._T_kf_prev
                T_kf_cur = fuse_relative_poses(
                    r_kf_T, np.asarray(informations[0], np.float64),
                    T_alt, np.asarray(informations[1], np.float64),
                )
            self._T_kf_prev = T_kf_cur
            self._prev_pyr = pyr
            self.frames.append(FrameRecord(timestamp, kf.idx, T_kf_cur.copy()))
            if self.collect_covariance:
                self.covariances.append(
                    (timestamp, _cov_from_info(informations[0]))
                )
            if self.slam_cfg.local_map_optimize:
                self._local_map.add_frame(
                    len(self.frames) - 1,
                    T_kf_cur,
                    (r_kf_T, np.asarray(informations[0], np.float64)),
                    None if odo_nan
                    else (r_odo_T, np.asarray(informations[1], np.float64)),
                )
            return self._world_pose(kf.idx, T_kf_cur)

        # --- keyframe switch: current frame becomes the new keyframe ---
        # Consume the previous (asynchronously dispatched) graph solve now:
        # the new keyframe anchors on the optimized parent pose.
        self._sync_poses()
        if accept:
            Z_new = r_kf_T  # new-cam <- kf-cam
            info = np.asarray(informations[0], np.float64)
        elif not odo_nan:
            # Tracking-failure fallback: chain previous kf-relative pose
            # with the frame-to-frame odometry result (graceful
            # degradation, SURVEY.md §6 failure handling).
            Z_new = r_odo_T @ self._T_kf_prev
            info = np.asarray(informations[1], np.float64)
        else:
            # Total failure: keep last relative pose (constant position).
            Z_new = self._T_kf_prev
            info = np.eye(6) * 1e2

        # --- window solve + loop search + graph ops: one round trip ---
        new_kf = self._perform_switch(
            pyr, timestamp, Z_new, info,
            (r_kf_T, np.asarray(informations[0], np.float64))
            if accept else None,
            None if odo_nan
            else (r_odo_T, np.asarray(informations[1], np.float64)),
        )

        self._prev_pyr = pyr
        self._T_kf_prev = np.eye(4)
        self.frames.append(FrameRecord(timestamp, new_kf.idx, np.eye(4)))
        if self.collect_covariance:
            # Same measurement-selection chain as the Z_new fallback.
            self.covariances.append((timestamp, _cov_from_info(info)))
        return self._world_pose(new_kf.idx, np.eye(4))

    def finish(self) -> List[Tuple[float, np.ndarray]]:
        """Final optimization + full-trajectory interpolation (reference
        KeyframeGraph::finalOptimization + pose composition, SURVEY.md §3.4).
        """
        # Land any in-flight window refinement + loop-closure edges before
        # the final solve (one combined transfer).
        self._drain_device_reads()
        # Flush the trailing (never-switched) window through the local-map
        # solve so its frame records are refined too.
        if self.slam_cfg.local_map_optimize and len(self._local_map) >= 2:
            refined = self._local_map.optimize(self.slam_cfg.local_map_iterations)
            for fi, T in zip(self._local_map.frame_indices, refined):
                if fi >= 0:
                    self.frames[fi].T_kf_frame = T
            self._local_map = self._new_local_map()
        if self.slam_cfg.remove_outliers and self.num_loop_edges > 0:
            self._prune_outlier_edges()
        self._optimize(self.slam_cfg.final_optimization_iterations)
        return self.trajectory()

    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """Current full trajectory: optimized keyframe poses composed with
        per-frame relative poses."""
        self._drain_device_reads()
        return [
            (f.timestamp, self._world_pose(f.keyframe_idx, f.T_kf_frame))
            for f in self.frames
        ]

    def export_graph(self, path: str) -> None:
        """Write the current (latest-solve) pose graph as .g2o — the
        reference backend's interchange format (g2o_viewer etc.)."""
        from dvo_slam_tpu_torch.utils import g2o_io

        self._drain_device_reads()
        g2o_io.save_g2o(path, self.graph)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _new_local_map(self):
        return local_map.LocalMap(self.slam_cfg.local_map_capacity,
                                  device=self.device)

    def _upload(self, intensity, depth):
        """The frame on the device. Raw sensor dtypes (uint8 intensity /
        uint16 depth / uint8 12-bit-packed depth) upload raw;
        build_pyramid converts them on the device."""
        def up(img, raw):
            t = torch.as_tensor(np.asarray(img) if not isinstance(
                img, torch.Tensor) else img)
            if t.dtype not in raw:
                t = t.to(torch.float32)
            return t.to(self.device)

        return (up(intensity, (torch.uint8,)),
                up(depth, (torch.uint16, torch.uint8)))

    def _build_pyramid(self, intensity, depth):
        return pyramid.build_pyramid(*self._upload(intensity, depth),
                                     self.tracker_cfg.num_levels)

    def _world_pose(self, kf_idx: int, T_kf_frame: np.ndarray) -> np.ndarray:
        """T_w_frame = T_w_kf o inv(T_kf_frame) with T_kf_frame: frame<-kf."""
        return self.kf_poses[kf_idx] @ se3_np.inverse(T_kf_frame)

    def _add_keyframe(self, pyr, timestamp, T_w, parent_idx, edge):
        # Graph edits must land on top of the latest optimized poses (the
        # orchestrator always syncs before adding; this is the defensive
        # no-op form of that invariant).
        self._sync_poses()
        idx = len(self.keyframes)
        if idx >= self.graph.poses.shape[0]:
            # Graceful growth instead of a hard failure (the reference runs
            # indefinitely): doubling keeps optimize() recompiles O(log N).
            self.graph = pose_graph.grow(
                self.graph, max_vertices=2 * self.graph.poses.shape[0]
            )
        self.keyframes.append(Keyframe(idx=idx, timestamp=timestamp, pyramid=pyr))
        self.kf_poses.append(np.asarray(T_w, np.float64))
        self.graph.poses[idx] = np.asarray(T_w, np.float32)
        self.graph = self.graph._replace(
            num_vertices=np.asarray(idx + 1, np.int32),
        )
        if parent_idx is not None:
            Z, info = edge
            self._add_edge(parent_idx, idx, se3_np.inverse(Z), info)
        self._evict_keyframe_pyramids()

    def _evict_keyframe_pyramids(self):
        """Spill old keyframe pyramids to host RAM, keeping at most
        `resident_keyframes` in device memory. Pyramids are only needed
        again for loop-closure validation, whose batched stack accepts host
        arrays (re-upload happens inside that call), so eviction bounds the
        device memory at ~resident_keyframes x 10 MB at 640x480, whatever
        the sequence length."""
        # Previous evictions' copies have had at least one keyframe
        # interval to land — materialize them first (cheap by now).
        self._finalize_evictions()
        budget = self.slam_cfg.resident_keyframes
        resident = [k for k in self.keyframes[:-1] if k.resident]
        cuda = self.device.type == "cuda"
        for kf in resident[: max(0, len(resident) + 1 - budget)]:
            # Start the device->host copies WITHOUT blocking: non-blocking
            # copies into pinned host memory, ordered on the current
            # stream; an event marks their end. The numpy materialization
            # happens at the next combined drain (_finalize_evictions); in
            # between the pyramid stays usable as device tensors (e.g. for
            # a validation batch).
            host = tuple(
                torch.empty(lvl.shape, dtype=lvl.dtype, pin_memory=cuda
                            ).copy_(lvl, non_blocking=cuda)
                for lvl in kf.pyramid)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            kf.spill = (host, event)
            kf.resident = False
            self._pending_evictions.append(kf)

    def _finalize_evictions(self):
        """Materialize in-flight pyramid spills to numpy (frees the device
        memory).
        Called from the combined drain and the switch path; by then the
        async copies have usually landed, so this is a cheap copy-out
        rather than a blocking transfer."""
        for kf in self._pending_evictions:
            host, event = kf.spill
            if event is not None:
                event.synchronize()
            kf.pyramid = tuple(h.numpy() for h in host)
            kf.spill = None
        self._pending_evictions.clear()

    def _add_edge(self, i: int, j: int, Z: np.ndarray, info: np.ndarray):
        """Z convention: T_i^{-1} T_j (maps j-cam coords into i-cam)."""
        self._sync_poses()
        e = int(self.graph.num_edges)
        if e >= self.graph.edge_i.shape[0]:
            self.graph = pose_graph.grow(
                self.graph, max_edges=2 * self.graph.edge_i.shape[0]
            )
        self.graph.edge_i[e] = i
        self.graph.edge_j[e] = j
        self.graph.measurements[e] = np.asarray(Z, np.float32)
        self.graph.information[e] = np.asarray(info, np.float32)
        self.graph.edge_mask[e] = True
        self.graph = self.graph._replace(
            num_edges=np.asarray(e + 1, np.int32),
        )

    def _perform_switch(self, pyr, timestamp: float, Z_new: np.ndarray,
                        info: np.ndarray, kf_measurement, odo_measurement
                        ) -> Keyframe:
        """Complete a keyframe switch without waiting for the device.

        The reference hands the finished LocalMap to the background graph
        thread (dvo_slam/src/keyframe_graph.cpp): window solve, candidate
        validation and the interleaved g2o optimize all run off the
        tracking thread. Here the window solve AND every loop-closure
        validation batch are queued back to back with no host sync, and
        their results ride a single device->host transfer at the next
        frame (or drain).

        Args:
          pyr: the switching frame's pyramid (becomes the new keyframe).
          Z_new / info: old-kf -> new-kf measurement after the acceptance
            fallback chain (UNREFINED; the window solve refines it here).
          kf_measurement / odo_measurement: optional (T, info) dual
            measurements of the switching frame for the window's final
            vertex.

        Loop-closure proposals are seeded from the PREDICTED anchor pose
        (pre-refinement): the window refinement moves the anchor by
        microns while the seeds' job is only to start the coarse tracker
        inside its convergence basin (and the odometry voter's threshold
        is ~1 rad/m). This is what lets validation dispatch before the
        refinement is fetched.
        """
        # Results from the PREVIOUS switch's background work must land
        # before this switch's graph edits (normally a no-op: the
        # piggybacked collect at the next frame/chunk fetch already ran).
        self._drain_device_reads()
        kf = self.keyframes[-1]
        lm_handle = None
        lm_before = len(self._local_map)
        if self.slam_cfg.local_map_optimize:
            # The switching frame joins as the final vertex; its refined
            # pose becomes the odometry-edge measurement anchoring the new
            # keyframe (reference LocalMap::optimize on MapComplete).
            self._local_map.add_frame(-1, Z_new, kf_measurement,
                                      odo_measurement)
            if len(self._local_map) >= 2:
                lm_handle = self._local_map.optimize_async(
                    self.slam_cfg.local_map_iterations
                )

        if self.enable_loop_closure:
            T_w_pred = self.kf_poses[kf.idx] @ se3_np.inverse(Z_new)
            # Dispatched NOW, collected at the next existing transfer.
            self._pending_validation = self._dispatch_loop_search(
                T_w_pred, pyr
            )

        # The window refinement is DEFERRED like the validation (reference:
        # both run on the background graph thread): the new keyframe
        # anchors on the unrefined Z_new now, and the collect rewrites the
        # window's frame records + this odometry edge's measurement before
        # any LATER solve consumes them.
        T_w_new = self.kf_poses[kf.idx] @ se3_np.inverse(Z_new)
        self._add_keyframe(pyr, timestamp, T_w_new, kf.idx, (Z_new, info))
        new_kf = self.keyframes[-1]
        if lm_handle is not None:
            self._pending_window = {
                "handle": lm_handle,
                "lmap": self._local_map,
                # The odometry edge _add_keyframe just appended.
                "edge_index": int(self.graph.num_edges) - 1,
                "switch_frame_added": len(self._local_map) == lm_before + 1,
            }

        self._switches_since_solve += 1
        if self._should_solve_interleaved():
            self._optimize(self.slam_cfg.optimization_iterations)
        self._local_map = self._new_local_map()
        return new_kf

    def _should_solve_interleaved(self) -> bool:
        """Solve-frequency backoff at scale (g2o-user practice): the
        reference optimizes per insertion, which is fine while the graph
        is small. Once M exceeds optimization_backoff_vertices, plain
        odometry insertions solve every ceil(M/backoff)-th switch; new
        loop-closure edges ALWAYS trigger an immediate solve."""
        backoff = self.slam_cfg.optimization_backoff_vertices
        if self._loop_edges_since_solve:
            return True
        M = len(self.keyframes)
        if backoff <= 0 or M <= backoff:
            return True
        period = -(-M // backoff)  # ceil
        return self._switches_since_solve >= period

    def _drain_device_reads(self) -> None:
        """Land every in-flight device result — optimized poses, window
        refinement, validation batch — in ONE combined transfer.

        Apply order matches the per-frame piggybacked path:
        poses first, then the window rewrite, then validation edges.
        (One rare exception: if _apply_poses masks outlier edges, it
        re-dispatches a solve whose poses the subsequent edge insertion
        syncs with a second fetch — correctness first on that path.)"""
        pw = self._pending_window
        pv = self._pending_validation
        fetch = []
        if self._poses_stale:
            fetch.append(self._pending_poses)
        if pw is not None:
            fetch.append(pw["handle"])
        if pv is not None:
            fetch += pv.tensors()
        if not fetch:
            return
        host = to_host(fetch)
        i = 0
        if self._poses_stale:
            self._apply_poses(host[i])
            i += 1
        if pw is not None:
            self._collect_pending_window(host_poses=host[i])
            i += 1
        if pv is not None:
            self._collect_pending_validation(
                host_results=pv.results_from(host[i:]))
        self._finalize_evictions()

    def _collect_pending_window(self, host_poses=None):
        """Apply the in-flight window refinement (if any): refined
        T_kf_frame for the window's frame records and the refined
        measurement of the new keyframe's odometry edge. With host_poses
        the caller already fetched the solve output (piggybacked on
        another transfer); otherwise fetch here."""
        pw = self._pending_window
        if pw is None:
            return
        self._pending_window = None
        lmap = pw["lmap"]
        if host_poses is None:
            host_poses = to_host([pw["handle"]])[0]
        refined = lmap.refined_from(host_poses)
        for fi, T in zip(lmap.frame_indices, refined):
            if fi >= 0:
                self.frames[fi].T_kf_frame = T
        if pw["switch_frame_added"]:
            # Same convention as _add_keyframe's edge: Z_edge = inv(Z_new).
            self.graph.measurements[pw["edge_index"]] = se3_np.inverse(
                refined[-1]
            ).astype(np.float32)

    def _collect_pending_validation(self, host_results=None):
        """Insert the edges of the in-flight validation (if any). With
        host_results the caller already fetched the batch outputs
        (piggybacked on another transfer); otherwise fetch here."""
        pending = self._pending_validation
        if pending is None:
            return
        self._pending_validation = None
        if host_results is None:
            host_results = pending.results_from(to_host(pending.tensors()))
        # The window-miss voter keeps the JAX default threshold (its
        # TrackerConfig.pallas_miss_escalate, 0.02): the port's fine
        # re-track has no sampler window, its miss fraction is always 0,
        # and the voter always passes.
        accepted = constraints.vote_validation(
            pending.chunks, host_results,
            [k.entropy_avg for k in self.keyframes], self.slam_cfg,
            _WINDOW_MISS_THRESHOLD,
        )
        for a in accepted:
            self._add_edge(a.keyframe_idx, a.new_idx, a.measurement,
                           a.information)
        self.num_loop_edges += len(accepted)
        self._loop_edges_since_solve += len(accepted)

    def _dispatch_loop_search(self, T_w_new: np.ndarray, new_pyramid):
        """Radius candidate search + validation DISPATCH (no fetch) for a
        keyframe about to be inserted at index len(self.keyframes)."""
        new_idx = len(self.keyframes)
        positions = np.stack(
            [T[:3, 3] for T in self.kf_poses] + [T_w_new[:3, 3]]
        )
        cand_idx = constraints.propose_candidates(
            positions, new_idx, self.slam_cfg
        )
        if not cand_idx:
            return None
        cands = []
        for k in cand_idx:
            # Tracker wants T: cand-cam -> new-cam (p_new = T p_cand):
            # T = inv(T_w_new) @ T_w_cand.
            T_init = se3_np.inverse(T_w_new) @ self.kf_poses[k]
            cands.append(
                constraints.ConstraintCandidate(
                    keyframe_idx=k, new_idx=new_idx, T_init=T_init
                )
            )
        return constraints.dispatch_validation(
            cands,
            [kf.pyramid for kf in self.keyframes],
            new_pyramid,
            self.Ks,
            self.coarse_cfg,
            self.fine_cfg,
            self.slam_cfg,
            pyramid_keys=[(kf.idx, kf.timestamp) for kf in self.keyframes],
            device_cache=self._validation_cache,
        )

    def _optimize(self, iterations: int):
        """Run the device LM solve WITHOUT reading its outputs.

        The reference runs g2o on a background thread (keyframe_graph.cpp);
        here the solve runs on the device, and its poses are materialized
        by _sync_poses() at the next pose read. On a CUDA device every
        solve, dense or CG at any size, is one kernel launch that reads
        nothing back (pose_graph.graph_route: the cluster kernel up to 128
        dense vertex slots, the grid kernel past that and for CG), so the
        solve stays asynchronous until that read; on the CPU the host
        loop runs it.
        """
        self._switches_since_solve = 0
        self._loop_edges_since_solve = 0
        if len(self.keyframes) < 2 or int(self.graph.num_edges) == 0:
            return
        # Never upload stale host poses over an unconsumed solve (no-op in
        # the normal flow: the orchestrator syncs at every switch before
        # adding, and adds precede this dispatch).
        self._sync_poses()
        view = self._solve_view()
        g_opt, chi2, _ = pose_graph.optimize(
            view,
            iterations=iterations,
            use_robust=self.slam_cfg.use_robust_kernel,
            cauchy_c=self.slam_cfg.cauchy_c,
            # Fresh loop-closure edges carry drift-sized residuals at
            # insertion; the ADAPTIVE GNC anneal sizes the initial kernel
            # width from the worst active edge so a correct loop edge
            # starts at weight ~0.5 regardless of accumulated drift or
            # information scale (fixed anneals silently zero out loop
            # edges at 640x480 information magnitudes — see
            # pose_graph.optimize docstring); gnc_init stays as the floor.
            gnc_init=16.0,
            gnc_adaptive=True,
            solver=self._solver_for(view),
            device=self.device,
        )
        self._pending_poses = g_opt.poses  # device; fetched lazily
        self._poses_stale = True

    def _solve_view(self) -> pose_graph.PoseGraph:
        """Crop the host graph to power-of-two buckets of the ACTIVE sizes
        before a solve: the dense device system scales with the uploaded
        capacity, so solving a 30-keyframe graph inside a 256-slot pad
        wastes ~600x the FLOPs."""
        Mb = pose_graph.bucket(len(self.keyframes), 16)
        Eb = pose_graph.bucket(int(self.graph.num_edges), 64)
        return pose_graph.crop(self.graph, Mb, Eb)

    def _solver_for(self, view: pose_graph.PoseGraph) -> str:
        """Dense Cholesky below graph_cg_threshold vertices; matrix-free
        block-Jacobi CG at and above it (the dense 6Mx6M system grows
        O(M^2) memory / O(M^3) solve — see pose_graph.optimize)."""
        return ("cg" if view.poses.shape[0]
                >= self.slam_cfg.graph_cg_threshold else "dense")

    def _sync_poses(self):
        """Blocking fetch of the device-optimized poses into kf_poses."""
        if not self._poses_stale:
            return
        self._apply_poses(to_host([self._pending_poses])[0])

    def _apply_poses(self, poses: np.ndarray):
        """Mirror already-fetched optimized poses into kf_poses and the
        host graph (callers that piggyback the pose fetch onto another
        transfer), then run per-insertion outlier pruning on the updated
        poses."""
        poses = np.asarray(poses, np.float64)
        n = min(len(poses), self.graph.poses.shape[0])
        self.graph.poses[:n] = poses[:n].astype(np.float32)
        for k in range(len(self.kf_poses)):
            self.kf_poses[k] = se3_np.renormalize(poses[k])
        self._poses_stale = False
        self._pending_poses = None
        self._pose_fetches += 1
        if self.slam_cfg.remove_outliers:
            # Reference interleaved pruning (SURVEY.md §3.4 "optional
            # outlier-edge pruning ... re-optimize"): a validated-but-bad
            # edge is masked when the solve is consumed, and one re-solve
            # is dispatched so it stops poisoning every interleaved solve
            # until finish().
            if self._mask_outlier_edges():
                self._optimize(self.slam_cfg.optimization_iterations)

    def _mask_outlier_edges(self) -> int:
        """Mask outlier loop edges (reference OptimizationRemoveOutliers +
        OutlierWeightThreshold), judged by chi^2 computed on the host
        graph at the just-applied poses. Returns the number dropped.

        The threshold is POPULATION-RELATIVE, not the raw robust weight:
        tracker information scales with pixel count, so at the optimum of
        a perfectly CONSISTENT full-res graph every loop edge still sits
        at chi^2 in the thousands (measured: 600-11k on the noiseless
        bench ring) — a fixed weight cutoff at cauchy_c prunes them all.
        An edge is an outlier when it is grossly worse than the best the
        graph demonstrably achieves: chi^2 > f * max(cauchy_c^2, best
        OTHER loop edge's chi^2), with f = (1/T - 1)^2 from the
        configured weight threshold T. NOTE this f is a DELIBERATE
        deviation from the reference's raw weight-threshold semantics
        (Cauchy w = 1/(1 + chi^2/c^2) < T <=> chi^2 > c^2 (1/T - 1), i.e.
        the unsquared factor): dense-tracker information is overconfident
        by a resolution-dependent factor (correlated pixels), so a
        perfectly consistent edge's chi^2 lands anywhere from O(10) at
        64x48 to O(10^4) at 640x480 and the literal w < T test prunes
        correct edges at every scale (measured: the reduced-scale ATE
        gate fails with the unsquared factor because mid-range correct
        edges exceed it whenever the best edge fits very well). Squaring
        widens both the floor and the population band by the same 1/T
        ratio — "one threshold-width worse than the best demonstrated",
        scale-free. Leave-one-out keeps a lone bad edge from vouching
        for itself (a lone edge is judged against the f*c^2 floor
        alone). Listed in docs/fr1_desk_protocol.md as a semantic
        deviation to re-verify against the real reference."""
        g = self.graph
        T = self.slam_cfg.outlier_weight_threshold
        factor = (1.0 / T - 1.0) ** 2
        c2 = self.slam_cfg.cauchy_c ** 2
        # Vectorized over ALL active loop edges: this runs on every
        # consumed solve, so at thousands of edges a per-edge Python loop
        # with scalar SE(3) logs dominates keyframe-switch time (measured
        # ~90 ms at 2k edges; batched ~1 ms).
        ne = int(g.num_edges)
        ei = np.asarray(g.edge_i[:ne], np.int64)
        ej = np.asarray(g.edge_j[:ne], np.int64)
        sel = np.asarray(g.edge_mask[:ne], bool) & (np.abs(ej - ei) != 1)
        idx = np.nonzero(sel)[0]
        if idx.size == 0:
            return 0
        poses = np.asarray(g.poses, np.float64)
        Z = np.asarray(g.measurements[idx], np.float64)
        T_rel = (se3_np.inverse_batch(Z)
                 @ se3_np.inverse_batch(poses[ei[idx]])
                 @ poses[ej[idx]])
        r = se3_np.log_batch(T_rel)
        info = np.asarray(g.information[idx], np.float64)
        chi = np.einsum("ei,eij,ej->e", r, info, r)
        # Leave-one-out population floor: each edge is judged against the
        # best OTHER loop edge (a lone bad edge cannot vouch for itself).
        order = np.sort(chi)
        lo = order[0]
        others_min = (np.where(chi == lo, order[1], lo)
                      if idx.size >= 2 else np.zeros_like(chi))
        drop = chi > factor * np.maximum(c2, others_min)
        g.edge_mask[idx[drop]] = False
        return int(drop.sum())

    def _prune_outlier_edges(self):
        """Final-pass pruning before finish()'s long solve (reference
        OptimizationRemoveOutliers; the per-insertion path in _apply_poses
        usually got there first). Host chi^2 at the latest solved poses —
        no extra device dispatch."""
        self._sync_poses()
        self._mask_outlier_edges()


def _stats_record(stats, iterations, b):
    """Per-level per-iteration stats of batch row b as plain JSON types
    (reference IterationStats granularity), trimmed to executed
    iterations. stats: host (valid, error, delta_norm, accepted,
    termination), each with a leading batch axis."""
    valid, error, delta_norm, accepted, termination = stats
    levels = []
    for lvl in range(iterations.shape[1]):
        n = int(iterations[b, lvl])
        levels.append({
            "iterations": n,
            "termination": int(termination[b, lvl]),
            "valid": valid[b, lvl][:n].tolist(),
            "error": error[b, lvl][:n].tolist(),
            "delta_norm": delta_norm[b, lvl][:n].tolist(),
            "accepted": accepted[b, lvl][:n].tolist(),
        })
    return levels


def fuse_relative_poses(T_a, info_a, T_b, info_b):
    """Information-weighted SE(3) fusion of two estimates of the same
    relative pose (host, f64).

    Equivalent of the reference LocalMap::optimize() (dvo_slam/src/
    local_map.cpp): the keyframe->current measurement and the chained
    odometry measurement are fused instead of trusting the keyframe
    alignment alone. One Gauss-Newton step from T_a (exact at this scale:
    the two estimates differ by a small twist):

        xi = log(T_b T_a^{-1});  T = exp((L_a + L_b)^{-1} L_b xi) T_a
    """
    xi = se3_np.log(np.asarray(T_b, np.float64) @ se3_np.inverse(T_a))
    L = info_a + info_b
    try:
        delta = np.linalg.solve(L, info_b @ xi)
    except np.linalg.LinAlgError:
        return np.asarray(T_a, np.float64)
    if not np.isfinite(delta).all():
        return np.asarray(T_a, np.float64)
    return se3_np.exp(delta) @ T_a

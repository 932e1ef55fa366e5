"""Chunked streaming SLAM: device-resident front-end + host graph backend
(counterpart of ``dvo_slam_tpu/models/chunked_slam.py``).

The per-frame KeyframeSlam reads each frame's results back before it can
decide the next (one device round trip per frame). ChunkedKeyframeSlam
issues a CHUNK of frames through the device-resident keyframe front-end
(models/keyframe_scan.py: dual alignment, entropy-ratio keyframe
switching and measurement fusion, every decision a ``torch.where`` on the
card) with no host sync between frames, and reads the chunk's outputs back
in one copy. The backend (keyframe records, pose graph, loop-closure
proposal + two-stage validation, the device LM solve) is inherited
unchanged from KeyframeSlam; keyframe switches discovered inside a chunk
are replayed on the host walk of the chunk outputs: new-keyframe pyramids
come from the scan carry (the last switch of the chunk) or are rebuilt
from the chunk's frames, odometry edges enter the graph, loop closures are
searched and validated, and the global solve is dispatched exactly as in
the per-frame orchestrator.

Pipelining: ``submit_chunk`` uploads the frames (non-blocking copies from
pinned host memory), issues the scan, and starts a non-blocking copy of
its outputs into one pinned host buffer, marked by an event;
``collect_chunk`` waits on that event alone. Results the previous walk
left on the device (window refinement, validation batch, graph solve) are
read on a side stream after an event recorded where they were issued. So
with chunk k+1 submitted before chunk k is collected (depth 2), collecting
k does not wait for k+1's scan. (The pose graph's LM solve reads its stop
flag back each step: a walk that solves still waits for the work ahead of
it on the stream.)

Feature parity with KeyframeSlam: the windowed LocalMap solve runs on the
host walk (the scan emits the raw dual measurements + informations per
frame), and per-iteration TrackStats flow into the same frame-logger
records. Per-frame poses inside a window use the scan's f32 closed-form
fusion (the per-frame engine fuses in f64 on the host) — sub-micron
numeric deltas, not semantic ones.

Trajectory results are chunk-size invariant: splitting a sequence at any
boundaries yields the same poses (tests/test_torch_chunked_slam.py).
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import List, Sequence

import numpy as np
import torch

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models import keyframe_scan
from dvo_slam_tpu_torch.models.keyframe_tracker import (
    FrameRecord, KeyframeSlam, _cov_from_info, _stats_record,
)
from dvo_slam_tpu_torch.utils.transfer import to_host

# The scan outputs the walk reads, in the order of the packed host copy.
_FIELDS = ("rel_pose", "switch", "Z_switch", "info_switch", "entropy",
           "entropy_ratio", "accept", "valid_ratio", "T_kf_meas",
           "T_odo_meas", "info_pair", "is_nan", "iterations")


_TORCH_DTYPES = {np.float32: torch.float32, np.uint8: torch.uint8,
                 np.uint16: torch.uint16}


def stage(array, device, raw=()):
    """One frame or chunk on ``device``: raw sensor dtypes (``raw``, numpy
    dtypes) keep their dtype, anything else becomes f32. On a CUDA device
    the host array is copied into pinned memory and uploaded with a
    non-blocking copy (no sync); torch tensors already on the device pass
    through (f32 conversion on the device)."""
    device = torch.device(device)
    if isinstance(array, torch.Tensor):
        t = array.to(device, non_blocking=True)
        if t.dtype not in (torch.uint8, torch.uint16):
            t = t.to(torch.float32)
        return t
    array = np.asarray(array)
    if array.dtype not in raw:
        array = array.astype(np.float32, copy=False)
    if device.type != "cuda":
        return torch.from_numpy(np.array(array))
    host = torch.empty(array.shape, dtype=_TORCH_DTYPES[array.dtype.type],
                       pin_memory=True)
    host.numpy()[...] = array
    return host.to(device, non_blocking=True)


class _HostCopy:
    """Tensors (each with a leading dim n) packed into one f32 device
    buffer and copied to the host: on CUDA non-blocking into pinned memory
    with an event marking its end, so reading it waits for that copy and
    nothing issued after it."""

    def __init__(self, tensors):
        n = tensors[0].shape[0]
        self.shapes = [tuple(t.shape) for t in tensors]
        self.dtypes = [torch.empty((), dtype=t.dtype).numpy().dtype
                       for t in tensors]
        flat = torch.cat([t.reshape(n, -1).to(torch.float32)
                          for t in tensors], dim=1)
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=torch.float32,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def arrays(self):
        """numpy copies of the tensors, in their dtypes."""
        if self.event is not None:
            self.event.synchronize()
        host = self.host.numpy()
        out, at = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            width = int(np.prod(shape[1:], dtype=np.int64))
            out.append(host[:, at:at + width].reshape(shape).astype(dtype))
            at += width
        return out


class ChunkedKeyframeSlam(KeyframeSlam):
    """KeyframeSlam with a chunked device-resident front-end.

    Public surface: `update_chunk(intensities, depths, timestamps)`,
    `submit_chunk` / `collect_chunk`, plus everything inherited (init /
    force_keyframe / reset / finish / trajectory). `update()` processes a
    1-frame chunk — identical results; use update_chunk for throughput.
    """

    def __init__(self, K, tracker_cfg: TrackerConfig = TrackerConfig(),
                 slam_cfg: SlamConfig = SlamConfig(),
                 enable_loop_closure: bool = True, frame_logger=None,
                 collect_covariance: bool = False, device="cuda"):
        super().__init__(K, tracker_cfg, slam_cfg,
                         enable_loop_closure=enable_loop_closure,
                         frame_logger=frame_logger,
                         collect_covariance=collect_covariance,
                         device=device)
        self._carry = None
        # Submitted-but-not-collected chunks (see submit_chunk).
        self._chunk_queue: deque = deque()
        # Recorded after each issue of work whose results the walk reads
        # later (graph solve, window refinement, validation batch).
        self._issued = None

    def update(self, intensity, depth, timestamp: float) -> np.ndarray:
        return self.update_chunk(intensity[None], depth[None],
                                 [timestamp])[-1]

    def update_chunk(self, intensities, depths,
                     timestamps: Sequence[float]) -> List[np.ndarray]:
        """Track a chunk of frames; returns one world pose (4,4) f64 per
        frame. intensities/depths: (N, H, W) numpy arrays or tensors;
        timestamps: length N.

        Raw sensor dtypes upload as they are (uint8 intensity, uint16 raw
        depth or 12-bit-packed uint8 depth — converted on the device by
        build_pyramid): 2.7x less transfer than the f32 pair.

        Equivalent to submit_chunk() + collect_chunk(); streaming callers
        that know the next chunk early should submit it BEFORE collecting
        the previous one."""
        # Outstanding pipelined submissions belong to EARLIER frames;
        # without this drain collect_chunk() would return the oldest
        # queued chunk's poses for this call's frames.
        if self._chunk_queue:
            warnings.warn(
                f"update_chunk() called with {len(self._chunk_queue)} "
                "pipelined chunk(s) outstanding; draining them first "
                "(their per-frame poses are only available via "
                "trajectory()). Pair submit_chunk with collect_chunk "
                "when pipelining.",
                RuntimeWarning,
                stacklevel=2,
            )
        self._drain_chunks()
        self.submit_chunk(intensities, depths, timestamps)
        return self.collect_chunk()

    def submit_chunk(self, intensities, depths,
                     timestamps: Sequence[float]) -> None:
        """Issue a chunk's device-resident scan WITHOUT reading it back
        (no host sync after the engine's first frame, on the level
        kernel's route).

        Any submit depth works (records queue up); depth 2 captures the
        pipelining win. force_keyframe() applies to the next SUBMITTED
        chunk. collect_chunk() pops results in submission order;
        finish/reset/trajectory/export/checkpoint drain the queue first.
        """
        intensities = stage(intensities, self.device, (np.uint8,))
        # uint16 = raw ticks; uint8 = 12-bit packed ticks (pack_depth12).
        depths = stage(depths, self.device, (np.uint16, np.uint8))
        if intensities.dim() != 3 or len(timestamps) != intensities.shape[0]:
            raise ValueError(
                f"want (N, H, W) frames and N timestamps, got "
                f"{tuple(intensities.shape)} and {len(timestamps)}")
        init_poses: List[np.ndarray] = []
        start = 0

        if not self._initialized:
            if not hasattr(self, "_T0"):
                self.init()
            pyr0 = keyframe_scan.pyramid_from_stack(
                intensities, depths, 0, self.tracker_cfg.num_levels)
            self._add_keyframe(pyr0, timestamps[0], self._T0, None, None)
            self.frames.append(
                FrameRecord(timestamps[0], self.keyframes[-1].idx, np.eye(4))
            )
            self._carry = keyframe_scan.init_carry(pyr0)
            # Fresh anchor keyframe => fresh measurement window (the
            # per-frame engine's init branch does the same).
            self._local_map = self._new_local_map()
            if self.collect_covariance:
                self.covariances.append((timestamps[0], np.zeros((6, 6))))
            self._initialized = True
            init_poses.append(self._T0.copy())
            start = 1

        n = intensities.shape[0] - start
        if n == 0:
            self._chunk_queue.append({"n": 0, "init_poses": init_poses})
            return

        # Made on the device (writing a host bool into it would copy and
        # sync): True at frame 0 when a keyframe is forced.
        force = torch.arange(n, device=self.device) < int(self._force_next)
        self._force_next = False

        with_stats = self.frame_logger is not None
        self._carry, outs = keyframe_scan.track_keyframe_chunk(
            self._carry, intensities[start:], depths[start:], self.K,
            self.tracker_cfg, self.slam_cfg, force_keyframe=force,
            with_stats=with_stats,
        )
        fields = [outs[f] for f in _FIELDS]
        if "stats" in outs:
            fields += list(outs["stats"])
        self._chunk_queue.append({
            "n": n, "start": start, "init_poses": init_poses,
            "host": _HostCopy(fields), "timestamps": list(timestamps),
            "intensities": intensities, "depths": depths,
            # The carry as of THIS chunk's scan: its "kf" pyramid is this
            # chunk's last-switch keyframe. self._carry may already belong
            # to a later submitted chunk by collect time.
            "carry_after": self._carry,
        })

    def _fetch_issued(self, tensors):
        """numpy copies of results issued before the last ``_issued``
        event, read on a side stream so the copy does not wait for work
        issued after it (a later chunk's scan)."""
        if self.device.type != "cuda" or self._issued is None:
            return to_host(tensors)
        side = torch.cuda.Stream(device=self.device)
        side.wait_event(self._issued)
        with torch.cuda.stream(side):
            out = to_host(tensors)
        return out

    def _mark_issued(self):
        if self.device.type == "cuda":
            self._issued = torch.cuda.Event()
            self._issued.record()

    def _optimize(self, iterations: int):
        super()._optimize(iterations)
        self._mark_issued()

    def _perform_switch(self, *args, **kwargs):
        new_kf = super()._perform_switch(*args, **kwargs)
        self._mark_issued()
        return new_kf

    def collect_chunk(self) -> List[np.ndarray]:
        """Read back + walk the oldest submitted chunk; returns its
        poses."""
        if not self._chunk_queue:
            raise RuntimeError(
                "collect_chunk() with no submitted chunk outstanding — "
                "every submit_chunk() pairs with exactly one "
                "collect_chunk(), and the read paths (finish / reset / "
                "trajectory / export_graph / checkpoint) drain the queue "
                "themselves."
            )
        chunk_rec = self._chunk_queue.popleft()
        out_poses: List[np.ndarray] = chunk_rec["init_poses"]
        n = chunk_rec["n"]
        if n == 0:
            return out_poses
        start = chunk_rec["start"]
        timestamps = chunk_rec["timestamps"]
        # Results the previous walk left on the device, applied first, in
        # the per-frame engine's order: the async graph solve's poses, the
        # window refinement, the validation batch.
        pend_val = self._pending_validation
        pend_win = self._pending_window
        stale = self._poses_stale
        fetch = []
        if stale:
            fetch.append(self._pending_poses)
        if pend_win is not None:
            fetch.append(pend_win["handle"])
        if pend_val is not None:
            fetch += pend_val.tensors()
        if fetch:
            host = self._fetch_issued(fetch)
            i = 0
            if stale:
                self._apply_poses(host[i])
                i += 1
            if pend_win is not None:
                self._collect_pending_window(host_poses=host[i])
                i += 1
            if pend_val is not None:
                self._collect_pending_validation(
                    host_results=pend_val.results_from(host[i:]))

        arrays = chunk_rec["host"].arrays()
        (rel, switch, Zs, infos, entropies, ratios, accepts, valid_ratios,
         kf_meas, odo_meas, info_pair, nan_pair, iters_b) = \
            arrays[:len(_FIELDS)]
        stats_b = arrays[len(_FIELDS):] or None
        lm_on = self.slam_cfg.local_map_optimize

        # The chunk's scan carry already holds the pyramid of its LAST
        # in-chunk switch keyframe: reuse it instead of rebuilding from the
        # chunk's frames. Earlier switches in the same chunk (rare) still
        # rebuild.
        switch_positions = np.flatnonzero(switch[:n])
        last_switch = int(switch_positions[-1]) if len(switch_positions) else -1

        for k in range(n):
            t = float(timestamps[start + k])
            kf = self.keyframes[-1]
            if self.frame_logger is not None:
                rec = dict(
                    t=t, frame=len(self.frames), keyframe=kf.idx,
                    entropy=float(entropies[k]),
                    entropy_ratio=float(ratios[k]),
                    valid_ratio=float(valid_ratios[k]),
                    accepted=bool(accepts[k]),
                    keyframe_switch=bool(switch[k]),
                    window_miss_frac=0.0,
                    escalated=False,
                )
                if stats_b is not None:
                    stats_k = [a[k] for a in stats_b]
                    rec["kf_track"] = _stats_record(stats_k, iters_b[k], 0)
                    rec["odo_track"] = _stats_record(stats_k, iters_b[k], 1)
                self.frame_logger.log(**rec)
            # Entropy bookkeeping mirrors KeyframeSlam.update exactly:
            # entropy_first is recorded for any accepted frame BEFORE the
            # switch decision, sum/count only on non-switch frames.
            h = float(entropies[k])
            if bool(accepts[k]) and np.isfinite(h) and kf.entropy_first is None:
                kf.entropy_first = h
            if bool(switch[k]):
                # Replay of KeyframeSlam's switch branch (shared
                # _perform_switch: window solve + loop search + graph ops).
                Z_new = np.asarray(Zs[k], np.float64)
                info = np.asarray(infos[k], np.float64)
                kf_meas_k = odo_meas_k = None
                if lm_on:
                    kf_meas_k = (
                        (np.asarray(kf_meas[k], np.float64),
                         np.asarray(info_pair[k][0], np.float64))
                        if bool(accepts[k]) else None
                    )
                    odo_meas_k = (
                        None if bool(nan_pair[k][1])
                        else (np.asarray(odo_meas[k], np.float64),
                              np.asarray(info_pair[k][1], np.float64))
                    )
                if k == last_switch:
                    pyr = chunk_rec["carry_after"]["kf"]
                else:
                    pyr = keyframe_scan.pyramid_from_stack(
                        chunk_rec["intensities"], chunk_rec["depths"],
                        start + k, self.tracker_cfg.num_levels,
                    )
                new_kf = self._perform_switch(
                    pyr, t, Z_new, info, kf_meas_k, odo_meas_k
                )
                self.frames.append(FrameRecord(t, new_kf.idx, np.eye(4)))
                if self.collect_covariance:
                    # info_switch already followed the per-frame engine's
                    # measurement-selection fallback chain.
                    self.covariances.append((t, _cov_from_info(infos[k])))
                out_poses.append(self._world_pose(new_kf.idx, np.eye(4)))
                continue

            if bool(accepts[k]) and np.isfinite(h):
                kf.entropy_sum += h
                kf.entropy_count += 1
            T_kf_cur = np.asarray(rel[k], np.float64)
            self.frames.append(FrameRecord(t, kf.idx, T_kf_cur))
            if lm_on:
                self._local_map.add_frame(
                    len(self.frames) - 1,
                    T_kf_cur,
                    (np.asarray(kf_meas[k], np.float64),
                     np.asarray(info_pair[k][0], np.float64)),
                    None if bool(nan_pair[k][1])
                    else (np.asarray(odo_meas[k], np.float64),
                          np.asarray(info_pair[k][1], np.float64)),
                )
            if self.collect_covariance:
                self.covariances.append(
                    (t, _cov_from_info(info_pair[k][0]))
                )
            out_poses.append(self._world_pose(kf.idx, T_kf_cur))
        return out_poses

    # -- pipelining bookkeeping -----------------------------------------

    def _drain_chunks(self) -> None:
        """Collect every submitted-but-unwalked chunk (results land in
        frames/trajectory; the per-chunk pose lists are not returned)."""
        while self._chunk_queue:
            self.collect_chunk()

    def reset(self, T0=None):
        self._drain_chunks()
        super().reset(T0)

    def finish(self):
        self._drain_chunks()
        return super().finish()

    def trajectory(self):
        self._drain_chunks()
        return super().trajectory()

    def export_graph(self, path: str) -> None:
        self._drain_chunks()
        super().export_graph(path)

    def force_keyframe(self):
        """Applies to the next SUBMITTED chunk (under pipelining, submit
        order — not collect order — is the frame order)."""
        super().force_keyframe()

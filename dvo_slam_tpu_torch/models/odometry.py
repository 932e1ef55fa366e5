"""Frame-to-frame visual odometry (counterpart of
``dvo_slam_tpu/models/odometry.py``; reference camera_tracker node).

Every frame aligns against the previous frame with a constant-velocity
warm start; world poses are chained on the host in f64. ``track_sequence``
is a Python loop over frames where the JAX package uses ``lax.scan``.
"""

from __future__ import annotations

import numpy as np
import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.ops import camera, pyramid
from dvo_slam_tpu_torch.utils import se3_np


def track_sequence(intensities, depths, K, cfg: TrackerConfig):
    """Frame-to-frame odometry over a whole sequence.

    intensities, depths: (T, H, W) tensors on the device (float grayscale
    0..255; metric depth, NaN invalid); K: (4,) intrinsics on the same
    device. Returns a dict of per-transition tensors (T-1 leading dim):
    rel_poses (frame k -> frame k+1, p_{k+1} = T p_k), entropy,
    valid_ratio, iterations, is_nan.
    """
    Ks = camera.pyramid_intrinsics(K, cfg.num_levels)
    eye = torch.eye(4, dtype=torch.float32, device=intensities.device)
    prev_pyr = pyramid.build_pyramid(intensities[0], depths[0], cfg.num_levels)
    last_rel = eye
    rels, entropy, valid_ratio, iterations, nan = [], [], [], [], []
    for k in range(1, intensities.shape[0]):
        cur_pyr = pyramid.build_pyramid(intensities[k], depths[k],
                                        cfg.num_levels)
        T0 = last_rel if cfg.use_initial_estimate else eye
        res = dense_tracker.track(prev_pyr, cur_pyr, Ks, T0, cfg)
        # NaN guard: fall back to the constant-velocity increment for both
        # the output chain and the next warm start.
        is_nan = res.is_nan()
        last_rel = torch.where(is_nan, last_rel, res.transformation)
        rels.append(last_rel)
        entropy.append(res.entropy)
        valid_ratio.append(res.valid_ratio)
        iterations.append(res.iterations)
        nan.append(is_nan)
        prev_pyr = cur_pyr
    return {
        "rel_poses": torch.stack(rels),
        "entropy": torch.stack(entropy),
        "valid_ratio": torch.stack(valid_ratio),
        "iterations": torch.stack(iterations),
        "is_nan": torch.stack(nan),
    }


class OdometryTracker:
    """Host-driven frame-to-frame visual odometry: every frame aligns
    against the previous one, the world pose is chained on the host in
    f64, and the per-frame 6x6 covariance (information^{-1}) is kept on
    request.

    ``last_result`` holds the TrackResult of the latest tracked frame.
    """

    def __init__(self, K, cfg: TrackerConfig = TrackerConfig(),
                 collect_covariance: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        self.Ks = camera.pyramid_intrinsics(self.K, cfg.num_levels)
        self.collect_covariance = collect_covariance
        self.trajectory = []  # (timestamp, T_w_frame f64)
        self.covariances = []  # (timestamp, (6,6) f64) when collected
        self.last_result = None
        self._prev_pyr = None
        self._T_w = np.eye(4)
        self._last_rel = np.eye(4)

    def init(self, T0=None):
        self._T_w = np.eye(4) if T0 is None else np.asarray(T0, np.float64)

    def _to_device(self, img, raw_dtypes):
        t = torch.as_tensor(img)
        if t.dtype not in raw_dtypes:
            t = t.to(torch.float32)
        return t.to(self.device)

    def update(self, intensity, depth, timestamp: float) -> np.ndarray:
        """Track one frame; returns the current world pose (4, 4) f64.

        Raw sensor dtypes (uint8 intensity, uint16 depth ticks, uint8
        12-bit-packed depth) are uploaded raw and converted on the device.
        """
        intensity = self._to_device(intensity, (torch.uint8,))
        depth = self._to_device(depth, (torch.uint16, torch.uint8))
        cur = pyramid.build_pyramid(intensity, depth, self.cfg.num_levels)
        if self._prev_pyr is None:
            self._prev_pyr = cur
            self.trajectory.append((timestamp, self._T_w.copy()))
            if self.collect_covariance:
                self.covariances.append((timestamp, np.zeros((6, 6))))
            return self._T_w.copy()

        T0 = torch.as_tensor(
            self._last_rel if self.cfg.use_initial_estimate else np.eye(4),
            dtype=torch.float32, device=self.device)
        res = dense_tracker.track(self._prev_pyr, cur, self.Ks, T0, self.cfg)
        self.last_result = res
        # The frame's one host sync: the pose and the log-likelihood that
        # is_nan() reads, one view of the result (no cat), widened on the
        # host.
        host = dense_tracker.pose_and_loglik(res).cpu().to(torch.float64)
        rel = host[:16].view(4, 4).numpy()
        is_nan = not bool(torch.isfinite(host[:16]).all()
                          and torch.isfinite(host[-1]))
        if is_nan:
            # NaN guard: fall back to the constant-velocity increment.
            rel = self._last_rel.copy()
        else:
            self._last_rel = rel
        self._T_w = self._T_w @ se3_np.inverse(rel)
        self._prev_pyr = cur
        self.trajectory.append((timestamp, self._T_w.copy()))
        if self.collect_covariance:
            cov = np.full((6, 6), np.nan)
            if not is_nan:
                info = res.information.to("cpu", torch.float64).numpy()
                if np.isfinite(info).all():
                    try:
                        cov = np.linalg.inv(info)
                    except np.linalg.LinAlgError:
                        pass
            self.covariances.append((timestamp, cov))
        return self._T_w.copy()


def compose_trajectory(rel_poses, T0=None):
    """Host-side f64 pose chain from relative poses: rel_poses[k] maps
    frame k -> frame k+1; returns len+1 world poses with T_w_0 = T0."""
    if isinstance(rel_poses, torch.Tensor):
        rel_poses = rel_poses.cpu()
    rels = np.asarray(rel_poses, np.float64)
    T_w = np.eye(4) if T0 is None else np.asarray(T0, np.float64)
    out = [T_w.copy()]
    for k in range(len(rels)):
        T_w = T_w @ se3_np.inverse(rels[k])
        out.append(T_w.copy())
    return out

"""Trajectory / map visualization (counterpart of
``dvo_slam_tpu/utils/visualization.py``).

The reference's visualization stack (SURVEY.md C11, R3):
CameraTrajectoryVisualizerInterface with a Noop implementation
(dvo_core/include/dvo/visualization/camera_trajectory_visualizer.h) plus
concrete backends. The reference renders live via PCL/rviz threads; here
runs dump artifacts on the host:

  * FileTrajectoryVisualizer — TUM trajectories + PLY point clouds on disk
  * MatplotlibTrajectoryVisualizer — static 3D trajectory plots (matplotlib
    is imported when a figure is rendered; without it rendering raises)
  * LiveTrajectoryVisualizer — re-renders as poses arrive (the node's
    in-process viewer and ``cli viz``)
  * NoopTrajectoryVisualizer — default (zero overhead)

numpy only: nothing here touches a device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class TrajectoryVisualizerInterface:
    """Reference CameraTrajectoryVisualizerInterface equivalent."""

    def add_pose(self, timestamp: float, T_wc: np.ndarray, is_keyframe: bool = False):
        raise NotImplementedError

    def add_point_cloud(self, points: np.ndarray, colors: Optional[np.ndarray] = None):
        raise NotImplementedError

    def finish(self):
        raise NotImplementedError


class NoopTrajectoryVisualizer(TrajectoryVisualizerInterface):
    """Reference NoopCameraTrajectoryVisualizer."""

    def add_pose(self, timestamp, T_wc, is_keyframe=False):
        pass

    def add_point_cloud(self, points, colors=None):
        pass

    def finish(self):
        pass


class FileTrajectoryVisualizer(TrajectoryVisualizerInterface):
    """Dump trajectory (TUM format) and point clouds (PLY) to a directory."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.poses = []
        self.keyframe_poses = []
        self._cloud_idx = 0

    def add_pose(self, timestamp, T_wc, is_keyframe=False):
        self.poses.append((timestamp, np.asarray(T_wc, np.float64)))
        if is_keyframe:
            self.keyframe_poses.append((timestamp, np.asarray(T_wc, np.float64)))

    def add_point_cloud(self, points, colors=None):
        path = os.path.join(self.out_dir, f"cloud_{self._cloud_idx:04d}.ply")
        write_ply(path, points, colors)
        self._cloud_idx += 1

    def finish(self):
        from dvo_slam_tpu_torch.utils import tum

        if self.poses:
            tum.write_trajectory(
                os.path.join(self.out_dir, "trajectory.txt"),
                [t for t, _ in self.poses],
                [T for _, T in self.poses],
            )
        if self.keyframe_poses:
            tum.write_trajectory(
                os.path.join(self.out_dir, "keyframes.txt"),
                [t for t, _ in self.keyframe_poses],
                [T for _, T in self.keyframe_poses],
            )


class MatplotlibTrajectoryVisualizer(FileTrajectoryVisualizer):
    """Additionally renders a 3D trajectory figure on finish()."""

    def _render(self):
        if not self.poses:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.array([T[:3, 3] for _, T in self.poses])
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        ax.plot(t[:, 0], t[:, 1], t[:, 2], "-", lw=1, label="trajectory")
        if self.keyframe_poses:
            k = np.array([T[:3, 3] for _, T in self.keyframe_poses])
            ax.scatter(k[:, 0], k[:, 1], k[:, 2], c="r", s=12, label="keyframes")
        ax.legend()
        ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.set_zlabel("z [m]")
        # Write-to-temp + rename: a concurrent viewer refreshing mid-write
        # must never see a truncated PNG (the live backend re-renders this
        # file while observers watch it).
        png = os.path.join(self.out_dir, "trajectory.png")
        fig.savefig(png + ".tmp.png", dpi=120)
        os.replace(png + ".tmp.png", png)
        plt.close(fig)

    def finish(self):
        super().finish()
        self._render()


class LiveTrajectoryVisualizer(MatplotlibTrajectoryVisualizer):
    """Incrementally-updating backend (the rviz stand-in, SURVEY.md R3).

    The reference's RosCameraTrajectoryVisualizer republishes the growing
    trajectory as rviz markers on every update
    (dvo_ros/src/visualization/ros_camera_trajectory_visualizer.cpp); this
    backend re-renders `trajectory.png` + rewrites `trajectory.txt` every
    `snapshot_every` poses so an observer (or a file watcher / image
    viewer) sees the live state of the run, headless."""

    def __init__(self, out_dir: str, snapshot_every: int = 25):
        super().__init__(out_dir)
        self.snapshot_every = max(1, int(snapshot_every))

    def add_pose(self, timestamp, T_wc, is_keyframe=False):
        super().add_pose(timestamp, T_wc, is_keyframe)
        if len(self.poses) % self.snapshot_every == 0:
            self._snapshot()

    def _snapshot(self):
        from dvo_slam_tpu_torch.utils import tum

        # Atomic replace: a file watcher reading between truncation and the
        # final write would otherwise see an empty/torn trajectory.
        txt = os.path.join(self.out_dir, "trajectory.txt")
        tum.write_trajectory(
            txt + ".tmp",
            [t for t, _ in self.poses],
            [T for _, T in self.poses],
        )
        os.replace(txt + ".tmp", txt)
        self._render()


def point_cloud_from_rgbd(intensity, depth, K, T_wc=np.eye(4), stride=4):
    """Back-project an RGB-D frame to a world-frame point cloud
    (reference AsyncPointCloudBuilder equivalent, host-side)."""
    H, W = depth.shape
    fx, fy, cx, cy = [float(x) for x in np.asarray(K).reshape(-1)[:4]]
    v, u = np.mgrid[0:H:stride, 0:W:stride]
    z = np.asarray(depth)[v, u]
    good = np.isfinite(z)
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = np.stack([x[good], y[good], z[good]], axis=-1)
    pts = pts @ np.asarray(T_wc)[:3, :3].T + np.asarray(T_wc)[:3, 3]
    gray = np.asarray(intensity)[v, u][good]
    colors = np.stack([gray] * 3, axis=-1).astype(np.uint8)
    return pts, colors


def write_ply(path, points, colors=None):
    """Minimal ASCII PLY writer (PCL-file equivalent for offline viewing)."""
    points = np.asarray(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.5f} {points[i,1]:.5f} {points[i,2]:.5f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")

"""Exact-geometry synthetic RGB-D scenes.

The reference validates against the TUM RGB-D dataset, which is not
available offline; this module renders multi-view-consistent RGB-D frames
analytically so unit/integration tests and the fps benchmark run
self-contained. A camera observing textured planes admits a closed-form
raycast, so for ANY camera pose the rendered intensity/depth pair is exact —
a frame pair rendered at poses (T_a, T_b) must be aligned by the tracker to
T_b^{-1} T_a with zero residual at the optimum (the "synthetic warp
recovery" property test of SURVEY.md §5).

World convention: camera-to-world poses T_wc; camera looks down +z; pixel
(u, v) has ray direction K^{-1} (u, v, 1) in the camera frame.

Numpy-only copy of ``dvo_slam_tpu/utils/synthetic.py`` for the PyTorch
port, which must run where JAX is not installed: importing anything
from ``dvo_slam_tpu`` imports jax through its ``__init__``. The code
below is the original, except that ``write_tum_dataset`` writes its PNGs
through ``utils/png.py`` where the original uses OpenCV;
tests/test_torch_utils.py holds every other function to the original's
source, and tests/test_torch_tum.py holds the files written to the
original's pixel for pixel.
"""

from __future__ import annotations

import numpy as np

from dvo_slam_tpu_torch.utils import se3_np


def _texture(points, sharpness=1.0):
    """Smooth, non-periodic-ish intensity field over 3D world points (0..255).

    Low-frequency sum of sinusoids: smooth enough for coarse-to-fine GN,
    textured enough that the photometric Jacobian is well conditioned in
    every direction.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    v = (
        np.sin(1.7 * sharpness * x + 0.5)
        + np.sin(2.3 * sharpness * y + 1.1)
        + np.sin(1.3 * sharpness * (x + y) + 2.0)
        + np.sin(2.9 * sharpness * (x - 0.5 * y))
        + 0.5 * np.sin(5.1 * sharpness * x + 3.0 * sharpness * y)
        + 0.5 * np.sin(4.3 * sharpness * y - 2.1 * sharpness * x + 0.7)
    )
    return (128.0 + 28.0 * v).astype(np.float32)


class PlaneScene:
    """One or more textured planes; closed-form raycasting.

    Each plane is (n, d) with points X satisfying n.X = d; the first hit
    (smallest positive depth) wins, giving depth discontinuities when
    several planes are used.
    """

    def __init__(self, planes=None, sharpness=1.0):
        if planes is None:
            # A gently tilted wall ~2m in front of the origin.
            n = np.array([0.15, -0.1, 1.0])
            planes = [(n / np.linalg.norm(n), 2.0)]
        self.planes = [(np.asarray(n, np.float64), float(d)) for n, d in planes]
        self.sharpness = sharpness

    def render(self, K, width, height, T_wc=np.eye(4)):
        """Render (intensity (H,W) f32, depth (H,W) f32 meters, NaN=miss)."""
        fx, fy, cx, cy = [float(k) for k in np.asarray(K).reshape(-1)[:4]]
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        dirs_cam = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=np.float64)], axis=-1
        )
        R = T_wc[:3, :3]
        c = T_wc[:3, 3]
        dirs_world = dirs_cam @ R.T  # (H, W, 3)

        depth = np.full((height, width), np.inf)
        hit_points = np.zeros((height, width, 3))
        for n, d in self.planes:
            denom = dirs_world @ n
            # A ray (near-)parallel to the plane is a MISS, never a hit at
            # ~1e12 m: exclude it from validity (the epsilon replacement
            # below only silences the division warning).
            parallel = np.abs(denom) < 1e-9
            denom = np.where(parallel, 1e-9, denom)
            lam = (d - c @ n) / denom  # camera-frame depth (dir_z == 1)
            valid = (lam > 0.05) & ~parallel
            closer = valid & (lam < depth)
            X = c + lam[..., None] * dirs_world
            depth = np.where(closer, lam, depth)
            hit_points = np.where(closer[..., None], X, hit_points)

        miss = ~np.isfinite(depth)
        intensity = _texture(hit_points, self.sharpness)
        intensity = np.where(miss, 0.0, intensity).astype(np.float32)
        depth = np.where(miss, np.nan, depth).astype(np.float32)
        return intensity, depth


def two_plane_scene(sharpness=1.0):
    """Wall + floor: depth discontinuities and a range of depths."""
    n1 = np.array([0.15, -0.1, 1.0])
    n2 = np.array([0.0, -1.0, 0.15])
    return PlaneScene(
        planes=[(n1 / np.linalg.norm(n1), 2.5), (n2 / np.linalg.norm(n2), 1.2)],
        sharpness=sharpness,
    )


def orbit_trajectory(num_frames, radius=0.04, yaw_amplitude=0.03,
                     cycles=1.0):
    """Small smooth camera motion (camera-to-world poses), loop-friendly.

    A gentle circular translation + yaw oscillation: consecutive-frame
    motion is a few mm / <0.5 deg like a 30 Hz handheld camera, and the
    trajectory returns near its start (exercises loop closure).
    yaw_amplitude (radians) controls how far the viewpoint sweeps — large
    values shrink frame-to-keyframe overlap and drive entropy-ratio
    keyframe switches like real exploratory motion does. cycles > 1
    re-traverses the loop so revisits (loop-closure opportunities) occur
    throughout the sequence, not only at the very end.
    """
    poses = []
    for i in range(num_frames):
        a = 2.0 * np.pi * cycles * i / max(num_frames, 1)
        t = np.array([radius * np.sin(a), radius * (1 - np.cos(a)), 0.02 * np.sin(a)])
        yaw = yaw_amplitude * np.sin(a)
        pitch = 0.02 * (1 - np.cos(a))
        xi = np.concatenate([t, [pitch, yaw, 0.01 * np.sin(2 * a)]])
        poses.append(se3_np.exp(xi))
    return poses


def figure8_trajectory(num_frames, radius=0.04, yaw_amplitude=0.03,
                       cycles=1.0):
    """Figure-8 camera path (camera-to-world poses): a Gerono lemniscate
    in translation with a yaw sweep following the lobe direction.

    Harder loop-closure workload than orbit_trajectory: the center
    crossing is revisited twice per cycle at DIFFERENT headings and the
    two lobes curve in opposite directions, so candidate proposals span a
    wider pose-difference range (tests the odometry voter's tolerance and
    the validators' convergence basins, not just same-heading revisits).
    """
    poses = []
    for i in range(num_frames):
        a = 2.0 * np.pi * cycles * i / max(num_frames, 1)
        t = np.array([
            radius * np.sin(a),
            0.5 * radius * np.sin(2 * a),
            0.02 * np.sin(a),
        ])
        yaw = yaw_amplitude * np.sin(2 * a)
        pitch = 0.02 * (1 - np.cos(a))
        xi = np.concatenate([t, [pitch, yaw, 0.01 * np.sin(3 * a)]])
        poses.append(se3_np.exp(xi))
    return poses


def add_sensor_noise(intensity, depth, rng, intensity_std=2.0,
                     depth_rel_std=0.01, dropout=0.0):
    """Kinect-like sensor noise: additive intensity noise, depth noise
    growing with range (~1% of Z), optional random depth dropout."""
    i = intensity + rng.normal(scale=intensity_std, size=intensity.shape)
    i = np.clip(i, 0.0, 255.0).astype(np.float32)
    z = depth * (1.0 + rng.normal(scale=depth_rel_std, size=depth.shape))
    if dropout > 0:
        z = np.where(rng.uniform(size=depth.shape) < dropout, np.nan, z)
    return i, z.astype(np.float32)


def render_sequence(scene, K, width, height, poses):
    """Render a full RGB-D sequence at the given camera-to-world poses."""
    frames = []
    for T_wc in poses:
        frames.append(scene.render(K, width, height, T_wc))
    return frames


def write_tum_dataset(out_dir, frames, poses, fps=30.0, depth_scale=5000.0):
    """Write frames to disk in the standard TUM RGB-D layout.

    Produces rgb/*.png (8-bit grayscale), depth/*.png (uint16,
    meters * depth_scale, 0 = invalid — exactly the Kinect encoding the
    reference's SurfacePyramid::convertRawDepthImage consumes), rgb.txt /
    depth.txt / assoc.txt and groundtruth.txt, so the full from-disk
    pipeline (PNG decode, depth conversion, association, ATE oracle) is
    exercised end to end without the real dataset. `frames` may be any
    iterable of (intensity, depth), consumed one frame at a time.

    The JAX package's function, writing its PNGs with utils/png.py where
    the original uses OpenCV: the same pixel values, the same files.
    """
    import os

    from dvo_slam_tpu_torch.utils import png, tum

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_lines, depth_lines, assoc_lines, stamps = [], [], [], []
    for i, (intensity, depth) in enumerate(frames):
        ts = i / fps
        stamps.append(ts)
        rgb_name = f"rgb/{ts:.6f}.png"
        depth_name = f"depth/{ts:.6f}.png"
        # round() before the integer casts: plain .astype FLOORS, a
        # systematic -0.5 LSB bias (1 gray level / up to 0.1 mm depth) on
        # every pixel of the "exact-geometry" dataset; rounding halves the
        # quantization error and removes the bias.
        png.write(
            os.path.join(out_dir, rgb_name),
            np.round(np.clip(intensity, 0, 255)).astype(np.uint8),
        )
        raw = np.where(np.isfinite(depth), depth * depth_scale, 0.0)
        # Kinect/TUM convention: out-of-range depth is 0 (INVALID), never
        # clipped to 65535 — that would decode as a false 13.1 m reading.
        raw = np.where((raw < 0) | (raw > 65535), 0.0, raw)
        png.write(
            os.path.join(out_dir, depth_name),
            np.round(raw).astype(np.uint16),
        )
        rgb_lines.append(f"{ts:.6f} {rgb_name}")
        depth_lines.append(f"{ts:.6f} {depth_name}")
        assoc_lines.append(f"{ts:.6f} {rgb_name} {ts:.6f} {depth_name}")
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("assoc.txt", assoc_lines)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("# synthetic TUM-layout sequence\n")
            f.write("\n".join(lines) + "\n")
    tum.write_trajectory(os.path.join(out_dir, "groundtruth.txt"), stamps, poses)
    return stamps


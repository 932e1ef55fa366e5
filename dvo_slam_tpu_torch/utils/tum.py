"""TUM RGB-D dataset IO and TUM-format trajectory serialization
(counterpart of ``dvo_slam_tpu/utils/tum.py``).

Equivalent of the reference's host I/O layer:
  * dvo_benchmark file_reader.h / rgbd_pair.h / groundtruth.h — assoc.txt
    + groundtruth.txt parsing and closest-timestamp association.
  * dvo_core SurfacePyramid::convertRawDepthImage — uint16/5000 -> meters.
  * dvo_slam TrajectorySerializer — TUM-format trajectories
    ("timestamp tx ty tz qx qy qz qw"), the format the ATE oracle reads.

PNG decode goes through one of two decoders, picked by name and never
switched behind the caller's back: "native" (the C++ decoder and its
prefetch thread, ``dvo_slam_tpu_torch.native``, built at first use) or
"numpy" (``utils/png.py``, its plain version; synchronous). Where the JAX
package falls back to OpenCV, the port has no OpenCV dependency at all.
"""

from __future__ import annotations

import bisect
import os
from typing import Optional

import numpy as np

from dvo_slam_tpu_torch.utils import se3_np

DEPTH_SCALE = 5000.0  # TUM RGB-D: uint16 depth units per meter.
DECODERS = ("native", "numpy")


def _read_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def read_trajectory(path):
    """Read a TUM-format trajectory: list of (timestamp, 4x4 T_wc)."""
    out = []
    for parts in _read_lines(path):
        ts = float(parts[0])
        t = [float(x) for x in parts[1:4]]
        q = [float(x) for x in parts[4:8]]
        out.append((ts, se3_np.pose_to_matrix(t, q)))
    return out


def write_trajectory(path, timestamps, poses):
    """Write TUM format (TrajectorySerializer equivalent)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            t, q = se3_np.matrix_to_pose(T)
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_assoc(path):
    """Parse assoc.txt: rows (rgb_ts, rgb_file, depth_ts, depth_file)."""
    out = []
    for parts in _read_lines(path):
        out.append((float(parts[0]), parts[1], float(parts[2]), parts[3]))
    return out


def associate(a_stamps, b_stamps, max_difference=0.02):
    """Greedy closest-timestamp association (reference findClosestEntry /
    the dataset's associate.py). Returns a sorted list of (i, j) index
    pairs. Candidates come from bisecting each a-stamp into the sorted
    b-stamps: the all-pairs candidate set, without building it."""
    order_b = sorted(range(len(b_stamps)), key=lambda j: b_stamps[j])
    sorted_b = [b_stamps[j] for j in order_b]
    candidates = []
    for i, ta in enumerate(a_stamps):
        lo = bisect.bisect_left(sorted_b, ta - max_difference)
        hi = bisect.bisect_right(sorted_b, ta + max_difference)
        for k in range(lo, hi):
            if abs(ta - sorted_b[k]) < max_difference:
                candidates.append((abs(ta - sorted_b[k]), i, order_b[k]))
    candidates.sort()
    pairs = []
    used_a, used_b = set(), set()
    for _, i, j in candidates:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    return sorted(pairs)


def _codec(decoder: str):
    """The module that decodes for `decoder`: both have png_size,
    decode_intensity and decode_depth."""
    if decoder == "native":
        from dvo_slam_tpu_torch import native

        return native
    if decoder == "numpy":
        from dvo_slam_tpu_torch.utils import png

        return png
    raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")


def load_image_pair(dataset_dir, rgb_file, depth_file, decoder="native"):
    """Load one frame: (intensity f32 (H,W) 0..255, depth f32 meters
    NaN-invalid), as cv_bridge + SurfacePyramid::convertRawDepthImage
    give it. A file that does not decode raises OSError."""
    codec = _codec(decoder)
    rgb_path = os.path.join(dataset_dir, rgb_file)
    depth_path = os.path.join(dataset_dir, depth_file)
    w, h = codec.png_size(rgb_path)
    intensity = codec.decode_intensity(rgb_path, w, h)
    wd, hd = codec.png_size(depth_path)
    depth = codec.decode_depth(depth_path, wd, hd, DEPTH_SCALE)
    return intensity, depth


class TumDataset:
    """Iterator over a TUM RGB-D sequence directory.

    Expects the standard layout: rgb/, depth/, rgb.txt, depth.txt (or a
    precomputed assoc.txt) and optionally groundtruth.txt. Equivalent to the
    dvo_benchmark FileReader-driven loop (SURVEY.md §3.1). `decoder`:
    "native" or "numpy" (see the module docstring).
    """

    def __init__(self, dataset_dir, assoc_file=None, max_difference=0.02,
                 decoder="native"):
        _codec(decoder)
        self.dir = dataset_dir
        self.decoder = decoder
        assoc_path = assoc_file or os.path.join(dataset_dir, "assoc.txt")
        if os.path.exists(assoc_path):
            self.pairs = read_assoc(assoc_path)
        else:
            rgb_list = list(_read_lines(os.path.join(dataset_dir, "rgb.txt")))
            depth_list = list(_read_lines(os.path.join(dataset_dir,
                                                       "depth.txt")))
            rgb_ts = [float(r[0]) for r in rgb_list]
            depth_ts = [float(d[0]) for d in depth_list]
            matches = associate(rgb_ts, depth_ts, max_difference)
            self.pairs = [
                (rgb_ts[i], rgb_list[i][1], depth_ts[j], depth_list[j][1])
                for i, j in matches
            ]
        gt_path = os.path.join(dataset_dir, "groundtruth.txt")
        self.groundtruth = (read_trajectory(gt_path)
                            if os.path.exists(gt_path) else None)
        self._gt_sorted = self._gt_stamps = None

    def __len__(self):
        return len(self.pairs)

    def timestamp(self, idx):
        return self.pairs[idx][0]

    def __getitem__(self, idx):
        ts, rgb_file, _, depth_file = self.pairs[idx]
        intensity, depth = load_image_pair(self.dir, rgb_file, depth_file,
                                           self.decoder)
        return ts, intensity, depth

    def prefetch_iter(self, prefetch: int = 4, limit: Optional[int] = None):
        """Iterate (timestamp, intensity, depth) over the first `limit`
        frames (all by default).

        The native decoder runs on the C++ prefetch thread, `prefetch`
        frames ahead (decode overlaps device compute; a frame that fails
        to decode is skipped, as the reference drops bad messages); the
        numpy decoder decodes each frame when it is asked for. The
        sequence must be dimensionally homogeneous (TUM sequences are).
        """
        pairs = self.pairs if limit is None else self.pairs[:limit]
        if not pairs:
            return
        if self.decoder != "native":
            for i in range(len(pairs)):
                yield self[i]
            return
        from dvo_slam_tpu_torch import native

        w, h = native.png_size(os.path.join(self.dir, pairs[0][1]))
        rgb_paths = [os.path.join(self.dir, p[1]) for p in pairs]
        depth_paths = [os.path.join(self.dir, p[3]) for p in pairs]
        with native.PrefetchLoader(rgb_paths, depth_paths, w, h,
                                   depth_scale=DEPTH_SCALE,
                                   prefetch=prefetch) as loader:
            for idx, intensity, depth in loader:
                yield pairs[idx][0], intensity, depth

    def groundtruth_pose(self, timestamp,
                         max_difference=0.05) -> Optional[np.ndarray]:
        """Closest groundtruth pose to `timestamp` (reference groundtruth.h),
        or None when none lies within `max_difference` seconds. Bisects the
        time-sorted groundtruth."""
        if not self.groundtruth:
            return None
        if self._gt_stamps is None:
            self._gt_sorted = sorted(self.groundtruth, key=lambda e: e[0])
            self._gt_stamps = [e[0] for e in self._gt_sorted]
        i = bisect.bisect_left(self._gt_stamps, timestamp)
        best = min(self._gt_sorted[max(0, i - 1): i + 1],
                   key=lambda e: abs(e[0] - timestamp))
        if abs(best[0] - timestamp) > max_difference:
            return None
        return best[1]

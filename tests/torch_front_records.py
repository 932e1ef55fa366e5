#!/usr/bin/env python3
"""Device records a frame by layer of the tracking front, on the card.

    python tests/torch_front_records.py [TREE]

Runs the profiles of chip_smoke.py's phases 4 (odometry over phase 3's
640x480 orbit), 5c (the SLAM ring after 48 warm-up frames; frames without
a switch) and 6h (the offline cell's SLAM path over bench/accuracy.py's
sequence) through the level kernel, with the port of TREE: the checkout
holding this script by default, or a `git archive` of another commit
unpacked under build/ (the profile code is this checkout's chip_smoke.py,
which counts a tree that lacks one of its layers' functions too). Each
phase prints the records a frame by layer: pyramid (build_pyramid),
reference (prepare_reference), levels (the level loops), assembly (the
rest of track_batched), copies and other (chip_smoke.FRONT_LAYERS).
Needs one card; writes nothing.
"""

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    import dvo_slam_tpu_torch
    from dvo_slam_tpu_torch import KeyframeSlam, cli
    from dvo_slam_tpu_torch.utils import synthetic, tum

    if not torch.cuda.is_available():
        sys.exit("torch_front_records: no CUDA card")
    print(f"tree {tree} (package {Path(dvo_slam_tpu_torch.__file__).parent})")
    device = torch.device("cuda", 0)
    smoke.phase_device()

    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(smoke.N_FRAMES, radius=0.06)
    frames = synthetic.render_sequence(scene, np.asarray(smoke.K_TUPLE),
                                       smoke.W, smoke.H, poses)
    smoke.phase_profile(device, frames, host=False, limits=False)

    ring, _ = smoke._ring()
    slam = KeyframeSlam(smoke.K_TUPLE, device=device)
    smoke._slam_frames(slam, ring, 48, 0.0)
    smoke.phase_slam_profile({"slam": slam, "frames": ring}, host=False)

    n = smoke.OFFLINE_PROFILED_FRAMES
    with tempfile.TemporaryDirectory(prefix="dvo_front_") as tmp:
        seq = str(Path(tmp) / "seq")
        smoke._render_offline(seq, smoke.OFFLINE_FRAMES, smoke.W, smoke.H)
        ds = tum.TumDataset(seq)
        cli_args = cli._parser().parse_args(["benchmark", seq,
                                             *smoke.OFFLINE_FLAGS])
        offline = {"frames": [ds[k] for k in range(2 * n)],
                   "groundtruth": ds.groundtruth_pose,
                   "tracker_cfg": cli._tracker_cfg(cli_args),
                   "slam_cfg": cli._slam_cfg(cli_args)}
        smoke.phase_offline_profile(offline, device, host=False)


if __name__ == "__main__":
    main()

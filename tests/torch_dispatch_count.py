"""Count the eager aten ops one odometry frame dispatches, on the CPU.

    python tests/torch_dispatch_count.py [--root CHECKOUT] [--width 160]

Imports ``dvo_slam_tpu_torch`` from CHECKOUT (default: this repository),
tracks the verify skill's orbit with ``OdometryTracker`` at the default
``TrackerConfig`` (and, with ``--budget``, at that
``point_budget_fraction``) and prints the non-view aten ops of one frame
after two warm-up frames, by op name and in total, with a digest of the
frame's pose. Two checkouts giving the same counts dispatch the same work
a frame. Not a test: pytest does not collect it.
"""

import argparse
import collections
import hashlib
import os
import sys

VIEW_OPS = ("aten::view", "aten::_unsafe_view", "aten::slice",
            "aten::select", "aten::unbind", "aten::expand",
            "aten::unsqueeze", "aten::squeeze", "aten::t",
            "aten::transpose", "aten::permute", "aten::alias",
            "aten::detach", "aten::as_strided")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--budget", type=float, default=0.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import dvo_slam_tpu_torch
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.utils import synthetic

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if not name.startswith(VIEW_OPS):
                self.ops[name] += 1
            return func(*args, **(kwargs or {}))

    W, H = args.width, args.width * 3 // 4
    K = (525.0 * W / 640, 525.0 * H / 480, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.orbit_trajectory(4, radius=0.06)
    frames = synthetic.render_sequence(
        synthetic.two_plane_scene(sharpness=2.0), np.asarray(K), W, H, poses)
    cfg = TrackerConfig(point_budget_fraction=args.budget)
    tracker = OdometryTracker(K, cfg, device="cpu")
    for k in range(3):
        tracker.update(*frames[k], float(k))
    with Count() as count:
        T = tracker.update(*frames[3], 3.0)
    digest = hashlib.sha256(np.asarray(T, np.float64).tobytes()).hexdigest()
    print(f"dvo_slam_tpu_torch from {os.path.dirname(dvo_slam_tpu_torch.__file__)}")
    print(f"{W}x{H}, point_budget_fraction {args.budget:g}: "
          f"{sum(count.ops.values())} aten ops in one frame, pose sha256 "
          f"{digest[:16]}")
    for name, n in sorted(count.ops.items()):
        print(f"  {name} {n}")


if __name__ == "__main__":
    main()

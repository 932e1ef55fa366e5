"""Run-to-run spread of tests/test_torch_benchmark.py's
test_run_tum_dataset_like_jax[slam] scenario, each package on its own.

    JAX_PLATFORMS=cpu python tests/torch_benchmark_spread.py --runs 4

Writes the test's 16-frame 64x48 two-lap orbit to a temporary TUM
directory once, then runs the JAX package's and the port's
``run_tum_dataset`` (slam mode, the test's configs) ``--runs`` times each,
alternating, in this one process. Prints per run each package's
keyframes, loop edges and ATE, then each run's largest trajectory
difference from that package's first run and from the other package's
run. Run several copies at once to see the spread under load (the tier-1
command runs 6 test workers). Not a test: pytest does not collect it.
"""

import argparse
import os
import sys
import tempfile

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dvo_slam_tpu import benchmark  # noqa: E402
from dvo_slam_tpu.utils import synthetic, tum  # noqa: E402
from dvo_slam_tpu_torch import benchmark as t_benchmark  # noqa: E402
from dvo_slam_tpu_torch.utils import synthetic as t_synthetic  # noqa: E402

import test_torch_benchmark as T  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--tag", default="spread")
    args = ap.parse_args()
    torch.set_num_threads(1)  # as the test's module fixture
    poses = synthetic.orbit_trajectory(16, radius=0.08, yaw_amplitude=0.3,
                                       cycles=2.0)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(T.K_TUPLE), T.W, T.H, poses)
    with tempfile.TemporaryDirectory() as d:
        t_synthetic.write_tum_dataset(d, frames, poses)
        trajs = {"jax": [], "port": []}
        for r in range(args.runs):
            for side in ("jax", "port"):
                path = os.path.join(d, f"{side}{r}.txt")
                if side == "jax":
                    res = benchmark.run_tum_dataset(
                        d, T.TRACKER, T.SLAM, mode="slam",
                        intrinsics=T.K_TUPLE, trajectory_out=path)
                else:
                    res = t_benchmark.run_tum_dataset(
                        d, *T._cfgs(), mode="slam", intrinsics=T.K_TUPLE,
                        trajectory_out=path, device="cpu")
                trajs[side].append(np.stack(
                    [Tm for _, Tm in tum.read_trajectory(path)]))
                print(f"{args.tag} {side} run {r}: keyframes "
                      f"{res.num_keyframes}, loop edges "
                      f"{res.num_loop_edges}, ATE {res.ate_rmse_m!r} m",
                      flush=True)
    for r in range(args.runs):
        j, p = trajs["jax"][r], trajs["port"][r]
        print(f"{args.tag} run {r}: max |jax - jax run 0| "
              f"{np.abs(j - trajs['jax'][0]).max():.3e}, max |port - port "
              f"run 0| {np.abs(p - trajs['port'][0]).max():.3e}, max |port "
              f"- jax| {np.abs(p - j).max():.3e}", flush=True)


if __name__ == "__main__":
    main()

"""The port's CLI against the JAX package's, and the on-disk accuracy
gates of tests/test_accuracy_benchmark.py on the port.

Each command runs with ``--device cpu`` beside the JAX CLI on the same
arguments and prints the same thing: `evaluate` the same text; the JSON
result line of `synthetic` and `odometry` with the same keys, equal
counts, ATE and translational RPE within 1e-4 m and rotational RPE within
1e-3 rad (tests/test_torch_benchmark.py says why). `optimize-graph` is in
tests/test_torch_g2o.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dvo_slam_tpu import cli
from dvo_slam_tpu.config import SlamConfig
from dvo_slam_tpu.utils import se3_np, synthetic, tum
from dvo_slam_tpu_torch import benchmark as t_benchmark
from dvo_slam_tpu_torch import cli as t_cli
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.utils import synthetic as t_synthetic
from test_torch_benchmark import (ATOL, RPE_ROT_ATOL, H, W, _cfgs,
                                  one_torch_thread)  # noqa: F401

# The CLI's tracker flags for test_torch_benchmark.TRACKER.
TRACKER_ARGS = ["--num-levels", "2", "--first-level", "1", "--last-level",
                "0", "--max-iterations", "30"]


def test_on_disk_accuracy_gates(tmp_path):
    """tests/test_accuracy_benchmark.py's gates on the port: real keyframe
    cadence, a genuine loop closure, an absolute bound, and loop closure
    beating keyframe odometry by a margin."""
    w, h = 96, 72
    K = (525.0 * w / 640.0, 525.0 * h / 480.0, (w - 1) / 2.0, (h - 1) / 2.0)
    rng = np.random.default_rng(11)
    scene = t_synthetic.two_plane_scene(sharpness=2.0)
    poses = t_synthetic.orbit_trajectory(60, radius=0.25, yaw_amplitude=0.6,
                                         cycles=2.0)
    frames = [t_synthetic.add_sensor_noise(i, z, rng, intensity_std=3.0,
                                           depth_rel_std=0.015, dropout=0.08)
              for i, z in t_synthetic.render_sequence(scene, np.asarray(K),
                                                      w, h, poses)]
    out = str(tmp_path / "seq")
    t_synthetic.write_tum_dataset(out, frames, poses)
    slam_cfg = SlamConfig(new_constraint_search_radius=0.12,
                          min_constraint_distance=4, coarse_first_level=1,
                          coarse_last_level=1, validation_batch=4)
    cfgs = _cfgs(slam_cfg)
    res = t_benchmark.run_tum_dataset(out, *cfgs, mode="slam", intrinsics=K,
                                      device="cpu")
    assert res.num_keyframes >= 3, res
    assert res.num_loop_edges >= 1, res
    assert res.ate_rmse_m is not None and res.ate_rmse_m < 0.02, res
    odo = t_benchmark.run_tum_dataset(out, *cfgs, mode="keyframe",
                                      intrinsics=K, device="cpu")
    assert res.ate_rmse_m < 0.7 * odo.ate_rmse_m, (res.ate_rmse_m,
                                                   odo.ate_rmse_m)


def _json_like(got_out, want_out):
    got, want = json.loads(got_out), json.loads(want_out)
    assert set(got) == set(want)
    for key in ("num_frames", "num_keyframes", "num_loop_edges"):
        assert got[key] == want[key], key
    for key, atol in (("ate_rmse_m", ATOL), ("rpe_trans_m", ATOL),
                      ("rpe_rot_rad", RPE_ROT_ATOL)):
        np.testing.assert_allclose(got[key], want[key], atol=atol)


def test_cli_synthetic_like_jax(capsys):
    args = ["synthetic", "--frames", "6", "--width", str(W), "--height",
            str(H), "--mode", "keyframe", *TRACKER_ARGS]
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert t_cli.main(args + ["--device", "cpu"]) == 0
    _json_like(capsys.readouterr().out, want)


def test_cli_odometry_like_jax(tmp_path, capsys):
    """`odometry --fr 1` over a 640x480 sequence rendered with the
    freiburg-1 intrinsics (tracked at the coarsest level only)."""
    poses = synthetic.orbit_trajectory(3, radius=0.02)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(t_camera.TUM_FR1), 640,
                                       480, poses)
    d = str(tmp_path / "fr1")
    t_synthetic.write_tum_dataset(d, frames, poses)
    args = ["odometry", d, "--fr", "1", "--num-levels", "4",
            "--first-level", "3", "--last-level", "3"]
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert t_cli.main(args + ["--device", "cpu"]) == 0
    _json_like(capsys.readouterr().out, want)
    assert json.loads(want)["ate_rmse_m"] < 5e-3


@pytest.mark.parametrize("extra", [[], ["--rpe-seconds"],
                                   ["--rpe-delta", "2"]])
def test_cli_evaluate_like_jax(tmp_path, capsys, extra):
    poses = synthetic.orbit_trajectory(40, radius=0.1)
    ts = [i / 30.0 for i in range(40)]
    rng = np.random.default_rng(2)
    est = [T @ se3_np.exp(rng.normal(scale=1e-3, size=6)) for T in poses]
    offset = se3_np.exp(np.array([0.3, -0.2, 0.1, 0.2, 0.1, -0.3]))
    est_path, gt_path = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    tum.write_trajectory(est_path, ts, [offset @ T for T in est])
    tum.write_trajectory(gt_path, ts, poses)
    assert cli.main(["evaluate", est_path, gt_path, *extra]) == 0
    want = capsys.readouterr().out
    assert t_cli.main(["evaluate", est_path, gt_path, *extra]) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("ate_rmse_m ")


def test_cli_module_entry_point(tmp_path):
    """`python -m dvo_slam_tpu_torch.cli` runs; the card is the default
    device, and without one the engine commands refuse to start."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "dvo_slam_tpu_torch.cli", "synthetic",
         "--frames", "2", "--width", str(W), "--height", str(H)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 2, proc.stderr
    assert "--device cpu" in proc.stderr and not proc.stdout

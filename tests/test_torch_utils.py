"""The port's numpy-only utility copies against their originals, and the
guard that the port imports nothing of JAX.

dvo_slam_tpu_torch/utils holds copies of dvo_slam_tpu/utils/{se3_np,
synthetic, evaluate}.py so that the port runs without JAX. Each copy must
stay the original: every function's source is compared verbatim (but
write_tum_dataset's, which writes through the port's PNG encoder), and
the same seeds and renders give bit-identical outputs (tolerance: exact).
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest

from dvo_slam_tpu.utils import evaluate, se3_np, synthetic
from dvo_slam_tpu_torch.utils import evaluate as t_evaluate
from dvo_slam_tpu_torch.utils import se3_np as t_se3_np
from dvo_slam_tpu_torch.utils import synthetic as t_synthetic

PAIRS = {
    "se3_np": (se3_np, t_se3_np),
    "synthetic": (synthetic, t_synthetic),
    "evaluate": (evaluate, t_evaluate),
}


def _members(mod):
    return {
        name: obj for name, obj in vars(mod).items()
        if (inspect.isfunction(obj) or inspect.isclass(obj))
        and obj.__module__ == mod.__name__
    }


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_copy_is_verbatim(name):
    orig, copy = PAIRS[name]
    o, c = _members(orig), _members(copy)
    assert c, f"{name}: copy defines nothing"
    assert set(c) == set(o), f"{name}: members differ {set(c) ^ set(o)}"
    # write_tum_dataset writes its PNGs through utils/png.py where the
    # original uses OpenCV; tests/test_torch_tum.py holds its files to the
    # original's.
    for member in set(c) - {"write_tum_dataset"}:
        assert inspect.getsource(c[member]) == inspect.getsource(o[member]), (
            f"{name}.{member} differs from the original"
        )


def test_copy_imports_no_jax():
    for _, copy in PAIRS.values():
        src = inspect.getsource(copy)
        assert "import jax" not in src
        assert "from dvo_slam_tpu." not in src and "import dvo_slam_tpu\n" not in src


ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "dvo_slam_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"])


def _imported(tree):
    """Every module name an import statement of the tree names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package, at any depth of the file (function-level imports
    included)."""
    src = (ROOT / path).read_text()
    for name in _imported(ast.parse(src)):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "dvo_slam_tpu"), (path, name)
    for needle in ("import jax", "importlib", "__import__"):
        assert needle not in src, (path, needle)


def test_port_sources_listed():
    assert "chip_smoke.py" in PORT_SOURCES
    for module in ("models/keyframe_tracker.py", "models/pose_graph.py",
                   "models/local_map.py", "models/constraints.py",
                   "ops/linearize.py", "utils/transfer.py", "benchmark.py",
                   "cli.py", "native/__init__.py", "utils/png.py",
                   "utils/tum.py", "utils/checkpoint.py"):
        assert f"dvo_slam_tpu_torch/{module}" in PORT_SOURCES


@pytest.mark.parametrize("entry", ["OdometryTracker", "KeyframeSlam",
                                   "LocalMap", "optimize", "run_sequence",
                                   "run_tum_dataset", "run_synthetic",
                                   "load_slam"])
def test_entry_points_run_on_the_card_by_default(entry):
    """Every entry point a user calls runs on the card unless the caller
    asks for the CPU (the tests pass device="cpu")."""
    from dvo_slam_tpu_torch import benchmark
    from dvo_slam_tpu_torch.models import (keyframe_tracker, local_map,
                                           odometry, pose_graph)
    from dvo_slam_tpu_torch.utils import checkpoint

    fn = {"OdometryTracker": odometry.OdometryTracker,
          "KeyframeSlam": keyframe_tracker.KeyframeSlam,
          "LocalMap": local_map.LocalMap,
          "optimize": pose_graph.optimize,
          "run_sequence": benchmark.run_sequence,
          "run_tum_dataset": benchmark.run_tum_dataset,
          "run_synthetic": benchmark.run_synthetic,
          "load_slam": checkpoint.load_slam}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_runs_on_the_card_by_default():
    """Every CLI command that tracks or solves takes --device, cuda by
    default."""
    from dvo_slam_tpu_torch import cli

    for argv in (["benchmark", "d"], ["slam", "d"], ["odometry", "d"],
                 ["synthetic"], ["optimize-graph", "g", "--out", "o"]):
        assert cli._parser().parse_args(argv).device == "cuda", argv


def test_se3_np_matches():
    rng = np.random.default_rng(0)
    xis = np.concatenate([np.zeros((1, 6)), rng.normal(scale=0.3, size=(31, 6))])
    Ts = []
    for xi in xis:
        T = se3_np.exp(xi)
        np.testing.assert_array_equal(t_se3_np.exp(xi), T)
        np.testing.assert_array_equal(t_se3_np.log(T), se3_np.log(T))
        np.testing.assert_array_equal(t_se3_np.inverse(T), se3_np.inverse(T))
        np.testing.assert_array_equal(t_se3_np.rot_to_quat(T[:3, :3]),
                                      se3_np.rot_to_quat(T[:3, :3]))
        Ts.append(T)
    Ts = np.stack(Ts)
    np.testing.assert_array_equal(t_se3_np.log_batch(Ts), se3_np.log_batch(Ts))
    np.testing.assert_array_equal(t_se3_np.inverse_batch(Ts),
                                  se3_np.inverse_batch(Ts))


def test_synthetic_matches():
    W, H = 80, 60
    K = np.asarray((40.0, 40.0, (W - 1) / 2, (H - 1) / 2))
    poses = synthetic.orbit_trajectory(4, radius=0.06)
    t_poses = t_synthetic.orbit_trajectory(4, radius=0.06)
    np.testing.assert_array_equal(np.stack(t_poses), np.stack(poses))
    np.testing.assert_array_equal(
        np.stack(t_synthetic.figure8_trajectory(4)),
        np.stack(synthetic.figure8_trajectory(4)))
    frames = synthetic.render_sequence(
        synthetic.two_plane_scene(sharpness=2.0), K, W, H, poses)
    t_frames = t_synthetic.render_sequence(
        t_synthetic.two_plane_scene(sharpness=2.0), K, W, H, t_poses)
    for (i, z), (ti, tz) in zip(frames, t_frames):
        np.testing.assert_array_equal(ti, i)
        np.testing.assert_array_equal(tz, z)
    noisy = synthetic.add_sensor_noise(*frames[0], np.random.default_rng(0),
                                       dropout=0.02)
    t_noisy = t_synthetic.add_sensor_noise(*t_frames[0],
                                           np.random.default_rng(0),
                                           dropout=0.02)
    for a, b in zip(noisy, t_noisy):
        np.testing.assert_array_equal(b, a)


def test_evaluate_matches():
    gt = synthetic.orbit_trajectory(12, radius=0.05)
    rng = np.random.default_rng(1)
    est = [T @ se3_np.exp(rng.normal(scale=1e-3, size=6)) for T in gt]
    assert t_evaluate.ate_rmse(est, gt) == evaluate.ate_rmse(est, gt)
    assert t_evaluate.rpe(est, gt, delta=2) == evaluate.rpe(est, gt, delta=2)
    ts = np.arange(12) / 10.0
    assert (t_evaluate.rpe(est, gt, delta=0.3, timestamps=ts, per_second=True)
            == evaluate.rpe(est, gt, delta=0.3, timestamps=ts, per_second=True))

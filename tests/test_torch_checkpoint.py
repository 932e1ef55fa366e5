"""The port's SLAM checkpoints against the JAX package's.

tests/test_checkpoint_bench.py's 10-frame 64x48 orbit (two levels, loop
closure off, a forced keyframe at frame 5) runs through both packages:
the port resumes its own checkpoint like an uninterrupted run, and a
checkpoint written by either package resumes in the other. Discrete
structure (keyframes, each frame's keyframe) is asserted exactly, poses
within 1e-4 (the cross-run tolerance of tests/cross_run.py; f32 tracking
with sums in another order). The files hold the same keys, dtypes and
shapes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.models.keyframe_tracker import KeyframeSlam
from dvo_slam_tpu.utils import checkpoint, se3_np, synthetic
from dvo_slam_tpu_torch import KeyframeSlam as TKeyframeSlam
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.utils import checkpoint as t_checkpoint
from test_torch_benchmark import one_torch_thread  # noqa: F401

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
TRACKER = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=30)
SLAM = SlamConfig(max_keyframes=32, max_edges=128, min_constraint_distance=3,
                  coarse_first_level=1, coarse_last_level=1,
                  validation_batch=4)
TRAJ_ATOL = 1e-4
SPLIT = 5


def _cfgs(slam_cfg=SLAM, tracker_cfg=TRACKER):
    return (convert.tracker_config_from_fields(dataclasses.asdict(tracker_cfg)),
            convert.slam_config_from_fields(dataclasses.asdict(slam_cfg)))


def _frames(n, radius=0.05):
    poses = synthetic.orbit_trajectory(n, radius=radius)
    return synthetic.render_sequence(synthetic.two_plane_scene(),
                                     np.asarray(K_TUPLE), W, H, poses), poses


def _port(slam_cfg=SLAM, **kw):
    return TKeyframeSlam(K_TUPLE, *_cfgs(slam_cfg), enable_loop_closure=False,
                         device="cpu", **kw)


def _jax(slam_cfg=SLAM):
    return KeyframeSlam(K_TUPLE, TRACKER, slam_cfg, enable_loop_closure=False)


def _feed(slam, frames, start):
    for i, (intensity, depth) in enumerate(frames, start=start):
        if i == SPLIT:
            slam.force_keyframe()
        slam.update(intensity, depth, i / 30.0)
    return slam


def _load_port(path, slam_cfg=SLAM):
    return t_checkpoint.load_slam(path, K_TUPLE, *_cfgs(slam_cfg),
                                  enable_loop_closure=False, device="cpu")


def _load_jax(path):
    return checkpoint.load_slam(path, K_TUPLE, TRACKER, SLAM,
                                enable_loop_closure=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Uninterrupted runs of both packages, and each package's checkpoint
    at the split."""
    d = tmp_path_factory.mktemp("ckpt")
    frames, poses = _frames(10)
    out = {"frames": frames, "dir": d}
    for name, make, save in (("jax", _jax, checkpoint.save_slam),
                             ("port", _port, t_checkpoint.save_slam)):
        full = make()
        full.init(poses[0])
        out[f"{name}_full"] = _feed(full, frames, 0)
        half = make()
        half.init(poses[0])
        _feed(half, frames[:SPLIT], 0)
        out[f"{name}_ckpt"] = str(d / f"{name}.npz")
        save(out[f"{name}_ckpt"], half)
    return out


def _assert_like(resumed, full):
    assert ([k.idx for k in resumed.keyframes]
            == [k.idx for k in full.keyframes])
    assert ([f.keyframe_idx for f in resumed.frames]
            == [f.keyframe_idx for f in full.frames])
    ta, tb = resumed.trajectory(), full.trajectory()
    assert [t for t, _ in ta] == [t for t, _ in tb] and len(ta) == 10
    for (_, Ta), (_, Tb) in zip(ta, tb):
        np.testing.assert_allclose(Ta, Tb, atol=TRAJ_ATOL)


def test_port_resume_equivalence(runs):
    resumed = _feed(_load_port(runs["port_ckpt"]), runs["frames"][SPLIT:],
                    SPLIT)
    _assert_like(resumed, runs["port_full"])
    _assert_like(runs["port_full"], runs["jax_full"])


def test_jax_checkpoint_resumes_in_port(runs):
    resumed = _feed(_load_port(runs["jax_ckpt"]), runs["frames"][SPLIT:],
                    SPLIT)
    _assert_like(resumed, runs["jax_full"])


def test_port_checkpoint_resumes_in_jax(runs):
    resumed = _feed(_load_jax(runs["port_ckpt"]), runs["frames"][SPLIT:],
                    SPLIT)
    _assert_like(resumed, runs["jax_full"])


def test_same_format_as_jax(runs):
    ours, theirs = np.load(runs["port_ckpt"]), np.load(runs["jax_ckpt"])
    assert sorted(ours.files) == sorted(theirs.files)
    for key in theirs.files:
        assert ours[key].dtype == theirs[key].dtype, key
        assert ours[key].shape == theirs[key].shape, key
        if theirs[key].dtype.kind in "biu":  # counts, indices, flags
            np.testing.assert_array_equal(ours[key], theirs[key],
                                          err_msg=key)


def test_restore_respects_residency_budget(tmp_path):
    cfg = dataclasses.replace(SLAM, resident_keyframes=2)
    frames, poses = _frames(8)
    slam = _port(cfg)
    slam.init(poses[0])
    for i, (intensity, depth) in enumerate(frames):
        if i and i % 2 == 0:
            slam.force_keyframe()
        slam.update(intensity, depth, i / 30.0)
    assert len(slam.keyframes) >= 4
    path = str(tmp_path / "evicted.npz")
    t_checkpoint.save_slam(path, slam)
    restored = _load_port(path, cfg)
    n = len(restored.keyframes)
    for k, kf in enumerate(restored.keyframes):
        resident = k >= n - cfg.resident_keyframes
        assert kf.resident == resident, k
        assert isinstance(kf.pyramid[0], torch.Tensor) == resident, k
        np.testing.assert_array_equal(np.asarray(kf.pyramid[1]),
                                      np.asarray(slam.keyframes[k].pyramid[1]))


def test_reset_anchor_survives(tmp_path):
    frames, poses = _frames(6)
    slam = _port()
    slam.init(poses[0])
    for i, (intensity, depth) in enumerate(frames[:4]):
        slam.update(intensity, depth, i / 30.0)
    T_reset = poses[0] @ se3_np.exp(np.array([0.3, 0.1, -0.2, 0.05, 0.02,
                                              -0.04]))
    slam.reset(T_reset)
    path = str(tmp_path / "reset.npz")
    t_checkpoint.save_slam(path, slam)
    restored = _load_port(path)
    assert not restored._initialized
    np.testing.assert_allclose(
        restored.update(frames[4][0], frames[4][1], 4 / 30.0), T_reset,
        atol=1e-9)


def test_exact_path_any_extension(tmp_path):
    frames, poses = _frames(3)
    slam = _feed(_port(), frames, 0)
    path = str(tmp_path / "state.ckpt")
    t_checkpoint.save_slam(path, slam)
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    ta, tb = slam.trajectory(), _load_port(path).trajectory()
    assert [t for t, _ in ta] == [t for t, _ in tb] and len(ta) == 3
    for (_, Ta), (_, Tb) in zip(ta, tb):
        np.testing.assert_allclose(Ta, Tb, atol=1e-12)


def test_mismatches_raise(runs, tmp_path):
    path = runs["port_ckpt"]
    with pytest.raises(ValueError, match="num_levels"):
        t_checkpoint.load_slam(path, K_TUPLE, *_cfgs(tracker_cfg=dataclasses.
                               replace(TRACKER, num_levels=3)), device="cpu")
    with pytest.raises(ValueError, match="local_map_capacity"):
        _load_port(path, dataclasses.replace(SLAM, local_map_capacity=2))
    # A per-frame checkpoint loaded as chunked, and a checkpoint of the
    # JAX package's chunked engine loaded as per-frame: the JAX reader's
    # engine-mismatch error.
    with pytest.raises(ValueError, match="per-frame engine"):
        t_checkpoint.load_slam(path, K_TUPLE, *_cfgs(), chunked=True,
                               device="cpu")
    from dvo_slam_tpu.models.chunked_slam import ChunkedKeyframeSlam

    chunked = ChunkedKeyframeSlam(K_TUPLE, TRACKER, SLAM,
                                  enable_loop_closure=False)
    chunked.init()
    chunked_path = str(tmp_path / "chunked.npz")
    checkpoint.save_slam(chunked_path, chunked)
    with pytest.raises(ValueError, match="chunked engine"):
        _load_port(chunked_path)

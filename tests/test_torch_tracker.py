"""The port's dense tracker and odometry against the JAX package.

Synthetic 80x60 frames with exact ground truth (utils/synthetic), three
pyramid levels. Tolerances: transformation entries 1e-4 and per-frame
world poses 1e-4 (f32 IRLS on both sides, reductions in another order);
iterations per level equal or +-1 (an accept/reject decision at the f32
noise floor may flip); valid_pixels within 2; entropy and log-likelihood
rtol 1e-3; ATE below 5 mm for both over the orbit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import dense_tracker, odometry
from dvo_slam_tpu.ops import camera, pyramid
from dvo_slam_tpu.utils import evaluate, se3_np, synthetic
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import dense_tracker as t_dense_tracker
from dvo_slam_tpu_torch.models import odometry as t_odometry
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

W, H = 80, 60
K_TUPLE = (40.0, 40.0, (W - 1) / 2.0, (H - 1) / 2.0)
CFG = TrackerConfig(num_levels=3, first_level=2, last_level=0)
CFG_LM = dataclasses.replace(CFG, lm_lambda_init=1e-4)
XI = np.array([0.02, -0.015, 0.01, 0.01, -0.008, 0.012])


def _port_cfg(cfg):
    return convert.tracker_config_from_fields(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair():
    scene = synthetic.PlaneScene()
    T_rel = se3_np.exp(XI)
    K = np.asarray(K_TUPLE)
    ref = scene.render(K, W, H, np.eye(4))
    cur = scene.render(K, W, H, se3_np.inverse(T_rel))
    return ref, cur, T_rel


@pytest.fixture(scope="module")
def orbit():
    poses = synthetic.orbit_trajectory(8, radius=0.05)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(K_TUPLE), W, H, poses)
    return frames, poses


def _track_both(ref, cur, cfg, T_init=np.eye(4)):
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE),
                                   cfg.num_levels)
    pyr = [pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z),
                                 cfg.num_levels) for i, z in (ref, cur)]
    want = dense_tracker.track_jit(pyr[0], pyr[1], Ks,
                                   jnp.asarray(T_init, jnp.float32), cfg)
    t_cfg = _port_cfg(cfg)
    t_Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), cfg.num_levels)
    t_pyr = [t_pyramid.build_pyramid(torch.from_numpy(i), torch.from_numpy(z),
                                     cfg.num_levels) for i, z in (ref, cur)]
    got = t_dense_tracker.track(
        t_pyr[0], t_pyr[1], t_Ks,
        torch.as_tensor(T_init, dtype=torch.float32), t_cfg)
    return convert.result_to_numpy(got), want


def _pose_error(T_est, T_true):
    return np.linalg.norm(se3_np.log(
        se3_np.inverse(np.asarray(T_est, np.float64)) @ T_true))


def _assert_results_agree(got, want):
    np.testing.assert_allclose(got.transformation,
                               np.asarray(want.transformation), atol=1e-4)
    assert np.abs(got.iterations - np.asarray(want.iterations)).max() <= 1
    assert abs(float(got.valid_pixels) - float(want.valid_pixels)) <= 2
    np.testing.assert_allclose(got.entropy, np.asarray(want.entropy),
                               rtol=1e-3)
    np.testing.assert_allclose(got.log_likelihood,
                               np.asarray(want.log_likelihood), rtol=1e-3)
    assert not bool(got.is_nan())


@pytest.mark.parametrize("cfg", [CFG, CFG_LM], ids=["gauss_newton", "lm"])
def test_track_recovers_known_pose_like_jax(pair, cfg):
    ref, cur, T_rel = pair
    got, want = _track_both(ref, cur, cfg)
    _assert_results_agree(got, want)
    assert _pose_error(got.transformation, T_rel) < 2e-3
    assert _pose_error(want.transformation, T_rel) < 2e-3
    # Per-iteration stats follow the same IRLS history.
    s, ws = got.stats, want.stats
    assert s.valid.shape == (3, cfg.max_iterations)
    np.testing.assert_array_equal(s.window_miss, 0.0)
    assert float(got.window_miss_frac) == 0.0 and not bool(got.escalated)
    for lvl, n in enumerate(got.iterations):
        assert (s.valid[lvl, :n] > 0).all() and (s.valid[lvl, n:] == 0).all()
        if n == int(want.iterations[lvl]):
            assert int(s.termination[lvl]) == int(ws.termination[lvl])
            np.testing.assert_array_equal(s.accepted[lvl],
                                          np.asarray(ws.accepted[lvl]))


def test_reference_without_depth_stops_early_like_jax(pair):
    """Zero selected points: early stop, initial pose kept, no NaN."""
    ref, cur, _ = pair
    no_depth = (ref[0], np.full_like(ref[1], np.nan))
    got, want = _track_both(no_depth, cur, CFG)
    assert float(got.valid_pixels) == float(want.valid_pixels) == 0.0
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))
    np.testing.assert_allclose(got.transformation, np.eye(4), atol=1e-6)
    assert (got.stats.termination
            == t_dense_tracker.TERM_TOO_FEW_CONSTRAINTS).all()
    assert not bool(got.is_nan())


def test_odometry_tracker_orbit_like_jax(orbit):
    frames, poses = orbit
    jax_tr = odometry.OdometryTracker(K_TUPLE, CFG, collect_covariance=True)
    port_tr = t_odometry.OdometryTracker(K_TUPLE, _port_cfg(CFG),
                                         collect_covariance=True,
                                         device="cpu")
    for k, (i, z) in enumerate(frames):
        want = jax_tr.update(i, z, float(k))
        got = port_tr.update(i, z, float(k))
        np.testing.assert_allclose(got, want, atol=1e-4)
    est_j = [T for _, T in jax_tr.trajectory]
    est_t = [T for _, T in port_tr.trajectory]
    assert evaluate.ate_rmse(est_j, poses) < 5e-3
    assert evaluate.ate_rmse(est_t, poses) < 5e-3
    assert port_tr.last_result is not None
    for (_, cj), (_, ct) in zip(jax_tr.covariances[1:],
                                port_tr.covariances[1:]):
        assert np.isfinite(ct).all()
        np.testing.assert_allclose(np.diag(ct), np.diag(cj), rtol=1e-2)


def test_track_sequence_like_jax(orbit):
    frames, _ = orbit
    ints = np.stack([f[0] for f in frames])
    deps = np.stack([f[1] for f in frames])
    want = odometry.track_sequence(jnp.asarray(ints), jnp.asarray(deps),
                                   camera.intrinsics(*K_TUPLE), CFG)
    got = t_odometry.track_sequence(
        torch.from_numpy(ints), torch.from_numpy(deps),
        t_camera.intrinsics(*K_TUPLE, device="cpu"), _port_cfg(CFG))
    np.testing.assert_allclose(got["rel_poses"].numpy(),
                               np.asarray(want["rel_poses"]), atol=1e-4)
    assert not got["is_nan"].any()
    d_it = got["iterations"].numpy() - np.asarray(want["iterations"])
    assert np.abs(d_it).max() <= 1
    traj = t_odometry.compose_trajectory(got["rel_poses"])
    np.testing.assert_allclose(
        np.stack(traj),
        np.stack(odometry.compose_trajectory(np.asarray(want["rel_poses"]))),
        atol=1e-4)


def test_config_conversion():
    t_cfg = _port_cfg(TrackerConfig(sampler_backend="pallas", pallas_margin=4,
                                    lm_lambda_init=1e-3))
    assert t_cfg.lm_lambda_init == 1e-3
    assert not hasattr(t_cfg, "sampler_backend")
    assert _port_cfg(TrackerConfig(
        point_budget_fraction=0.5)).point_budget_fraction == 0.5
    with pytest.raises(ValueError):
        convert.tracker_config_from_fields(
            {"point_budget_fraction": 1.5})
    with pytest.raises(ValueError):
        convert.tracker_config_from_fields({"not_a_knob": 1})
    levels = convert.pyramid_from_numpy(
        [np.zeros((6, 4, 8), np.float64)], "cpu")
    assert levels[0].dtype == torch.float32 and levels[0].is_contiguous()

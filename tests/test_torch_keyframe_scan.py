"""The port's device-resident keyframe scan against the JAX package's.

Counterparts of tests/test_keyframe_scan.py: the same 64x48 orbits and
configs go through both packages' ``track_keyframe_sequence`` (on the CPU
the port's tracker runs the plain version of its kernels). Switch flags,
acceptance and keyframe indices are compared exactly, per-frame poses
within TRAJ_ATOL (tests/test_torch_slam.py's tolerance).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.models import dense_tracker, keyframe_scan
from dvo_slam_tpu.ops import camera
from dvo_slam_tpu.utils import evaluate, synthetic
from dvo_slam_tpu_torch import KeyframeSlam as TKeyframeSlam
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import dense_tracker as t_dense_tracker
from dvo_slam_tpu_torch.models import keyframe_scan as t_keyframe_scan
from dvo_slam_tpu_torch.ops import camera as t_camera

from test_torch_benchmark import one_torch_thread  # noqa: F401

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
TRACKER = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=30)
# local_map_optimize off: the scan implements the closed-form fusion path.
SLAM = SlamConfig(local_map_optimize=False, min_constraint_distance=3)
TRAJ_ATOL = 1e-4
T_TRACKER = convert.tracker_config_from_fields(dataclasses.asdict(TRACKER))
T_SLAM = convert.slam_config_from_fields(dataclasses.asdict(SLAM))


def _sequence(n=10, radius=0.05, dropout=None):
    scene = synthetic.two_plane_scene()
    poses = synthetic.orbit_trajectory(n, radius=radius)
    frames = synthetic.render_sequence(scene, np.asarray(K_TUPLE), W, H, poses)
    if dropout is not None:
        out = []
        for i, (intensity, depth) in enumerate(frames):
            d = depth.copy()
            d[:, : int(W * min(0.85, dropout * i))] = np.nan
            out.append((intensity, d))
        frames = out
    return (np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
            poses)


def _both(seq_i, seq_z, force=None):
    """The JAX and the port scan over the same frames."""
    j_outs = keyframe_scan.track_keyframe_sequence(
        jnp.asarray(seq_i), jnp.asarray(seq_z), camera.intrinsics(*K_TUPLE),
        TRACKER, SLAM,
        force_keyframe=None if force is None else jnp.asarray(force))
    t_outs = t_keyframe_scan.track_keyframe_sequence(
        torch.as_tensor(seq_i), torch.as_tensor(seq_z),
        t_camera.intrinsics(*K_TUPLE, device="cpu"), T_TRACKER, T_SLAM,
        force_keyframe=None if force is None else torch.as_tensor(force))
    return j_outs, t_outs


def _assert_same(j_outs, t_outs):
    for key in ("switch", "accept"):
        np.testing.assert_array_equal(t_outs[key].numpy(),
                                      np.asarray(j_outs[key]), err_msg=key)
    for key in ("rel_pose", "Z_switch"):
        np.testing.assert_allclose(t_outs[key].numpy(), np.asarray(j_outs[key]),
                                   atol=TRAJ_ATOL, err_msg=key)
    np.testing.assert_allclose(t_outs["entropy_ratio"].numpy(),
                               np.asarray(j_outs["entropy_ratio"]), atol=1e-4)


@pytest.fixture(scope="module")
def forced_run():
    seq_i, seq_z, poses = _sequence(10)
    force = np.zeros(10, bool)
    force[[4, 8]] = True
    return seq_i, seq_z, poses, force, _both(seq_i, seq_z, force)


def test_scan_matches_host_orchestrator(forced_run):
    """The device-resident scan reproduces the port's per-frame
    KeyframeSlam (same switch frames, same trajectory) and the JAX scan
    (same decisions, same poses)."""
    seq_i, seq_z, _, force, (j_outs, t_outs) = forced_run
    slam = TKeyframeSlam(K_TUPLE, T_TRACKER, T_SLAM,
                         enable_loop_closure=False, device="cpu")
    slam.init()
    for i in range(len(seq_i)):
        if force[i]:
            slam.force_keyframe()
        slam.update(seq_i[i], seq_z[i], i / 30.0)
    host_traj = [T for _, T in slam.trajectory()]

    _assert_same(j_outs, t_outs)
    scan_traj, kf_indices = t_keyframe_scan.compose_keyframe_trajectory(t_outs)
    j_traj, j_kf = keyframe_scan.compose_keyframe_trajectory(j_outs)
    assert kf_indices == j_kf == [0, 4, 8]
    assert len(kf_indices) == len(slam.keyframes)
    assert [slam.frames[i].keyframe_idx for i in kf_indices] == \
        [k.idx for k in slam.keyframes]
    assert len(scan_traj) == len(host_traj) == len(seq_i)
    for Ts, Th, Tj in zip(scan_traj, host_traj, j_traj):
        np.testing.assert_allclose(Ts, Th, atol=TRAJ_ATOL)
        np.testing.assert_allclose(Ts, Tj, atol=TRAJ_ATOL)


def test_scan_entropy_switches_and_accuracy():
    """Without forced keyframes, degrading depth triggers entropy-ratio
    switches on the device, on the same frames as the JAX scan, and the
    composed trajectory stays accurate."""
    seq_i, seq_z, poses = _sequence(10, radius=0.02, dropout=0.12)
    j_outs, t_outs = _both(seq_i, seq_z)
    assert bool(t_outs["switch"].any()), "entropy switch never fired"
    _assert_same(j_outs, t_outs)
    traj, kf_indices = t_keyframe_scan.compose_keyframe_trajectory(
        t_outs, T0=poses[0])
    _, j_kf = keyframe_scan.compose_keyframe_trajectory(j_outs, T0=poses[0])
    assert kf_indices == j_kf and len(kf_indices) >= 2
    ate = evaluate.ate_rmse(traj, poses)
    assert ate < 0.01, f"scan keyframe odometry ATE {ate * 1000:.2f} mm"


def test_scan_chunks_chain_the_carry(forced_run):
    """track_keyframe_chunk split at arbitrary boundaries gives the whole
    sequence's outputs (the carry is self-contained)."""
    seq_i, seq_z, _, force, (_, whole) = forced_run
    K = t_camera.intrinsics(*K_TUPLE, device="cpu")
    ti, tz = torch.as_tensor(seq_i), torch.as_tensor(seq_z)
    carry = t_keyframe_scan.init_carry(t_keyframe_scan.pyramid_from_stack(
        ti, tz, 0, T_TRACKER.num_levels))
    parts = []
    for a, b in ((1, 3), (3, 4), (4, 10)):
        carry, outs = t_keyframe_scan.track_keyframe_chunk(
            carry, ti[a:b], tz[a:b], K, T_TRACKER, T_SLAM,
            force_keyframe=torch.as_tensor(force[a:b]))
        parts.append(outs)
    for key in ("rel_pose", "switch", "Z_switch", "entropy"):
        np.testing.assert_array_equal(
            torch.cat([p[key] for p in parts]).numpy(), whole[key].numpy())


@pytest.mark.parametrize("h_ref", [-0.5, 0.25, 1.0, -3.0, 2.7])
def test_entropy_floor_shared_and_engines_agree_at_boundary(h_ref):
    """The entropy-denominator floor is ONE constant used by both engines
    of the port (a drift would desynchronize their keyframe cadence), and
    the host and device entropy-ratio forms agree with the JAX package's
    in the floor-active regime (|h_ref| < floor)."""
    assert (t_keyframe_scan._ENTROPY_FLOOR
            is t_dense_tracker._ENTROPY_DENOM_FLOOR)
    assert (t_keyframe_scan._ENTROPY_FLOOR
            == dense_tracker._ENTROPY_DENOM_FLOOR)
    h_ref = h_ref * t_dense_tracker._ENTROPY_DENOM_FLOOR
    for h_cur in (h_ref - 1.3, h_ref, h_ref + 0.8, -4.1):
        want = dense_tracker.entropy_ratio(h_cur, h_ref)
        host = t_dense_tracker.entropy_ratio(h_cur, h_ref)
        device = float(t_keyframe_scan._entropy_ratio(
            torch.tensor(h_cur, dtype=torch.float32),
            torch.tensor(h_ref, dtype=torch.float32), torch.tensor(True)))
        traced = float(keyframe_scan._entropy_ratio_jnp(
            jnp.float32(h_cur), jnp.float32(h_ref), jnp.bool_(True)))
        np.testing.assert_allclose(host, want, rtol=1e-12)
        np.testing.assert_allclose(device, traced, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(device, host, rtol=1e-6, atol=1e-6)


def test_entropy_ratio_without_history_and_non_finite():
    """No reference yet -> 1.0 even for a non-finite entropy; with history
    a non-finite entropy is -inf (forces a switch), as in the JAX scan."""
    f = torch.tensor
    for h_cur in (2.0, float("inf"), float("nan")):
        for has in (False, True):
            got = float(t_keyframe_scan._entropy_ratio(
                f(h_cur), f(1.5), f(has)))
            want = float(keyframe_scan._entropy_ratio_jnp(
                jnp.float32(h_cur), jnp.float32(1.5), jnp.bool_(has)))
            assert got == want or (np.isnan(got) and np.isnan(want))


def test_fusion_matches_jax_and_guards_singular():
    """The scan's f32 closed-form fusion equals the JAX scan's, and a
    singular information sum leaves T_a unchanged."""
    from dvo_slam_tpu.utils import se3_np

    rng = np.random.default_rng(3)
    T_a = se3_np.exp(rng.normal(scale=0.05, size=6)).astype(np.float32)
    T_b = (se3_np.exp(rng.normal(scale=0.01, size=6)) @ T_a).astype(np.float32)
    M = rng.normal(size=(2, 6, 6))
    info = (np.einsum("bij,bkj->bik", M, M) * 1e3 + 10 * np.eye(6)).astype(
        np.float32)
    got = t_keyframe_scan._fuse_relative_poses(
        *(torch.as_tensor(x) for x in (T_a, info[0], T_b, info[1])))
    want = keyframe_scan._fuse_relative_poses_jnp(
        *(jnp.asarray(x) for x in (T_a, info[0], T_b, info[1])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    zero = torch.zeros((6, 6))
    same = t_keyframe_scan._fuse_relative_poses(
        torch.as_tensor(T_a), zero, torch.as_tensor(T_b), zero)
    np.testing.assert_allclose(same.numpy(), T_a, atol=1e-6)

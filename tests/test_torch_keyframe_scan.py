"""The port's device-resident keyframe scan against the JAX package's.

Counterparts of tests/test_keyframe_scan.py: the same 64x48 orbits and
configs go through both packages' ``track_keyframe_sequence`` (on the CPU
the port's tracker runs the plain version of its kernels). Switch flags,
acceptance and keyframe indices are compared exactly, per-frame poses
within TRAJ_ATOL (tests/test_torch_slam.py's tolerance).
"""

import dataclasses
from pathlib import Path

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
from dvo_slam_tpu_torch.ops import linearize as t_linearize
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid
from dvo_slam_tpu_torch.ops import scan_step

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


def _both(seq_i, seq_z, force=None, tracker=TRACKER):
    """The JAX and the port scan over the same frames."""
    j_outs = keyframe_scan.track_keyframe_sequence(
        jnp.asarray(seq_i), jnp.asarray(seq_z), camera.intrinsics(*K_TUPLE),
        tracker, SLAM,
        force_keyframe=None if force is None else jnp.asarray(force))
    t_outs = t_keyframe_scan.track_keyframe_sequence(
        torch.as_tensor(seq_i), torch.as_tensor(seq_z),
        t_camera.intrinsics(*K_TUPLE, device="cpu"),
        convert.tracker_config_from_fields(dataclasses.asdict(tracker)),
        T_SLAM,
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


@pytest.mark.parametrize("fields", [
    {"scale_estimator": "mad", "influence": "huber"}, {"mu": 0.1},
    {"point_budget_fraction": 0.5}],
    ids=["mad_huber", "mu", "budget"])
def test_scan_off_the_default_estimator_matches_jax(fields):
    """The scan under MAD + Huber, under the motion prior and at a point
    budget (on the card all take the kernel route) against the JAX scan on
    the same frames, one forced switch: the same decisions, poses within
    TRAJ_ATOL."""
    seq_i, seq_z, _ = _sequence(8)
    force = np.zeros(8, bool)
    force[4] = True
    j_outs, t_outs = _both(seq_i, seq_z, force,
                           dataclasses.replace(TRACKER, **fields))
    _assert_same(j_outs, t_outs)
    assert bool(t_outs["switch"].any())


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


# --- the scan step's decisions (ops/scan_step.py) against the JAX step's
# where-chain, and the kernel route's plumbing on the CPU ---

SCAN = t_keyframe_scan.ScanConfig(min_constraint_ratio=0.2,
                                  min_entropy_ratio=0.9, fuse_odometry=True,
                                  with_stats=False)
# Poses and informations of the step against the JAX step (the fusion's
# f32 log, solve and exp in two libraries): 1e-6; the decisions, the
# copied fields and the entropy ratio exactly.
STEP_ATOL = 1e-6
STEP_CASES = ("accepted", "no_history", "kf_nan", "odo_nan", "both_nan",
              "forced", "low_valid_ratio", "low_entropy_ratio",
              "inf_entropy_with_history", "nan_entropy_without_history",
              "signs_rising", "signs_falling", "singular_information",
              "fuse_off", "pivot_tie")


def _step_case(name):
    """A frame's two track-result rows (keyframe, previous frame), the
    carry before it and its force flag, as numpy arrays, for one case."""
    from dvo_slam_tpu.utils import se3_np

    rng = np.random.default_rng(STEP_CASES.index(name))
    T = np.stack([se3_np.exp(rng.normal(scale=0.02, size=6))
                  for _ in range(2)]).astype(np.float32)
    M = rng.normal(size=(2, 6, 6))
    info = (np.einsum("bij,bkj->bik", M, M) * 1e3
            + 10 * np.eye(6)).astype(np.float32)
    c = {"T": T, "ll": np.float32([-1e4, -2e4]), "info": info,
         "entropy": np.float32([-20.0, -19.0]),
         "valid_ratio": np.float32([0.8, 0.7]),
         "iterations": np.int32([[5, 6, 7], [4, 5, 6]]),
         "T_kf_prev": se3_np.exp(rng.normal(scale=0.01, size=6)).astype(
             np.float32),
         "last_odo": se3_np.exp(rng.normal(scale=0.01, size=6)).astype(
             np.float32),
         "H_first": np.float32(-20.5), "has_first": np.bool_(True),
         "force": np.bool_(False), "fuse": True}
    if name == "no_history":
        c["has_first"], c["H_first"] = np.bool_(False), np.float32(0.0)
    elif name in ("kf_nan", "both_nan"):
        c["T"][0, 1, 2] = np.nan
    if name in ("odo_nan", "both_nan"):
        c["ll"][1] = np.inf
    elif name == "forced":
        c["force"] = np.bool_(True)
    elif name == "low_valid_ratio":
        c["valid_ratio"][0] = 0.1
    elif name == "low_entropy_ratio":
        c["entropy"][0] = -10.0
    elif name == "inf_entropy_with_history":
        c["entropy"][0] = np.inf
    elif name == "nan_entropy_without_history":
        c["entropy"][0] = np.nan
        c["has_first"], c["H_first"] = np.bool_(False), np.float32(0.0)
    elif name == "signs_rising":  # |H_first| under the floor: ratio 1.7
        c["H_first"], c["entropy"][0] = np.float32(0.4), -0.3
    elif name == "signs_falling":  # ratio 0.3
        c["H_first"], c["entropy"][0] = np.float32(-0.4), 0.3
    elif name == "singular_information":  # a zero row and column in both
        c["info"][:, 5, :] = 0.0
        c["info"][:, :, 5] = 0.0
    elif name == "fuse_off":
        c["fuse"] = False
    elif name == "pivot_tie":
        # Rows 2 and 4 of column 0 of info[0] + info[1] tie for the
        # largest |a|: the first pivot is row 2 under the first-maximum
        # rule, row 4 under a last-maximum one.
        from chip_smoke import _pivot_tie

        _pivot_tie(c["info"])
    return c


def _jax_step(c, monkeypatch):
    """The JAX package's scan step on the case's rows: its tracker and
    pyramid stood in for, so the step's where-chain, entropy ratio and
    fusion run on exactly these values."""
    from dvo_slam_tpu.models import keyframe_scan as j_scan

    res = dense_tracker.TrackResult(
        transformation=jnp.asarray(c["T"]),
        information=jnp.asarray(c["info"]),
        log_likelihood=jnp.asarray(c["ll"]),
        entropy=jnp.asarray(c["entropy"]), error=jnp.zeros(2),
        sigma=jnp.zeros((2, 2, 2)), valid_pixels=jnp.zeros(2),
        valid_ratio=jnp.asarray(c["valid_ratio"]),
        iterations=jnp.asarray(c["iterations"]),
        level_errors=jnp.zeros((2, 3)), stats=None,
        window_miss_frac=jnp.zeros(2), escalated=jnp.zeros(2, bool))
    monkeypatch.setattr(j_scan.dense_tracker, "track_batched_escalating",
                        lambda *args: res)
    monkeypatch.setattr(j_scan.pyramid, "build_pyramid",
                        lambda *args: tuple(jnp.full((1, 2, 2), 7.0 + lvl)
                                            for lvl in range(4)))
    scan_cfg = j_scan.ScanConfig(SCAN.min_constraint_ratio,
                                 SCAN.min_entropy_ratio, c["fuse"], False)
    step = j_scan._make_step(None, TrackerConfig(), scan_cfg)
    kf = tuple(jnp.full((1, 2, 2), -1.0 - lvl) for lvl in range(4))
    carry = {"kf": kf, "prev": kf, "T_kf_prev": jnp.asarray(c["T_kf_prev"]),
             "last_odo": jnp.asarray(c["last_odo"]),
             "H_first": jnp.asarray(c["H_first"]),
             "has_first": jnp.asarray(c["has_first"])}
    return step(carry, (None, None, jnp.asarray(c["force"])))


def _port_step(c):
    res = t_dense_tracker.TrackResult(
        transformation=torch.as_tensor(c["T"]),
        information=torch.as_tensor(c["info"]),
        log_likelihood=torch.as_tensor(c["ll"]),
        entropy=torch.as_tensor(c["entropy"]), error=torch.zeros(2),
        sigma=torch.zeros(2, 2, 2), valid_pixels=torch.zeros(2),
        valid_ratio=torch.as_tensor(c["valid_ratio"]),
        iterations=torch.as_tensor(c["iterations"]),
        level_errors=torch.zeros(2, 3))
    kf = tuple(torch.full((1, 2, 2), -1.0 - lvl) for lvl in range(4))
    cur = tuple(torch.full((1, 2, 2), 7.0 + lvl) for lvl in range(4))
    carry = {"kf": kf, "prev": kf,
             **{k: torch.as_tensor(c[k]) for k in
                ("T_kf_prev", "last_odo", "H_first", "has_first")}}
    return scan_step.scan_step_reference(
        res, carry, torch.as_tensor(c["force"]), cur,
        dataclasses.replace(SCAN, fuse_odometry=c["fuse"]))


@pytest.mark.parametrize("name", STEP_CASES)
def test_scan_step_reference_like_jax(name, monkeypatch):
    """scan_step_reference, the scan step's plain version (the decisions
    of _step, and the kernel's yardstick), against the JAX package's step
    (_make_step's where-chain, _entropy_ratio_jnp, _fuse_relative_poses_jnp)
    on the same result rows and carry: the decisions, the entropy ratio,
    the entropy history and every copied field exactly, poses and
    informations within STEP_ATOL, the same keyframe pyramid kept."""
    c = _step_case(name)
    j_carry, j_out = _jax_step(c, monkeypatch)
    t_carry, t_out = _port_step(c)
    for key in ("switch", "accept", "is_nan", "entropy", "entropy_ratio",
                "valid_ratio", "T_kf_meas", "T_odo_meas", "info_pair",
                "iterations"):
        np.testing.assert_array_equal(t_out[key].numpy(),
                                      np.asarray(j_out[key]), err_msg=key)
    for key in ("H_first", "has_first", "last_odo"):
        np.testing.assert_array_equal(t_carry[key].numpy(),
                                      np.asarray(j_carry[key]), err_msg=key)
    for key in ("rel_pose", "Z_switch", "info_switch"):
        np.testing.assert_allclose(t_out[key].numpy(),
                                   np.asarray(j_out[key]), atol=STEP_ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(t_carry["T_kf_prev"].numpy(),
                               np.asarray(j_carry["T_kf_prev"]),
                               atol=STEP_ATOL, rtol=0)
    for a, b in zip(t_carry["kf"], j_carry["kf"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want_switch = {"kf_nan": True, "both_nan": True, "forced": True,
                   "low_valid_ratio": True, "low_entropy_ratio": True,
                   "inf_entropy_with_history": True, "signs_falling": True}
    assert bool(t_out["switch"]) == want_switch.get(name, False)
    if name == "singular_information":
        # The non-finite step is dropped: the keyframe measurement stands.
        np.testing.assert_array_equal(t_out["rel_pose"].numpy(), c["T"][0])
    if name in ("accepted", "pivot_tie"):
        assert np.abs(t_out["rel_pose"].numpy() - c["T"][0]).max() > 1e-5
    if name == "pivot_tie":
        col = np.abs((c["info"][0] + c["info"][1])[:, 0])
        assert col[2] == col[4] == col.max() and (col == col.max()).sum() == 2
        assert np.all(np.linalg.eigvalsh(c["info"].astype(np.float64)) > 0)


def test_kernel_source_scan_step_layout_matches_python():
    """The packed row, carry slot and level-row offsets csrc/keyframe_scan.cu
    writes and reads are the ones ops/scan_step.py and ops/linearize.py
    lay out, and the device-table route's code in csrc/linearize.cu is the
    wrapper's."""
    from test_torch_sampler import _source_constants

    src = Path(t_linearize.__file__).parents[1] / "csrc"
    layout = {f.name: f.offset
              for f in scan_step.output_layout(3, 7, with_stats=True)}
    names = {"kOutRelPose": "rel_pose", "kOutSwitch": "switch",
             "kOutZSwitch": "Z_switch", "kOutInfoSwitch": "info_switch",
             "kOutEntropy": "entropy", "kOutEntropyRatio": "entropy_ratio",
             "kOutAccept": "accept", "kOutValidRatio": "valid_ratio",
             "kOutTKfMeas": "T_kf_meas", "kOutTOdoMeas": "T_odo_meas",
             "kOutInfoPair": "info_pair", "kOutIsNan": "is_nan",
             "kOutIterations": "iterations"}
    got = _source_constants(src / "keyframe_scan.cu", list(names))
    assert got == {k: layout[v] for k, v in names.items()}
    # The stats follow the iterations (2 L), plane after plane.
    L, M = 3, 7
    at = layout["iterations"] + 2 * L
    for i, f in enumerate(scan_step.STAT_FIELDS):
        assert layout[f] == at + i * 2 * L * M
    state = _source_constants(src / "keyframe_scan.cu", [
        "kStateTKfPrev", "kStateOdoInit", "kStateLastOdo", "kStateHFirst",
        "kStateHasFirst", "kStateSize"])
    S = scan_step
    assert list(state.values()) == [
        S._STATE_T_KF_PREV, S._STATE_ODO_INIT, S._STATE_LAST_ODO,
        S._STATE_H_FIRST, S._STATE_HAS_FIRST, S.STATE_SIZE]
    assert _source_constants(src / "keyframe_scan.cu", [
        "kTimingSlots"]) == {"kTimingSlots": S._TIMING_SLOTS}
    slots = [i for pair in S._PHASE_SLOTS.values() for i in pair]
    assert max(slots + [S._CLOCK_END]) < S._TIMING_SLOTS
    level = _source_constants(src / "keyframe_scan.cu", [
        "kLevelT", "kLevelLoglik", "kLevelBest", "kLevelStats",
        "kStatPlanes", "kExtraEntropy", "kExtraRatio", "kExtraSize",
        "kMaxLevels", "kEntropyFloor"])
    Lo = t_linearize
    assert list(level.values()) == [
        Lo._LEVEL_T, Lo._LEVEL_LOGLIK, Lo._LEVEL_BEST, Lo._LEVEL_STATS,
        Lo._STAT_PLANES, Lo._EXTRA_ENTROPY, Lo._EXTRA_RATIO, Lo._EXTRA_SIZE,
        t_pyramid._MAX_LEVELS, t_dense_tracker._ENTROPY_DENOM_FLOOR]
    assert t_dense_tracker._A == 0  # the record's information comes first
    table = _source_constants(src / "linearize.cu", [
        "kTableStride", "kTableParams", "kTableDevice"])
    assert list(table.values()) == [Lo._TABLE_STRIDE, Lo._TABLE_PARAMS,
                                    Lo._TABLE_DEVICE]


def test_step_phase_times():
    """The step kernel's phase split from its stamps: clock64 spans
    converted by the launch's %globaltimer span over its clock64 span, a
    name a span in the kernel's order, "copies" from the start to warp
    1's end."""
    rng = np.random.default_rng(3)
    buf = np.zeros(scan_step._TIMING_SLOTS, np.int64)
    # Clocks 2..10 in order, warp 1's end [11] between the start and the
    # end.
    steps = rng.integers(10, 1000, size=8)
    buf[2] = 10**9
    buf[3:11] = buf[2] + np.cumsum(steps)
    buf[11] = buf[2] + 123
    buf[12] = buf[10] + 40
    # 2 clocks a nanosecond: the globaltimer span is half the clock span.
    buf[0] = 5000
    buf[1] = buf[0] + (buf[12] - buf[2]) // 2
    phases, span = scan_step.phase_times(buf)
    assert list(phases) == ["before the wait", "loads", "finite checks",
                            "T_alt", "log", "elimination", "exp",
                            "decided writes", "copies"]
    ns = (buf[1] - buf[0]) / (buf[12] - buf[2])
    np.testing.assert_allclose([phases[k] for k in list(phases)[:8]],
                               steps * ns / 1e3, rtol=1e-12)
    assert phases["copies"] == pytest.approx(123 * ns / 1e3)
    assert span == (buf[1] - buf[0]) / 1e3


@pytest.mark.parametrize("with_stats", [False, True])
def test_packed_outputs_round_trip(with_stats):
    """pack -> field_views gives back every field in its dtype as views of
    the packed buffer, and host_arrays the same numpy arrays (booleans and
    integers as int32 bits)."""
    L, M, n = 3, 5, 4
    layout = scan_step.output_layout(L, M, with_stats)
    g = torch.Generator().manual_seed(1)
    outs = {}
    for f in layout:
        shape = (n, *f.shape)
        if f.kind == scan_step.F32:
            x = torch.randn(shape, generator=g)
        elif f.kind == scan_step.I32:
            x = torch.randint(-3, 60, shape, generator=g, dtype=torch.int32)
        else:
            x = torch.rand(shape, generator=g) < 0.5
        outs[f.name] = x
    stats = tuple(outs.pop(f) for f in scan_step.STAT_FIELDS if f in outs)
    if stats:
        outs["stats"] = stats
    packed = scan_step.pack(outs, layout)
    assert packed.shape == (n, scan_step.row_width(layout))
    views = scan_step.field_views(packed, layout)
    assert sorted(views) == sorted(outs)
    host = scan_step.host_arrays(packed.numpy(), layout)
    flat = [outs[k] for k in scan_step.FIELDS] + list(stats)
    for f, want, got, arr in zip(layout, flat, [views[k] for k in
                                                scan_step.FIELDS]
                                 + list(views.get("stats", ())), host):
        assert got.dtype == want.dtype and torch.equal(got, want), f.name
        assert got.untyped_storage().data_ptr() == \
            packed.untyped_storage().data_ptr(), f.name
        np.testing.assert_array_equal(arr, want.numpy(), err_msg=f.name)
        assert arr.dtype == want.numpy().dtype, f.name


def test_pending_keyframe_resolves_in_chunk_order():
    """A kernel route carry's keyframe: the chunk's last switch, else the
    keyframe before it (resolved first); it holds every candidate until
    then and drops them after."""
    a, b = (torch.zeros(1),), (torch.ones(1),)
    frames1 = [(torch.full((1,), 2.0),), (torch.full((1,), 3.0),)]
    frames2 = [(torch.full((1,), 4.0),)]
    p1 = t_keyframe_scan.PendingKeyframe(a, frames1)
    p2 = t_keyframe_scan.PendingKeyframe(p1, frames2)
    assert p2.candidates() == [a, *frames1, *frames2]
    with pytest.raises(RuntimeError):
        p2.resolve([False])
    assert p1.resolve([True, False]) is frames1[0]
    assert p1.frames is None and p1.candidates() == [frames1[0]]
    assert p2.resolve([False]) is frames1[0]
    assert p2.before is None and p2.frames is None
    assert t_keyframe_scan.PendingKeyframe(b, frames2).resolve([True]) \
        is frames2[0]


# The kernel route on the CPU: the kernels stood in for (the pyramid
# into its slot, the level launches by the host loop packed in mode (b)'s
# layout, the scan step by its plain version on the same buffers), counted.
def stand_in_kernel_route(monkeypatch):
    """Route chunks on the CPU through ``_track_chunk_kernels`` with the
    kernels stood in for; returns the launch counts by kernel."""
    from test_torch_front import _stand_in_level_kernels

    counts = {"pyramid": 0, "track_level": 0, "scan_step": 0}

    def pyramid_kernel(intensity, depth, num_levels, timing=None, out=None):
        counts["pyramid"] += 1
        levels = t_pyramid.build_pyramid_reference(intensity, depth,
                                                   num_levels)
        if out is None:
            return levels
        views, at = [], 0
        for lvl in levels:
            out[at:at + lvl.numel()] = lvl.reshape(-1)
            views.append(out[at:at + lvl.numel()].view(lvl.shape))
            at += lvl.numel()
        assert at == out.numel()
        return tuple(views)

    def level_kernels(*args, **kwargs):
        counts["track_level"] += 1
        return _stand_in_level_kernels(*args, **kwargs)

    step = scan_step.scan_step

    def step_counted(*args, **kwargs):
        counts["scan_step"] += 1
        return step(*args, **kwargs)

    monkeypatch.setattr(t_dense_tracker, "front_route",
                        lambda cfg, device, pixel_group=None: True)
    monkeypatch.setattr(t_pyramid, "build_pyramid_kernel", pyramid_kernel)
    monkeypatch.setattr(t_pyramid, "build_pyramid",
                        lambda i, z, n: pyramid_kernel(i, z, n))
    monkeypatch.setattr(t_linearize, "track_level_kernels", level_kernels)
    monkeypatch.setattr(scan_step, "scan_step", step_counted)
    return counts


def _nan_equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.nan_to_num(-7.0) if a.is_floating_point() else a,
        b.nan_to_num(-7.0) if b.is_floating_point() else b)


@pytest.mark.parametrize("budget", [0.0, 0.5], ids=["full", "budget"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_kernel_route_chunks_match_the_step_route(forced_run, monkeypatch,
                                                  with_stats, budget):
    """The kernel route's chunks (five launches a frame, the outputs views
    of one packed buffer, the keyframe carried as a pointer table and a
    PendingKeyframe) against the per-frame route's _step loop on the same
    frames, split at the same boundaries, on the full grid and at a point
    budget: every output equal, and the carry's pose and entropy state
    after every chunk."""
    seq_i, seq_z, _, force, _ = forced_run
    cfg = dataclasses.replace(T_TRACKER, collect_stats=True,
                              point_budget_fraction=budget)
    K = t_camera.intrinsics(*K_TUPLE, device="cpu")
    ti, tz = torch.as_tensor(seq_i), torch.as_tensor(seq_z)
    f = torch.as_tensor(force)
    runs = []
    for kernels in (False, True):
        if kernels:
            counts = stand_in_kernel_route(monkeypatch)
        carry = t_keyframe_scan.init_carry(t_keyframe_scan.pyramid_from_stack(
            ti, tz, 0, cfg.num_levels))
        parts, carries = [], []
        for a, b in ((1, 3), (3, 4), (4, 10)):
            carry, outs = t_keyframe_scan.track_keyframe_chunk(
                carry, ti[a:b], tz[a:b], K, cfg, T_SLAM,
                force_keyframe=f[a:b], with_stats=with_stats)
            parts.append(outs)
            carries.append(carry)
        runs.append((parts, carries))
    assert counts == {"pyramid": 10, "track_level": 9 * 2, "scan_step": 9}
    (want, want_c), (got, got_c) = runs
    for p_w, p_g in zip(want, got):
        assert sorted(p_g) == sorted(p_w)
        for key in p_w:
            pairs = (zip(p_w[key], p_g[key]) if key == "stats"
                     else [(p_w[key], p_g[key])])
            for x, y in pairs:
                assert _nan_equal(x, y), key
    assert bool(torch.cat([p["switch"] for p in got]).any())
    for c_w, c_g in zip(want_c, got_c):
        assert isinstance(c_g["kf"], t_keyframe_scan.PendingKeyframe)
        for key in ("T_kf_prev", "last_odo", "H_first", "has_first"):
            assert _nan_equal(c_w[key], c_g[key]), key
        for a, b in zip(c_w["prev"], c_g["prev"]):
            assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))
    # Resolved in chunk order, each carry's keyframe is the step route's.
    for c_w, c_g, p in zip(want_c, got_c, got):
        kf = c_g["kf"].resolve(p["switch"].numpy())
        for a, b in zip(c_w["kf"], kf):
            assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))

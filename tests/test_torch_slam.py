"""The port's KeyframeSlam against the JAX package's, end to end.

tests/test_slam.py's 14-frame orbit (64x48, two levels, a forced keyframe
every second frame, loop closure on) runs through both packages once per
module. Discrete structure is asserted exactly, as tests/cross_run.py
does across runs: keyframe indices, the graph's edge list with each
edge's mask (accepted loop edges and pruned outliers), the loop-edge
count. Poses: per-frame returns and the final trajectory within 1e-4 (the
cross-run tolerance; f32 tracking and solves with sums in another order).

So that a sequence near a decision boundary fails loudly instead of at
random, the JAX run is instrumented: no entropy ratio, valid ratio or
voted quantity may lie within 1e-3 of its threshold (relative 1e-3 for the
outlier-pruning chi2 test).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.models import constraints, dense_tracker
from dvo_slam_tpu.models.keyframe_tracker import KeyframeSlam
from dvo_slam_tpu.utils import evaluate, se3_np, synthetic
from dvo_slam_tpu_torch import KeyframeSlam as TKeyframeSlam
from dvo_slam_tpu_torch import convert

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
TRACKER = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=30)
SLAM = SlamConfig(max_keyframes=32, max_edges=128, min_constraint_distance=3,
                  coarse_first_level=1, coarse_last_level=1,
                  validation_batch=4)
MARGIN = 1e-3
TRAJ_ATOL = 1e-4


def _port_cfgs(slam_cfg):
    return (convert.tracker_config_from_fields(dataclasses.asdict(TRACKER)),
            convert.slam_config_from_fields(dataclasses.asdict(slam_cfg)))


def _frames(n, radius):
    poses = synthetic.orbit_trajectory(n, radius=radius)
    return synthetic.render_sequence(synthetic.two_plane_scene(),
                                     np.asarray(K_TUPLE), W, H, poses), poses


def _every_second(i):
    return i > 0 and i % 2 == 0


def _every(i):
    return i > 0


def _drive(slam, frames, poses, force):
    slam.init(poses[0])
    out = []
    for i, (intensity, depth) in enumerate(frames):
        if force(i):
            slam.force_keyframe()
        out.append(slam.update(intensity, depth, float(i) / 30.0))
    return out, [T for _, T in slam.finish()]


def _edges(slam):
    g = slam.graph
    return [(int(g.edge_i[e]), int(g.edge_j[e]), bool(g.edge_mask[e]))
            for e in range(int(g.num_edges))]


class _Margins:
    """Records how close each decision of the JAX run came to its
    threshold."""

    def __init__(self):
        self.seen = []  # (what, value, threshold)

    def check(self, what, value, threshold):
        self.seen.append((what, float(value), float(threshold)))

    def near(self):
        return [s for s in self.seen
                if np.isfinite(s[1]) and abs(s[1] - s[2]) < MARGIN * (
                    max(1.0, abs(s[2])) if s[0] == "chi2" else 1.0)]


def _instrument(mp, margins, slam_cfg, running):
    """Watch the decisions that steer a JAX KeyframeSlam run: those whose
    outcome is used (a forced switch ignores the entropy ratio; a voter
    after the first rejection is not consulted)."""
    ratio = dense_tracker.entropy_ratio

    def entropy_ratio(h_cur, h_ref):
        r = ratio(h_cur, h_ref)
        # The keyframe decision in update() (the voters' ratios are
        # watched below, against their own thresholds).
        if (sys._getframe(1).f_code.co_name == "update"
                and not running[0]._force_next):
            margins.check("entropy ratio", r, slam_cfg.min_entropy_ratio)
        return r

    mp.setattr(dense_tracker, "entropy_ratio", entropy_ratio)
    vote = constraints.vote_validation

    def vote_validation(chunks, results, entropies, cfg, wmiss=0.02):
        for chunk, r in zip(chunks, results):
            for k, c in enumerate(chunk):
                if bool(r["fwd_nan"][k]) or bool(r["bwd_nan"][k]):
                    continue
                T_f = np.asarray(r["fwd_T"][k], np.float64)
                T_b = np.asarray(r["bwd_T"][k], np.float64)
                T_fine = np.asarray(r["fine_T"][k], np.float64)
                den = entropies[c.keyframe_idx]
                for what, v, t in (
                    ("cross", np.linalg.norm(se3_np.log(T_f @ T_b)),
                     cfg.cross_validation_threshold),
                    ("coarse ratio", constraints._entropy_ratio(
                        float(r["fwd_H"][k]), den),
                     cfg.min_entropy_ratio_coarse),
                    ("coarse vr", r["fwd_vr"][k], cfg.min_constraint_ratio),
                    ("odometry", np.linalg.norm(se3_np.log(
                        T_f @ se3_np.inverse(c.T_init))),
                     cfg.odometry_constraint_threshold),
                    ("fine ratio", constraints._entropy_ratio(
                        float(r["fine_H"][k]), den),
                     cfg.min_entropy_ratio_fine),
                    ("fine vr", r["fine_vr"][k], cfg.min_constraint_ratio),
                    ("fine odometry", np.linalg.norm(se3_np.log(
                        T_fine @ se3_np.inverse(c.T_init))),
                     cfg.odometry_constraint_threshold),
                    ("fine step", np.linalg.norm(se3_np.log(
                        T_fine @ se3_np.inverse(T_f))),
                     cfg.cross_validation_threshold),
                ):
                    if what == "fine ratio" and bool(r["fine_nan"][k]):
                        break
                    margins.check(what, v, t)
                    # Ratios pass at or above their threshold, the rest at
                    # or below: stop at the first voter that rejects.
                    at_least = "ratio" in what or " vr" in what
                    if (v < t) if at_least else (v > t):
                        break
        return vote(chunks, results, entropies, cfg, wmiss)

    mp.setattr(constraints, "vote_validation", vote_validation)
    mask = KeyframeSlam._mask_outlier_edges

    def mask_outlier_edges(self):
        g = self.graph
        ne = int(g.num_edges)
        ei, ej = g.edge_i[:ne].astype(np.int64), g.edge_j[:ne].astype(np.int64)
        idx = np.nonzero(g.edge_mask[:ne] & (np.abs(ej - ei) != 1))[0]
        if idx.size:
            poses = np.asarray(g.poses, np.float64)
            Z = np.asarray(g.measurements[idx], np.float64)
            r = se3_np.log_batch(se3_np.inverse_batch(Z)
                                 @ se3_np.inverse_batch(poses[ei[idx]])
                                 @ poses[ej[idx]])
            info = np.asarray(g.information[idx], np.float64)
            chi = np.einsum("ei,eij,ej->e", r, info, r)
            factor = (1.0 / slam_cfg.outlier_weight_threshold - 1.0) ** 2
            order = np.sort(chi)
            others = (np.where(chi == order[0], order[1], order[0])
                      if idx.size >= 2 else np.zeros_like(chi))
            for c, o in zip(chi, others):
                margins.check("chi2", c,
                              factor * max(slam_cfg.cauchy_c ** 2, o))
        return mask(self)

    mp.setattr(KeyframeSlam, "_mask_outlier_edges", mask_outlier_edges)


def _jax_run(slam_cfg, frames, poses, force, **kw):
    margins = _Margins()
    with pytest.MonkeyPatch.context() as mp:
        slam = KeyframeSlam(K_TUPLE, TRACKER, slam_cfg, **kw)
        _instrument(mp, margins, slam_cfg, [slam])
        per_frame, traj = _drive(slam, frames, poses, force)
    assert not margins.near(), (
        f"the JAX run decides within {MARGIN} of a threshold: "
        f"{margins.near()}")
    return slam, per_frame, traj, margins


@pytest.fixture(scope="module")
def orbit():
    frames, poses = _frames(14, 0.06)
    jax_side = _jax_run(SLAM, frames, poses, _every_second,
                        enable_loop_closure=True)
    port = TKeyframeSlam(K_TUPLE, *_port_cfgs(SLAM), enable_loop_closure=True,
                         device="cpu")
    port_side = (port, *_drive(port, frames, poses, _every_second))
    return jax_side, port_side, poses


def test_slam_orbit_like_jax(orbit):
    (j_slam, j_frames, j_traj, margins), (t_slam, t_frames, t_traj), gt = orbit
    assert len(margins.seen) > 20  # the decisions were really watched
    assert ([k.idx for k in t_slam.keyframes]
            == [k.idx for k in j_slam.keyframes])
    assert ([f.keyframe_idx for f in t_slam.frames]
            == [f.keyframe_idx for f in j_slam.frames])
    assert _edges(t_slam) == _edges(j_slam)
    assert t_slam.num_loop_edges == j_slam.num_loop_edges >= 1
    for a, b in zip(t_frames, j_frames):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)
    assert len(t_traj) == len(j_traj) == 14
    for a, b in zip(t_traj, j_traj):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)
    ate = evaluate.ate_rmse(t_traj, gt)
    assert ate < 5e-3, f"port SLAM ATE {ate * 1e3:.3f} mm"
    assert int(t_slam.graph.num_edges) >= len(t_slam.keyframes) - 1


def test_slam_state_after_finish(orbit):
    (j_slam, *_), (t_slam, *_), _ = orbit
    assert not t_slam._poses_stale and t_slam._pending_validation is None
    assert t_slam._pending_window is None
    np.testing.assert_allclose(t_slam.graph.poses, j_slam.graph.poses,
                               atol=TRAJ_ATOL)
    np.testing.assert_allclose(np.stack(t_slam.kf_poses),
                               np.stack(j_slam.kf_poses), atol=TRAJ_ATOL)
    assert t_slam.validation_cache_stats == j_slam.validation_cache_stats


def test_reset_restarts_tracking_like_jax():
    frames, poses = _frames(6, 0.04)
    anchor = np.eye(4)
    anchor[:3, 3] = [1.0, 2.0, 3.0]
    outs = []
    for slam in (KeyframeSlam(K_TUPLE, TRACKER, SLAM,
                              enable_loop_closure=False),
                 TKeyframeSlam(K_TUPLE, *_port_cfgs(SLAM),
                               enable_loop_closure=False, device="cpu")):
        slam.init(poses[0])
        for i in range(3):
            slam.update(frames[i][0], frames[i][1], i / 30.0)
        n_kf = len(slam.keyframes)
        slam.reset(anchor)
        out = slam.update(frames[3][0], frames[3][1], 0.1)
        np.testing.assert_allclose(out, anchor, atol=1e-9)
        assert len(slam.keyframes) == n_kf + 1
        out2 = slam.update(frames[4][0], frames[4][1], 0.133)
        assert np.linalg.norm(out2[:3, 3] - anchor[:3, 3]) < 0.05
        traj = dict(slam.trajectory())
        np.testing.assert_allclose(traj[0.1], anchor, atol=1e-9)
        outs.append((out2, [T for _, T in slam.trajectory()]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=TRAJ_ATOL)
    for a, b in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)


def test_eviction_and_growth_like_jax():
    """Tiny capacities and two resident keyframes: the graph grows, old
    pyramids spill to host numpy (finalized at the next drain) and still
    serve loop-closure validation; the run stays the JAX package's.

    tests/test_slam.py runs this at radius 0.06, where one outlier-pruning
    chi2 lands 7e-4 (relative) from its threshold; radius 0.05 keeps every
    decision clear of its threshold."""
    tiny = dataclasses.replace(SLAM, max_keyframes=3, max_edges=3,
                               resident_keyframes=2)
    frames, poses = _frames(12, 0.05)
    j_slam, _, j_traj, _ = _jax_run(tiny, frames, poses, _every,
                                    enable_loop_closure=True)
    t_slam = TKeyframeSlam(K_TUPLE, *_port_cfgs(tiny),
                           enable_loop_closure=True, device="cpu")
    in_flight = []

    def force(i):
        if i == 6:
            # The latest spill is in flight: flagged, still tensors.
            in_flight.extend(t_slam._pending_evictions)
            assert in_flight and all(isinstance(k.pyramid[0], torch.Tensor)
                                     and k.spill is not None
                                     for k in in_flight)
        return _every(i)

    _, t_traj = _drive(t_slam, frames, poses, force)
    assert not t_slam._pending_evictions
    assert all(k.spill is None for k in in_flight)
    assert len(t_slam.keyframes) == 12 and t_slam.graph.poses.shape[0] >= 12
    resident = [k for k in t_slam.keyframes if k.resident]
    assert len(resident) <= tiny.resident_keyframes
    evicted = [k for k in t_slam.keyframes if not k.resident]
    assert evicted and all(isinstance(k.pyramid[0], np.ndarray)
                           for k in evicted)
    assert t_slam.num_loop_edges == j_slam.num_loop_edges >= 1
    assert _edges(t_slam) == _edges(j_slam)
    assert t_slam.validation_cache_stats == j_slam.validation_cache_stats
    assert t_slam.validation_cache_stats["hits"] > 0
    for a, b in zip(t_traj, j_traj):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)
    assert evaluate.ate_rmse(t_traj, poses) < 5e-3


def test_unported_options_raise(tmp_path):
    """What the port does not run raises instead of running something
    else: an engine that does not match the checkpoint (a per-frame
    checkpoint loaded as chunked, and a chunked one loaded per frame)."""
    from dvo_slam_tpu_torch.utils import checkpoint

    slam = TKeyframeSlam(K_TUPLE, *_port_cfgs(SLAM), device="cpu")
    slam.init()
    path = str(tmp_path / "state.npz")
    checkpoint.save_slam(path, slam)
    with pytest.raises(ValueError, match="per-frame"):
        checkpoint.load_slam(path, K_TUPLE, *_port_cfgs(SLAM), chunked=True,
                             device="cpu")
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam

    chunked = ChunkedKeyframeSlam(K_TUPLE, *_port_cfgs(SLAM), device="cpu")
    chunked.init()
    path = str(tmp_path / "chunked.npz")
    checkpoint.save_slam(path, chunked)
    with pytest.raises(ValueError, match="chunked"):
        checkpoint.load_slam(path, K_TUPLE, *_port_cfgs(SLAM), device="cpu")


def test_budget_config_converts():
    """point_budget_fraction > 0 runs in the port: a JAX TrackerConfig
    with a budget converts with it, and the port's tracker takes it."""
    cfg = convert.tracker_config_from_fields(dataclasses.asdict(
        dataclasses.replace(TRACKER, point_budget_fraction=0.5)))
    assert cfg.point_budget_fraction == 0.5
    assert dataclasses.replace(cfg, point_budget_fraction=0.0) == \
        _port_cfgs(SLAM)[0]
    slam = TKeyframeSlam(K_TUPLE, cfg, _port_cfgs(SLAM)[1], device="cpu")
    frames, poses = _frames(2, 0.06)
    _drive(slam, frames, poses, lambda i: False)
    assert slam.tracker_cfg.point_budget_fraction == 0.5

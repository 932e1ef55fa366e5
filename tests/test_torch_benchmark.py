"""The port's offline benchmark harness against the JAX package's.

- ``run_synthetic`` and ``run_tum_dataset`` in the three modes: equal
  frame, keyframe and loop-edge counts; trajectories, ATE and translational
  RPE within 1e-4 m; rotational RPE within 1e-3 rad. (RPE's angle is
  arccos((tr R - 1) / 2), whose slope is infinite at 0: the ~1e-7
  orthonormality error of an f32 rotation moves a sub-milliradian angle by
  up to ~sqrt(2e-7) = 4.5e-4 rad, and one package read 0.0 where the other
  read 3.0e-4 on the same 1e-5 m trajectories.) Each JAX run is watched as
  tests/test_torch_slam.py watches it: no keyframe or loop-closure decision
  may lie within 1e-3 of its threshold.
- The frame logger: the JAX package's records for tests/test_torch_slam.py's
  orbit, behind the same watch; the same keys, each frame's discrete
  fields exactly and its floats within 1e-4 relative. The per-iteration
  traces are the IRLS path, which f32 rounding steers where the path is
  degenerate: at an identity start every point samples a pixel centre, and
  the last bit of the warp decides whether a NaN neighbour enters the
  bilinear footprint (first valid counts 709 against 702); at convergence
  an evaluation within rounding of the best is accepted by one package and
  rolled back by the other (5 iterations against 6, or the same count
  ending on a small step in one and a rollback in the other). So per level
  the iteration counts agree within one; each termination code agrees with
  its own trace (a rollback ends on a rejected evaluation) and with the
  other package's, except that the two ways of stopping at the optimum
  (small step, rollback) may trade places; and the final evaluation is
  held: its valid count exactly, its error within 1e-4 relative.
- Covariance and .g2o exports.

tests/test_torch_cli.py holds the CLI and the on-disk accuracy gates.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dvo_slam_tpu import benchmark
from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.utils import g2o_io, stats, synthetic, tum
from dvo_slam_tpu_torch import KeyframeSlam as TKeyframeSlam
from dvo_slam_tpu_torch import benchmark as t_benchmark
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.utils import stats as t_stats
from dvo_slam_tpu_torch.utils import synthetic as t_synthetic
from test_torch_slam import _drive, _every_second, _jax_run, _Margins
from test_torch_slam import _instrument

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
TRACKER = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=30)
SLAM = SlamConfig(max_keyframes=32, max_edges=128, min_constraint_distance=3,
                  coarse_first_level=1, coarse_last_level=1,
                  validation_batch=4, min_entropy_ratio=2.0)
# min_entropy_ratio 2.0 switches keyframes at every frame: the small orbits
# below then hold many keyframes and loop-closure decisions.
MODES = ("slam", "keyframe", "odometry")
ATOL = 1e-4  # m
RPE_ROT_ATOL = 1e-3  # rad


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread each
    (more spin on the cores the test workers share), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(slam_cfg=SLAM, tracker_cfg=TRACKER):
    return (convert.tracker_config_from_fields(dataclasses.asdict(tracker_cfg)),
            convert.slam_config_from_fields(dataclasses.asdict(slam_cfg)))


class _NotForced:
    _force_next = False


def _watched(fn, slam_cfg=SLAM):
    """fn() with the JAX package's decisions watched (the warm-up's
    forced switches count too: a stricter watch)."""
    margins = _Margins()
    with pytest.MonkeyPatch.context() as mp:
        _instrument(mp, margins, slam_cfg, [_NotForced()])
        out = fn()
    assert not margins.near(), margins.near()
    return out


def _assert_result_like(got, want):
    assert got.num_frames == want.num_frames
    assert got.num_keyframes == want.num_keyframes
    assert got.num_loop_edges == want.num_loop_edges
    for field, atol in (("ate_rmse_m", ATOL), ("rpe_trans_m", ATOL),
                        ("rpe_rot_rad", RPE_ROT_ATOL)):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=field)
    assert got.fps > 0 and got.elapsed_s > 0
    assert set(json.loads(got.to_json())) == set(json.loads(want.to_json()))


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    """A 16-frame 64x48 orbit on disk (the port's writer: 8-bit intensity,
    0.2 mm depth steps), two laps of a loop. Without sensor noise: on
    noisy frames each package's f32 optimum wanders by ~1e-5 per frame,
    and a keyframe chain sums that past 1e-4."""
    poses = synthetic.orbit_trajectory(16, radius=0.08, yaw_amplitude=0.3,
                                       cycles=2.0)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(K_TUPLE), W, H, poses)
    d = str(tmp_path_factory.mktemp("seq"))
    t_synthetic.write_tum_dataset(d, frames, poses)
    return d


@pytest.mark.parametrize("mode", MODES)
def test_run_synthetic_like_jax(mode):
    kw = dict(num_frames=8, width=W, height=H, tracker_cfg=TRACKER,
              slam_cfg=SLAM, mode=mode)
    want = _watched(lambda: benchmark.run_synthetic(**kw))
    got = t_benchmark.run_synthetic(**{**kw, "tracker_cfg": _cfgs()[0],
                                       "slam_cfg": _cfgs()[1]},
                                    device="cpu")
    _assert_result_like(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_run_tum_dataset_like_jax(seq_dir, tmp_path, mode):
    want_traj, got_traj = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    want = _watched(lambda: benchmark.run_tum_dataset(
        seq_dir, TRACKER, SLAM, mode=mode, intrinsics=K_TUPLE,
        trajectory_out=want_traj))
    got = t_benchmark.run_tum_dataset(seq_dir, *_cfgs(), mode=mode,
                                      intrinsics=K_TUPLE,
                                      trajectory_out=got_traj, device="cpu")
    _assert_result_like(got, want)
    if mode == "slam":
        assert got.num_keyframes >= 3 and got.num_loop_edges >= 1
    a, b = tum.read_trajectory(got_traj), tum.read_trajectory(want_traj)
    assert [t for t, _ in a] == [t for t, _ in b] and len(a) == 16
    for (_, Ta), (_, Tb) in zip(a, b):
        np.testing.assert_allclose(Ta, Tb, atol=ATOL)


FLOAT_FIELDS = ("t", "entropy", "entropy_ratio", "valid_ratio",
                "window_miss_frac")
TERMINATIONS = {0, 1, 2, 3}  # iterations, increment, rollback, too few
ROLLBACK = 2
CONVERGED = {1, 2}  # the two ways an IRLS loop stops at its optimum


def test_frame_logger_like_jax():
    poses = synthetic.orbit_trajectory(14, radius=0.06)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(K_TUPLE), W, H, poses)
    slam_cfg = dataclasses.replace(SLAM, min_entropy_ratio=0.9)
    want_log = stats.FrameLogger()
    _jax_run(slam_cfg, frames, poses, _every_second,
             enable_loop_closure=True, frame_logger=want_log)
    got_log = t_stats.FrameLogger()
    port = TKeyframeSlam(K_TUPLE, *_cfgs(slam_cfg), enable_loop_closure=True,
                         frame_logger=got_log, device="cpu")
    _drive(port, frames, poses, _every_second)
    got, want = got_log.records, want_log.records
    assert len(got) == len(want) == 13
    assert sum(r["keyframe_switch"] for r in got) >= 6
    for a, b in zip(got, want):
        assert set(a) == set(b)
        json.dumps(a)
        for key in set(b) - {"kf_track", "odo_track"}:
            if key in FLOAT_FIELDS:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                           err_msg=key)
            else:
                assert a[key] == b[key], key
        for row in ("kf_track", "odo_track"):
            assert len(a[row]) == len(b[row]) == 2
            for la, lb in zip(a[row], b[row]):
                assert set(la) == set(lb)
                assert abs(la["iterations"] - lb["iterations"]) <= 1
                for lv in (la, lb):
                    # Pure Gauss-Newton: a rollback stop, and only that,
                    # ends on a rejected evaluation.
                    assert lv["termination"] in TERMINATIONS
                    assert ((lv["termination"] == ROLLBACK)
                            == (not lv["accepted"][-1])), row
                if la["termination"] != lb["termination"]:
                    assert {la["termination"], lb["termination"]} == \
                        CONVERGED, row
                for key in ("valid", "error", "delta_norm", "accepted"):
                    assert len(la[key]) == la["iterations"], key
                assert la["valid"][-1] == lb["valid"][-1], row
                np.testing.assert_allclose(la["error"][-1], lb["error"][-1],
                                           rtol=1e-4)


def _covariances(path):
    rows = [line.split() for line in open(path)]
    assert all(len(r) == 37 for r in rows)  # timestamp + 6x6
    return [float(r[0]) for r in rows], np.asarray(
        [[float(v) for v in r[1:]] for r in rows]).reshape(-1, 6, 6)


def test_covariance_and_graph_exports(seq_dir, tmp_path):
    cfgs = _cfgs()
    cov, graph = str(tmp_path / "cov.txt"), str(tmp_path / "graph.g2o")
    res = t_benchmark.run_tum_dataset(
        seq_dir, *cfgs, mode="keyframe", intrinsics=K_TUPLE, device="cpu",
        max_frames=6, covariance_out=cov, graph_out=graph)
    stamps, c = _covariances(cov)
    assert len(stamps) == 6 == res.num_frames
    np.testing.assert_allclose(c[0], 0.0)  # the anchor keyframe
    for k in range(1, 6):
        assert np.isfinite(c[k]).all()
        np.testing.assert_allclose(c[k], c[k].transpose(), rtol=1e-6,
                                   atol=1e-12)
        assert (np.linalg.eigvalsh(c[k]) > 0).all()
    g = g2o_io.load_g2o(graph)  # the JAX loader reads the port's file
    assert int(g.num_vertices) == res.num_keyframes == 6
    assert int(g.num_edges) >= res.num_keyframes - 1
    # Odometry covariances against the JAX package's.
    want_cov = str(tmp_path / "want.txt")
    benchmark.run_tum_dataset(seq_dir, TRACKER, SLAM, mode="odometry",
                              intrinsics=K_TUPLE, max_frames=6,
                              covariance_out=want_cov)
    t_benchmark.run_tum_dataset(seq_dir, *_cfgs(), mode="odometry",
                                intrinsics=K_TUPLE, max_frames=6,
                                covariance_out=cov, device="cpu")
    (sa, ca), (sb, cb) = _covariances(cov), _covariances(want_cov)
    assert sa == sb
    np.testing.assert_allclose(ca, cb, rtol=1e-3,
                               atol=1e-3 * np.abs(cb).max())


def test_stats_like_jax(tmp_path):
    """Stopwatch sections (waiting for the tensors registered on the
    handle), the torch.profiler trace, and the FrameLogger's jsonl: the
    same bytes as the JAX package's logger for the same records."""
    watch = t_stats.Stopwatch()
    with watch.section("a"):
        sum(range(1000))
    with watch.section("a") as sec:
        y = sec.block_on({"x": [torch.ones(4) * 2]})
    assert y["x"][0].sum().item() == 8.0
    summary = watch.summary()
    assert summary["a"]["count"] == 2
    theirs = stats.Stopwatch()
    with theirs.section("a"):
        pass
    assert set(summary["a"]) == set(theirs.summary()["a"])
    assert "a" in watch.report()

    with t_stats.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert json.load(open(tmp_path / "trace" / "trace.json"))

    records = [dict(frame=1, entropy=-54.2, iters=np.asarray([3, 4]),
                    accepted=True),
               dict(frame=2, kf_track=[{"valid": [1.0, 2.5]}])]
    for logger_cls, name in ((t_stats.FrameLogger, "ours"),
                             (stats.FrameLogger, "theirs")):
        logger = logger_cls(str(tmp_path / f"{name}.jsonl"))
        for rec in records:
            logger.log(**rec)
        logger.close()
    assert ((tmp_path / "ours.jsonl").read_text()
            == (tmp_path / "theirs.jsonl").read_text())
    assert json.loads((tmp_path / "ours.jsonl").read_text().splitlines()[0]
                      )["iters"] == [3, 4]

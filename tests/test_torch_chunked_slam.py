"""The port's chunked streaming SLAM against the JAX package's.

Counterparts of tests/test_chunked_slam.py on its 12-frame 64x48 orbit and
configs. The JAX ChunkedKeyframeSlam runs once per scenario (module
fixtures); the port's runs on the CPU (the plain versions of the
kernels). Keyframes, the graph's edge list and the loop-edge count are
compared exactly; poses within TRAJ_ATOL (tests/test_torch_slam.py's
tolerance), as are two runs of the port that must agree (chunk
boundaries, pipelining, checkpoint resume), as tests/cross_run.py does for
the JAX package.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.models.chunked_slam import ChunkedKeyframeSlam
from dvo_slam_tpu.utils import checkpoint, evaluate, synthetic
from dvo_slam_tpu.utils.stats import FrameLogger
from dvo_slam_tpu_torch import KeyframeSlam as TKeyframeSlam
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models.chunked_slam import (
    ChunkedKeyframeSlam as TChunkedKeyframeSlam,
)
from dvo_slam_tpu_torch.utils import checkpoint as t_checkpoint
from dvo_slam_tpu_torch.utils.stats import FrameLogger as TFrameLogger

from test_torch_benchmark import one_torch_thread  # noqa: F401

W, H = 64, 48
K = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
TRACKER = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=30)
SLAM = SlamConfig(max_keyframes=32, max_edges=128, min_constraint_distance=3,
                  coarse_first_level=1, coarse_last_level=1,
                  validation_batch=4, local_map_optimize=False)
SLAM_LM = dataclasses.replace(SLAM, local_map_optimize=True)
TRAJ_ATOL = 1e-4
# Frames whose chunk starts with force_keyframe() in the forced scenario.
FORCED = (4, 8)


def _port(cfg):
    return convert.slam_config_from_fields(dataclasses.asdict(cfg))


T_TRACKER = convert.tracker_config_from_fields(dataclasses.asdict(TRACKER))


def _sequence(n=12, radius=0.05):
    scene = synthetic.two_plane_scene()
    poses = synthetic.orbit_trajectory(n, radius=radius)
    frames = synthetic.render_sequence(scene, np.asarray(K), W, H, poses)
    seq_i = np.stack([f[0] for f in frames])
    seq_z = np.stack([f[1] for f in frames])
    ts = [i / 30.0 for i in range(n)]
    return seq_i, seq_z, ts, poses


SEQ = _sequence()


def _feed(slam, chunks, force=FORCED, seq=SEQ, start=0):
    """update_chunk over consecutive chunks of the given sizes from frame
    start, with force_keyframe() before the chunks that start at a frame
    in force."""
    seq_i, seq_z, ts = seq[:3]
    poses, k = [], start
    for size in chunks:
        if k in force:
            slam.force_keyframe()
        poses.extend(slam.update_chunk(seq_i[k:k + size], seq_z[k:k + size],
                                       ts[k:k + size]))
        k += size
    return poses


def _t(cfg=SLAM, lc=True, tracker=T_TRACKER, **kw):
    slam = TChunkedKeyframeSlam(K, tracker, _port(cfg), enable_loop_closure=lc,
                                device="cpu", **kw)
    slam.init()
    return slam


def _j(cfg=SLAM, lc=True, **kw):
    slam = ChunkedKeyframeSlam(K, TRACKER, cfg, enable_loop_closure=lc, **kw)
    slam.init()
    return slam


def _edges(slam):
    g = slam.graph
    return [(int(g.edge_i[e]), int(g.edge_j[e]), bool(g.edge_mask[e]))
            for e in range(int(g.num_edges))]


def _close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   atol=TRAJ_ATOL)


def _traj(slam_traj):
    return [T for _, T in slam_traj]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine over the forced scenario: loop closure on and the
    window solve off and on; the first with a checkpoint after 8 frames."""
    import tempfile

    out = {}
    for name, cfg in (("slam", SLAM), ("lm", SLAM_LM)):
        slam = _j(cfg)
        poses = _feed(slam, [4, 4])
        if name == "slam":
            out["ckpt"] = tempfile.mkdtemp() + "/jax_chunked.npz"
            checkpoint.save_slam(out["ckpt"], slam)
        poses += _feed(slam, [4], start=8)
        out[name] = {"poses": poses, "traj": slam.finish(),
                     "kfs": [k.timestamp for k in slam.keyframes],
                     "edges": _edges(slam), "frames": [
                         (f.keyframe_idx, f.T_kf_frame) for f in slam.frames],
                     "loops": slam.num_loop_edges}
    return out


def _same_as_jax(slam, poses, want):
    assert [k.timestamp for k in slam.keyframes] == want["kfs"]
    assert _edges(slam) == want["edges"]
    assert slam.num_loop_edges == want["loops"]
    _close(poses, want["poses"])


def test_chunk_boundaries_do_not_change_results(jax_runs):
    """The same sequence split at different chunk boundaries (including
    per-frame update()) gives identical keyframes and edges and the same
    trajectory, and the JAX engine's."""
    slam_a = _t()
    poses_a = _feed(slam_a, [4, 4, 4])
    slam_b = _t()
    poses_b = _feed(slam_b, [1, 3, 2, 2, 4])
    seq_i, seq_z, ts, _ = SEQ
    slam_c = _t()
    poses_c = []
    for i in range(len(ts)):
        if i in FORCED:
            slam_c.force_keyframe()
        poses_c.append(slam_c.update(seq_i[i], seq_z[i], ts[i]))
    kfs = [[k.timestamp for k in s.keyframes] for s in (slam_a, slam_b,
                                                        slam_c)]
    assert kfs[0] == kfs[1] == kfs[2] and len(kfs[0]) == 3
    _close(poses_a, poses_b)
    _close(poses_a, poses_c)
    _same_as_jax(slam_a, poses_a, jax_runs["slam"])


def test_chunked_slam_tracks_groundtruth(jax_runs):
    """End-to-end accuracy through the chunked path (loop closure on), and
    finish() as the JAX engine's."""
    slam = _t()
    poses = _feed(slam, [4, 4, 4])
    gt = SEQ[3]
    assert evaluate.ate_rmse(poses, gt) < 0.005
    final = slam.finish()
    assert evaluate.ate_rmse(_traj(final), gt) < 0.005
    _close(_traj(final), _traj(jax_runs["slam"]["traj"]))
    assert _edges(slam) == jax_runs["slam"]["edges"]


def test_benchmark_runner_chunked_path():
    """benchmark.run_sequence(chunk_size=...) drives the chunked engine end
    to end (depth-2 pipeline, warm-up, ATE evaluated), with the per-frame
    engine's keyframes; odometry has no chunked path."""
    from dvo_slam_tpu_torch import benchmark

    kw = dict(num_frames=10, width=W, height=H, tracker_cfg=T_TRACKER,
              slam_cfg=_port(SLAM), mode="slam", device="cpu")
    res = benchmark.run_synthetic(chunk_size=4, **kw)
    per_frame = benchmark.run_synthetic(**kw)
    assert res.num_frames == 10
    assert res.ate_rmse_m < 0.005
    assert abs(res.ate_rmse_m - per_frame.ate_rmse_m) < TRAJ_ATOL
    assert res.num_keyframes == per_frame.num_keyframes
    with pytest.raises(ValueError, match="odometry"):
        benchmark.run_synthetic(chunk_size=4, **{**kw, "mode": "odometry"})


def test_chunked_checkpoint_resume_equivalence(tmp_path):
    """Save mid-run (scan carry included), resume, continue: the
    uninterrupted run's trajectory. A per-frame checkpoint refuses to load
    as chunked, and a chunked one as per-frame."""
    seq_i, seq_z, ts, _ = SEQ
    full = _t()
    _feed(full, [6])
    path = str(tmp_path / "chunked.npz")
    t_checkpoint.save_slam(path, full)
    full.update_chunk(seq_i[6:], seq_z[6:], ts[6:])
    traj_full = full.finish()

    resumed = t_checkpoint.load_slam(path, K, T_TRACKER, _port(SLAM),
                                     chunked=True, device="cpu")
    assert isinstance(resumed, TChunkedKeyframeSlam)
    resumed.update_chunk(seq_i[6:], seq_z[6:], ts[6:])
    traj_res = resumed.finish()
    assert [t for t, _ in traj_full] == [t for t, _ in traj_res] == ts
    _close(_traj(traj_full), _traj(traj_res))

    per_frame = TKeyframeSlam(K, T_TRACKER, _port(SLAM), device="cpu")
    per_frame.init()
    per_frame.update(seq_i[0], seq_z[0], ts[0])
    path2 = str(tmp_path / "perframe.npz")
    t_checkpoint.save_slam(path2, per_frame)
    with pytest.raises(ValueError, match="per-frame"):
        t_checkpoint.load_slam(path2, K, T_TRACKER, _port(SLAM), chunked=True,
                               device="cpu")
    with pytest.raises(ValueError, match="chunked"):
        t_checkpoint.load_slam(path, K, T_TRACKER, _port(SLAM), device="cpu")


def test_jax_chunked_checkpoint_resumes_in_port(jax_runs):
    """A JAX chunked checkpoint (after 8 frames) loads into the port's
    chunked engine, which continues to the JAX run's finish()."""
    seq_i, seq_z, ts, _ = SEQ
    slam = t_checkpoint.load_slam(jax_runs["ckpt"], K, T_TRACKER, _port(SLAM),
                                  chunked=True, device="cpu")
    assert slam._carry["kf"][0].dtype == torch.float32
    _feed(slam, [4], start=8)
    traj = slam.finish()
    want = jax_runs["slam"]
    assert [k.timestamp for k in slam.keyframes] == want["kfs"]
    assert _edges(slam) == want["edges"]
    _close(_traj(traj), _traj(want["traj"]))


def test_port_chunked_checkpoint_resumes_in_jax(jax_runs, tmp_path):
    """A checkpoint of the port's chunked engine (after 8 frames) loads
    into the JAX package's chunked engine, which continues to the port's
    finish()."""
    seq_i, seq_z, ts, _ = SEQ
    slam = _t()
    _feed(slam, [4, 4])
    path = str(tmp_path / "port_chunked.npz")
    t_checkpoint.save_slam(path, slam)
    _feed(slam, [4], start=8)
    traj = slam.finish()

    resumed = checkpoint.load_slam(path, K, TRACKER, SLAM, chunked=True)
    assert isinstance(resumed, ChunkedKeyframeSlam)
    _feed(resumed, [4], start=8)
    j_traj = resumed.finish()
    assert [k.timestamp for k in resumed.keyframes] == \
        [k.timestamp for k in slam.keyframes]
    assert _edges(resumed) == _edges(slam)
    _close(_traj(j_traj), _traj(traj))


def test_chunked_force_keyframe():
    """force_keyframe() promotes the first frame of the next chunk."""
    seq_i, seq_z, ts, _ = SEQ
    slam = _t(lc=False)
    slam.update_chunk(seq_i[:4], seq_z[:4], ts[:4])
    n_before = len(slam.keyframes)
    slam.force_keyframe()
    slam.update_chunk(seq_i[4:8], seq_z[4:8], ts[4:8])
    assert len(slam.keyframes) > n_before
    assert slam.frames[4].keyframe_idx == slam.keyframes[n_before].idx
    np.testing.assert_allclose(slam.frames[4].T_kf_frame, np.eye(4))


def test_chunked_frame_logger_iteration_stats():
    """The chunked engine's frame logger carries the JAX engine's records:
    the same keys and decisions, per-iteration stats trimmed to each
    level's iterations."""
    seq = _sequence(n=7)
    logs = []
    for engine, logger in ((_t, TFrameLogger()), (_j, FrameLogger())):
        slam = engine(lc=False, frame_logger=logger)
        _feed(slam, [4, 3], force=(4,), seq=seq)
        logs.append(logger.records)
    got, want = logs
    assert len(got) == len(want) == 6  # the first frame only inits
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("frame", "keyframe", "accepted", "keyframe_switch",
                    "window_miss_frac", "escalated"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["entropy"], w["entropy"], rtol=1e-4)
        for track in ("kf_track", "odo_track"):
            for lvl in g[track]:
                n = lvl["iterations"]
                assert n >= 1
                assert len(lvl["valid"]) == len(lvl["error"]) == n
                assert all(v > 0 for v in lvl["valid"])
    assert any(r["keyframe_switch"] for r in got)
    json.dumps(got)


def test_chunked_local_map_matches_per_frame_engine(jax_runs):
    """With local_map_optimize=True the chunked walk replays the windowed
    LocalMap solve: on tests/test_chunked_slam.py's scenario (chunks of 5,
    a switch forced at frame 5) the port's per-frame engine's refined frame
    records up to the scan's f32 in-window fusion; on the forced scenario
    with loop closure the JAX chunked engine's."""
    seq_i, seq_z, ts, gt = SEQ
    chunked = _t(SLAM_LM, lc=False)
    pc = _feed(chunked, [5, 5, 2], force=(5,))
    per_frame = TKeyframeSlam(K, T_TRACKER, _port(SLAM_LM),
                              enable_loop_closure=False, device="cpu")
    per_frame.init()
    pf = []
    for i in range(len(ts)):
        if i == 5:
            per_frame.force_keyframe()
        pf.append(per_frame.update(seq_i[i], seq_z[i], ts[i]))
    assert len(chunked.keyframes) == len(per_frame.keyframes) >= 2
    for fc, fp in zip(chunked.frames, per_frame.frames):
        assert fc.keyframe_idx == fp.keyframe_idx
        np.testing.assert_allclose(fc.T_kf_frame, fp.T_kf_frame,
                                   atol=TRAJ_ATOL)
    _close(pc, pf)
    tc = _traj(chunked.finish())
    _close(tc, _traj(per_frame.finish()))
    assert evaluate.ate_rmse(tc, gt) < 0.005

    chunked = _t(SLAM_LM)
    pc = _feed(chunked, [4, 4, 4])
    want = jax_runs["lm"]
    _close(_traj(chunked.finish()), _traj(want["traj"]))
    _same_as_jax(chunked, pc, want)
    # The frame records after finish() (the trailing window refined).
    for fc, (kf_idx, T) in zip(chunked.frames, want["frames"]):
        assert fc.keyframe_idx == kf_idx
        np.testing.assert_allclose(fc.T_kf_frame, T, atol=TRAJ_ATOL)


def test_chunk_boundaries_invariant_with_local_map():
    """Chunk-boundary invariance holds with the LocalMap replay on."""
    slam_a = _t(SLAM_LM, lc=False)
    poses_a = _feed(slam_a, [12], force=())
    slam_b = _t(SLAM_LM, lc=False)
    poses_b = _feed(slam_b, [3, 1, 6, 2], force=())
    assert [k.idx for k in slam_a.keyframes] == \
        [k.idx for k in slam_b.keyframes]
    _close(poses_a, poses_b)


def test_chunked_checkpoint_resume_with_local_map(tmp_path):
    """Resume equivalence with the windowed LocalMap replay on: the pending
    window is serialized and the resumed run refines it identically."""
    seq_i, seq_z, ts, _ = SEQ
    full = _t(SLAM_LM)
    _feed(full, [6], force=())
    assert len(full._local_map) >= 1  # a pending window crosses the save
    path = str(tmp_path / "chunked_lm.npz")
    t_checkpoint.save_slam(path, full)
    full.update_chunk(seq_i[6:], seq_z[6:], ts[6:])
    traj_full = full.finish()
    resumed = t_checkpoint.load_slam(path, K, T_TRACKER, _port(SLAM_LM),
                                     chunked=True, device="cpu")
    resumed.update_chunk(seq_i[6:], seq_z[6:], ts[6:])
    traj_res = resumed.finish()
    assert [t for t, _ in traj_full] == [t for t, _ in traj_res]
    _close(_traj(traj_full), _traj(traj_res))


def test_chunked_reset_clears_local_map_window():
    """reset() leaves no pre-reset measurement in the LocalMap: the fresh
    anchor keyframe starts a fresh window (per-frame engine parity)."""
    seq_i, seq_z, ts, _ = SEQ
    slam = _t(SLAM_LM, lc=False)
    slam.update_chunk(seq_i[:6], seq_z[:6], ts[:6])
    assert len(slam._local_map) >= 2
    slam.reset()
    slam.update_chunk(seq_i[6:], seq_z[6:], ts[6:])
    assert all(fi > 6 for fi in slam._local_map.frame_indices)
    traj = slam.finish()
    assert all(np.isfinite(T).all() for _, T in traj)


def _raw(seq_i, seq_z):
    raw_i = np.clip(np.round(seq_i), 0, 255).astype(np.uint8)
    raw_z = np.nan_to_num(seq_z * 5000.0, nan=0.0).astype(np.uint16)
    return raw_i, raw_z


def _run_chunks(engine, ii, zz, ts):
    slam = engine()
    poses = []
    for k in range(0, len(ts), 4):
        poses.extend(slam.update_chunk(ii[k:k + 4], zz[k:k + 4], ts[k:k + 4]))
    return slam, poses


def test_raw_u8_u16_chunks_match_f32():
    """Raw sensor chunks (uint8 intensity + uint16 depth, converted on the
    device by the pyramid build) give the trajectory of f32 chunks of the
    same quantized values, and the JAX engine's on the same raw chunks."""
    seq_i, seq_z, ts, _ = SEQ
    raw_i, raw_z = _raw(seq_i, seq_z)
    f32_i = raw_i.astype(np.float32)
    f32_z = raw_z.astype(np.float32) / 5000.0
    f32_z[raw_z == 0] = np.nan
    slam_raw, poses_raw = _run_chunks(_t, raw_i, raw_z, ts)
    slam_f32, poses_f32 = _run_chunks(_t, f32_i, f32_z, ts)
    assert [k.idx for k in slam_raw.keyframes] == \
        [k.idx for k in slam_f32.keyframes]
    _close(poses_raw, poses_f32)
    slam_j, poses_j = _run_chunks(_j, raw_i, raw_z, ts)
    assert [k.idx for k in slam_j.keyframes] == \
        [k.idx for k in slam_raw.keyframes]
    _close(poses_raw, poses_j)


def test_packed_depth_chunks_match_u16():
    """12-bit packed depth chunks (pack_depth12, 2.5 B/px) track as u16
    chunks do: the same keyframes, poses within the depth quantization."""
    from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

    seq_i, seq_z, ts, _ = SEQ
    raw_i, raw_z = _raw(seq_i, seq_z)
    packed_z = t_pyramid.pack_depth12(raw_z)
    assert packed_z.shape == (raw_z.shape[0], raw_z.shape[1],
                              3 * raw_z.shape[2] // 2)
    slam_p, poses_p = _run_chunks(_t, raw_i, packed_z, ts)
    slam_r, poses_r = _run_chunks(_t, raw_i, raw_z, ts)
    assert [k.idx for k in slam_p.keyframes] == \
        [k.idx for k in slam_r.keyframes]
    for Tp, Tr in zip(poses_p, poses_r):
        np.testing.assert_allclose(Tp[:3, 3], Tr[:3, 3], atol=2e-3)
        np.testing.assert_allclose(Tp[:3, :3], Tr[:3, :3], atol=1e-2)


def test_chunked_with_reference_gradients():
    """gradient_source="reference" flows through the device-resident scan
    engine end to end: accurate, with a forced switch."""
    seq_i, seq_z, ts, gt = SEQ
    cfg = dataclasses.replace(T_TRACKER, gradient_source="reference")
    slam = _t(tracker=cfg)
    _feed(slam, [4, 4, 4], force=(4,))
    est = _traj(slam.finish())
    assert len(est) == len(ts)
    ate = evaluate.ate_rmse(est, gt)
    assert ate < 0.003, f"ATE {ate * 1000:.2f} mm with reference gradients"
    assert len(slam.keyframes) >= 2


def test_pipelined_submit_collect_matches_sequential():
    """submit_chunk(k+1) before collect_chunk(k) — the depth-2 pipeline —
    gives exactly the sequential update_chunk results, forced keyframes
    (bound to SUBMIT order) and finish() included; a chunk's carry is
    never written after the next chunk runs."""
    seq_i, seq_z, ts, _ = SEQ
    chunks = [(seq_i[k:k + 4], seq_z[k:k + 4], ts[k:k + 4])
              for k in range(0, 12, 4)]
    seq_slam = _t(SLAM_LM)
    seq_poses = []
    for ci, c in enumerate(chunks):
        if ci > 0:
            seq_slam.force_keyframe()
        seq_poses.extend(seq_slam.update_chunk(*c))
    seq_traj = seq_slam.finish()

    pipe = _t(SLAM_LM)
    pipe_poses, pending, carries = [], 0, []
    for ci, c in enumerate(chunks):
        if ci > 0:
            pipe.force_keyframe()
        pipe.submit_chunk(*c)
        carries.append((pipe._carry, {k: v.clone() for k, v in
                                      pipe._carry.items() if k not in
                                      ("kf", "prev")},
                        [x.clone() for x in pipe._carry["kf"]]))
        pending += 1
        if pending == 2:
            pipe_poses.extend(pipe.collect_chunk())
            pending -= 1
    while pending:
        pipe_poses.extend(pipe.collect_chunk())
        pending -= 1
    pipe_traj = pipe.finish()
    for carry, state, kf in carries:
        for k, v in state.items():
            assert torch.equal(carry[k], v), k
        for a, b in zip(carry["kf"], kf):
            assert torch.equal(a, b)

    assert len(seq_poses) == len(pipe_poses) == len(ts)
    _close(seq_poses, pipe_poses)
    assert [t for t, _ in seq_traj] == [t for t, _ in pipe_traj]
    _close(_traj(seq_traj), _traj(pipe_traj))
    assert len(seq_slam.keyframes) == len(pipe.keyframes) == 3


def test_pipelined_drain_on_reads():
    """finish/trajectory with submitted-but-uncollected chunks drain the
    queue, never lose frames."""
    seq_i, seq_z, ts, _ = SEQ
    slam = _t()
    slam.submit_chunk(seq_i[:6], seq_z[:6], ts[:6])
    slam.submit_chunk(seq_i[6:], seq_z[6:], ts[6:])
    assert len(slam.trajectory()) == len(ts)
    assert not slam._chunk_queue
    slam.submit_chunk(seq_i[:2], seq_z[:2], [1.0, 1.1])
    traj = slam.finish()
    assert len(traj) == len(ts) + 2
    assert not slam._chunk_queue


def test_update_chunk_drains_outstanding_submissions():
    """update_chunk()/update() with pipelined submissions outstanding
    return THIS call's poses (the queued chunks are walked first)."""
    seq_i, seq_z, ts, _ = SEQ
    slam = _t()
    slam.submit_chunk(seq_i[:6], seq_z[:6], ts[:6])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        poses = slam.update_chunk(seq_i[6:9], seq_z[6:9], ts[6:9])
    assert len(poses) == 3
    assert not slam._chunk_queue
    pose = slam.update(seq_i[9], seq_z[9], ts[9])
    assert pose.shape == (4, 4)
    assert len(slam.frames) == 10
    ref = _t()
    ref_poses = ref.update_chunk(seq_i[:9], seq_z[:9], ts[:9])
    np.testing.assert_allclose(poses[-1], ref_poses[-1], atol=TRAJ_ATOL)


def test_collect_without_submit_raises_clear_error():
    slam = _t()
    with pytest.raises(RuntimeError, match="no submitted chunk"):
        slam.collect_chunk()


def test_cli_chunk_size(tmp_path):
    """`cli synthetic --chunk-size N` and `cli benchmark --chunk-size N`
    (over an on-disk TUM directory) run the chunked engine."""
    import contextlib
    import io

    from dvo_slam_tpu_torch import cli
    from dvo_slam_tpu_torch.utils import synthetic as t_synthetic

    tracker = ["--num-levels", "2", "--first-level", "1", "--last-level",
               "0", "--max-iterations", "30", "--device", "cpu"]

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(args) == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    res = run(["synthetic", "--frames", "8", "--width", str(W), "--height",
               str(H), "--chunk-size", "4", *tracker])
    assert res["num_frames"] == 8 and res["ate_rmse_m"] < 0.005
    seq_i, seq_z, _, gt = _sequence(8)
    t_synthetic.write_tum_dataset(str(tmp_path / "seq"),
                                  zip(seq_i, seq_z), gt)
    res = run(["benchmark", str(tmp_path / "seq"), "--chunk-size", "4",
               "--checkpoint-out", str(tmp_path / "state.npz"), *tracker])
    assert res["num_frames"] == 8
    resumed = t_checkpoint.load_slam(str(tmp_path / "state.npz"),
                                     (517.3, 516.5, 318.6, 255.3), T_TRACKER,
                                     chunked=True, device="cpu")
    assert len(resumed.frames) == 8


def _pipelined(slam, sizes, force=FORCED, seq=SEQ):
    """submit_chunk over consecutive chunks of the given sizes with a
    depth-2 pipeline (chunk k + 1 submitted before chunk k is collected),
    force_keyframe() before the chunks that start at a frame in force."""
    seq_i, seq_z, ts = seq[:3]
    poses, k, in_flight = [], 0, 0
    for size in sizes:
        if k in force:
            slam.force_keyframe()
        slam.submit_chunk(seq_i[k:k + size], seq_z[k:k + size],
                          ts[k:k + size])
        k += size
        in_flight += 1
        if in_flight == 2:
            poses.extend(slam.collect_chunk())
            in_flight -= 1
    while in_flight:
        poses.extend(slam.collect_chunk())
        in_flight -= 1
    return poses


@pytest.mark.parametrize("sizes, force", [((4, 4, 4), FORCED),
                                          ((2, 3, 3, 2, 2), ())],
                         ids=["forced", "held_keyframe"])
def test_kernel_route_engine_matches_step_route(monkeypatch, sizes, force):
    """ChunkedKeyframeSlam with its chunks on the kernel route (the
    kernels stood in for on the CPU: tests/test_torch_keyframe_scan.py
    stand_in_kernel_route) against the per-frame route, depth-2 pipelined,
    loop closure and the window solve on: the same keyframes, edges and
    poses, bit for bit; the frame logger's records equal. Without forced
    keyframes one keyframe is held across chunks that are submitted
    before the chunk that found it is collected: its PendingKeyframe must
    keep the slabs the later chunks' tables point at. Every carry ends
    resolved, with the keys a checkpoint saves."""
    from test_torch_keyframe_scan import stand_in_kernel_route

    runs = []
    for kernels in (False, True):
        if kernels:
            counts = stand_in_kernel_route(monkeypatch)
        logger = TFrameLogger()
        slam = _t(SLAM_LM, frame_logger=logger)
        poses = _pipelined(slam, sizes, force)
        runs.append((slam, poses, logger.records))
    (want, p_w, r_w), (got, p_g, r_g) = runs
    n = sum(sizes)
    assert counts["scan_step"] == n - 1 and counts["track_level"] >= \
        2 * (n - 1)
    assert [k.timestamp for k in got.keyframes] == \
        [k.timestamp for k in want.keyframes]
    assert _edges(got) == _edges(want)
    assert len(p_g) == len(p_w) == n
    for a, b in zip(p_g, p_w):
        np.testing.assert_array_equal(a, b)
    assert json.dumps(r_g, sort_keys=True, default=str) == \
        json.dumps(r_w, sort_keys=True, default=str)
    carry = got._carry
    assert isinstance(carry["kf"], tuple) and "_state" in carry
    for key in ("kf", "prev", "T_kf_prev", "last_odo", "H_first",
                "has_first"):
        assert key in carry
    if not force:
        assert len(got.keyframes) < 4  # a keyframe spanned chunks

"""The plain reference against the port's plain CPU versions at a tiny
size: the pyramid, a pair's pose, a SLAM sequence's keyframes and poses,
and the pose-graph solve. The tests may import the port; the reference
may not."""

import numpy as np
import pytest
import torch

from portbench.reference import pose_graph, pyramid, scan, se3, tracker
from portbench.tests import tiny
from portbench.traffic import chunked_replay, scene

SEED = 2**31 + 4099


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _sequence(cell, n):
    cfg = cell["config"]
    cam, proto = cfg["camera"], cfg["protocol"]
    poses = scene.orbit(n, proto["orbit"]["radius"],
                        proto["orbit"]["yaw_amplitude"],
                        n / proto["orbit"]["frames_per_lap"])
    shape = (n, cam["height"], cam["width"])
    i = torch.empty(shape, dtype=torch.uint8)
    z = torch.empty(shape, dtype=torch.uint16)
    scene.frames(proto, cam, poses, scene.generator(SEED, "cpu"), i, z)
    return i, z


def test_pyramid_is_the_ports_plain_chain_bit_for_bit():
    from dvo_slam_tpu_torch.ops import pyramid as port

    cell = tiny.cell("vo.fleet8")
    i, z = _sequence(cell, 2)
    for k in range(2):
        want = port.build_pyramid_reference(i[k], z[k], 4)
        got = pyramid.pyramid(i[k], z[k], 4)
        for a, b in zip(want, got):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _port_cfg(cell):
    from dvo_slam_tpu_torch import TrackerConfig

    return TrackerConfig(**cell["config"]["tracker"])


@pytest.mark.parametrize("sums", [torch.float32, torch.float64])
def test_a_pairs_pose_matches_the_ports_plain_tracker(sums):
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import camera
    from dvo_slam_tpu_torch.ops import pyramid as port_pyr

    cell = tiny.cell("vo.fleet8")
    i, z = _sequence(cell, 3)
    cfg = _port_cfg(cell)
    K = torch.tensor(cell["config"]["camera"]["intrinsics"])
    Ks = camera.pyramid_intrinsics(K, cfg.num_levels)
    pyrs = [port_pyr.build_pyramid(i[k], z[k], cfg.num_levels)
            for k in range(3)]
    T0 = torch.eye(4).expand(2, 4, 4).contiguous()
    ref = tuple(torch.stack([pyrs[0][lv], pyrs[1][lv]])
                for lv in range(cfg.num_levels))
    cur = tuple(torch.stack([pyrs[1][lv], pyrs[2][lv]])
                for lv in range(cfg.num_levels))
    want = dense_tracker.track_batched(ref, cur, Ks, T0, cfg)
    st = tracker.Settings.of(cell["config"]["tracker"])
    got = tracker.track(list(ref), list(cur),
                        tracker.level_intrinsics(K, st.num_levels), T0, st,
                        sums)
    # The sums' order (and at float64 their precision) differs from the
    # port's plain version: where a step's error change is at the float32
    # noise floor, Gauss-Newton's rollback decides it either way, and the
    # rows part by up to a last step (the port's own card tests accept
    # that at a tie and hold the pose to 1e-4 there).
    assert float(se3.gap(want.transformation, got["T"]).max()) < 1e-4
    torch.testing.assert_close(got["entropy"].float(), want.entropy,
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got["valid_ratio"].float(), want.valid_ratio,
                               rtol=1e-3, atol=1e-3)


def test_a_slam_sequences_keyframes_and_poses_match_the_port():
    """The front end's keyframes and per-frame poses against the port's
    plain scan, and the port's final graph, loop edges closed, solved by
    ``finish()`` against the reference's solve."""
    from dvo_slam_tpu_torch.models import keyframe_scan

    cell = dict(tiny.slam(), seed=SEED)
    driver = chunked_replay.Driver(cell, device="cpu")
    cfg = cell["config"]
    n = cell["params"]["frames"]
    outs = keyframe_scan.track_keyframe_sequence(
        driver.intensity, driver.depth,
        torch.tensor(cfg["camera"]["intrinsics"]), _port_cfg(cell),
        __import__("dvo_slam_tpu_torch").SlamConfig(**cfg["slam"]))
    st = tracker.Settings.of(cfg["tracker"])
    ref = scan.replay(driver.intensity, driver.depth,
                      cfg["camera"]["intrinsics"], st, cfg["slam"])
    assert ref["mismatches"] == 0
    np.testing.assert_array_equal(ref["own"][1:], outs["switch"].numpy())
    # The port's plain CPU version sums in float32 in an order that
    # follows the host's thread count; a rollback decided at the noise
    # floor stops a level early, by up to a few early steps at 80x60.
    assert float(se3.gap(outs["rel_pose"], ref["rel"][1:]).max()) < 1e-3

    rec = driver._sequence(lambda name: __import__("contextlib")
                           .nullcontext(), float("inf"), [])
    assert rec["frames"] == n
    assert rec["kf_frames"] == [0] + list(np.flatnonzero(ref["own"][1:]) + 1)
    assert rec["loop_edges"] >= 1
    assert driver._polish(rec) < 1e-5


def _ring(M=12, noise=0.01, seed=3):
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(M) / M
    xi = np.stack([np.cos(a), np.sin(a), 0 * a, 0 * a, 0 * a, a], 1)
    P = se3.exp(torch.as_tensor(xi)).numpy()
    ei = np.arange(M)
    ej = (ei + 1) % M
    Z = np.linalg.inv(P[ei]) @ P[ej]
    Z = Z @ se3.exp(torch.as_tensor(rng.normal(0, noise, (M, 6)))).numpy()
    info = np.tile(1e4 * np.eye(6), (M, 1, 1))
    return P, ei, ej, Z.astype(np.float32), info.astype(np.float32)


def test_graph_solve_matches_the_ports_and_finds_its_optimum():
    from dvo_slam_tpu_torch.models import pose_graph as port

    P, ei, ej, Z, info = _ring()
    M = len(P)
    g = port.empty_graph_host(16, 16)
    g.poses[:M] = P
    g.edge_i[:M], g.edge_j[:M] = ei, ej
    g.measurements[:M], g.information[:M] = Z, info
    g.edge_mask[:M] = True
    g = g._replace(num_vertices=np.asarray(M, np.int32),
                   num_edges=np.asarray(M, np.int32))
    solved, _, _ = port.optimize(g, iterations=100, gnc_init=16.0,
                                 gnc_adaptive=True, device="cpu")
    want = solved.poses[:M].double()
    got = pose_graph.polish(P, ei, ej, Z, info, np.ones(M))
    assert float(se3.gap(want, got).max()) < 1e-4
    again = pose_graph.polish(got, ei, ej, Z, info, np.ones(M))
    assert float(se3.gap(got, again).max()) < 1e-9
    assert float(se3.gap(torch.as_tensor(P), got).max()) > 1e-3

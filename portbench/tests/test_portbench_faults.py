"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, the window, the check) on the CPU at a tiny size, with one
fault planted in the program: a step that returns its state unchanged,
half of the batch left out (the mean taken over the rest), an answer
altered where it is produced; in the fleet besides, one stream of four
gone wrong with its iteration counts, and iteration counts misreported
with every pose right. The exchange between chips does not apply:
every cell runs on one chip. A sound run at the same size reads far below
each fault (its own limits are set from the card's readings)."""

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 7919


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run(cell, seconds=0.0):
    return harness.run(cell, SEED, seconds, 0, time.perf_counter(),
                       device="cpu")


def _values(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.fixture(scope="module")
def fleet_sound():
    torch.set_num_threads(2)
    return _values(_run(tiny.fleet(check_calls=4, streams=4,
                                   ring_frames=17), seconds=0.5))


def _twist(x, y=0.0):
    from portbench.reference import se3

    return se3.exp(torch.tensor([x, y, 0.0, 0.0, 0.0, 0.0]))


def _broken_fleet(monkeypatch, fault):
    from dvo_slam_tpu_torch.parallel import batch_slam

    real = batch_slam.track_sequences_batched

    def track(intensities, depths, K, cfg):
        if fault == "unchanged":
            out = real(intensities, depths, K, cfg)
            return dict(out, rel_poses=torch.eye(4).expand_as(
                out["rel_poses"]))
        if fault == "half":
            S = intensities.shape[0]
            out = real(intensities[:S // 2], depths[:S // 2], K, cfg)
            mean = out["rel_poses"].mean(0, keepdim=True)
            rel = torch.cat([out["rel_poses"],
                             mean.expand(S - S // 2, *mean.shape[1:])])
            return dict(out, rel_poses=rel,
                        is_nan=torch.cat([out["is_nan"]] * 2)[:S],
                        iterations=torch.cat([out["iterations"]] * 2)[:S])
        out = real(intensities, depths, K, cfg)
        rel, iters = out["rel_poses"].clone(), out["iterations"].clone()
        if fault == "altered":
            rel[0, 1] = rel[0, 1] @ _twist(5e-3)
        elif fault == "one_stream":
            # Stream 0 diverges: every answer 5 mm off, and the iterations
            # it reports are not the reference's.
            rel[0] = rel[0] @ _twist(5e-3)
            iters[0] += 1
        else:
            iters += 1
        return dict(out, rel_poses=rel, iterations=iters)

    monkeypatch.setattr(batch_slam, "track_sequences_batched", track)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "one_stream", "misreported"])
def test_fleet_fault_is_not_correct(monkeypatch, fleet_sound, fault):
    cell = tiny.fleet(check_calls=4, streams=4, ring_frames=17)
    _broken_fleet(monkeypatch, fault)
    result = _run(cell, seconds=0.5)
    assert result["correct"] is False
    got = _values(result)
    # The fault shows in a number that a sound run reads far below.
    assert any(c["value"] > c["limit"] and c["value"] > 3 * fleet_sound[k]
               for k, c in result["checks"].items()), (got, fleet_sound)


@pytest.fixture(scope="module")
def slam_sound():
    torch.set_num_threads(2)
    return _values(_run(tiny.slam()))


def _broken_slam(monkeypatch, fault):
    from dvo_slam_tpu_torch.models import dense_tracker, keyframe_scan
    from dvo_slam_tpu_torch.models import pose_graph

    if fault == "tracker_unchanged":
        real = dense_tracker.track_batched

        def track(ref, cur, Ks, T_inits, cfg, pixel_group=None):
            res = real(ref, cur, Ks, T_inits, cfg, pixel_group)
            return res._replace(transformation=T_inits.clone())

        monkeypatch.setattr(dense_tracker, "track_batched", track)
    elif fault == "graph_unchanged":
        real = pose_graph.optimize

        def optimize(graph, iterations=20, **kw):
            return real(graph, iterations=0, **kw)

        monkeypatch.setattr(pose_graph, "optimize", optimize)
    elif fault == "half":
        real = dense_tracker.track_batched

        def track(ref, cur, Ks, T_inits, cfg, pixel_group=None):
            # The batch's second row (the odometry alignment) left out:
            # the first row's result stands for both.
            res = real(ref, cur, Ks, T_inits, cfg, pixel_group)
            first = res.transformation[:1]
            return res._replace(transformation=first.expand_as(
                res.transformation).clone())

        monkeypatch.setattr(dense_tracker, "track_batched", track)
    else:
        real = keyframe_scan._step
        sign = [1.0]

        def step(*a, **kw):
            # Each frame's pose offset by 2 mm where the step produces it,
            # the other way from the frame before.
            carry, out = real(*a, **kw)
            sign[0] = -sign[0]
            T = out["rel_pose"]
            out["rel_pose"] = torch.where(
                out["switch"], T, T @ _twist(2e-3 * sign[0], 1e-3))
            return carry, out

        monkeypatch.setattr(keyframe_scan, "_step", step)


@pytest.mark.parametrize("fault", ["tracker_unchanged", "graph_unchanged",
                                   "half", "altered"])
def test_slam_fault_is_not_correct(monkeypatch, slam_sound, fault):
    _broken_slam(monkeypatch, fault)
    result = _run(tiny.slam())
    assert result["correct"] is False
    got = _values(result)
    worse = [k for k in got
             if got[k] > max(100 * slam_sound[k], 1e-4)]
    assert worse, (got, slam_sound)


def test_sound_runs_read_low(fleet_sound, slam_sound):
    assert fleet_sound["pose_gap_stream_p50_max"] < 1e-5
    assert fleet_sound["off_path_share"] < 0.25
    assert slam_sound["pyramid_max_abs"] == 0.0
    assert slam_sound["switch_mismatches"] == 0
    assert np.isfinite(list(slam_sound.values())).all()

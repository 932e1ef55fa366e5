"""The port's loop-closure proposal, voters and batched two-stage
validation against the JAX package's.

Candidates and voters are host numpy on both sides and must make the same
decisions exactly. One padded validation batch (three candidates padded to
four with candidate 0) goes through the port's ``_validate_batch`` and the
JAX ``_validate_batch_jit`` on the same 64x48 pyramids. Tolerances there:
poses 1e-4, entropies rtol 1e-3, valid ratios 1e-3 absolute, NaN flags
exact; the accepted constraints of ``validate_candidates`` (with the level
trim and the evicted-pyramid cache) are the same (keyframe, new) pairs with
measurements within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import SlamConfig, TrackerConfig
from dvo_slam_tpu.models import constraints
from dvo_slam_tpu.ops import camera, pyramid
from dvo_slam_tpu.utils import se3_np, synthetic
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import constraints as t_constraints
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
# Three levels, tracked 2 -> 1: validation trims level 0.
FINE = TrackerConfig(num_levels=3, first_level=2, last_level=1,
                     max_iterations=30)
COARSE = dataclasses.replace(FINE, first_level=2, last_level=2,
                             max_iterations=25)
SLAM = SlamConfig(min_constraint_distance=3, validation_batch=4)
T_FINE, T_COARSE = (convert.tracker_config_from_fields(dataclasses.asdict(c))
                    for c in (FINE, COARSE))
T_SLAM = convert.slam_config_from_fields(dataclasses.asdict(SLAM))
CANDIDATES = (0, 1, 5)  # keyframes validated against the new one (9)
NEW = 9


def test_propose_candidates_like_jax():
    rng = np.random.default_rng(0)
    for cap in (0, 3):
        cfg = dataclasses.replace(SLAM, max_loop_candidates=cap,
                                  new_constraint_search_radius=0.8)
        t_cfg = convert.slam_config_from_fields(dataclasses.asdict(cfg))
        for _ in range(20):
            pos = rng.normal(scale=0.6, size=(12, 3))
            n = int(rng.integers(1, 12))
            assert (t_constraints.propose_candidates(pos, n, t_cfg)
                    == constraints.propose_candidates(pos, n, cfg))


def test_voters_like_jax():
    rng = np.random.default_rng(1)
    T_init = se3_np.exp(np.array([0.1, 0.0, 0.05, 0.02, 0.0, 0.01]))
    for scale in (0.01, 0.3, 1.0):
        for _ in range(20):
            T = se3_np.exp(rng.normal(scale=scale, size=6)) @ T_init
            assert (t_constraints._odometry_vote(T, T_init, T_SLAM)
                    == constraints._odometry_vote(T, T_init, SLAM))
    for h, d in ((-90.0, -100.0), (10.0, 5.0), (1.0, 1e-9), (np.nan, -1.0),
                 (-90.0, None)):
        assert t_constraints._entropy_ratio(h, d) == constraints._entropy_ratio(
            h, d)
    # vote_validation on synthetic batch results straddling every
    # threshold: the same accepted constraints.
    B = 32
    chunk = [constraints.ConstraintCandidate(
        keyframe_idx=k % 4, new_idx=7,
        T_init=se3_np.exp(rng.normal(scale=0.1, size=6))) for k in range(B)]
    t_chunk = [t_constraints.ConstraintCandidate(c.keyframe_idx, c.new_idx,
                                                 c.T_init) for c in chunk]

    def near(T, s):
        return np.stack([se3_np.exp(rng.normal(scale=s, size=6)) @ t
                         for t in T]).astype(np.float32)

    T_f = near([c.T_init for c in chunk], 0.3)
    res = {
        "fwd_T": T_f, "fwd_nan": rng.random(B) < 0.1,
        "fwd_H": rng.uniform(-120, -40, B).astype(np.float32),
        "fwd_vr": rng.uniform(0.0, 1.0, B).astype(np.float32),
        "bwd_T": np.stack([se3_np.inverse(t) for t in near(T_f, 0.03)]
                          ).astype(np.float32),
        "bwd_nan": rng.random(B) < 0.1,
        "fine_T": near(T_f, 0.05), "fine_nan": rng.random(B) < 0.1,
        "fine_H": rng.uniform(-120, -60, B).astype(np.float32),
        "fine_vr": rng.uniform(0.0, 1.0, B).astype(np.float32),
        "fine_info": np.tile(np.eye(6, dtype=np.float32) * 1e3, (B, 1, 1)),
        "fine_wmiss": np.zeros(B, np.float32),
    }
    entropies = [-100.0, None, -90.0, -80.0]
    want = constraints.vote_validation([chunk], [res], entropies, SLAM)
    got = t_constraints.vote_validation([t_chunk], [res], entropies, T_SLAM)
    assert 0 < len(want) < B
    assert [(a.keyframe_idx, a.new_idx) for a in got] == [
        (a.keyframe_idx, a.new_idx) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.measurement, b.measurement)
        np.testing.assert_array_equal(a.information, b.information)


@pytest.fixture(scope="module")
def scene():
    poses = synthetic.orbit_trajectory(10, radius=0.06)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(K_TUPLE), W, H, poses)
    return frames, poses


def _candidates(poses, cls):
    rng = np.random.default_rng(5)
    return [cls(keyframe_idx=k, new_idx=NEW, T_init=(
        se3_np.inverse(poses[NEW]) @ poses[k]
        @ se3_np.exp(rng.normal(scale=5e-3, size=6)))) for k in CANDIDATES]


def test_validation_batch_like_jax(scene):
    """One padded batch (3 candidates -> 4 rows, row 3 repeats candidate
    0): coarse forward, coarse backward and fine, each one batched tracker
    call, against the JAX package's single vmapped program."""
    frames, poses = scene
    idx = list(range(len(CANDIDATES))) + [0]
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE), 3)
    t_Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), 3)
    pyrs = {k: pyramid.build_pyramid(jnp.asarray(frames[k][0]),
                                     jnp.asarray(frames[k][1]), 3)
            for k in CANDIDATES + (NEW,)}
    t_pyrs = {k: t_pyramid.build_pyramid(torch.from_numpy(frames[k][0]),
                                         torch.from_numpy(frames[k][1]), 3)
              for k in CANDIDATES + (NEW,)}
    cands = _candidates(poses, constraints.ConstraintCandidate)
    Tf = np.stack([cands[i].T_init for i in idx]).astype(np.float32)
    Tb = np.stack([se3_np.inverse(cands[i].T_init)
                   for i in idx]).astype(np.float32)
    want = constraints._validate_batch_jit(
        tuple(pyrs[CANDIDATES[i]] for i in idx), pyrs[NEW], Ks,
        jnp.asarray(Tf), jnp.asarray(Tb), COARSE, FINE)
    got = t_constraints._validate_batch(
        tuple(t_pyrs[CANDIDATES[i]] for i in idx), t_pyrs[NEW], t_Ks,
        torch.from_numpy(Tf), torch.from_numpy(Tb), T_COARSE, T_FINE)
    assert set(got) == set(want)
    for key in ("fwd_T", "bwd_T", "fine_T", "fine_info"):
        w = np.asarray(want[key])
        scale = 1.0 if key != "fine_info" else np.abs(w).max()
        np.testing.assert_allclose(got[key].numpy() / scale, w / scale,
                                   atol=1e-4, err_msg=key)
    for key in ("fwd_nan", "bwd_nan", "fine_nan"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("fwd_H", "fine_H"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-3)
    for key in ("fwd_vr", "fine_vr"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-3)
    np.testing.assert_array_equal(got["fine_wmiss"].numpy(), 0.0)
    # The padded row repeats candidate 0.
    np.testing.assert_array_equal(got["fine_T"][3].numpy(),
                                  got["fine_T"][0].numpy())


def test_validate_candidates_with_trim_and_cache_like_jax(scene):
    """The synchronous validation, level trim and evicted-pyramid LRU
    cache included: the same accepted constraints and cache counters."""
    frames, poses = scene
    j_pyrs = [pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z), 3)
              for i, z in frames]
    t_pyrs = [t_pyramid.build_pyramid(torch.from_numpy(i),
                                      torch.from_numpy(z), 3)
              for i, z in frames]
    # Keyframe 1 is evicted (host numpy) in both.
    j_pyrs[1] = tuple(np.asarray(x) for x in j_pyrs[1])
    t_pyrs[1] = tuple(x.numpy() for x in t_pyrs[1])
    entropies = [-60.0] * 10
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE), 3)
    t_Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), 3)
    keys = [(k, k / 30.0) for k in range(10)]
    j_cache, t_cache = (constraints.ValidationCache(),
                        t_constraints.ValidationCache())
    want = constraints.collect_validation(constraints.dispatch_validation(
        _candidates(poses, constraints.ConstraintCandidate), j_pyrs,
        j_pyrs[NEW], Ks, COARSE, FINE, SLAM, keys, j_cache), entropies, SLAM)
    got = t_constraints.collect_validation(t_constraints.dispatch_validation(
        _candidates(poses, t_constraints.ConstraintCandidate), t_pyrs,
        t_pyrs[NEW], t_Ks, T_COARSE, T_FINE, T_SLAM, keys, t_cache),
        entropies, T_SLAM)
    assert [a.keyframe_idx for a in got] == [a.keyframe_idx for a in want]
    assert len(got) >= 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.measurement, b.measurement, atol=1e-4)
    assert t_cache.stats() == j_cache.stats()
    assert t_cache.stats()["misses"] == 1
    sync = t_constraints.validate_candidates(
        _candidates(poses, t_constraints.ConstraintCandidate), t_pyrs,
        entropies, t_pyrs[NEW], t_Ks, T_COARSE, T_FINE, T_SLAM)
    assert [a.keyframe_idx for a in sync] == [a.keyframe_idx for a in got]
    assert t_constraints.dispatch_validation(
        [], t_pyrs, t_pyrs[NEW], t_Ks, T_COARSE, T_FINE, T_SLAM) is None

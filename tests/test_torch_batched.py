"""The port's batched tracker against the JAX package's vmapped one.

64x48 synthetic frames (tests/test_slam.py's size), two levels. The port
runs one lockstep host loop per level over (B, ...) tensors; the JAX
package vmaps ``track`` over the batch (a vmap of a while_loop). Same
semantics: every row is linearized every iteration, and a row whose stop
test fired keeps its carry frozen.

Tolerances: transformation entries 1e-4 (f32 IRLS on both sides,
reductions in another order); iterations per level equal or +-1 (an
accept/reject decision at the f32 noise floor may flip); valid_pixels
within 2; entropy rtol 1e-3. A row that stops at its first iteration
(all-NaN reference depth) is exact: iterations, zero valid pixels, the
initial pose. The port's B = 1 batched result equals its ``track`` bit
for bit, and a batched row equals ``track`` of that pair within 1e-6 (the
same per-row arithmetic; batched small matrix products may round
differently).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import dense_tracker
from dvo_slam_tpu.ops import camera, pyramid
from dvo_slam_tpu.utils import se3_np, synthetic
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import dense_tracker as t_dense_tracker
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
CFG = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                    max_iterations=30)
T_CFG = convert.tracker_config_from_fields(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_trajectory(6, radius=0.06)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(K_TUPLE), W, H, poses)
    # Row 3 of the paired batch: a reference with no valid depth.
    frames[3] = (frames[3][0], np.full_like(frames[3][1], np.nan))
    return frames, poses


def _inits(poses, refs, curs):
    rng = np.random.default_rng(7)
    return np.stack([
        (se3_np.inverse(poses[c]) @ poses[r]
         @ se3_np.exp(rng.normal(scale=3e-3, size=6))).astype(np.float32)
        for r, c in zip(refs, curs)])


def _jax_pyr(frame):
    return pyramid.build_pyramid(jnp.asarray(frame[0]), jnp.asarray(frame[1]),
                                 CFG.num_levels)


def _port_pyr(frame):
    return t_pyramid.build_pyramid(torch.from_numpy(frame[0]),
                                   torch.from_numpy(frame[1]),
                                   CFG.num_levels)


def _stack(pyrs, lib):
    return tuple(lib.stack([p[lvl] for p in pyrs])
                 for lvl in range(CFG.num_levels))


J_KS = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE), CFG.num_levels)
T_KS = t_camera.pyramid_intrinsics(t_camera.intrinsics(*K_TUPLE, device="cpu"),
                                   CFG.num_levels)

# Shared: references 0, 1 against frame 2 (a SLAM frame's dual alignment).
SHARED = ((0, 1), (2, 2))
# Paired: four references, each against its own current frame; row 3's
# reference has all-NaN depth.
PAIRED = ((0, 1, 4, 3), (1, 2, 5, 4))


@pytest.fixture(scope="module")
def jax_results(frames):
    frames, poses = frames
    pyrs = [_jax_pyr(f) for f in frames]
    refs, curs = SHARED
    shared = dense_tracker.track_batched(
        _stack([pyrs[r] for r in refs], jnp), pyrs[curs[0]], J_KS,
        jnp.asarray(_inits(poses, refs, curs)), CFG)
    refs, curs = PAIRED
    paired = dense_tracker.track_pairs_batched(
        _stack([pyrs[r] for r in refs], jnp),
        _stack([pyrs[c] for c in curs], jnp), J_KS,
        jnp.asarray(_inits(poses, refs, curs)), CFG)
    return shared, paired


def _port_batched(frames, which):
    frames, poses = frames
    pyrs = [_port_pyr(f) for f in frames]
    refs, curs = which
    T0 = torch.from_numpy(_inits(poses, refs, curs))
    ref_pyrs = _stack([pyrs[r] for r in refs], torch)
    if which is SHARED:
        res = t_dense_tracker.track_batched(ref_pyrs, pyrs[curs[0]], T_KS, T0,
                                            T_CFG)
    else:
        res = t_dense_tracker.track_pairs_batched(
            ref_pyrs, _stack([pyrs[c] for c in curs], torch), T_KS, T0,
            T_CFG)
    return res, pyrs, T0


def _assert_like_jax(got, want, rows):
    got = convert.result_to_numpy(got)
    for b in rows:
        np.testing.assert_allclose(got.transformation[b],
                                   np.asarray(want.transformation[b]),
                                   atol=1e-4, err_msg=f"row {b}")
        assert np.abs(got.iterations[b]
                      - np.asarray(want.iterations[b])).max() <= 1
        assert abs(float(got.valid_pixels[b])
                   - float(want.valid_pixels[b])) <= 2
        np.testing.assert_allclose(got.entropy[b], np.asarray(want.entropy[b]),
                                   rtol=1e-3)
    assert not got.is_nan().any()


def test_track_batched_shared_frame_like_jax(frames, jax_results):
    got, _, _ = _port_batched(frames, SHARED)
    assert got.transformation.shape == (2, 4, 4)
    assert got.iterations.shape == (2, 2)
    _assert_like_jax(got, jax_results[0], rows=(0, 1))


def test_track_pairs_batched_rows_stop_apart_like_jax(frames, jax_results):
    got, pyrs, T0 = _port_batched(frames, PAIRED)
    want = jax_results[1]
    _assert_like_jax(got, want, rows=(0, 1, 2))
    # Row 3 (no valid reference depth) stops at its first iteration on
    # every level and keeps its initial pose; the other rows go on.
    np.testing.assert_array_equal(got.iterations[3].numpy(), [1, 1])
    np.testing.assert_array_equal(np.asarray(want.iterations[3]), [1, 1])
    assert float(got.valid_pixels[3]) == float(want.valid_pixels[3]) == 0.0
    np.testing.assert_allclose(got.transformation[3].numpy(), T0[3].numpy(),
                               atol=1e-6)
    assert (got.iterations[:3] > 1).any()
    # Frozen rows' per-iteration stats stay zero past their iterations,
    # as in the JAX package's frozen carry.
    s = got.stats
    for b in range(4):
        for lvl, n in enumerate(got.iterations[b].tolist()):
            assert not s.valid[b, lvl, n:].any()
            assert not s.accepted[b, lvl, n:].any()
    assert (s.termination[3] == t_dense_tracker.TERM_TOO_FEW_CONSTRAINTS).all()
    np.testing.assert_array_equal(
        s.termination.numpy(), np.asarray(want.stats.termination))
    # Each row is the single-pair tracker's result on that pair.
    refs, curs = PAIRED
    for b in range(4):
        one = t_dense_tracker.track(pyrs[refs[b]], pyrs[curs[b]], T_KS, T0[b],
                                    T_CFG)
        np.testing.assert_array_equal(one.iterations.numpy(),
                                      got.iterations[b].numpy())
        np.testing.assert_allclose(one.transformation.numpy(),
                                   got.transformation[b].numpy(), atol=1e-6)


def test_batched_b1_is_bit_equal_to_track(frames):
    frames, poses = frames
    pyrs = [_port_pyr(f) for f in frames]
    T0 = torch.from_numpy(_inits(poses, (0,), (1,)))
    batched = t_dense_tracker.track_batched(_stack([pyrs[0]], torch), pyrs[1],
                                            T_KS, T0, T_CFG)
    single = t_dense_tracker.track(pyrs[0], pyrs[1], T_KS, T0[0], T_CFG)
    row = t_dense_tracker.row(batched, 0)
    for field, a, b in zip(single._fields, single, row):
        if field == "stats":
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        else:
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), field

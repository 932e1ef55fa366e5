"""The port's point compaction (ops/linearize.compact_reference,
TrackerConfig.point_budget_fraction) against the JAX package's, on the
gather-backend cases of tests/test_compaction.py.

- Budgets equal. Compacted fields equal the JAX ones exactly (they are
  copies of the same f32 values), at every case: under budget, decimated,
  at the 320x240 scale where the JAX package's int32 slot map needed its
  split arithmetic, with nothing selected, with reference gradients, and
  over a (B, N) batch.
- Linearizations of the compacted points: valid counts exactly; A, b,
  Sigma and the error within the f32 tolerances of
  tests/test_torch_tracker.py (sums in another order).
- Tracking under a budget: poses within 5e-5 of the JAX package's on
  noise-free renders, valid counts and ratios from the compacted
  selection; one keyframe SLAM run at budget 0.5 through both packages:
  the same keyframes and edges, trajectories within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import dense_tracker
from dvo_slam_tpu.models.keyframe_tracker import KeyframeSlam
from dvo_slam_tpu.ops import camera, pyramid
from dvo_slam_tpu.ops import linearize as lin_ops
from dvo_slam_tpu.utils import evaluate, se3_np, synthetic
from dvo_slam_tpu_torch import KeyframeSlam as TKeyframeSlam
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import dense_tracker as t_dense_tracker
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import linearize as t_lin
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

W, H = 128, 32  # tests/test_compaction.py's grid
K_TUPLE = (64.0, 64.0, (W - 1) / 2.0, (H - 1) / 2.0)
N = W * H
CFG = TrackerConfig(num_levels=1, first_level=0, last_level=0,
                    intensity_grad_threshold=3.0, max_iterations=30)
FIELDS = ("px", "py", "pz", "i1", "selected", "gix", "giy", "gzx", "gzy")
POSE_ATOL = 5e-5


def _port_cfg(cfg):
    return convert.tracker_config_from_fields(dataclasses.asdict(cfg))


def _render(xi_rel=np.zeros(6), sharpness=1.0):
    scene = synthetic.PlaneScene(sharpness=sharpness)
    K = np.asarray(K_TUPLE)
    ref = scene.render(K, W, H, np.eye(4))
    cur = scene.render(K, W, H, se3_np.inverse(se3_np.exp(xi_rel)))
    return ref, cur, se3_np.exp(xi_rel)


def _slabs(intensity, depth):
    """The level-0 slab of both packages from the same numpy frame."""
    j = pyramid.build_pyramid(jnp.asarray(intensity), jnp.asarray(depth),
                              1)[0]
    t = t_pyramid.build_pyramid(torch.from_numpy(intensity),
                                torch.from_numpy(depth), 1)[0]
    return j, t


def _prepare_both(j_slab, t_slab, cfg):
    j = lin_ops.prepare_reference(j_slab, camera.intrinsics(*K_TUPLE), cfg)
    t = t_lin.prepare_reference(
        t_slab, t_camera.intrinsics(*K_TUPLE, device="cpu"), _port_cfg(cfg))
    return j, t


def _assert_fields_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)


@pytest.mark.parametrize("n, frac, tile", [
    (76800, 0.25, 2048), (76800, 0.25, 128), (100, 0.01, 128),
    (768, 0.9, 2048), (4096, 1.0, 2048), (4800, 0.5, 128),
    (19200, 0.5, 128), (307200, 0.25, 128), (1, 1.0, 128)])
def test_compact_budget_like_jax(n, frac, tile):
    assert t_lin.compact_budget(n, frac, tile) == lin_ops.compact_budget(
        n, frac, tile)
    assert t_lin._COMPACT_TILE_GATHER == lin_ops._COMPACT_TILE_GATHER


def test_compact_identity_under_budget_like_jax():
    """selected <= budget: exactly the selected points in row-major order,
    the tail replicating the last one, unselected."""
    (i_r, z_r), _, _ = _render()
    j_slab, t_slab = _slabs(i_r, z_r)
    cfg = dataclasses.replace(CFG, point_budget_fraction=0.9)
    j, t = _prepare_both(j_slab, t_slab, cfg)
    full = t_lin.prepare_reference(
        t_slab, t_camera.intrinsics(*K_TUPLE, device="cpu"), _port_cfg(CFG))
    count = int(full.selected.sum())
    budget = t_lin.compact_budget(N, 0.9, t_lin._COMPACT_TILE_GATHER)
    assert 0 < count <= budget and count < N
    assert t.px.shape == (budget,)
    _assert_fields_equal(t, j)
    idx = torch.nonzero(full.selected)[:, 0]
    assert torch.equal(t.selected, torch.arange(budget) < count)
    assert torch.equal(t.px[:count], full.px[idx])
    assert bool((t.i1[count:] == full.i1[idx[-1]]).all())


def test_compact_decimation_like_jax():
    """selected > budget: uniform row-major decimation, every slot real,
    slot j the point of rank ceil(j count / budget)."""
    (i_r, z_r), _, _ = _render()
    j_slab, t_slab = _slabs(i_r, z_r)
    cfg = dataclasses.replace(CFG, intensity_grad_threshold=0.0,
                              point_budget_fraction=0.25)
    j, t = _prepare_both(j_slab, t_slab, cfg)
    _assert_fields_equal(t, j)
    full = t_lin.prepare_reference(
        t_slab, t_camera.intrinsics(*K_TUPLE, device="cpu"),
        _port_cfg(dataclasses.replace(cfg, point_budget_fraction=0.0)))
    sel_idx = torch.nonzero(full.selected)[:, 0]
    count, budget = len(sel_idx), t.px.shape[0]
    assert count > budget and bool(t.selected.all())
    jj = torch.arange(budget)
    expect = sel_idx[(jj * count + budget - 1) // budget]
    assert torch.equal(t.px, full.px[expect])


@pytest.mark.parametrize("tile", [2048, 128])
def test_compact_at_int32_overflow_scale_like_jax(tile):
    """320x240 at budget 0.5: rank * budget passes 2^31, where the JAX
    package needed its split int32 map; the port's int64 slots must equal
    it."""
    n = 76800
    rng = np.random.default_rng(3)
    sel = rng.uniform(size=n) < 0.824
    count = int(sel.sum())
    budget = lin_ops.compact_budget(n, 0.5, tile)
    assert count > budget and count * budget > 2**31
    vals = np.arange(1, n + 1, dtype=np.float32)
    j = lin_ops.compact_reference(lin_ops.RefData(
        *(jnp.asarray(vals) for _ in range(4)), selected=jnp.asarray(sel)),
        budget)
    t = t_lin.compact_reference(t_lin.RefData(
        *(torch.from_numpy(vals) for _ in range(4)),
        selected=torch.from_numpy(sel)), budget)
    _assert_fields_equal(t, j)
    assert bool((t.pz > 0).all())
    sel_idx = np.flatnonzero(sel)
    jj = np.arange(budget, dtype=np.int64)
    np.testing.assert_array_equal(t.pz.numpy(),
                                  vals[sel_idx[-(-jj * count // budget)]])


def test_compact_zero_selected_like_jax():
    (i_r, _), _, _ = _render()
    j_slab, t_slab = _slabs(i_r, np.full((H, W), np.nan, np.float32))
    j, t = _prepare_both(j_slab, t_slab,
                         dataclasses.replace(CFG, point_budget_fraction=0.5))
    _assert_fields_equal(t, j)
    assert not bool(t.selected.any()) and bool(torch.isfinite(t.px).all())


def test_compact_reference_gradients_like_jax():
    (i_r, z_r), _, _ = _render()
    j_slab, t_slab = _slabs(i_r, z_r)
    j, t = _prepare_both(j_slab, t_slab, dataclasses.replace(
        CFG, gradient_source="reference", point_budget_fraction=0.9))
    assert t.gzy is not None
    _assert_fields_equal(t, j)


def test_compact_batched_like_jax():
    """A (B, 6, H, W) batch: every row compacted to the same budget, each
    row equal to the JAX package's compaction of that slab (rows under and
    over the budget, and one with nothing selected)."""
    (i_r, z_r), (i_c, z_c), _ = _render(
        np.array([0.004, -0.003, 0.002, 0.001, -0.001, 0.002]))
    holes = z_r.copy()
    holes[:, : W // 2] = np.nan
    frames = [(i_r, z_r), (i_c, z_c), (i_r, holes),
              (i_r, np.full((H, W), np.nan, np.float32))]
    cfg = dataclasses.replace(CFG, intensity_grad_threshold=0.0,
                              point_budget_fraction=0.6)
    j_rows, t_slabs = [], []
    for i, z in frames:
        j_slab, t_slab = _slabs(i, z)
        j_rows.append(lin_ops.prepare_reference(
            j_slab, camera.intrinsics(*K_TUPLE), cfg))
        t_slabs.append(t_slab)
    t = t_lin.prepare_reference(
        torch.stack(t_slabs), t_camera.intrinsics(*K_TUPLE, device="cpu"),
        _port_cfg(cfg))
    counts = [int(np.asarray(lin_ops.prepare_reference(
        _slabs(i, z)[0], camera.intrinsics(*K_TUPLE),
        dataclasses.replace(cfg, point_budget_fraction=0.0)).selected).sum())
        for i, z in frames]
    budget = t.px.shape[1]
    assert min(counts[:2]) > budget > counts[2] > 0 == counts[3]
    for b, want in enumerate(j_rows):
        _assert_fields_equal(t_lin.RefData(
            *(None if f is None else f[b] for f in t)), want)
        assert t.px[b].is_contiguous() and t.px.is_contiguous()


def test_linearize_under_budget_like_jax():
    """Every selected point kept: the compacted linearization equals the
    JAX package's (and the port's full-grid one) to f32 sum order."""
    ref, cur, _ = _render(np.array([0.004, -0.003, 0.002, 0.001, -0.001,
                                    0.002]))
    j_ref, t_ref = _slabs(*ref)
    j_cur, t_cur = _slabs(*cur)
    cfg = dataclasses.replace(CFG, point_budget_fraction=0.9)
    j, t = _prepare_both(j_ref, t_ref, cfg)
    Kd = camera.intrinsics(*K_TUPLE)
    tK = t_camera.intrinsics(*K_TUPLE, device="cpu")
    want = lin_ops.linearize(j, j_cur, Kd, jnp.eye(4), cfg)
    got = t_lin.linearize(t, t_cur, tK, torch.eye(4), _port_cfg(cfg))
    full = t_lin.linearize(
        t_lin.prepare_reference(t_ref, tK, _port_cfg(CFG)), t_cur, tK,
        torch.eye(4), _port_cfg(CFG))
    for other in (want, full):
        assert int(got.n_raw) == int(np.asarray(other.n_raw)) > 0
        np.testing.assert_allclose(got.sigma.numpy(), np.asarray(other.sigma),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(got.err_mean),
                                   float(np.asarray(other.err_mean)),
                                   rtol=1e-4, atol=1e-5)
        A = np.asarray(other.A)
        np.testing.assert_allclose(got.A.numpy(), A, rtol=2e-4,
                                   atol=2e-4 * np.abs(A).max())
        b = np.asarray(other.b)
        np.testing.assert_allclose(got.b.numpy(), b, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(b).max(), 1e-6))


def _track_both(cfg, xi):
    ref, cur, T_true = _render(xi)
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE), 1)
    want = dense_tracker.track_jit(
        tuple(_slabs(*ref)[:1]), tuple(_slabs(*cur)[:1]), Ks, jnp.eye(4),
        cfg)
    tKs = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), 1)
    got = t_dense_tracker.track(
        (_slabs(*ref)[1],), (_slabs(*cur)[1],), tKs, torch.eye(4),
        _port_cfg(cfg))
    return convert.result_to_numpy(got), want, T_true


@pytest.mark.parametrize("frac, thr", [(0.9, 3.0), (0.25, 0.0)])
def test_track_with_compaction_like_jax(frac, thr):
    """A budget under the selection (0.9 at threshold 3) and a decimating
    one (0.25 of every point): the pose within 5e-5 of the JAX package's,
    the pose recovered, and the statistics that count points from the
    compacted selection."""
    xi = np.array([0.006, -0.004, 0.003, 0.002, -0.001, 0.002])
    cfg = dataclasses.replace(CFG, max_iterations=50,
                              intensity_grad_threshold=thr,
                              point_budget_fraction=frac)
    got, want, T_true = _track_both(cfg, xi)
    np.testing.assert_allclose(got.transformation,
                               np.asarray(want.transformation),
                               atol=POSE_ATOL)
    err = np.linalg.norm(se3_np.log(se3_np.inverse(
        np.asarray(got.transformation, np.float64)) @ T_true))
    assert err < 2e-3
    assert float(got.valid_pixels) == float(np.asarray(want.valid_pixels))
    np.testing.assert_allclose(float(got.valid_ratio),
                               float(np.asarray(want.valid_ratio)), rtol=1e-6)
    budget = t_lin.compact_budget(N, frac, t_lin._COMPACT_TILE_GATHER)
    assert float(got.valid_pixels) <= budget
    if frac < 0.5:
        assert float(got.valid_pixels) < 0.3 * N


def test_keyframe_slam_at_budget_like_jax():
    """One keyframe SLAM run (tests/test_torch_slam.py's 14-frame orbit,
    loop closure on) at point_budget_fraction 0.5 through both packages:
    the same keyframes and graph edges, trajectories within 1e-4."""
    from test_torch_slam import (K_TUPLE as S_K, SLAM, TRACKER, TRAJ_ATOL,
                                 _drive, _edges, _every_second, _frames,
                                 _instrument, _Margins)

    cfg = dataclasses.replace(TRACKER, point_budget_fraction=0.5)
    frames, poses = _frames(14, 0.06)
    margins = _Margins()
    with pytest.MonkeyPatch.context() as mp:
        j_slam = KeyframeSlam(S_K, cfg, SLAM, enable_loop_closure=True)
        _instrument(mp, margins, SLAM, [j_slam])
        _, j_traj = _drive(j_slam, frames, poses, _every_second)
    assert not margins.near(), margins.near()
    t_slam = TKeyframeSlam(
        S_K, _port_cfg(cfg),
        convert.slam_config_from_fields(dataclasses.asdict(SLAM)),
        enable_loop_closure=True, device="cpu")
    _, t_traj = _drive(t_slam, frames, poses, _every_second)
    assert ([k.idx for k in t_slam.keyframes]
            == [k.idx for k in j_slam.keyframes])
    assert _edges(t_slam) == _edges(j_slam)
    assert t_slam.num_loop_edges == j_slam.num_loop_edges >= 1
    for a, b in zip(t_traj, j_traj):
        np.testing.assert_allclose(a, b, atol=TRAJ_ATOL)
    assert evaluate.ate_rmse(t_traj, poses) < 5e-3


def test_budget_changes_nothing_without_it():
    """point_budget_fraction 0 leaves prepare_reference's full grid (and
    row_offset 0 its coordinates) exactly as before."""
    (i_r, z_r), _, _ = _render()
    _, t_slab = _slabs(i_r, z_r)
    tK = t_camera.intrinsics(*K_TUPLE, device="cpu")
    a = t_lin.prepare_reference(t_slab, tK, _port_cfg(CFG))
    b = t_lin.prepare_reference(t_slab, tK, _port_cfg(CFG), row_offset=0)
    assert a.px.shape == (N,)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.equal(x, y)
    # A shard's rows: row_offset moves py, the back-projected row.
    c = t_lin.prepare_reference(t_slab[:, 8:16], tK, _port_cfg(CFG),
                                row_offset=8)
    assert torch.equal(c.py, a.py[8 * W:16 * W])
    assert torch.equal(c.selected, a.selected[8 * W:16 * W])

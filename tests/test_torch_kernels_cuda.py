"""The port's CUDA kernels and main path on a CUDA card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one:
a CUDA kernel has no CPU mode. This file imports no JAX, so it also runs
where JAX is not installed; there, skip tests/conftest.py (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the sampler kernel is bit-identical to its plain version by
construction (no FMA contraction) and is held to 1e-5 * max|slab|. The
cluster kernel's mode (a) (csrc/linearize.cu, one linearization per row)
against ``linearize_reference`` on the same card tensors: ``n_raw``, the
per-point valid mask and rI, rZ exact (the residual pass repeats the plain
arithmetic with _rn intrinsics); A and b within 1e-4 * max|.|; sigma,
err_mean, log1p_sum and err_raw rtol 1e-4 (sums over <= 76 800 points in
another order: the kernel sums in f64, the plain version in f32). The
tracker on the card is held to the same tracker on the CPU at 1e-4 on the
transformation (f32 reductions in another order).

Mode (a) over a batch (one launch over B rows, shared or per-row current
slabs): every row's rI, rZ and valid bit-identical to its plain version,
A and b within 1e-4 * max|.|, and every row bit-identical to a B = 1 call
on that row's inputs (a row's arithmetic does not depend on B), the B = 1
call bit-identical to the single-pair entry point, and 20 repeated B = 8
calls identical (fixed-order cluster sums).

Mode (b) (a level's whole IRLS loop in one launch) against its plain
version, the host loop ``_track_level`` over
``linearize_batched_reference``, on a noise-free 640x480 orbit: T within
1e-5 on every row. A row on which both take the same accept decisions
and iteration count: termination codes and valid counts equal, errors
rtol 1e-4, increment norms within 1e-5, the final A within 1e-4 *
max|A|; the final b, the gradient, by the step it asks for:
||A^-1 (b - b_host)|| <= cfg.precision (at the optimum b is f32
evaluation noise: residuals of ~1e-3 rounded to ~1e-5 each, so two poses
1e-8 apart give gradients as far apart as the gradient itself, while
the plain version's own b is ~1e-7 of a step from an f64 evaluation);
and without the Sigma warm start the final A and b so close to the plain
linearization at the kernel's own pose. Gauss-Newton stops where a step
raises the error at the f32 noise floor, and the kernel's f64 sums and
the plain version's f32 sums decide such a comparison differently: a
row's paths may part at such a tie (the step's error within 1e-5 of the
best, or an increment norm within a factor 2 of the precision), on at
most one row or a quarter of a batch, and its pose still within 1e-5.

The pose-graph kernel (csrc/pose_graph.cu, one launch per dense solve)
against its plain version, the host loop ``optimize_reference`` on the
same card (cuSOLVER's Cholesky): poses within 1e-4, the final chi2 within
rtol 1e-4 (atol 1e-6: a consistent graph's chi2 is f32 rounding noise);
the weights within 1e-4 of the plain formula's at the kernel's own poses
(a loop edge's Cauchy weight moves ~1e-3 for a 2e-6 pose change, so the
two routes' weights are not held to each other). The two factor and sum
in different orders (the
kernel's own Cholesky and fixed-order sums against cuSOLVER and torch's
reductions), and their f32 steps differ with the system's conditioning:
near the optimum the two routes' trials at one step move the chi2 by
amounts up to ~7.5e-5 relative apart (seen on the card: a window graph
whose trials at step 1 moved it by -1.3e-5 and +6.2e-5). Once a solve
comes that close to its optimum, each accept test compares two chi2
within that noise and the stop test (|delta| < 1e-8) a step norm at
the f32 noise of the residuals (~1e-7), so the two routes may take
different decisions there and stop at different steps. Both routes
record each step's chi2, trial chi2, step norm and accept flag
(LAST_STATS): the runs must take the same decisions up to their first
parting step, and at that step neither run's trial may move the chi2 by
more than 1e-4 relative (atol 1e-6), the final chi2's tolerance: a
parting on a trial that moves it more fails the test.
"""

import numpy as np
import pytest
import torch

import dataclasses

from dvo_slam_tpu_torch import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker, pose_graph
from dvo_slam_tpu_torch.ops import camera, linearize, pyramid, sampler
from dvo_slam_tpu_torch.utils import se3_np, synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _slab(seed, shape, n_nan):
    rng = np.random.default_rng(seed)
    slab = (rng.normal(size=shape) * 50.0).astype(np.float32)
    c, h, w = shape
    for _ in range(n_nan):
        slab[rng.integers(c), rng.integers(h), rng.integers(w)] = np.nan
    return slab


def _points(h, w, max_shift=6.0):
    """Warped grid plus NaN, +-1e9, infinities and exact-edge points."""
    vg, ug = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    k = np.arange(h * w)
    u = ug.reshape(-1) + max_shift * np.sin(k / 300.0)
    v = vg.reshape(-1) + max_shift * np.cos(k / 400.0)
    su = [np.nan, 5.5, 1e9, -1e9, 5.5, 5.5, np.inf, -np.inf,
          w - 2, w - 2 + 0.75, w - 1, 0.0, -0.25, -1.0, 3.25, np.nan]
    sv = [3.5, np.nan, 3.5, 3.5, 1e9, -1e9, 3.5, 3.5,
          h - 2, h - 2 + 0.5, 2.0, h - 2, 4.0, 4.0, h - 1, np.nan]
    return (np.concatenate([u, su]).astype(np.float32),
            np.concatenate([v, sv]).astype(np.float32))


@pytest.mark.parametrize("level_hw", [(60, 80), (120, 160), (240, 320)])
def test_kernel_matches_plain(cuda, level_hw):
    """At the 640x480 tracked-level shapes, for 6, 2 and 1 channels."""
    h, w = level_hw
    slab = torch.from_numpy(_slab(4, (6, h, w), n_nan=50)).to(cuda)
    u, v = (torch.from_numpy(a).to(cuda) for a in _points(h, w))
    scale = slab.nan_to_num().abs().max().item()
    for channels in (6, 2, 1):
        before = sampler.LAUNCHES
        out, inb = sampler.sample_slab(slab[:channels], u, v)
        torch.cuda.synchronize()
        assert sampler.LAUNCHES == before + 1
        want, want_inb = sampler.sample_slab_reference(slab[:channels], u, v)
        assert out.shape == (channels, u.numel()) and inb.dtype == torch.bool
        assert torch.equal(inb, want_inb)
        assert torch.equal(torch.isnan(out), torch.isnan(want))
        fin = torch.isfinite(want)
        assert (out[fin] - want[fin]).abs().max().item() <= 1e-5 * scale


def test_kernel_on_a_card_that_is_not_current(cuda):
    """Tensors on card 1 while card 0 is current: the wrapper launches on
    the tensors' card and leaves the current card as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    h, w = 120, 160
    slab = torch.from_numpy(_slab(5, (6, h, w), n_nan=20)).to(second)
    u, v = (torch.from_numpy(a).to(second) for a in _points(h, w))
    scale = slab.nan_to_num().abs().max().item()
    with torch.cuda.device(cuda):
        out, inb = sampler.sample_slab(slab, u, v)
        assert torch.cuda.current_device() == cuda.index
    torch.cuda.synchronize(second)
    want, want_inb = sampler.sample_slab_reference(slab, u, v)
    assert out.device == second and torch.equal(inb, want_inb)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    fin = torch.isfinite(want)
    assert (out[fin] - want[fin]).abs().max().item() <= 1e-5 * scale


def test_track_on_card_matches_cpu(cuda):
    """The whole tracker on the card (the level kernel) against
    the same code on the CPU (plain version), at 80x60 with three
    levels."""
    W, H = 80, 60
    K_t = (40.0, 40.0, (W - 1) / 2.0, (H - 1) / 2.0)
    cfg = TrackerConfig(num_levels=3, first_level=2, last_level=0)
    T_rel = se3_np.exp(np.array([0.02, -0.015, 0.01, 0.01, -0.008, 0.012]))
    scene = synthetic.two_plane_scene()
    ref = scene.render(np.asarray(K_t), W, H, np.eye(4))
    cur = scene.render(np.asarray(K_t), W, H, se3_np.inverse(T_rel))
    results = {}
    for dev in (torch.device("cpu"), cuda):
        Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_t, device=dev), 3)
        pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                      torch.as_tensor(z, device=dev), 3)
                for i, z in (ref, cur)]
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        before = (sampler.LAUNCHES, linearize.LAUNCHES_LINEARIZE,
                  linearize.LAUNCHES_TRACK_LEVEL)
        res = dense_tracker.track(pyrs[0], pyrs[1], Ks, T0, cfg)
        levels = len(cfg.tracked_levels) if dev.type == "cuda" else 0
        # The main path runs one level-kernel launch per tracked level,
        # never mode (a) alone or the standalone sampler.
        assert (sampler.LAUNCHES - before[0],
                linearize.LAUNCHES_LINEARIZE - before[1],
                linearize.LAUNCHES_TRACK_LEVEL - before[2]) == (0, 0, levels)
        results[dev.type] = res
    got, want = results["cuda"], results["cpu"]
    np.testing.assert_allclose(got.transformation.cpu().numpy(),
                               want.transformation.numpy(), atol=1e-4)
    assert (got.iterations.cpu() - want.iterations).abs().max() <= 1
    assert not bool(got.is_nan().item())
    err = np.linalg.norm(se3_np.log(
        se3_np.inverse(got.transformation.cpu().double().numpy()) @ T_rel))
    assert err < 2e-3


# ---- mode (a) of csrc/linearize.cu (one linearization) against plain

W640, H640 = 640, 480
K640 = (525.0, 525.0, (W640 - 1) / 2.0, (H640 - 1) / 2.0)
FUSED_CONFIGS = {
    "tdist": {},
    "photometric": {"use_depth": False},
    "reference_gradients": {"gradient_source": "reference"},
    "tdist_warm": {"tdist_scale_warm_iters": 2},
}


@pytest.fixture(scope="module")
def pair640():
    """A noisy 640x480 pair of the synthetic orbit (numpy) and the
    reference -> current pose, perturbed off the optimum."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(24, radius=0.06)
    rng = np.random.default_rng(0)
    frames = [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K640), W640, H640, T), rng, dropout=0.02)
        for T in poses[:2]]
    T_rel = se3_np.inverse(poses[1]) @ poses[0]
    T = T_rel @ se3_np.exp(np.array([2e-3, -1e-3, 1e-3, 1e-3, 2e-3, -1e-3]))
    return frames, T.astype(np.float32)


def _level_inputs(frames, T, cfg, level, dev):
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=dev),
                                   cfg.num_levels)
    ref_pyr, cur_pyr = (
        pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                              torch.as_tensor(z, device=dev), cfg.num_levels)
        for i, z in frames)
    ref = linearize.prepare_reference(ref_pyr[level], Ks[level], cfg)
    return ref, cur_pyr[level], Ks[level], torch.as_tensor(T, device=dev)


SIGMA0 = [[40.0, 0.01], [0.01, 1e-3]]


def _assert_fused_matches_plain(ref, slab, K, T, cfg, sigma_warm=True):
    sigma0 = torch.tensor(SIGMA0, device=slab.device)
    got = linearize.linearize(ref, slab, K, T, cfg, sigma_init=sigma0,
                              sigma_warm=sigma_warm)
    N = ref.px.numel()
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(slab.device, N))
    want = linearize.linearize_reference(ref, slab, K, T, cfg,
                                         sigma_init=sigma0,
                                         sigma_warm=sigma_warm)
    res = linearize.residuals_reference(ref, slab, K, T, cfg)
    torch.cuda.synchronize()
    assert torch.equal(valid, res.valid)
    assert torch.equal(rI, res.rI) and torch.equal(rZ, res.rZ)
    assert float(got.n_raw) == float(want.n_raw) == float(valid.sum())
    assert float(got.n_valid) == float(want.n_valid)
    for field in ("A", "b"):
        a, b = getattr(got, field), getattr(want, field)
        assert torch.isfinite(a).all(), field
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-4 * scale, field
    assert torch.equal(got.A, got.A.T)
    for field in ("sigma", "err_mean", "log1p_sum", "err_raw"):
        np.testing.assert_allclose(getattr(got, field).cpu().numpy(),
                                   getattr(want, field).cpu().numpy(),
                                   rtol=1e-4, atol=1e-30, err_msg=field)
    return got, want


@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("name", sorted(FUSED_CONFIGS))
def test_fused_linearize_matches_plain(cuda, pair640, name, level):
    cfg = TrackerConfig(**FUSED_CONFIGS[name])
    frames, T = pair640
    ref, slab, K, Tt = _level_inputs(frames, T, cfg, level, cuda)
    before = (linearize.LAUNCHES_LINEARIZE, linearize.LAUNCHES_TRACK_LEVEL,
              sampler.LAUNCHES)
    got, _ = _assert_fused_matches_plain(ref, slab, K, Tt, cfg)
    assert (linearize.LAUNCHES_LINEARIZE - before[0],
            linearize.LAUNCHES_TRACK_LEVEL - before[1],
            sampler.LAUNCHES - before[2]) == (1, 0, 0)
    assert float(got.n_raw) > 0.5 * ref.px.numel()
    if name == "tdist_warm":
        # The cold start (sigma_warm False) too.
        _assert_fused_matches_plain(ref, slab, K, Tt, cfg, sigma_warm=False)


def test_fused_linearize_is_deterministic(cuda, pair640):
    cfg = TrackerConfig()
    frames, T = pair640
    ref, slab, K, Tt = _level_inputs(frames, T, cfg, 1, cuda)
    runs = [linearize.linearize(ref, slab, K, Tt, cfg) for _ in range(3)]
    for other in runs[1:]:
        for field, a, b in zip(runs[0]._fields, runs[0], other):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), field


def test_fused_linearize_edge_cases(cuda, pair640):
    """All-NaN current depth, no selected reference point, and points
    behind the camera, each against the plain version."""
    cfg = TrackerConfig()
    (ref_f, cur_f), T = pair640
    level = 2
    nan_depth = np.full_like(cur_f[1], np.nan)
    ref, slab, K, Tt = _level_inputs((ref_f, (cur_f[0], nan_depth)), T,
                                     cfg, level, cuda)
    got, _ = _assert_fused_matches_plain(ref, slab, K, Tt, cfg)
    assert float(got.n_raw) == 0.0 and float(got.n_valid) == 1.0

    ref, slab, K, Tt = _level_inputs(((ref_f[0], np.full_like(ref_f[1],
                                                              np.nan)),
                                      cur_f), T, cfg, level, cuda)
    assert not bool(ref.selected.any())
    got, _ = _assert_fused_matches_plain(ref, slab, K, Tt, cfg)
    assert float(got.n_raw) == 0.0 and float(got.n_valid) == 1.0
    assert not bool(got.A.any()) and not bool(got.b.any())

    # Move the camera forward by the median depth: the nearer half of the
    # points ends up behind it.
    ref, slab, K, _ = _level_inputs((ref_f, cur_f), T, cfg, level, cuda)
    T_behind = T.copy()
    T_behind[2, 3] -= ref.pz[ref.selected].median().item()
    Tt = torch.as_tensor(T_behind, device=cuda)
    Z = linearize.warp(ref, K, Tt)[2]
    assert bool(((Z < 0) & ref.selected).any())
    assert bool(((Z > 0) & ref.selected).any())
    _assert_fused_matches_plain(ref, slab, K, Tt, cfg)


def test_fused_linearize_on_a_card_that_is_not_current(cuda, pair640):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    cfg = TrackerConfig()
    frames, T = pair640
    ref, slab, K, Tt = _level_inputs(frames, T, cfg, 2, second)
    with torch.cuda.device(cuda):
        got = linearize.linearize(ref, slab, K, Tt, cfg)
        assert torch.cuda.current_device() == cuda.index
    want = linearize.linearize_reference(ref, slab, K, Tt, cfg)
    torch.cuda.synchronize(second)
    assert got.A.device == second
    assert float(got.n_raw) == float(want.n_raw)
    assert (got.A - want.A).abs().max().item() <= \
        1e-4 * want.A.abs().max().item()


def test_plain_only_config_stays_plain_on_the_card(cuda, pair640):
    """Off the cluster kernel's route the plain linearization still
    gathers with the sampler kernel: one launch per call, no other."""
    cfg = dataclasses.replace(TrackerConfig(), scale_estimator="mad",
                              influence="huber")
    frames, T = pair640
    ref, slab, K, Tt = _level_inputs(frames, T, cfg, 3, cuda)
    before = (linearize.LAUNCHES_LINEARIZE, linearize.LAUNCHES_TRACK_LEVEL,
              sampler.LAUNCHES)
    for calls in (1, 2):
        got = linearize.linearize(ref, slab, K, Tt, cfg)
        assert (linearize.LAUNCHES_LINEARIZE - before[0],
                linearize.LAUNCHES_TRACK_LEVEL - before[1],
                sampler.LAUNCHES - before[2]) == (0, 0, calls)
    want = linearize.linearize_reference(ref, slab, K, Tt, cfg)
    assert sampler.LAUNCHES - before[2] == 2
    for field, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(torch.as_tensor(a).cpu().numpy(),
                                   torch.as_tensor(b).cpu().numpy(),
                                   rtol=1e-6, err_msg=field)


# ---- the batched kernels (grid (blocks, B)) against their plain version

def _batch_inputs(dev, B, paired, level=2):
    """B reference rows from the first B frames of a noisy 640x480 orbit,
    each at its own perturbed pose, and the current slab: frame B (shared)
    or frames 1..B (one per row)."""
    cfg = TrackerConfig()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(24, radius=0.06)
    rng = np.random.default_rng(1)
    frames = [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K640), W640, H640, poses[k]), rng,
        dropout=0.02) for k in range(B + 1)]
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=dev),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                  torch.as_tensor(z, device=dev),
                                  cfg.num_levels)[level] for i, z in frames]
    ref_slabs = torch.stack(pyrs[:B])
    cur = torch.stack(pyrs[1:B + 1]) if paired else pyrs[B]
    T = []
    for b in range(B):
        target = (se3_np.inverse(poses[b + 1]) if paired
                  else se3_np.inverse(poses[B])) @ poses[b]
        xi = rng.normal(scale=2e-3, size=6)
        T.append(target @ se3_np.exp(xi))
    T = torch.as_tensor(np.stack(T), dtype=torch.float32, device=dev)
    # Per-row Sigma seeds; row 1's is NaN, so its device state takes the
    # cold start while the others warm-start.
    sigma = torch.tensor([[[40.0 + b, 0.01], [0.01, 1e-3]]
                          for b in range(B)], device=dev)
    if B > 1:
        sigma[1] = float("nan")
    ref = linearize.prepare_reference(ref_slabs, Ks[level], cfg)
    return ref, cur, Ks[level], T, sigma


def _row_ref(ref, b):
    return linearize.RefData(*(None if f is None else f[b].contiguous()
                               for f in ref))


def _one_row(ref, cur, K, T, sigma, b, cfg, warm):
    """A B = 1 kernel call on row b's inputs."""
    slab = cur[b] if cur.dim() == 4 else cur
    ref_b = linearize.RefData(*(None if f is None else f[b:b + 1]
                                for f in ref))
    return linearize.linearize_kernels_batched(
        ref_b, slab, K, T[b:b + 1], cfg, sigma[b:b + 1], warm)


@pytest.mark.parametrize("paired", [False, True], ids=["shared", "paired"])
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("name", ["tdist", "tdist_warm"])
def test_batched_linearize_matches_plain(cuda, name, B, paired):
    cfg = TrackerConfig(**FUSED_CONFIGS[name])
    warm = True
    ref, cur, K, T, sigma = _batch_inputs(cuda, B, paired)
    N = ref.px.shape[1]
    by_b = linearize.LAUNCHES_BY_BATCH
    before = (linearize.LAUNCHES_LINEARIZE, by_b.get(("linearize", B), 0))
    got = linearize.linearize_batched(ref, cur, K, T, cfg, sigma, warm)
    assert (linearize.LAUNCHES_LINEARIZE - before[0],
            by_b[("linearize", B)] - before[1]) == (1, 1)
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(cuda, N, B))
    assert got.A.shape == (B, 6, 6) and got.sigma.shape == (B, 2, 2)
    for b in range(B):
        slab = cur[b] if paired else cur
        ref_b = _row_ref(ref, b)
        res = linearize.residuals_reference(ref_b, slab, K, T[b], cfg)
        want = linearize.linearize_reference(ref_b, slab, K, T[b], cfg,
                                             sigma[b], warm)
        assert torch.equal(valid[b], res.valid), b
        assert torch.equal(rI[b], res.rI) and torch.equal(rZ[b], res.rZ), b
        assert float(got.n_raw[b]) == float(want.n_raw) > 0.5 * N
        for field in ("A", "b"):
            a, w = getattr(got, field)[b], getattr(want, field)
            scale = w.abs().max().item()
            assert (a - w).abs().max().item() <= 1e-4 * scale, (field, b)
        for field in ("sigma", "err_mean", "log1p_sum", "err_raw"):
            np.testing.assert_allclose(
                getattr(got, field)[b].cpu().numpy(),
                getattr(want, field).cpu().numpy(), rtol=1e-4,
                err_msg=f"{field} row {b}")
        # A row's bits do not depend on the batch around it.
        one = _one_row(ref, cur, K, T, sigma, b, cfg, warm)
        for field, x, y in zip(got._fields, got[:-1], one[:-1]):
            assert torch.equal(x[b], y[0]), (field, b)
    if B == 1:
        single = linearize.linearize(_row_ref(ref, 0), cur[0]
                                     if paired else cur, K, T[0], cfg,
                                     sigma[0], warm)
        for field, x, y in zip(got._fields, got[:-1], single[:-1]):
            assert torch.equal(x[0], y), field


def test_batched_linearize_is_deterministic(cuda):
    """20 repeated B = 8 calls: each row's cluster sums in a fixed order,
    under whatever order the card schedules the clusters in."""
    cfg = TrackerConfig()
    ref, cur, K, T, sigma = _batch_inputs(cuda, 8, paired=True)
    first = linearize.linearize_batched(ref, cur, K, T, cfg, sigma, True)
    first = [x.clone() for x in first[:-1]]
    for _ in range(20):
        again = linearize.linearize_batched(ref, cur, K, T, cfg, sigma, True)
        for field, x, y in zip(again._fields, first, again[:-1]):
            assert torch.equal(x, y), field


def test_track_batched_on_card_matches_cpu(cuda):
    """The batched tracker on the card (the level kernel) against the
    same code on the CPU, with one row of all-NaN reference depth that
    stops at its first iteration while the others go on."""
    W, H = 80, 60
    K_t = (40.0, 40.0, (W - 1) / 2.0, (H - 1) / 2.0)
    cfg = TrackerConfig(num_levels=3, first_level=2, last_level=0)
    scene = synthetic.two_plane_scene()
    poses = synthetic.orbit_trajectory(6, radius=0.05)
    frames = synthetic.render_sequence(scene, np.asarray(K_t), W, H, poses)
    frames[2] = (frames[2][0], np.full_like(frames[2][1], np.nan))
    results = {}
    for dev in (torch.device("cpu"), cuda):
        Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_t, device=dev), 3)
        pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                      torch.as_tensor(z, device=dev), 3)
                for i, z in frames]
        refs = tuple(torch.stack([p[lvl] for p in pyrs[:4]])
                     for lvl in range(3))
        T0 = torch.eye(4, dtype=torch.float32, device=dev).repeat(4, 1, 1)
        before = linearize.LAUNCHES_BY_BATCH.get(("track_level", 4), 0)
        res = dense_tracker.track_batched(refs, pyrs[5], Ks, T0, cfg)
        if dev.type == "cuda":
            # One launch over the 4 rows per tracked level.
            assert linearize.LAUNCHES_BY_BATCH[("track_level", 4)] - before \
                == len(cfg.tracked_levels)
        results[dev.type] = res
    got, want = results["cuda"], results["cpu"]
    np.testing.assert_allclose(got.transformation.cpu().numpy(),
                               want.transformation.numpy(), atol=1e-4)
    assert (got.iterations.cpu() - want.iterations).abs().max() <= 1
    assert got.iterations[2].tolist() == [1, 1, 1]
    assert float(got.valid_pixels[2]) == 0.0
    assert not bool(got.is_nan().any())


# ---- mode (b): a level's IRLS loop in one launch, against the host loop

LEVEL_CONFIGS = {
    "gn": {},
    "gn_warm": {"tdist_scale_warm_iters": 2},
    "lm": {"lm_lambda_init": 1e-4},
    "lm_warm": {"lm_lambda_init": 1e-4, "tdist_scale_warm_iters": 2},
}


@pytest.fixture(scope="module")
def orbit640():
    """Nine noise-free 640x480 frames of the synthetic orbit and their
    poses."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(24, radius=0.06)[:9]
    return synthetic.render_sequence(scene, np.asarray(K640), W640, H640,
                                     poses), poses


def _level_batch(orbit, dev, B, paired, level, cfg):
    """B rows of the orbit at one level: references 0..B-1 against frame B
    (shared) or frames 1..B (paired), each from a perturbed pose."""
    frames, poses = orbit
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=dev),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                  torch.as_tensor(z, device=dev),
                                  cfg.num_levels)[level]
            for i, z in frames[:B + 1]]
    cur = torch.stack(pyrs[1:B + 1]) if paired else pyrs[B]
    rng = np.random.default_rng(2)
    T = np.stack([(se3_np.inverse(poses[b + 1] if paired else poses[B])
                   @ poses[b]) @ se3_np.exp(rng.normal(scale=3e-3, size=6))
                  for b in range(B)])
    ref = linearize.prepare_reference(torch.stack(pyrs[:B]), Ks[level], cfg)
    return ref, cur, Ks[level], torch.as_tensor(T, dtype=torch.float32,
                                                device=dev)


def _parted(acc, acc_h, err, err_h, dn, dn_h, n, n_h, precision):
    """Where two IRLS paths of one row part, and whether at a tie: None if
    they take the same accept decisions and iteration count; else (k,
    tie). At an accept decision k: a tie if the step's error is within
    1e-5 (relative) of the best error before it on either side. At a stop
    (same decisions, other counts): a tie if the last common increment
    norm is within a factor 2 of the precision on either side."""
    for k in range(min(n, n_h)):
        if acc[k] != acc_h[k]:
            j = max(i for i in range(k) if acc[i])
            return k, any(abs(e[k] - e[j]) <= 1e-5 * abs(e[j])
                          for e in (err, err_h))
    if n == n_h:
        return None
    k = min(n, n_h) - 1
    return k, any(0.5 * precision <= d[k] <= 2.0 * precision
                  for d in (dn, dn_h))


def _step_apart(lin, lin_ref, b):
    """Norm of the Gauss-Newton step by which row b's gradient differs
    from the reference's, ||A_ref^-1 (b - b_ref)||. At the optimum b is
    f32 evaluation noise (residuals of ~1e-3 rounded to ~1e-5 each): two
    poses 1e-8 apart give gradients that differ as much as the gradient,
    but the steps they ask for differ by ~1e-7, below the precision the
    loop stops at."""
    A = lin_ref.A[b].double().cpu().numpy()
    d = (lin.b[b] - lin_ref.b[b]).double().cpu().numpy()
    return float(np.linalg.norm(np.linalg.solve(A, d)))


def _assert_level_matches_host_loop(ref, cur, K, T0, cfg):
    """Mode (b) against the plain host loop on the same rows; returns the
    kernel's stats and the rows whose paths part (at a tie)."""
    before = (linearize.LAUNCHES_TRACK_LEVEL, linearize.LAUNCHES_LINEARIZE,
              sampler.LAUNCHES)
    T, fin, stats = dense_tracker.track_level(ref, cur, K, T0, cfg)
    assert (linearize.LAUNCHES_TRACK_LEVEL - before[0],
            linearize.LAUNCHES_LINEARIZE - before[1],
            sampler.LAUNCHES - before[2]) == (1, 0, 0)
    T_h, fin_h, stats_h = dense_tracker._track_level(
        ref, cur, K, T0, cfg, linearize=linearize.linearize_batched_reference)
    torch.cuda.synchronize()
    assert (T - T_h).abs().max().item() <= 1e-5
    (valid, err, dn, acc, term, its), (valid_h, err_h, dn_h, acc_h, term_h,
                                        its_h) = (
        [x.cpu().numpy() for x in (*s["per_iter"], s["iterations"])]
        for s in (stats, stats_h))
    if cfg.tdist_scale_warm_iters == 0:
        # The record is the linearization at the level's pose (cold Sigma).
        want = linearize.linearize_batched_reference(ref, cur, K, T, cfg)
    parted = []
    for b in range(T.shape[0]):
        part = _parted(acc[b], acc_h[b], err[b], err_h[b], dn[b], dn_h[b],
                       its[b], its_h[b], cfg.precision)
        if part is not None:
            assert part[1], (b, part, err[b], err_h[b])
            parted.append(b)
            continue
        assert term[b] == term_h[b] and (valid[b] == valid_h[b]).all(), b
        np.testing.assert_allclose(err[b], err_h[b], rtol=1e-4, atol=0.0)
        np.testing.assert_allclose(dn[b], dn_h[b], rtol=0.0, atol=1e-5)
        assert float(fin.n_raw[b]) == float(fin_h.n_raw[b])
        if float(fin_h.n_raw[b]) < 6:
            # Too few constraints: the record's A and b are (near) empty.
            assert torch.equal(fin.A[b], fin_h.A[b]), b
            assert torch.equal(fin.b[b], fin_h.b[b]), b
            continue
        A_h = fin_h.A[b].double().cpu().numpy()
        scale = max(np.abs(A_h).max(), 1e-30)
        assert np.abs(fin.A[b].double().cpu().numpy() - A_h).max() \
            <= 1e-4 * scale, b
        assert _step_apart(fin, fin_h, b) <= cfg.precision, b
        if cfg.tdist_scale_warm_iters == 0:
            assert float(fin.n_raw[b]) == float(want.n_raw[b])
            a, w = fin.A[b], want.A[b]
            assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()
            assert _step_apart(fin, want, b) <= cfg.precision, b
    return stats, parted


@pytest.mark.parametrize("rows", ["B1", "B2_shared", "B2_paired",
                                  "B8_shared", "B8_paired"])
@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("name", sorted(LEVEL_CONFIGS))
def test_track_level_kernel_matches_host_loop(cuda, orbit640, name, level,
                                              rows):
    cfg = TrackerConfig(**LEVEL_CONFIGS[name])
    B, paired = int(rows[1]), rows.endswith("paired")
    ref, cur, K, T0 = _level_batch(orbit640, cuda, B, paired, level, cfg)
    stats, parted = _assert_level_matches_host_loop(ref, cur, K, T0, cfg)
    assert (stats["iterations"] >= 2).all()
    # At most one row or a quarter of the batch may part from the host
    # loop's path, and only at a tie.
    assert len(parted) <= max(1, B // 4), parted


def test_track_level_kernel_without_shared_points(cuda, orbit640):
    """Level 0 at 640x480 (307 200 points): the points do not fit in
    shared memory, so every pass recomputes them; both modes still match
    their plain versions."""
    cfg = TrackerConfig(last_level=0, max_iterations=6)
    ref, cur, K, T0 = _level_batch(orbit640, cuda, 1, False, 0, cfg)
    C, P, stored, smem = linearize.level_plan(cuda, ref.px.shape[1])
    assert (C, P, stored, smem) == (16, 19200, False, 0)
    _assert_level_matches_host_loop(ref, cur, K, T0, cfg)
    row = linearize.RefData(*(None if f is None else f[0] for f in ref))
    _assert_fused_matches_plain(row, cur, K, T0[0], cfg)


def test_track_level_kernel_is_deterministic(cuda, orbit640):
    """20 repeated B = 8 level launches give the same bits."""
    cfg = TrackerConfig(lm_lambda_init=1e-4)
    ref, cur, K, T0 = _level_batch(orbit640, cuda, 8, True, 1, cfg)
    first = [t.clone() for t in
             linearize.track_level_kernels(ref, cur, K, T0, cfg)]
    for _ in range(20):
        again = linearize.track_level_kernels(ref, cur, K, T0, cfg)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_level_kernel_rows_stop_apart(cuda, orbit640):
    """A row with all-NaN reference depth stops at its first iteration
    with too few constraints, one launch for all rows; the others go on."""
    cfg = TrackerConfig()
    frames, poses = orbit640
    nan_ref = [frames[0], (frames[1][0], np.full_like(frames[1][1], np.nan)),
               *frames[2:]]
    ref, cur, K, T0 = _level_batch((nan_ref, poses), cuda, 2, False, 2, cfg)
    stats, _ = _assert_level_matches_host_loop(ref, cur, K, T0, cfg)
    assert stats["iterations"].tolist()[1] == 1
    assert int(stats["per_iter"][4][1]) == \
        dense_tracker.TERM_TOO_FEW_CONSTRAINTS
    assert int(stats["iterations"][0]) > 1


def test_track_level_on_a_card_that_is_not_current(cuda, orbit640):
    """Mode (b) on tensors on card 1 while card 0 is current: the cluster
    attributes and the occupancy check are per card, and the launch runs
    on the tensors' card and leaves the current card as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    cfg = TrackerConfig()
    ref, cur, K, T0 = _level_batch(orbit640, second, 2, False, 1, cfg)
    with torch.cuda.device(cuda):
        T, fin, stats = dense_tracker.track_level(ref, cur, K, T0, cfg)
        assert torch.cuda.current_device() == cuda.index
    T_h, _, stats_h = dense_tracker._track_level(
        ref, cur, K, T0, cfg, linearize=linearize.linearize_batched_reference)
    torch.cuda.synchronize(second)
    assert T.device == second and fin.A.device == second
    assert (T - T_h).abs().max().item() <= 1e-5
    assert torch.equal(stats["iterations"], stats_h["iterations"])


def test_refused_launch_raises(cuda, orbit640, monkeypatch):
    """A launch the card refuses (here a cluster of 32 CTAs, past the
    limit of 16) raises with the CUDA error; nothing falls back."""
    cfg = TrackerConfig()
    ref, cur, K, T0 = _level_batch(orbit640, cuda, 1, False, 3, cfg)
    monkeypatch.setattr(linearize, "cluster_size", lambda N: 32)
    before = linearize.LAUNCHES_TRACK_LEVEL
    with pytest.raises(RuntimeError, match="dvo_track_level failed"):
        dense_tracker.track_level(ref, cur, K, T0, cfg)
    with pytest.raises(RuntimeError, match="dvo_linearize failed"):
        linearize.linearize_batched(ref, cur, K, T0, cfg)
    assert linearize.LAUNCHES_TRACK_LEVEL == before


# --- the device-resident keyframe scan, the chunked engine, and two SLAM
# paths the main path seldom reaches (validation batches of 16 and 32,
# keyframe pyramids evicted past resident_keyframes) ---

def _ring640(n):
    """The first n frames of the 8-frame 640x480 ring of chip_smoke's SLAM
    phase, repeated."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(9, radius=0.06)[:8]
    frames = synthetic.render_sequence(scene, np.asarray(K640), W640, H640,
                                       poses)
    return [frames[k % 8] for k in range(n)], [poses[k % 8] for k in range(n)]


def test_keyframe_scan_on_card_matches_host_loop(cuda, monkeypatch):
    """The scan on the card (one level-kernel launch per tracked level and
    frame) against the same scan through the tracker's host loop over the
    plain linearization: the same switch frames, poses within 1e-4."""
    from functools import partial

    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models import keyframe_scan

    frames, _ = _ring640(12)
    ii = torch.as_tensor(np.stack([f[0] for f in frames]), device=cuda)
    zz = torch.as_tensor(np.stack([f[1] for f in frames]), device=cuda)
    force = torch.zeros(12, dtype=torch.bool, device=cuda)
    force[6] = True
    K = camera.intrinsics(*K640, device=cuda)
    cfg, slam_cfg = TrackerConfig(), SlamConfig()
    before = linearize.LAUNCHES_TRACK_LEVEL
    got = keyframe_scan.track_keyframe_sequence(ii, zz, K, cfg, slam_cfg,
                                                force_keyframe=force)
    assert linearize.LAUNCHES_TRACK_LEVEL - before == \
        11 * len(cfg.tracked_levels)
    monkeypatch.setattr(dense_tracker, "track_level", partial(
        dense_tracker._track_level,
        linearize=linearize.linearize_batched_reference))
    want = keyframe_scan.track_keyframe_sequence(ii, zz, K, cfg, slam_cfg,
                                                 force_keyframe=force)
    assert torch.equal(got["switch"], want["switch"])
    assert bool(got["switch"][5])
    for key in ("rel_pose", "Z_switch"):
        assert (got[key] - want[key]).abs().max().item() <= 1e-4, key


def test_chunked_submit_issues_no_host_sync(cuda):
    """After the engine's first chunk, submit_chunk issues a whole chunk
    (uploads, scan, the copy of its outputs) with no synchronizing call:
    torch.cuda.set_sync_debug_mode("error") raises on any."""
    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam

    frames, _ = _ring640(24)
    slam = ChunkedKeyframeSlam(K640, TrackerConfig(), SlamConfig(),
                               device=cuda)
    slam.init()

    def chunk(a, b):
        return (np.stack([f[0] for f in frames[a:b]]),
                np.stack([f[1] for f in frames[a:b]]),
                [k / 30.0 for k in range(a, b)])

    slam.update_chunk(*chunk(0, 8))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam.force_keyframe()
        slam.submit_chunk(*chunk(8, 16))
        slam.submit_chunk(*chunk(16, 24))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(slam.collect_chunk()) == 8
    assert len(slam.collect_chunk()) == 8
    assert len(slam.keyframes) >= 2


def _validation_batch(dev, B, level):
    """A validation batch: B reference rows from B frames of a noisy
    640x480 orbit against B current frames (one per row), from perturbed
    poses."""
    cfg = TrackerConfig()
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(B + 1, radius=0.06)
    rng = np.random.default_rng(5)
    frames = [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K640), W640, H640, poses[k]), rng,
        dropout=0.02) for k in range(B + 1)]
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=dev),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                  torch.as_tensor(z, device=dev),
                                  cfg.num_levels)[level] for i, z in frames]
    T = np.stack([(se3_np.inverse(poses[b + 1]) @ poses[b])
                  @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                  for b in range(B)])
    ref = linearize.prepare_reference(torch.stack(pyrs[:B]), Ks[level], cfg)
    return (cfg, ref, torch.stack(pyrs[1:]), Ks[level],
            torch.as_tensor(T, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("B", [16, 32])
def test_validation_batches_16_32_match_host_loop(cuda, B, level):
    """Mode (b) at the validation batches past 8 (up to
    validation_batch_max = 32), one current slab per row, noisy frames:
    against the host loop over the plain linearization, with chip_smoke's
    phase 5a gates (T within 1e-3, final valid counts within 1 %)."""
    cfg, ref, cur, K, T0 = _validation_batch(cuda, B, level)
    before = dict(linearize.LAUNCHES_BY_BATCH)
    T, fin, _ = dense_tracker.track_level(ref, cur, K, T0, cfg)
    key = ("track_level", B)
    assert linearize.LAUNCHES_BY_BATCH[key] - before.get(key, 0) == 1
    T_h, fin_h, _ = dense_tracker._track_level(
        ref, cur, K, T0, cfg, linearize=linearize.linearize_batched_reference)
    assert (T - T_h).abs().max().item() <= 1e-3
    d_n = ((fin.n_raw - fin_h.n_raw).abs()
           / fin_h.n_raw.clamp(min=1.0)).max().item()
    assert d_n <= 0.01


def test_slam_evicts_past_resident_keyframes(cuda):
    """A KeyframeSlam run forced past 64 keyframes (resident_keyframes =
    64): older pyramids spill to the host and re-upload for validation.
    The run equals one whose budget holds every pyramid."""
    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig

    W, H = 160, 120
    K = (525.0 * W / 640.0, 525.0 * H / 480.0, (W - 1) / 2.0, (H - 1) / 2.0)
    scene = synthetic.two_plane_scene(sharpness=2.0)
    ring = synthetic.orbit_trajectory(9, radius=0.06)[:8]
    frames = synthetic.render_sequence(scene, np.asarray(K), W, H, ring)
    cfg = TrackerConfig(num_levels=3, first_level=2, last_level=0)

    def run(resident):
        slam = KeyframeSlam(K, cfg, SlamConfig(resident_keyframes=resident),
                            device=cuda)
        slam.init()
        for k in range(72):
            if k > 0:
                slam.force_keyframe()
            slam.update(*frames[k % 8], k / 30.0)
        return slam, [T for _, T in slam.finish()]

    small, traj_small = run(64)
    large, traj_large = run(256)
    assert len(small.keyframes) == 72
    assert sum(not k.resident for k in small.keyframes) >= 8
    assert all(k.resident for k in large.keyframes)
    assert small.validation_cache_stats["misses"] > 0
    edges = [[(int(s.graph.edge_i[e]), int(s.graph.edge_j[e]),
               bool(s.graph.edge_mask[e]))
              for e in range(int(s.graph.num_edges))] for s in (small, large)]
    assert edges[0] == edges[1] and small.num_loop_edges >= 1
    np.testing.assert_array_equal(np.stack(traj_small), np.stack(traj_large))


# ---- point compaction (point_budget_fraction > 0) on the card

BUDGET_CONFIG = {"intensity_grad_threshold": 1.0, "point_budget_fraction": 0.5}


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_track_level_kernel_at_budget_matches_host_loop(cuda, orbit640,
                                                        level, B):
    """Mode (b) over compacted points (N = the budget, past the selection
    at this threshold, so decimated) against the plain host loop, with the
    gates of the full grid's test."""
    cfg = TrackerConfig(**BUDGET_CONFIG)
    ref, cur, K, T0 = _level_batch(orbit640, cuda, B, False, level, cfg)
    h, w = cur.shape[-2:]
    assert ref.px.shape == (B, linearize.compact_budget(h * w, 0.5, 128))
    assert bool(ref.selected.all())  # decimated: every slot a point
    stats, parted = _assert_level_matches_host_loop(ref, cur, K, T0, cfg)
    assert (stats["iterations"] >= 2).all()
    assert len(parted) <= max(1, B // 4), parted


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_fused_linearize_at_budget_matches_plain(cuda, orbit640, level, B):
    """Mode (a) over compacted points: each row against the plain version
    (valid mask, rI and rZ exact; A and b within 1e-4 * max|.|), and the
    host loop over mode (a) against the host loop over plain (T within
    1e-5)."""
    cfg = TrackerConfig(**BUDGET_CONFIG)
    ref, cur, K, T = _level_batch(orbit640, cuda, B, False, level, cfg)
    N = ref.px.shape[1]
    got = linearize.linearize_batched(ref, cur, K, T, cfg)
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(cuda, N, B))
    for b in range(B):
        row = _row_ref(ref, b)
        res = linearize.residuals_reference(row, cur, K, T[b], cfg)
        want = linearize.linearize_reference(row, cur, K, T[b], cfg)
        torch.cuda.synchronize()
        assert torch.equal(valid[b], res.valid)
        assert torch.equal(rI[b], res.rI) and torch.equal(rZ[b], res.rZ)
        assert float(got.n_raw[b]) == float(want.n_raw) > 0.5 * N
        for field in ("A", "b"):
            a, w = getattr(got, field)[b], getattr(want, field)
            assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    T_a = dense_tracker._track_level(ref, cur, K, T, cfg)[0]
    T_h = dense_tracker._track_level(
        ref, cur, K, T, cfg, linearize=linearize.linearize_batched_reference)[0]
    assert (T_a - T_h).abs().max().item() <= 1e-5


@pytest.mark.parametrize("frac, thr", [(0.5, 1.0), (0.9, 3.0), (0.25, 0.0)])
def test_compaction_on_card_equals_cpu(cuda, orbit640, frac, thr):
    """prepare_reference's compaction on the card: the CPU's bits from the
    same slab at every level, one pyramid and a batch of two, and the same
    bits over repeated runs (no scatter: nothing depends on the order of
    writes)."""
    cfg = TrackerConfig(intensity_grad_threshold=thr,
                        point_budget_fraction=frac)
    frames, _ = orbit640
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=cuda),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=cuda),
                                  torch.as_tensor(z, device=cuda),
                                  cfg.num_levels) for i, z in frames[:2]]
    for level in range(cfg.num_levels):
        for slab in (pyrs[0][level], torch.stack([p[level] for p in pyrs])):
            got = linearize.prepare_reference(slab, Ks[level], cfg)
            want = linearize.prepare_reference(slab.cpu(), Ks[level].cpu(),
                                               cfg)
            again = [linearize.prepare_reference(slab, Ks[level], cfg)
                     for _ in range(5)]
            for f, a, w in zip(got._fields, got, want):
                if a is None:
                    continue
                assert torch.equal(a.cpu(), w), (level, f)
                assert all(torch.equal(a, getattr(x, f)) for x in again)


def test_pixel_sharded_world_on_card_matches_single(cuda, orbit640):
    """parallel/'s pixel route on the card: a 2-rank world (nccl with two
    cards, the ranks sharing one card over gloo with one) tracks two
    640x480 pairs with the reference rows split over the ranks, through
    the host loop over the all-reduced plain linearization and the
    standalone sampler kernel. Both ranks return the same poses: within
    5e-5 of the single-process host loop over the plain linearization (the
    same arithmetic, sums unsplit) and 1e-4 of the level kernel's, valid
    counts within 1e-3 relative."""
    import functools

    import torch_sharded_cases as cases
    from dvo_slam_tpu_torch import parallel

    frames, poses = orbit640
    rng = np.random.default_rng(3)
    inp = {"frames": frames[:3], "K": K640, "T0": np.stack([
        (se3_np.inverse(poses[b + 1]) @ poses[b])
        @ se3_np.exp(rng.normal(scale=2e-3, size=6))
        for b in range(2)]).astype(np.float32)}
    ranks = parallel.spawn(cases.run_card_pixel, 2, "cuda", (inp,),
                           timeout_s=300)
    for r in ranks:
        assert r["launches"]["sample_slab"] > 0, r["launches"]
        assert r["launches"]["track_level"] == 0
        np.testing.assert_array_equal(r["T"], ranks[0]["T"])
    refs, curs, Ks, T0 = cases.card_pairs(inp, cuda)
    cfg = TrackerConfig()
    want = {"kernel": dense_tracker.track_batched(refs, curs, Ks, T0, cfg)}
    plain = functools.partial(linearize.linearize_batched_reference,
                              sample=sampler.sample_slab)
    level = dense_tracker.track_level
    dense_tracker.track_level = functools.partial(dense_tracker._track_level,
                                                  linearize=plain)
    try:
        want["host"] = dense_tracker.track_batched(refs, curs, Ks, T0, cfg)
    finally:
        dense_tracker.track_level = level
    for name, tol in (("host", 5e-5), ("kernel", 1e-4)):
        w = want[name]
        np.testing.assert_allclose(ranks[0]["T"],
                                   w.transformation.cpu().numpy(), atol=tol)
        np.testing.assert_allclose(ranks[0]["valid"],
                                   w.valid_pixels.cpu().numpy(), rtol=1e-3)


# --- the pose-graph kernel (csrc/pose_graph.cu) against the host loop ---

def _chain_graph(n=8, drift=0.02, seed=0, max_v=16, max_e=32, loop=True):
    """tests/test_pose_graph.py's drifted circle with one exact loop edge,
    as a host (numpy) graph."""
    rng = np.random.default_rng(seed)
    gt = [se3_np.exp(np.array([np.sin(a), 1 - np.cos(a), 0.1 * np.sin(a),
                               0, 0, 0.0]))
          for a in 2 * np.pi * np.arange(n) / n]
    g = pose_graph.empty_graph_host(max_v, max_e)
    T_est, edges = [np.eye(4)], []
    for k in range(n - 1):
        Z = (se3_np.inverse(gt[k]) @ gt[k + 1]
             @ se3_np.exp(rng.normal(scale=drift, size=6)))
        T_est.append(T_est[-1] @ Z)
        edges.append((k, k + 1, Z, np.eye(6) * 1e2))
    if loop:
        edges.append((n - 1, 0, se3_np.inverse(gt[-1]) @ gt[0],
                      np.eye(6) * 1e4))
    for k in range(n):
        g.poses[k] = T_est[k] if k else np.eye(4)
    return _with_edges(g, n, edges)


def _with_edges(g, n, edges):
    for e, (i, j, Z, info) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = i, j
        g.measurements[e], g.information[e] = Z, info
        g.edge_mask[e] = True
    return g._replace(num_vertices=np.asarray(n, np.int32),
                      num_edges=np.asarray(len(edges), np.int32))


def _noisy_ring(M, n, seed, slots=64):
    """A seeded SLAM-like graph padded to M vertices and `slots` edges: n
    keyframes on a 1 m ring, odometry edges with 5 mm / 0.01 rad noise
    chained into the initial poses, loop edges from the last third back to
    the first, and one false loop edge; information scaled as a tracker's
    (1e4-1e6)."""
    rng = np.random.default_rng(seed)
    gt = [se3_np.exp(np.array([np.sin(a), 1 - np.cos(a), 0.05 * np.sin(2 * a),
                               0.02 * np.sin(a), 0, a]))
          for a in 2 * np.pi * np.arange(n) / n]
    sigma = np.array([5e-3] * 3 + [1e-2] * 3)
    info = np.diag(1.0 / sigma**2) * rng.uniform(0.5, 2.0)
    edges, T_est = [], [gt[0]]
    for k in range(n - 1):
        Z = (se3_np.inverse(gt[k]) @ gt[k + 1]
             @ se3_np.exp(rng.normal(size=6) * sigma))
        edges.append((k, k + 1, Z, info))
        T_est.append(T_est[-1] @ Z)
    for k in range(2 * n // 3, n):
        j = int(rng.integers(0, n // 3))
        Z = (se3_np.inverse(gt[k]) @ gt[j]
             @ se3_np.exp(rng.normal(size=6) * sigma))
        edges.append((k, j, Z, info))
    edges.append((n // 2, 1, se3_np.exp(np.array([0.4, -0.3, 0.2, 0.3, 0.1,
                                                  -0.2])), info))
    g = pose_graph.empty_graph_host(M, slots)
    g.poses[:n] = np.stack(T_est)
    return _with_edges(g, n, edges)


def _kernel_and_plain(g, dev, **kw):
    before = pose_graph.LAUNCHES
    got = pose_graph.optimize(g, device=dev, **kw)
    run = (int(pose_graph.LAST_STEPS), pose_graph.LAST_STATS.cpu().numpy())
    assert pose_graph.LAUNCHES == before + 1
    want = pose_graph.optimize_reference(g, device=dev, **kw)
    return got, run, want, (int(pose_graph.LAST_STEPS),
                            pose_graph.LAST_STATS.cpu().numpy())


def _assert_graph_close(got, run, want, run_h, g, kw):
    from chip_smoke import _graph_parted

    (g_opt, chi2, w), (h_opt, h_chi2, h_w) = got, want
    parted = _graph_parted(run, run_h)
    assert parted is None or parted[1], (parted, run[0], run_h[0])
    assert g_opt.poses.shape == h_opt.poses.shape
    assert torch.isfinite(g_opt.poses).all()
    assert (g_opt.poses - h_opt.poses).abs().max().item() <= 1e-4
    np.testing.assert_allclose(float(chi2), float(h_chi2), rtol=1e-4,
                               atol=1e-6)
    dev = g_opt.poses.device
    at = pose_graph.to_device(g, dev)._replace(poses=g_opt.poses)
    _, _, chi2_at, w_at = pose_graph._build_blocks(
        at, pose_graph._topology(g, dev), kw.get("use_robust", True),
        kw.get("cauchy_c", 1.0))
    assert (w - w_at).abs().max().item() <= 1e-4
    np.testing.assert_allclose(float(chi2), float(chi2_at), rtol=1e-4,
                               atol=1e-6)


def _false_loop_graph():
    g = _chain_graph(n=8, drift=0.01, max_e=32)
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 2, 6
    g.measurements[e] = se3_np.exp(np.array([1.5, -1.0, 0.8, 0.5, -0.4, 0.9]))
    g.information[e] = np.eye(6) * 1e4
    g.edge_mask[e] = True
    return g._replace(num_edges=np.asarray(e + 1, np.int32))


def _not_pd_graph():
    g = _chain_graph(n=8, drift=0.03)
    g = g._replace(information=g.information.copy())
    g.information[0] = -np.eye(6) * 1e2
    return g


def _high_information_graph():
    g = _chain_graph(n=8, drift=0.05)
    return g._replace(information=g.information * 1e4)


GRAPH_CASES = {
    "loop_closure": (lambda: _chain_graph(n=8, drift=0.03),
                     dict(iterations=30, gnc_init=64.0)),
    "consistent": (lambda: _chain_graph(n=6, drift=0.0),
                   dict(iterations=10)),
    "stops_early": (lambda: _chain_graph(n=6, drift=0.0),
                    dict(iterations=50)),
    "false_loop_edge": (_false_loop_graph,
                        dict(iterations=30, use_robust=True)),
    "gnc_fixed": (_high_information_graph,
                  dict(iterations=30, gnc_init=16.0)),
    "gnc_adaptive": (_high_information_graph,
                     dict(iterations=30, gnc_init=16.0, gnc_adaptive=True)),
    "not_pd_step_zeroed": (_not_pd_graph,
                           dict(iterations=3, use_robust=False)),
    "padded": (lambda: _chain_graph(n=6, drift=0.02, max_v=32, max_e=64),
               dict(iterations=15)),
    "zero_iterations": (lambda: _chain_graph(n=8, drift=0.03),
                        dict(iterations=0)),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_pose_graph_kernel_matches_host_loop(cuda, case):
    """tests/test_torch_pose_graph.py's graphs through one kernel launch
    and through the plain host loop on the card."""
    make, kw = GRAPH_CASES[case]
    g = make()
    got, run, want, run_h = _kernel_and_plain(g, cuda, **kw)
    _assert_graph_close(got, run, want, run_h, g, kw)
    steps = run[0]
    if case == "stops_early":
        assert 0 < steps < kw["iterations"]
    if case == "zero_iterations":
        assert steps == 0
        assert torch.equal(got[0].poses.cpu(), torch.from_numpy(g.poses))
    if case == "false_loop_edge":
        w = got[2].cpu().numpy()
        assert w[int(g.num_edges) - 1] < 0.05 and w[:7].min() > 0.3
    if case == "gnc_adaptive":
        assert float(got[2][int(g.num_edges) - 1]) > 0.5


def test_pose_graph_kernel_padding_invariance(cuda):
    small = _chain_graph(n=6, drift=0.02, max_v=8, max_e=16)
    big = _chain_graph(n=6, drift=0.02, max_v=32, max_e=64)
    a = pose_graph.optimize(small, iterations=15, device=cuda)[0].poses
    b = pose_graph.optimize(big, iterations=15, device=cuda)[0].poses
    assert (a[:6] - b[:6]).abs().max().item() <= 2e-4


@pytest.mark.parametrize("M, n", [(16, 10), (32, 19), (32, 32), (16, 4),
                                  (48, 40), (64, 40), (64, 64), (128, 100)])
@pytest.mark.parametrize("asked", [20, 100])
def test_pose_graph_kernel_on_noisy_rings(cuda, M, n, asked):
    """Seeded noisy rings at every M the route takes (one CTA up to 32,
    clusters of 2, 4 and 16 CTAs at 48, 64 and 128), solved as the SLAM
    engine solves its graph (Cauchy, adaptive GNC from 16): kernel
    against the host loop: the same decisions up to a parting at a tie."""
    g = _noisy_ring(M, n, seed=M + n, slots=max(64, 2 * M))
    kw = dict(iterations=asked, use_robust=True, cauchy_c=1.0,
              gnc_init=16.0, gnc_adaptive=True)
    got, run, want, run_h = _kernel_and_plain(g, cuda, **kw)
    _assert_graph_close(got, run, want, run_h, g, kw)


@pytest.mark.parametrize("M, n", [(32, 19), (128, 100)])
def test_pose_graph_kernel_is_deterministic(cuda, M, n):
    g = _noisy_ring(M, n, seed=5, slots=max(64, 2 * M))
    kw = dict(iterations=100, gnc_init=16.0, gnc_adaptive=True)
    runs = [pose_graph.optimize(g, device=cuda, **kw) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r[0].poses, runs[0][0].poses)
        assert torch.equal(r[1], runs[0][1]) and torch.equal(r[2], runs[0][2])


def test_pose_graph_kernel_issues_no_host_sync(cuda):
    """The kernel route uploads from pinned memory without blocking and
    reads nothing back: set_sync_debug_mode("error") raises on any sync."""
    g = _noisy_ring(16, 10, seed=1)
    pose_graph.optimize(g, iterations=5, device=cuda)  # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pose_graph.optimize(g, iterations=20, gnc_init=16.0,
                                  gnc_adaptive=True, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out[0].poses).all()


def test_pose_graph_kernel_plan_matches_python(cuda):
    """dvo_pose_graph_plan (the source) and kernel_plan (the route's
    Python side) agree on the limit, the layout and the shared memory."""
    import ctypes

    from dvo_slam_tpu_torch import _build

    lib = _build.load()
    for M in (*range(1, 130), 256):
        out = (ctypes.c_int * 4)()
        assert lib.dvo_pose_graph_plan(M, out) == 0
        assert tuple(out) == pose_graph.kernel_plan(M)


def test_pose_graph_kernel_refused_launch_raises(cuda, monkeypatch):
    """A solve the source refuses (here 256 vertices, past its limit,
    with the wrapper's own check widened) raises with the CUDA error;
    nothing falls back to the host loop."""
    g = pose_graph.grow(_chain_graph(n=6), max_vertices=256)
    monkeypatch.setattr(pose_graph, "KERNEL_MAX_VERTICES", 256)
    before = pose_graph.LAUNCHES
    with pytest.raises(RuntimeError, match="dvo_pose_graph failed"):
        pose_graph.optimize(g, iterations=5, device=cuda)
    assert pose_graph.LAUNCHES == before


def test_pose_graph_kernel_on_a_card_that_is_not_current(cuda):
    """A solve on card 1 while card 0 is current launches on card 1 and
    leaves the current card as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    g = _noisy_ring(64, 40, seed=7, slots=128)
    kw = dict(iterations=20, gnc_init=16.0, gnc_adaptive=True)
    with torch.cuda.device(cuda):
        got = pose_graph.optimize(g, device=second, **kw)
        assert torch.cuda.current_device() == cuda.index
    want = pose_graph.optimize(g, device=cuda, **kw)
    assert got[0].poses.device == second
    assert torch.equal(got[0].poses.cpu(), want[0].poses.cpu())

"""The port's CUDA kernels and main path on a CUDA card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one:
a CUDA kernel has no CPU mode. This file imports no JAX, so it also runs
where JAX is not installed; there, skip tests/conftest.py (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the sampler kernel is bit-identical to its plain version by
construction (no FMA contraction) and is held to it bit for bit, the NaN
pattern and the in-bounds mask included. The
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

Every scale estimator and influence function (MAD + Huber, normal +
Tukey, unit + t, unweighted, MAD without depth) in mode (a) at B = 1, 2
and 8 and at every tracked level: rI, rZ, valid and the MAD elements (the
|r| the plain version's sort reads) bit for bit, the rest as above; in
mode (b), and with the motion prior (mu = 0.5, GN, LM, and with MAD),
against the host loop with the gates above (the records the posterior
A + mu I on both routes), each iteration's error also within 1e-4 of the
row's first error off the t-distribution (its error has no log-det term
and falls ~100x over a level). mu = 1e9 holds a level's pose near its
start (the free level moves 5x further). A MAD + Huber chunk of the
keyframe scan: five launches a frame, no host sync in submit_chunk.

Point compaction on the slab route (each launch picks its slots' pixels
from the reference slab): both modes bit for bit against the same kernel
over prepare_reference's compacted points (by stride, row pointers and a
device table; B = 1, 2, 8; levels 3, 2, 1; four threshold and budget
pairs; a blank reference row; slot tables past shared memory), and every
budget path (odometry, SLAM, the chunked scan) on the kernel front with
no prepare_reference or scan_step_reference call.

The pixel route (parallel/sharded.py) on the level kernel's split mode
(stage launches over each rank's band, their partial sums all-reduced
between them) in 2-rank worlds on the card: every rank the same bits;
no standalone sampler, mode (b) or prepare_reference call; stage_plan x
iterations + 1 launches a level; poses within 1e-4 of the plain pixel
route in the same world (f64 sums against f32 ones), of the
single-process level kernel and within 5e-5 of the single-process host
loop, valid counts within 1e-3 relative. The 36 split cases (the default,
a budget of 0.5, MAD + Huber, mu = 0.1; B = 1, 2, 8; levels 3 / 2 / 1)
hold the level kernel over the bands' points side by side, each band
compacted to its own budget as the plain pixel route compacts.

The pose-graph kernels (csrc/pose_graph.cu, one launch per dense solve
of at most 128 vertices; csrc/pose_graph_grid.cu, one cooperative launch
per solve past that and per CG solve) against their plain version, the
host loop ``optimize_reference`` on the same card (cuSOLVER's Cholesky,
torch's CG): poses within 1e-4, the final chi2 within
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
from torch_graphs import two_lap_ring
import torch_sharded_cases as cases

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


def _assert_sampler_matches_plain(slab, u, v, channels):
    """One launch of the sampler kernel on the first `channels` planes,
    bit for bit against its plain version (NaN pattern and inb too)."""
    before = sampler.LAUNCHES
    out, inb = sampler.sample_slab(slab[:channels], u, v)
    torch.cuda.synchronize()
    assert sampler.LAUNCHES == before + 1
    want, want_inb = sampler.sample_slab_reference(slab[:channels], u, v)
    assert out.shape == (channels, u.numel()) and inb.dtype == torch.bool
    assert torch.equal(inb, want_inb)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert _bit_diff(out, want) == 0


@pytest.mark.parametrize("level_hw", [(60, 80), (120, 160), (240, 320)])
def test_kernel_matches_plain(cuda, level_hw):
    """At the 640x480 tracked-level shapes, for C = 1 to 6: bit for bit."""
    h, w = level_hw
    slab = torch.from_numpy(_slab(4, (6, h, w), n_nan=50)).to(cuda)
    u, v = (torch.from_numpy(a).to(cuda) for a in _points(h, w))
    for channels in range(1, 7):
        _assert_sampler_matches_plain(slab, u, v, channels)


def test_kernel_matches_plain_at_a_pixel_shard(cuda):
    """Phase 11's shape: half of level 1's rows (38 400 points) warped into
    the whole 320x240 slab; bit for bit for C = 1 to 6."""
    h, w = 240, 320
    slab = torch.from_numpy(_slab(6, (6, h, w), n_nan=50)).to(cuda)
    u, v = (torch.from_numpy(a[:h // 2 * w]).to(cuda)
            for a in _points(h, w))
    assert u.numel() == 38400
    for channels in range(1, 7):
        _assert_sampler_matches_plain(slab, u, v, channels)


@pytest.mark.parametrize("threads", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 255, 257])
def test_kernel_partial_blocks(cuda, monkeypatch, n, threads):
    """A last block that is partly past N at each block size the wrapper
    may pick (forced here), for C = 1 to 6: bit for bit."""
    h, w = 60, 80
    slab = torch.from_numpy(_slab(7, (6, h, w), n_nan=20)).to(cuda)
    u, v = (torch.from_numpy(np.resize(a[::-1], n).copy()).to(cuda)
            for a in _points(h, w))
    monkeypatch.setattr(sampler, "block_threads", lambda N, sms: threads)
    for channels in range(1, 7):
        _assert_sampler_matches_plain(slab, u, v, channels)


def test_kernel_on_a_card_that_is_not_current(cuda):
    """Tensors on card 1 while card 0 is current: the wrapper launches on
    the tensors' card and leaves the current card as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    h, w = 120, 160
    slab = torch.from_numpy(_slab(5, (6, h, w), n_nan=20)).to(second)
    u, v = (torch.from_numpy(a).to(second) for a in _points(h, w))
    with torch.cuda.device(cuda):
        out, inb = sampler.sample_slab(slab, u, v)
        assert torch.cuda.current_device() == cuda.index
    torch.cuda.synchronize(second)
    want, want_inb = sampler.sample_slab_reference(slab, u, v)
    assert out.device == second and torch.equal(inb, want_inb)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert _bit_diff(out, want) == 0


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
    """A config that ran the plain linearization on the card before the
    kernel took every estimator (MAD + Huber) now runs mode (a): one launch
    a call and no standalone sampler launch, held to the plain version."""
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
                sampler.LAUNCHES - before[2]) == (calls, 0, 0)
    _assert_fused_matches_plain(ref, slab, K, Tt, cfg)


# ---- every scale estimator, influence function and weighting on the
# cluster kernel, and the motion prior in mode (b)

ROBUST_CONFIGS = {
    "mad_huber": {"scale_estimator": "mad", "influence": "huber"},
    "normal_tukey": {"scale_estimator": "normal", "influence": "tukey"},
    "unit_tdist": {"scale_estimator": "unit", "influence": "tdist"},
    "unweighted": {"use_weighting": False},
    "mad_photometric": {"scale_estimator": "mad", "influence": "huber",
                        "use_depth": False},
}
PRIOR_CONFIGS = {
    "mu_gn": {"mu": 0.5},
    "mu_lm": {"mu": 0.5, "lm_lambda_init": 1e-4},
    "mu_mad_huber": {"mu": 0.5, "scale_estimator": "mad",
                     "influence": "huber"},
}


@pytest.mark.parametrize("paired", [False, True], ids=["shared", "paired"])
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("name", sorted(ROBUST_CONFIGS))
def test_robust_linearize_matches_plain(cuda, name, B, paired):
    """Mode (a) under each estimator against linearize_reference row by
    row: rI, rZ, valid and the MAD elements bit for bit, A and b within
    1e-4 * max|.|, sigma, err_mean, log1p_sum and err_raw rtol 1e-4, one
    launch and no standalone sampler launch."""
    cfg = dataclasses.replace(TrackerConfig(), **ROBUST_CONFIGS[name])
    ref, cur, K, T, sigma = _batch_inputs(cuda, B, paired)
    N = ref.px.shape[1]
    before = (linearize.LAUNCHES_LINEARIZE, sampler.LAUNCHES)
    got = linearize.linearize_batched(ref, cur, K, T, cfg, sigma, True)
    assert (linearize.LAUNCHES_LINEARIZE - before[0],
            sampler.LAUNCHES - before[1]) == (1, 0)
    rI, rZ, valid = (t.clone() for t in
                     linearize.kernel_residuals(cuda, N, B))
    mad = linearize.kernel_mad_elements(cuda, N, B).clone()
    for b in range(B):
        slab = cur[b] if paired else cur
        ref_b = _row_ref(ref, b)
        res = linearize.residuals_reference(ref_b, slab, K, T[b], cfg)
        want = linearize.linearize_reference(ref_b, slab, K, T[b], cfg,
                                             sigma[b], True)
        assert torch.equal(valid[b], res.valid), b
        assert torch.equal(rI[b], res.rI) and torch.equal(rZ[b], res.rZ), b
        if cfg.use_weighting and cfg.scale_estimator == "mad":
            assert torch.equal(mad[b], SMOKE._mad_elements(res)), b
        else:
            assert not bool(mad[b].any()), b
        assert float(got.n_raw[b]) == float(want.n_raw) > 0.5 * N
        for field in ("A", "b"):
            a, w = getattr(got, field)[b], getattr(want, field)
            scale = w.abs().max().item()
            assert (a - w).abs().max().item() <= 1e-4 * scale, (field, b)
        for field in ("sigma", "err_mean", "log1p_sum", "err_raw"):
            np.testing.assert_allclose(
                getattr(got, field)[b].cpu().numpy(),
                getattr(want, field).cpu().numpy(), rtol=1e-4, atol=1e-30,
                err_msg=f"{field} row {b}")


@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("name", sorted(ROBUST_CONFIGS))
def test_robust_linearize_at_every_level(cuda, pair640, name, level):
    """Mode (a) under each estimator at the three tracked levels of the
    noisy 640x480 pair, and with no selected reference point (the MAD
    element +inf and the scale 1.4826, as the sort's)."""
    cfg = dataclasses.replace(TrackerConfig(), **ROBUST_CONFIGS[name])
    frames, T = pair640
    ref, slab, K, Tt = _level_inputs(frames, T, cfg, level, cuda)
    _assert_fused_matches_plain(ref, slab, K, Tt, cfg)
    res = linearize.residuals_reference(ref, slab, K, Tt, cfg)
    mad = linearize.kernel_mad_elements(cuda, ref.px.numel()).clone()
    if cfg.use_weighting and cfg.scale_estimator == "mad":
        assert torch.equal(mad, SMOKE._mad_elements(res))
    if level == 3:
        (ref_f, cur_f) = frames
        ref, slab, K, Tt = _level_inputs(
            ((ref_f[0], np.full_like(ref_f[1], np.nan)), cur_f), T, cfg,
            level, cuda)
        got, _ = _assert_fused_matches_plain(ref, slab, K, Tt, cfg)
        assert float(got.n_raw) == 0.0
        mad = linearize.kernel_mad_elements(cuda, ref.px.numel())
        if cfg.use_weighting and cfg.scale_estimator == "mad":
            assert bool(torch.isinf(mad).all())


# Configs whose systems weigh depth residuals (metres) like intensities
# (unit scales, or no weighting): the kernel's and the host loop's f32
# solves part by ~1e-7 in the pose after the first step, and the errors,
# which have no log-det term and fall ~100x over a level, part by more
# than 1e-4 of themselves; under unit scales a border point may also
# change its validity at the next iteration. Readings on the card (H100
# 80GB HBM3, level 3 unless named): unit_tdist at level 1, B2_shared and
# B8_paired, a final valid count of 75 073 against the host loop's 75 074
# and an iteration's error 1.5e-4 (relative) from the host loop's at an
# error of 0.03; unweighted at B1, the second iteration's error 0.033608
# against 0.033604 (1.24e-4) after a first error of 14.65; the poses
# within 1e-5. These get an atol of 1e-4 x the row's first error on the
# errors (ERROR_SLACK), unit_tdist valid counts within 1e-4 (VALID_SLACK);
# every other config is held to rtol 1e-4 and exact counts.
ERROR_SLACK = ("unit_tdist", "unweighted")
VALID_SLACK = ("unit_tdist",)


@pytest.mark.parametrize("rows", ["B1", "B2_shared", "B8_paired"])
@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("name", sorted({**ROBUST_CONFIGS, **PRIOR_CONFIGS}))
def test_robust_track_level_matches_host_loop(cuda, orbit640, name, level,
                                              rows):
    """Mode (b) under each estimator and with the motion prior against the
    host loop over the plain linearization (the gates of
    test_track_level_kernel_matches_host_loop); with mu > 0 both records
    hold the posterior A + mu I. The configs of ERROR_SLACK hold each
    iteration's error within 1e-4 of the row's first error too, those of
    VALID_SLACK the valid counts within 1e-4 (a record with other points
    is held to the plain linearization at its own pose, not to the host
    loop's record); the poses stay within 1e-5 for every config."""
    cfg = dataclasses.replace(TrackerConfig(), **{
        **ROBUST_CONFIGS, **PRIOR_CONFIGS}[name])
    B, paired = int(rows[1]), rows.endswith("paired")
    ref, cur, K, T0 = _level_batch(orbit640, cuda, B, paired, level, cfg)
    stats, parted = _assert_level_matches_host_loop(
        ref, cur, K, T0, cfg,
        err_of_first=1e-4 if name in ERROR_SLACK else 0.0,
        valid_rtol=1e-4 if name in VALID_SLACK else 0.0)
    assert (stats["iterations"] >= 2).all()
    assert len(parted) <= max(1, B // 4), parted


@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("solver", ["gn", "lm"])
def test_motion_prior_pins_the_level_to_its_start(cuda, orbit640, solver,
                                                  level):
    """The prior at weights scaled to the data (chip_smoke._prior_check:
    mu = 1 and 1e4 x the free record's largest diagonal entry; the JAX
    package's test_mu_pose_prior_pulls_toward_init uses mu = 1e9, which is
    strong at 80x60 but not here: on the card the free level 2 moved 7.4e-3
    and one at mu = 1e9 6.5e-3): on two rows, the kernel's pose within 1e-5
    of the host loop's, its record the posterior A + mu I (against the host
    loop's and against the plain linearization at its pose plus mu I), its
    entropy that posterior's; the pose at c = 1 at least 1e-4 from the free
    pose, and at c = 1e4 a fifth as far from T_init as the free pose."""
    cfg = TrackerConfig(**({"lm_lambda_init": 1e-4} if solver == "lm"
                           else {}))
    ref, cur, K, T0 = _level_batch(orbit640, cuda, 2, False, level, cfg)
    _, _, mus, moved = SMOKE._prior_check(ref, cur, K, T0, cfg,
                                          f"{solver} level {level}")
    assert moved[0.0] > 0.0 and moved[1e4] <= moved[0.0] / 5, (mus, moved)


def test_robust_chunk_issues_no_host_sync(cuda):
    """Under MAD + Huber a chunk of the keyframe scan takes the kernel
    route (five launches a frame) and submit_chunk issues it with no
    synchronizing call."""
    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.ops import scan_step

    frames, _ = _ring640(24)
    cfg = dataclasses.replace(TrackerConfig(), **ROBUST_CONFIGS["mad_huber"])
    slam = ChunkedKeyframeSlam(K640, cfg, SlamConfig(), device=cuda)
    slam.init()

    def chunk(a, b):
        return (np.stack([f[0] for f in frames[a:b]]),
                np.stack([f[1] for f in frames[a:b]]),
                [k / 30.0 for k in range(a, b)])

    slam.update_chunk(*chunk(0, 8))
    torch.cuda.synchronize()
    before = (pyramid.LAUNCHES_PYRAMID, linearize.LAUNCHES_TRACK_LEVEL,
              scan_step.LAUNCHES_SCAN_STEP, linearize.LAUNCHES_LINEARIZE,
              sampler.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam.submit_chunk(*chunk(8, 24))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = (pyramid.LAUNCHES_PYRAMID, linearize.LAUNCHES_TRACK_LEVEL,
             scan_step.LAUNCHES_SCAN_STEP, linearize.LAUNCHES_LINEARIZE,
             sampler.LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [16, 48, 16, 0, 0]
    assert len(slam.collect_chunk()) == 16


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


def _assert_level_matches_host_loop(ref, cur, K, T0, cfg, err_of_first=0.0,
                                    valid_rtol=0.0):
    """Mode (b) against the plain host loop on the same rows; returns the
    kernel's stats and the rows whose paths part (at a tie). The errors
    agree within rtol 1e-4 and, with ``err_of_first``, within that
    fraction of the row's first error too; the per-iteration valid counts
    exactly, or within ``valid_rtol``."""
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
        # The record is the linearization at the level's pose (cold Sigma),
        # its A the posterior A + mu I with the motion prior.
        want = linearize.linearize_batched_reference(ref, cur, K, T, cfg)
        want = want._replace(A=want.A + cfg.mu * torch.eye(6, device=T.device))
    parted = []
    for b in range(T.shape[0]):
        part = _parted(acc[b], acc_h[b], err[b], err_h[b], dn[b], dn_h[b],
                       its[b], its_h[b], cfg.precision)
        if part is not None:
            assert part[1], (b, part, err[b], err_h[b])
            parted.append(b)
            continue
        assert term[b] == term_h[b], b
        assert (np.abs(valid[b] - valid_h[b])
                <= valid_rtol * valid_h[b]).all(), (b, valid[b], valid_h[b])
        np.testing.assert_allclose(err[b], err_h[b], rtol=1e-4,
                                   atol=err_of_first * abs(err_h[b][0]))
        np.testing.assert_allclose(dn[b], dn_h[b], rtol=0.0, atol=1e-5)
        n, n_h = float(fin.n_raw[b]), float(fin_h.n_raw[b])
        assert abs(n - n_h) <= valid_rtol * n_h, (b, n, n_h)
        if n_h < 6:
            # Too few constraints: the record's A and b are (near) empty.
            assert torch.equal(fin.A[b], fin_h.A[b]), b
            assert torch.equal(fin.b[b], fin_h.b[b]), b
            continue
        if n == n_h:
            # The same points: the records agree (with other points, the
            # record is held to the plain linearization at its pose below).
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
    C, P, stored, smem, _ = linearize.level_plan(cuda, ref.px.shape[1])
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
    # The eager front around the host loop over the plain linearization.
    monkeypatch.setattr(dense_tracker, "front_route",
                        lambda *args, **kwargs: False)
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


def _pixel_inputs(orbit, B):
    """B pairs of the orbit (frame b against b + 1), each from its ground
    truth pose perturbed."""
    frames, poses = orbit
    rng = np.random.default_rng(3)
    return {"frames": frames[:B + 1], "K": K640, "T0": np.stack([
        (se3_np.inverse(poses[b + 1]) @ poses[b])
        @ se3_np.exp(rng.normal(scale=2e-3, size=6))
        for b in range(B)]).astype(np.float32)}


def test_pixel_sharded_world_on_card_matches_single(cuda, orbit640):
    """parallel/'s pixel route on the card: a 2-rank world (nccl with two
    cards, the ranks sharing one card over gloo with one) tracks two
    640x480 pairs with the reference rows split over the ranks, through
    the level kernel's split mode (stage launches over each rank's band,
    their sums all-reduced between them; no standalone sampler launch, no
    mode (b) launch, no prepare_reference). Each level makes stage_plan x
    its iterations + 1 stage launches. Both ranks return the same poses:
    within 5e-5 of the single-process host loop over the plain
    linearization and 1e-4 of the level kernel's, valid counts within
    1e-3 relative."""
    import functools

    from dvo_slam_tpu_torch import parallel

    inp = _pixel_inputs(orbit640, 2)
    ranks = parallel.spawn(cases.run_card_pixel, 2, "cuda", (inp,),
                           timeout_s=300)
    cfg = TrackerConfig()
    plan = linearize.stage_plan(cfg)
    for r in ranks:
        la = r["launches"]
        assert la["sample_slab"] == 0 and la["track_level"] == 0, la
        assert la["prepare_reference"] == 0, la
        n_it = r["iterations"].max(axis=0)  # every level's loop count
        assert la["split"] == int((n_it * plan.cold + 1).sum()), (la, n_it)
        assert la["collectives"] == int(
            (n_it * plan.cold + (n_it < cfg.max_iterations)).sum())
        np.testing.assert_array_equal(r["T"], ranks[0]["T"])
    refs, curs, Ks, T0 = cases.card_pairs(inp, cuda)
    want = {"kernel": dense_tracker.track_batched(refs, curs, Ks, T0, cfg)}
    plain = functools.partial(linearize.linearize_batched_reference,
                              sample=sampler.sample_slab)
    level, front = dense_tracker.track_level, dense_tracker.front_route
    dense_tracker.track_level = functools.partial(dense_tracker._track_level,
                                                  linearize=plain)
    dense_tracker.front_route = lambda *args, **kwargs: False
    try:
        want["host"] = dense_tracker.track_batched(refs, curs, Ks, T0, cfg)
    finally:
        dense_tracker.track_level, dense_tracker.front_route = level, front
    for name, tol in (("host", 5e-5), ("kernel", 1e-4)):
        w = want[name]
        np.testing.assert_allclose(ranks[0]["T"],
                                   w.transformation.cpu().numpy(), atol=tol)
        np.testing.assert_allclose(ranks[0]["valid"],
                                   w.valid_pixels.cpu().numpy(), rtol=1e-3)


@pytest.fixture(scope="module")
def split_world(orbit640):
    """The split cases' 2-rank world (tests/torch_sharded_cases.py
    run_card_split), started once."""
    from dvo_slam_tpu_torch import parallel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    inp = _pixel_inputs(orbit640, 8)
    return inp, parallel.spawn(cases.run_card_split, 2, "cuda", (inp,),
                               timeout_s=900)


@pytest.mark.parametrize("case", range(len(cases.SPLIT_CASES)), ids=[
    f"{n}-B{B}-level{lvl}" for n, B, lvl in cases.SPLIT_CASES])
def test_pixel_split_case_on_card(cuda, split_world, case):
    """The split route at one level (levels 3 / 2 / 1), B = 1, 2 and 8, the
    default config, a point budget of 0.5 (each band compacted to its own
    budget, as the plain pixel route and the JAX package compact), MAD +
    Huber and mu = 0.1, over a 2-rank world: both ranks the same bits;
    stage_plan x iterations + 1 launches; poses within 1e-4 of the plain
    pixel route in the same world (f64 sums against f32 ones) and of the
    single-process level kernel (mode (b) over the bands' points side by
    side, each band compacted to its own budget: the same f64 sums but
    for their order), valid counts within 1e-3 relative. Off the
    t-distribution the ranks may part (each weighs its error by its own
    scale, as the JAX package does): both then raise the split route's
    error, the same launch."""
    inp, ranks = split_world
    name, B, level = cases.SPLIT_CASES[case]
    got = [r[(name, B, level)] for r in ranks]
    cfg = TrackerConfig(**cases.SPLIT_CONFIGS[name])
    if got[0]["error"] is not None:
        assert cfg.scale_estimator != "tdist", got[0]["error"]
        assert all("parted" in (g["error"] or "") for g in got)
        return
    for g in got[1:]:
        for key in ("T", "valid", "iterations", "launches", "collectives"):
            np.testing.assert_array_equal(g[key], got[0][key], err_msg=key)
    g = got[0]
    plan = linearize.stage_plan(cfg)
    n_it = int(g["iterations"].max())
    assert g["launches"] == n_it * plan.cold + 1
    assert g["collectives"] == n_it * plan.cold + (n_it < cfg.max_iterations)
    refs, curs, Ks, T0 = cases.card_pairs(inp, cuda)
    # The single process's points: each band's as prepare_reference gives
    # them at its row offset (compacted to the band's budget), side by side.
    h = refs[level].shape[-2] // len(ranks)
    bands = [linearize.prepare_reference(
        refs[level][:B, :, r * h:(r + 1) * h], Ks[level], cfg,
        row_offset=r * h) for r in range(len(ranks))]
    points = linearize.RefData(*(None if f[0] is None else torch.cat(
        f, dim=-1).contiguous() for f in zip(*bands)))
    out, out_i = linearize.track_level_kernels(
        points, curs[level][:B], Ks[level], T0[:B].contiguous(), cfg)
    single = linearize.unpack_level(out, out_i, cfg.max_iterations)
    for T, n in ((g["T_plain"], g["valid_plain"]),
                 (single.T.cpu().numpy(),
                  single.best[:, dense_tracker._N_RAW].cpu().numpy())):
        np.testing.assert_allclose(g["T"], T, atol=1e-4)
        np.testing.assert_allclose(g["valid"], n, rtol=1e-3)


@pytest.fixture(scope="module")
def one_rank_groups():
    """A 1-rank nccl default group in this process (the split route's
    graph issue) and a 1-rank gloo group beside it (its eager issue: the
    same sums, a 1-rank all-reduce leaves them as they are); destroyed
    after the module's tests that use them."""
    import torch.distributed as dist

    from dvo_slam_tpu_torch import parallel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
        rank=0, world_size=1)
    try:
        yield dist.group.WORLD, dist.new_group([0], backend="gloo")
    finally:
        parallel.destroy()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_split_graph_issue_matches_eager(cuda, orbit640, one_rank_groups,
                                         level, B):
    """Under nccl the split route replays one CUDA graph an iteration (the
    Sigma steps, the normal equations and the next stage 0, each with its
    all-reduce): at 640x480's levels 3 / 2 / 1 and B = 1 and 8 over the
    top half of the reference rows, three calls in a 1-rank nccl group
    give the eager issue's bits (a 1-rank gloo group), make its launches
    and all-reduces, and capture one graph (the default config's one
    unit) in the first call only; the later calls replay it. The eager
    issue captures nothing."""
    nccl, gloo = one_rank_groups
    cfg = TrackerConfig()
    refs, curs, Ks, T0 = cases.card_pairs(_pixel_inputs(orbit640, B), cuda)
    h = refs[level].shape[-2] // 2
    args = (linearize.RefSlabs(refs[level][:, :, :h].contiguous()),
            curs[level], Ks[level], T0.contiguous(), cfg)

    def counts():
        return (linearize.LAUNCHES_TRACK_LEVEL_SPLIT,
                linearize.COLLECTIVES_SPLIT, linearize.CAPTURES_SPLIT,
                linearize.REPLAYS_SPLIT)

    before = counts()
    want = [t.clone() for t in linearize.track_level_split(*args, gloo)]
    prev = counts()
    issued = (prev[0] - before[0], prev[1] - before[1])
    assert prev[2:] == before[2:]
    for call in range(3):
        got = linearize.track_level_split(*args, nccl)
        now = counts()
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), call
        assert (now[0] - prev[0], now[1] - prev[1]) == issued, (call, now)
        assert now[2] - prev[2] == (1 if call == 0 else 0), (call, now)
        assert now[3] > prev[3]
        prev = now


@pytest.mark.parametrize("level", [2, 1])
def test_split_stopped_rows_leave_no_ticket(cuda, orbit640, one_rank_groups,
                                            level):
    """Rows whose decision stops them at a stage 0 while the others go
    on, at B = 8 on more than one CTA a row: half the pairs start at their
    ground truth (they stop within an iteration or two), half perturbed.
    After each of three calls at the same shape, under nccl (the graph
    issue) and under gloo (the eager issue), every row's CTA ticket is back
    at 0 (a ticket left behind would make a later call's last CTA sum its
    partials too early), the calls give the first call's bits, and the
    poses are within 1e-4 of the level kernel over the same band's
    points."""
    from dvo_slam_tpu_torch import _build, parallel

    nccl, gloo = one_rank_groups
    cfg, B = TrackerConfig(), 8
    inp = _pixel_inputs(orbit640, B)
    frames, poses = orbit640
    for b in range(B // 2):
        inp["T0"][b] = se3_np.inverse(poses[b + 1]) @ poses[b]
    refs, curs, Ks, T0 = cases.card_pairs(inp, cuda)
    h = refs[level].shape[-2] // 2
    band = refs[level][:, :, :h].contiguous()
    args = (linearize.RefSlabs(band), curs[level], Ks[level],
            T0.contiguous(), cfg)
    N = h * refs[level].shape[-1]
    assert linearize.split_ctas(N, B, _build.sm_count(0)) > 1
    first = None
    for group in (gloo, nccl):
        ws = linearize.split_workspace(args[0], args[1], args[3], cfg,
                                       group, 0)
        for call in range(3):
            got = [t.clone() for t in linearize.track_level_split(*args,
                                                                  group)]
            torch.cuda.synchronize()
            tickets = ws.a.state.view(torch.int32)[
                :, linearize._SPLIT_TICKET_WORD]
            assert not tickets.any(), (group, call, tickets.tolist())
            first = first or got
            assert all(torch.equal(g, w) for g, w in zip(got, first)), call
        assert parallel.group_state(group)
    res = linearize.unpack_level(*first, cfg.max_iterations)
    its = res.iterations.tolist()
    assert min(its) < max(its), its  # some rows stopped before others
    o2, i2 = linearize.track_level_kernels(
        linearize.prepare_reference(band, Ks[level], cfg), curs[level],
        Ks[level], T0.contiguous(), cfg)
    want = linearize.unpack_level(o2, i2, cfg.max_iterations)
    assert float((res.T - want.T).abs().max()) <= 1e-4


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


def _not_pd_graph_at(M, n, v, seed=3):
    """_noisy_ring with the odometry edge (v, v + 1)'s information negated
    and scaled by 10: vertex v's diagonal block of H turns negative
    definite and no column before it changes, so the factorization's
    first failed pivot is column 6 v."""
    g = _noisy_ring(M, n, seed, slots=max(64, 2 * M))
    g = g._replace(information=g.information.copy())
    g.information[v] = -10.0 * g.information[v]
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
                                  (48, 40), (64, 40), (64, 64), (128, 100),
                                  (17, 12), (33, 25), (65, 50), (100, 80),
                                  (127, 120)])
@pytest.mark.parametrize("asked", [20, 100])
def test_pose_graph_kernel_on_noisy_rings(cuda, M, n, asked):
    """Seeded noisy rings at every M the route takes (one CTA up to 32,
    clusters of 4 CTAs at 33-64, 8 at 65-100 and 16 at 127-128; n = 6M at
    17, 33, 65, 100 and 127 no multiple of the panel width, so the last
    panel is ragged), solved as the SLAM engine solves its graph (Cauchy,
    adaptive GNC from 16): kernel against the host loop: the same
    decisions up to a parting at a tie."""
    g = _noisy_ring(M, n, seed=M + n, slots=max(64, 2 * M))
    kw = dict(iterations=asked, use_robust=True, cauchy_c=1.0,
              gnc_init=16.0, gnc_adaptive=True)
    got, run, want, run_h = _kernel_and_plain(g, cuda, **kw)
    _assert_graph_close(got, run, want, run_h, g, kw)


@pytest.mark.parametrize("M, n, v, C", [
    (32, 20, 3, 1),     # column 18: inside panel 1, one CTA
    (64, 40, 8, 4),     # column 48: the first column of panel 3, on CTA 3
    (128, 100, 48, 16),  # column 288: the first column of panel 18, CTA 2
])
def test_pose_graph_kernel_stops_at_a_failed_pivot(cuda, M, n, v, C):
    """A graph whose first failed pivot is column 6 v, inside a panel or
    at a panel's first column past a cluster boundary (the panel before it
    on another CTA): every CTA stops at that pivot and the step is zeroed
    (step norm 0, the poses unchanged), as on the host loop (cuSOLVER's
    info != 0)."""
    g = _not_pd_graph_at(M, n, v)
    kw = dict(iterations=3, use_robust=False)
    assert pose_graph.kernel_plan(M, g.edge_i.shape[0])[1] == C
    got, run, want, run_h = _kernel_and_plain(g, cuda, **kw)
    assert run[1][0, 2] == 0 and run_h[1][0, 2] == 0
    assert torch.equal(got[0].poses.cpu(), torch.from_numpy(g.poses))
    _assert_graph_close(got, run, want, run_h, g, kw)


def _overflowing_gradient_graph(M, n, seed=4):
    """_noisy_ring plus an edge 0 -> 1 with a 2 m translation residual and
    translation information 2e38 (rotation 0): its block of H stays finite
    (~2e38) and every pivot passes, but its gradient, 4e38, overflows f32,
    so the factorization succeeds and the step is not finite."""
    g = _noisy_ring(M, n, seed, slots=max(64, 2 * M))
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 0, 1
    g.measurements[e] = (se3_np.inverse(g.poses[0]) @ g.poses[1]
                         @ se3_np.exp(np.array([-2.0, 0, 0, 0, 0, 0])))
    g.information[e] = np.diag([2e38] * 3 + [0.0] * 3)
    g.edge_mask[e] = True
    return g._replace(num_edges=np.asarray(e + 1, np.int32))


@pytest.mark.parametrize("M, n, C", [(64, 40, 4), (128, 100, 16)])
def test_pose_graph_kernel_zeroes_a_non_finite_step(cuda, M, n, C):
    """A step that is not finite after a factorization that succeeded, in
    a cluster: every CTA zeroes it (step norm 0, the poses unchanged, one
    step: the zero step is accepted at the same infinite chi2 and stops
    the loop), as on the host loop (info 0, then the step zeroed)."""
    g = _overflowing_gradient_graph(M, n)
    kw = dict(iterations=3, use_robust=False)
    assert pose_graph.kernel_plan(M, g.edge_i.shape[0])[1] == C
    got, run, want, run_h = _kernel_and_plain(g, cuda, **kw)
    assert run[0] == run_h[0] == 1
    assert run[1][0, 2] == 0 and run_h[1][0, 2] == 0
    assert torch.equal(got[0].poses.cpu(), torch.from_numpy(g.poses))
    _assert_graph_close(got, run, want, run_h, g, kw)


def test_pose_graph_kernel_past_the_staging_limit(cuda):
    """One CTA whose per-edge blocks do not fit beside its panels (M = 32,
    1 024 edge slots, 832 fit) keeps them in global scratch: a noisy ring
    whose 32 edges are each repeated 27 times (864 real edges; the repeats
    sum in the plans' order), solved as the SLAM engine solves its graph,
    against the host loop."""
    g = _noisy_ring(32, 24, seed=11, slots=1024)
    ne = int(g.num_edges)
    edges = [(int(g.edge_i[e]), int(g.edge_j[e]), g.measurements[e],
              g.information[e]) for e in range(ne)] * 27
    g = _with_edges(g, int(g.num_vertices), edges)
    assert pose_graph.kernel_plan(32, 1024)[1] == 1
    assert pose_graph.kernel_plan(32, 1024)[5] == 0  # not staged
    kw = dict(iterations=100, use_robust=True, cauchy_c=1.0, gnc_init=16.0,
              gnc_adaptive=True)
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
    Python side) agree on the limit, the CTAs, the panel width, the shared
    memory, where the per-edge blocks live and the global scratch."""
    import ctypes

    from dvo_slam_tpu_torch import _build

    lib = _build.load()
    for M in (*range(1, 130), 256):
        for E in (0, 64, 4096):
            out = (ctypes.c_int * 7)()
            assert lib.dvo_pose_graph_plan(M, E, out) == 0
            assert tuple(out) == pose_graph.kernel_plan(M, E)


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


# --- the grid kernel (csrc/pose_graph_grid.cu) against the host loop ---
# Every CUDA solve the cluster kernel does not take: dense past 128 vertex
# slots, CG at any size. The host loop's CG reads its stop test back once a
# CG iteration (up to 4M a step), so each case runs a few LM steps.

GRID_CASES = {
    "dense256": (256, 150, "dense", 6),
    "dense512": (512, 300, "dense", 4),
    "cg64": (64, 40, "cg", 4),
    "cg512": (512, 300, "cg", 3),
}
GRID_KW = dict(use_robust=True, cauchy_c=1.0, gnc_init=16.0,
               gnc_adaptive=True)


def _grid_and_plain(g, dev, solver, **kw):
    before = (pose_graph.LAUNCHES, pose_graph.LAUNCHES_GRID)
    got = pose_graph.optimize(g, device=dev, solver=solver, **kw)
    run = (int(pose_graph.LAST_STEPS), pose_graph.LAST_STATS.cpu().numpy())
    assert (pose_graph.LAUNCHES, pose_graph.LAUNCHES_GRID) == (
        before[0], before[1] + 1)
    want = pose_graph.optimize_reference(g, device=dev, solver=solver, **kw)
    return got, run, want, (int(pose_graph.LAST_STEPS),
                            pose_graph.LAST_STATS.cpu().numpy())


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_pose_graph_grid_matches_host_loop(cuda, case):
    """Seeded noisy rings past 128 vertex slots (dense) and at 64 and 512
    (CG) through one grid launch and through the host loop on the card:
    poses within 1e-4, chi2 rtol 1e-4, weights against the plain formula
    at the grid's poses, LAST_STEPS and LAST_STATS the same decisions up
    to a parting at a tie (phase 5f's rule)."""
    M, n, solver, iterations = GRID_CASES[case]
    g = _noisy_ring(M, n, seed=M + n, slots=2 * M)
    assert pose_graph.graph_route(solver, M, cuda) == "grid"
    kw = dict(GRID_KW, iterations=iterations)
    got, run, want, run_h = _grid_and_plain(g, cuda, solver, **kw)
    _assert_graph_close(got, run, want, run_h, g, kw)
    assert run[0] > 0


@pytest.mark.parametrize("case", ["dense256", "cg512"])
def test_pose_graph_grid_is_deterministic(cuda, case):
    M, n, solver, iterations = GRID_CASES[case]
    g = _noisy_ring(M, n, seed=5, slots=2 * M)
    kw = dict(GRID_KW, iterations=iterations, solver=solver)
    runs = [pose_graph.optimize(g, device=cuda, **kw) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r[0].poses, runs[0][0].poses)
        assert torch.equal(r[1], runs[0][1]) and torch.equal(r[2], runs[0][2])


@pytest.mark.parametrize("v", [48, 50])
def test_pose_graph_grid_stops_at_a_failed_pivot(cuda, v):
    """A 256-slot graph whose first failed pivot is column 6 v (288: the
    first column of tile column 9; 300: inside it): every CTA stops at that
    pivot and the step is zeroed (step norm 0, the poses unchanged), as on
    the host loop (cuSOLVER's info != 0)."""
    g = _not_pd_graph_at(256, 150, v)
    kw = dict(iterations=3, use_robust=False)
    got, run, want, run_h = _grid_and_plain(g, cuda, "dense", **kw)
    assert run[1][0, 2] == 0 and run_h[1][0, 2] == 0
    assert torch.equal(got[0].poses.cpu(), torch.from_numpy(g.poses))
    _assert_graph_close(got, run, want, run_h, g, kw)


@pytest.mark.parametrize("M, n, v", [(256, 150, 54), (256, 256, 254)])
def test_pose_graph_grid_stops_at_a_failed_pivot_in_a_panel(cuda, M, n, v):
    """The dense factorization in panels of two tile columns: a first
    failed pivot at column 6 v = 324 (tile column 10, the first of panel 5:
    its first diagonal factor) and at 1 524 (tile column 47, the last of
    the matrix, the second factor of the last panel, every vertex active):
    every CTA stops there and the step is zeroed as on the host loop; the
    kernel and the host loop both record a failed pivot (LAST_ZEROED)."""
    g = _not_pd_graph_at(M, n, v)
    kw = dict(iterations=3, use_robust=False)
    got, run, want, run_h = _grid_and_plain(g, cuda, "dense", **kw)
    zeroed = pose_graph.LAST_ZEROED.cpu()
    assert run[1][0, 2] == 0 and run_h[1][0, 2] == 0
    assert int(zeroed[0]) == pose_graph.ZEROED_PIVOT
    optimize = pose_graph.optimize(g, device=cuda, solver="dense", **kw)
    assert int(pose_graph.LAST_ZEROED[0]) == pose_graph.ZEROED_PIVOT
    assert torch.equal(optimize[0].poses, got[0].poses)
    assert torch.equal(got[0].poses.cpu(), torch.from_numpy(g.poses))
    _assert_graph_close(got, run, want, run_h, g, kw)


def _full_window(M, n, seed=0):
    """_noisy_ring's first n keyframes (no false edge) with every pair of
    keyframes joined by an edge, padded to M vertex slots: a factor whose
    active tiles all fill in (phase 5g's graphs, a keyframe every frame)."""
    g = _noisy_ring(M, n, seed, slots=2 * M)
    rng = np.random.default_rng(seed + 1)
    sigma = np.array([5e-3] * 3 + [1e-2] * 3)
    info = np.diag(1.0 / sigma**2)
    poses = g.poses[:n].astype(np.float64)
    edges = [(j, i, se3_np.inverse(poses[j]) @ poses[i]
              @ se3_np.exp(rng.normal(size=6) * sigma), info)
             for i in range(n) for j in range(i + 1, n)]
    full = pose_graph.empty_graph_host(M, pose_graph.bucket(len(edges), 64))
    full.poses[:] = g.poses
    return _with_edges(full, n, edges)


def _hub_ring(M, n, hub, degree, seed=0):
    """_noisy_ring plus `degree` edges from vertex `hub` to the ring's
    other keyframes (measured at the initial poses with _noisy_ring's
    noise): a vertex with that many incident edges."""
    g = _noisy_ring(M, n, seed, slots=2 * M)
    rng = np.random.default_rng(seed + 2)
    sigma = np.array([5e-3] * 3 + [1e-2] * 3)
    e0 = int(g.num_edges)
    others = [j for j in range(n) if abs(j - hub) > 1][:degree]
    for e, j in enumerate(others, start=e0):
        g.edge_i[e], g.edge_j[e] = hub, j
        g.measurements[e] = (se3_np.inverse(g.poses[hub].astype(np.float64))
                             @ g.poses[j] @ se3_np.exp(rng.normal(size=6)
                                                       * sigma))
        g.information[e] = np.diag(1.0 / sigma**2)
        g.edge_mask[e] = True
    return g._replace(num_edges=np.asarray(e0 + len(others), np.int32))


NEW_GRID_CASES = {
    # the fill of a two-lap ring: about a third of the tiles
    "sparse_fill_ring512": (lambda: two_lap_ring(512), "dense", 4),
    # every active tile filled in, 136 keyframes in 256 slots
    "full_fill_window256": (lambda: _full_window(256, 136), "dense", 4),
    # CG with a vertex of 200 incident edges
    "cg_hub512": (lambda: _hub_ring(512, 300, 5, 200), "cg", 3),
}


@pytest.mark.parametrize("case", sorted(NEW_GRID_CASES))
def test_pose_graph_grid_fill_and_hubs_match_host_loop(cuda, case):
    """A graph whose factor stays mostly zero (the ring: the kernel skips
    those tiles), one whose factor fills in completely, and a CG solve over
    a vertex with 200 incident edges (its edges split over a group of
    lanes): one grid launch against the host loop by phase 5f's rule, and
    a second launch on the same inputs gives the same bits."""
    make, solver, iterations = NEW_GRID_CASES[case]
    g = make()
    M = g.poses.shape[0]
    if case.startswith("cg"):
        off, _ = pose_graph._csr(pose_graph._plan_targets(g)[0], M,
                                 np.tile(np.asarray(g.edge_mask), 2))
        assert np.diff(off).max() >= 200
    kw = dict(GRID_KW, iterations=iterations)
    got, run, want, run_h = _grid_and_plain(g, cuda, solver, **kw)
    _assert_graph_close(got, run, want, run_h, g, kw)
    assert run[0] > 0
    again = pose_graph.optimize(g, device=cuda, solver=solver, **kw)
    assert torch.equal(again[0].poses, got[0].poses)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_grid_zeroes_a_non_finite_step(cuda, solver):
    """A step that is not finite (the gradient overflows f32 while every
    pivot passes): zeroed on every CTA, one step, the poses unchanged, as
    on the host loop."""
    g = _overflowing_gradient_graph(256, 150)
    kw = dict(iterations=3, use_robust=False)
    got, run, want, run_h = _grid_and_plain(g, cuda, solver, **kw)
    assert run[0] == run_h[0] == 1
    assert run[1][0, 2] == 0 and run_h[1][0, 2] == 0
    assert torch.equal(got[0].poses.cpu(), torch.from_numpy(g.poses))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_grid_issues_no_host_sync(cuda, solver):
    """The grid route uploads from pinned memory without blocking,
    allocates its scratch and zeroes its barrier on the stream, and reads
    nothing back: set_sync_debug_mode("error") raises on any sync."""
    g = _noisy_ring(256, 150, seed=1, slots=512)
    pose_graph.optimize(g, iterations=2, solver=solver, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pose_graph.optimize(g, iterations=5, solver=solver,
                                  device=cuda, **GRID_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out[0].poses).all()


def test_pose_graph_grid_plan_matches_python(cuda):
    """dvo_pose_graph_grid_plan (the source) and grid_plan (the wrapper's
    Python side) agree on the CTAs, threads, shared memory, tile width,
    tiles a side and scratch; both refuse what the kernel does not take."""
    import ctypes

    from dvo_slam_tpu_torch import _build

    lib = _build.load()
    for M in (1, 17, 129, 150, 256, 512, 1024, 2560):
        for E in (0, 64, 4096):
            for solver in pose_graph.SOLVERS:
                for ctas in (1, 132):
                    out = (ctypes.c_int64 * 7)()
                    assert lib.dvo_pose_graph_grid_plan(
                        M, E, pose_graph.SOLVERS.index(solver), ctas,
                        out) == 0
                    assert tuple(out) == pose_graph.grid_plan(M, E, solver,
                                                              ctas)
    out = (ctypes.c_int64 * 7)()
    assert lib.dvo_pose_graph_grid_plan(0, 64, 0, 132, out) != 0


def test_pose_graph_grid_refuses_a_grid_the_card_cannot_hold(cuda,
                                                             monkeypatch):
    """More CTAs than the card holds at once: the launch is refused and
    raises with the message; nothing falls back to the host loop."""
    from dvo_slam_tpu_torch import _build

    g = _noisy_ring(256, 150, seed=2, slots=512)
    monkeypatch.setattr(_build, "sm_count", lambda index: 100_000)
    before = pose_graph.LAUNCHES_GRID
    with pytest.raises(RuntimeError, match="dvo_pose_graph_grid failed"):
        pose_graph.optimize(g, iterations=2, device=cuda)
    assert pose_graph.LAUNCHES_GRID == before


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_grid_phase_stamps(cuda, solver):
    """The timing buffer: six phases a step, each >= 0, summing to at most
    the launch's span; the CG iterations of each step (0 for dense)."""
    g = _noisy_ring(256, 150, seed=3, slots=512)
    kw = dict(GRID_KW, iterations=3)
    buf = torch.zeros(pose_graph.grid_timing_size(3), dtype=torch.int64,
                      device=cuda)
    pose_graph.optimize_grid(g, device=cuda, timing=buf, solver=solver, **kw)
    steps = int(pose_graph.LAST_STEPS)
    split, span, its = pose_graph.grid_phase_times(buf.cpu().numpy(), steps,
                                                   solver)
    assert steps == 3 and span > 0
    assert all(v >= 0 for v in split.values())
    assert sum(split.values()) * steps <= span
    assert (min(its) > 0) if solver == "cg" else its == [0] * steps


def test_pose_graph_grid_on_a_card_that_is_not_current(cuda):
    """A grid solve on card 1 while card 0 is current launches on card 1
    and leaves the current card as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    g = _noisy_ring(256, 150, seed=7, slots=512)
    kw = dict(GRID_KW, iterations=4)
    with torch.cuda.device(cuda):
        got = pose_graph.optimize(g, device=second, **kw)
        assert torch.cuda.current_device() == cuda.index
    want = pose_graph.optimize(g, device=cuda, **kw)
    assert got[0].poses.device == second
    assert torch.equal(got[0].poses.cpu(), want[0].poses.cpu())


# ---- the frame's front: csrc/pyramid.cu, the level kernel's slab route,
# and the track result written by the level launches

def _bit_diff(a, b):
    """Entries of two float tensors whose bits differ (NaN against NaN,
    whatever the payload, counts as equal)."""
    an, bn = torch.isnan(a), torch.isnan(b)
    return int(((a.contiguous().view(torch.int32)
                 != b.contiguous().view(torch.int32)) & ~(an & bn)).sum())


def _front_inputs(w, h, encoding, seed=5):
    """A noisy frame of the orbit (2 % depth dropout) at w x h in one of
    the inputs build_pyramid takes."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    K = (525.0 * w / 640.0, 525.0 * h / 480.0, (w - 1) / 2.0, (h - 1) / 2.0)
    i, z = synthetic.add_sensor_noise(
        *scene.render(np.asarray(K), w, h, np.eye(4)),
        np.random.default_rng(seed), dropout=0.02)
    if encoding == "f32":
        return i, z
    i8 = np.clip(np.round(i), 0, 255).astype(np.uint8)
    z16 = np.where(np.isfinite(z), np.round(z * 5000.0), 0).astype(np.uint16)
    if encoding == "u8+u16":
        return i8, z16
    return i8, pyramid.pack_depth12(z16)


def _assert_pyramid_matches_plain(ti, tz, levels):
    before = pyramid.LAUNCHES_PYRAMID
    got = pyramid.build_pyramid(ti, tz, levels)
    assert pyramid.LAUNCHES_PYRAMID - before == 1
    want = pyramid.build_pyramid_reference(ti, tz, levels)
    assert [g.shape for g in got] == [x.shape for x in want]
    assert bool(torch.isnan(want[0][pyramid.CH_Z]).any())
    for lvl, (g, x) in enumerate(zip(got, want)):
        assert g.is_contiguous() and g.device == ti.device
        assert _bit_diff(g, x) == 0, lvl


@pytest.mark.parametrize("levels", [1, 4, 5, 6])
@pytest.mark.parametrize("size", [(640, 480), (640, 470), (642, 482),
                                  (82, 61)])
@pytest.mark.parametrize("encoding", ["f32", "u8+u16", "u8+packed12",
                                      "u8+f32"])
def test_pyramid_kernel_matches_plain(cuda, encoding, size, levels):
    """Every level's slab bit for bit against build_pyramid_reference on
    the same card tensors (odd sizes drop a trailing row or column at each
    downsample; NaN depth propagates into the gradients); one launch. 640
    wide takes the TMA fill (640x470: rows aligned, the height not a
    multiple of the 32-pixel tile), 642 and 82 the scalar fill."""
    w, h = size
    if encoding == "u8+packed12" and w % 2:
        pytest.skip("12-bit packing needs an even width")
    if encoding == "u8+f32":
        i, z = _front_inputs(w, h, "u8+u16")[0], _front_inputs(w, h, "f32")[1]
    else:
        i, z = _front_inputs(w, h, encoding)
    ti, tz = torch.as_tensor(i, device=cuda), torch.as_tensor(z, device=cuda)
    assert pyramid.tma_fill(ti, tz) is (w == 640)
    _assert_pyramid_matches_plain(ti, tz, levels)


@pytest.mark.parametrize("levels", [1, 4, 6])
@pytest.mark.parametrize("encoding", ["f32", "u8+u16", "u8+packed12"])
def test_pyramid_kernel_misaligned_input(cuda, encoding, levels):
    """Contiguous 640x480 inputs whose base is one element into a larger
    buffer (not 16-B aligned) take the scalar fill; bit for bit."""
    w, h = 640, 480
    i, z = _front_inputs(w, h, encoding)
    ti, tz = (torch.empty(a.size + 1, dtype=t.dtype, device=cuda)[1:]
              .view(t.shape).copy_(t) for a, t in (
                  (a, torch.as_tensor(a, device=cuda)) for a in (i, z)))
    assert ti.is_contiguous() and tz.is_contiguous()
    assert not pyramid.tma_fill(ti, tz)
    _assert_pyramid_matches_plain(ti, tz, levels)


def test_pyramid_kernel_phase_stamps(cuda):
    """The timing entry point (a phase-timing buffer) writes the same
    slabs, one launch, and stamps every CTA in order."""
    i, z = _front_inputs(640, 480, "u8+u16")
    ti, tz = torch.as_tensor(i, device=cuda), torch.as_tensor(z, device=cuda)
    buf = pyramid.timing_buffer(480, 640, cuda)
    got = pyramid.build_pyramid_kernel(ti, tz, 4, timing=buf)
    want = pyramid.build_pyramid_kernel(ti, tz, 4)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert _bit_diff(g, x) == 0
    stamps = buf.cpu().numpy()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gx, gy = pyramid.kernel_grid(480, 640, pyramid.tile_rows(480, 640, 4, sms))
    assert (stamps[gx * gy:] == 0).all()
    stamps = stamps[:gx * gy]
    assert (stamps[:, 1] >= stamps[:, 0]).all() and (stamps[:, 0] > 0).all()
    assert (np.diff(stamps[:, 2:5 + 3 * 3 + 3], axis=1) >= 0).all()
    phases, span, cta = pyramid.phase_times(stamps, 4)
    assert 0 < cta <= span and all(t >= 0 for t in phases.values())


@pytest.mark.parametrize("case", ["f64 intensity", "i16 intensity",
                                  "i32 depth", "depth shape",
                                  "packed odd width", "3-d intensity",
                                  "7 levels", "too many levels",
                                  "depth on cpu"])
def test_pyramid_kernel_rejects(cuda, case):
    """An input the kernel does not take raises; nothing falls back to the
    plain version and nothing launches."""
    w, h = 64, 48
    i = torch.rand(h, w, device=cuda) * 255
    z = torch.rand(h, w, device=cuda) + 0.5
    levels = 4
    if case == "f64 intensity":
        i = i.double()
    elif case == "i16 intensity":
        i = i.to(torch.int16)
    elif case == "i32 depth":
        z = (z * 5000).to(torch.int32)
    elif case == "depth shape":
        z = z[:, :-1]
    elif case == "packed odd width":
        i = i[:, :-1]
        z = torch.zeros(h, 3 * ((w - 1) // 2), dtype=torch.uint8, device=cuda)
    elif case == "3-d intensity":
        i = i[None]
    elif case == "7 levels":
        levels = 7
    elif case == "too many levels":
        i, z = i[:4, :4], z[:4, :4]
    elif case == "depth on cpu":
        z = z.cpu()
    before = pyramid.LAUNCHES_PYRAMID
    with pytest.raises((TypeError, ValueError)):
        pyramid.build_pyramid(i, z, levels)
    assert pyramid.LAUNCHES_PYRAMID == before


@pytest.fixture(scope="module")
def noisy9():
    """Nine noisy 640x480 frames of the orbit (2 % depth dropout) and
    their poses."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(24, radius=0.06)[:9]
    rng = np.random.default_rng(3)
    return [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K640), W640, H640, T), rng, dropout=0.02)
        for T in poses], poses


FRONT_CONFIGS = {**FUSED_CONFIGS,
                 "thresholds": {"intensity_grad_threshold": 1.0,
                                "depth_grad_threshold": 0.005}}


def _front_batch(noisy, dev, B, level, cfg):
    """B reference slabs of the noisy orbit at one level (as a stacked
    tensor, or by row pointers at B = 2), the current slab (shared, or one
    a row at B = 8), K, perturbed poses and Sigma seeds."""
    frames, poses = noisy
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=dev),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                  torch.as_tensor(z, device=dev),
                                  cfg.num_levels)[level]
            for i, z in frames[:B + 1]]
    paired = B == 8
    cur = torch.stack(pyrs[1:B + 1]) if paired else pyrs[B]
    rng = np.random.default_rng(4)
    T = np.stack([(se3_np.inverse(poses[b + 1] if paired else poses[B])
                   @ poses[b]) @ se3_np.exp(rng.normal(scale=2e-3, size=6))
                  for b in range(B)])
    rows = tuple(pyrs[:B]) if B == 2 else torch.stack(pyrs[:B])
    sigma = torch.tensor([[[40.0 + b, 0.01], [0.01, 1e-3]]
                          for b in range(B)], device=dev)
    return (rows, torch.stack(pyrs[:B]), cur, Ks[level],
            torch.as_tensor(T, dtype=torch.float32, device=dev), sigma)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("level", [3, 1, 0])
@pytest.mark.parametrize("name", sorted(FRONT_CONFIGS))
def test_slab_route_matches_refdata_route(cuda, noisy9, name, level, B):
    """Both modes of the level kernel reading the reference points from
    the slabs (RefSlabs) give the bits of the same kernel reading them
    from prepare_reference's RefData: mode (a)'s Linearization and rI,
    rZ, valid; mode (b)'s whole output rows (pose, record, statistics,
    the selected count) and iterations. Level 0 (640x480) keeps no point
    in shared memory: every pass recomputes its points from the slab.
    The slab route makes no prepare_reference call."""
    cfg = dataclasses.replace(TrackerConfig(), **FRONT_CONFIGS[name])
    rows, stacked, cur, K, T, sigma = _front_batch(noisy9, cuda, B, level,
                                                   cfg)
    ref = linearize.prepare_reference(stacked, K, cfg)
    N = ref.px.shape[1]
    got = []
    for r in (linearize.RefSlabs(rows), ref):
        calls = linearize.PREPARE_REFERENCE_CALLS
        lin = linearize.linearize_kernels_batched(r, cur, K, T, cfg, sigma,
                                                  True)
        res = [t.clone() for t in linearize.kernel_residuals(cuda, N, B)]
        out, out_i = linearize.track_level_kernels(r, cur, K, T, cfg)
        assert linearize.PREPARE_REFERENCE_CALLS == calls
        got.append((lin, res, out, out_i))
    (lin_s, res_s, o_s, oi_s), (lin_r, res_r, o_r, oi_r) = got
    for field, a, b in zip(lin_s._fields, lin_s[:-1], lin_r[:-1]):
        assert _bit_diff(a, b) == 0, field
    for field, a, b in zip(("rI", "rZ", "valid"), res_s, res_r):
        assert torch.equal(a, b), field
    assert _bit_diff(o_s, o_r) == 0
    assert torch.equal(oi_s, oi_r)
    sel = o_s[:, linearize._LEVEL_STATS + linearize._STAT_PLANES
              * cfg.max_iterations + linearize._EXTRA_SELECTED]
    assert torch.equal(sel, ref.selected.sum(-1).float())


def test_slab_route_rejects_bad_references(cuda, noisy9):
    """A reference the slab route does not take raises before a launch:
    more row pointers than the kernel holds, slabs of another level's
    shape. A point budget launches (the kernel compacts the slab's
    points itself)."""
    cfg = TrackerConfig()
    rows, stacked, cur, K, T, _ = _front_batch(noisy9, cuda, 2, 3, cfg)
    before = linearize.LAUNCHES_TRACK_LEVEL
    many = tuple([rows[0]] * 33)
    with pytest.raises(ValueError):
        linearize.track_level_kernels(linearize.RefSlabs(many), cur, K,
                                      T[:1].expand(33, 4, 4), cfg)
    with pytest.raises(ValueError):
        linearize.track_level_kernels(
            linearize.RefSlabs(stacked[:, :, :-1]), cur, K, T, cfg)
    assert linearize.LAUNCHES_TRACK_LEVEL == before
    budget_cfg = dataclasses.replace(cfg, point_budget_fraction=0.5)
    out, out_i = linearize.track_level_kernels(linearize.RefSlabs(rows), cur,
                                               K, T, budget_cfg)
    assert linearize.LAUNCHES_TRACK_LEVEL == before + 1
    h, w = cur.shape[-2:]
    sel = out[:, linearize._LEVEL_STATS + linearize._STAT_PLANES
              * budget_cfg.max_iterations + linearize._EXTRA_SELECTED]
    assert (sel == linearize.ref_budget(budget_cfg, h, w)).all()
    assert (out_i[:, 0] >= 1).all()


# ---- compaction on the slab route: the launch picks each slot's pixel

BUDGET_FRONT = {
    "b50_t1": {"intensity_grad_threshold": 1.0, "point_budget_fraction": 0.5},
    "b90_t3": {"intensity_grad_threshold": 3.0, "point_budget_fraction": 0.9},
    "b25_t0": {"point_budget_fraction": 0.25},
    "b50_refgrad": {"gradient_source": "reference",
                    "intensity_grad_threshold": 1.0,
                    "depth_grad_threshold": 0.005,
                    "point_budget_fraction": 0.5},
}


def _table_of(stacked):
    """A SlabTable over the rows of a (B, 6, H, W) tensor."""
    ptrs = torch.tensor([r.data_ptr() for r in stacked.unbind(0)],
                        dtype=torch.int64, device=stacked.device)
    return linearize.SlabTable(ptrs, tuple(stacked.shape[1:]),
                               [(r,) for r in stacked.unbind(0)], 0)


def _budget_routes(rows, stacked, cur, K, T, sigma, cfg):
    """Both modes of the level kernel under cfg's point budget on the slab
    route (``rows`` as given, and through a SlabTable of ``stacked``) and on
    the RefData route over prepare_reference's compacted points: the
    compacted points and, per route, (Linearization, [rI, rZ, valid], out,
    out_i). The slab routes make no prepare_reference call."""
    ref = linearize.prepare_reference(stacked, K, cfg)
    N, B = ref.px.shape[1], T.shape[0]
    assert N == linearize.ref_budget(cfg, *cur.shape[-2:])
    routes = {"slabs": linearize.RefSlabs(rows),
              "table": linearize.RefSlabs(_table_of(stacked)),
              "points": ref}
    got = {}
    for name, r in routes.items():
        calls = linearize.PREPARE_REFERENCE_CALLS
        lin = linearize.linearize_kernels_batched(r, cur, K, T, cfg, sigma,
                                                  True)
        res = [t.clone() for t in linearize.kernel_residuals(cur.device, N,
                                                             B)]
        out, out_i = linearize.track_level_kernels(r, cur, K, T, cfg)
        assert linearize.PREPARE_REFERENCE_CALLS == calls
        got[name] = (lin, res, out, out_i)
    return ref, got


def _assert_routes_equal(ref, got, cfg):
    """Every slab route's outputs the RefData route's bits, and the
    selected count the compacted selection's."""
    lin_r, res_r, o_r, oi_r = got["points"]
    for name in ("slabs", "table"):
        lin_s, res_s, o_s, oi_s = got[name]
        for field, a, b in zip(lin_s._fields, lin_s[:-1], lin_r[:-1]):
            assert _bit_diff(a, b) == 0, (name, field)
        for field, a, b in zip(("rI", "rZ", "valid"), res_s, res_r):
            assert torch.equal(a, b), (name, field)
        assert _bit_diff(o_s, o_r) == 0, name
        assert torch.equal(oi_s, oi_r), name
        sel = o_s[:, linearize._LEVEL_STATS + linearize._STAT_PLANES
                  * cfg.max_iterations + linearize._EXTRA_SELECTED]
        assert torch.equal(sel, ref.selected.sum(-1).float()), name


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("level", [3, 2, 1])
@pytest.mark.parametrize("name", sorted(BUDGET_FRONT))
def test_slab_route_at_budget_matches_refdata_route(cuda, noisy9, name,
                                                    level, B):
    """Under a point budget, both modes of the level kernel on the slab
    route (by stride at B = 1 and 8, by row pointers at B = 2, and through
    a SlabTable), whose launches pick each slot's pixel themselves, give
    the bits of the same kernel over prepare_reference's compacted points:
    mode (a)'s Linearization and rI, rZ, valid; mode (b)'s whole output
    rows (pose, record, statistics, the selected count) and iterations."""
    cfg = dataclasses.replace(TrackerConfig(), **BUDGET_FRONT[name])
    rows, stacked, cur, K, T, sigma = _front_batch(noisy9, cuda, B, level,
                                                   cfg)
    ref, got = _budget_routes(rows, stacked, cur, K, T, sigma, cfg)
    if name == "b25_t0" and level < 3:
        # More points selected than slots: decimated, every slot filled.
        assert bool(ref.selected.all())
    _assert_routes_equal(ref, got, cfg)


@pytest.mark.parametrize("level", [3, 2, 1])
def test_slab_route_at_budget_blank_reference(cuda, noisy9, level):
    """A reference row with no finite depth at a point budget: no slot is
    filled, the row's level stops at its first iteration with too few
    constraints, and both routes give the same bits; the other row is
    untouched by it."""
    cfg = dataclasses.replace(TrackerConfig(), **BUDGET_FRONT["b50_t1"])
    rows, stacked, cur, K, T, sigma = _front_batch(noisy9, cuda, 2, level,
                                                   cfg)
    stacked = stacked.clone()
    stacked[1, pyramid.CH_Z] = float("nan")
    rows = tuple(stacked.unbind(0))
    ref, got = _budget_routes(rows, stacked, cur, K, T, sigma, cfg)
    assert not bool(ref.selected[1].any()) and bool(ref.selected[0].any())
    _assert_routes_equal(ref, got, cfg)
    lin, _, out, out_i = got["slabs"]
    assert float(lin.n_raw[1]) == 0.0 and float(lin.n_raw[0]) > 0.0
    assert out_i[1].tolist() == [1, dense_tracker.TERM_TOO_FEW_CONSTRAINTS]


@pytest.mark.parametrize("where", ["points_recomputed", "global_slots"])
def test_slab_route_at_budget_past_shared_memory(cuda, noisy9, where):
    """Where a CTA's slots do not fit in shared memory: 640x480's level 0 at
    budget 0.5 (9 600 slots a CTA: the points are recomputed every pass,
    the slot table stays in shared memory) and a 1280x960 slab at budget
    1.0 (76 800 slots a CTA: the slot table goes to a global (B, budget)
    table the wrapper allocates). The slab route gives the RefData route's
    bits in both modes."""
    cfg = dataclasses.replace(TrackerConfig(), max_iterations=4,
                              **BUDGET_FRONT["b50_t1"])
    if where == "points_recomputed":
        rows, stacked, cur, K, T, sigma = _front_batch(noisy9, cuda, 2, 0,
                                                       cfg)
        want_plan = (16, 9600, False, 38400, True)
    else:
        cfg = dataclasses.replace(cfg, point_budget_fraction=1.0)
        w, h = 2 * W640, 2 * H640
        Kt = (1050.0, 1050.0, (w - 1) / 2.0, (h - 1) / 2.0)
        scene = synthetic.two_plane_scene(sharpness=2.0)
        poses = synthetic.orbit_trajectory(24, radius=0.06)
        frames = [synthetic.add_sensor_noise(
            *scene.render(np.asarray(Kt), w, h, poses[k]),
            np.random.default_rng(k), dropout=0.02) for k in range(2)]
        slabs = [pyramid.build_pyramid(torch.as_tensor(i, device=cuda),
                                       torch.as_tensor(z, device=cuda), 1)[0]
                 for i, z in frames]
        stacked, cur = slabs[0][None], slabs[1]
        rows = stacked
        K = camera.intrinsics(*Kt, device=cuda)
        T = torch.as_tensor(se3_np.inverse(poses[1]) @ poses[0],
                            dtype=torch.float32, device=cuda)[None]
        sigma = torch.tensor([[[40.0, 0.01], [0.01, 1e-3]]], device=cuda)
        want_plan = (16, 76800, False, 0, False)
    N = linearize.ref_budget(cfg, *cur.shape[-2:])
    assert linearize.level_plan(cuda, N, True) == want_plan
    ref, got = _budget_routes(rows, stacked, cur, K, T, sigma, cfg)
    _assert_routes_equal(ref, got, cfg)


def test_budget_paths_run_on_the_kernel_front(cuda, monkeypatch):
    """At a point budget every single-card path runs the kernel front:
    odometry one pyramid and three level launches a frame; KeyframeSlam's
    pairs and validation batches (a loop edge accepted) and
    ChunkedKeyframeSlam's scan (five launches a frame, submit_chunk with
    no synchronizing call) level launches only. None makes a
    prepare_reference or scan_step_reference call, or a mode (a) or
    standalone sampler launch."""
    from dvo_slam_tpu_torch import KeyframeSlam, SlamConfig
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker
    from dvo_slam_tpu_torch.ops import scan_step

    plain = {"scan_step_reference": 0}
    step_reference = scan_step.scan_step_reference

    def counted(*args, **kwargs):
        plain["scan_step_reference"] += 1
        return step_reference(*args, **kwargs)

    monkeypatch.setattr(scan_step, "scan_step_reference", counted)

    def counts():
        return (pyramid.LAUNCHES_PYRAMID, linearize.LAUNCHES_TRACK_LEVEL,
                scan_step.LAUNCHES_SCAN_STEP, linearize.LAUNCHES_LINEARIZE,
                sampler.LAUNCHES, linearize.PREPARE_REFERENCE_CALLS,
                plain["scan_step_reference"])

    cfg = TrackerConfig(intensity_grad_threshold=1.0,
                        point_budget_fraction=0.5)
    frames, _ = _ring640(24)
    tracker = OdometryTracker(K640, cfg, device=cuda)
    before = counts()
    for k, (i, z) in enumerate(frames[:9]):
        tracker.update(i, z, float(k))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [9, 24, 0, 0, 0, 0, 0]

    W, H = 160, 120
    K = (525.0 * W / 640.0, 525.0 * H / 480.0, (W - 1) / 2.0, (H - 1) / 2.0)
    ring = synthetic.orbit_trajectory(9, radius=0.06)[:8]
    small = synthetic.render_sequence(synthetic.two_plane_scene(
        sharpness=2.0), np.asarray(K), W, H, ring)
    cfg3 = dataclasses.replace(cfg, num_levels=3, first_level=2,
                               last_level=0)
    slam = KeyframeSlam(K, cfg3, SlamConfig(), device=cuda)
    slam.init()
    before = counts()
    for k in range(72):
        if k > 0:
            slam.force_keyframe()
        slam.update(*small[k % 8], k / 30.0)
    slam.finish()
    diff = [a - b for a, b in zip(counts(), before)]
    assert diff[1] > 0 and diff[2:] == [0, 0, 0, 0, 0], diff
    assert slam.num_loop_edges >= 1

    chunked = ChunkedKeyframeSlam(K640, cfg, SlamConfig(), device=cuda)
    chunked.init()

    def chunk(a, b):
        return (np.stack([f[0] for f in frames[a:b]]),
                np.stack([f[1] for f in frames[a:b]]),
                [k / 30.0 for k in range(a, b)])

    chunked.update_chunk(*chunk(0, 8))
    torch.cuda.synchronize()
    before = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunked.submit_chunk(*chunk(8, 24))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    diff = [a - b for a, b in zip(counts(), before)]
    assert diff == [16, 48, 16, 0, 0, 0, 0], diff
    assert len(chunked.collect_chunk()) == 16


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("name", ["tdist", "thresholds", "reference_gradients"])
def test_kernel_front_matches_eager_front(cuda, noisy9, name, B):
    """track_batched's kernel front (slab route, the result written by the
    level launches) against its eager front on the same pyramids: every
    field bit for bit but the log-likelihood (rtol 1e-5: the eager f32
    normaliser) and the entropy (atol 1e-3: the eager f32 slogdet against
    the kernel's f64 LU); one launch a tracked level, no
    prepare_reference call."""
    cfg = dataclasses.replace(TrackerConfig(), **FRONT_CONFIGS[name])
    frames, _ = noisy9
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K640, device=cuda),
                                   cfg.num_levels)
    pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=cuda),
                                  torch.as_tensor(z, device=cuda),
                                  cfg.num_levels) for i, z in frames]
    refs = tuple(tuple(p[lvl] for p in pyrs[:B]) if B == 2
                 else torch.stack([p[lvl] for p in pyrs[:B]])
                 for lvl in range(cfg.num_levels))
    curs = (tuple(torch.stack([p[lvl] for p in pyrs[1:B + 1]])
                  for lvl in range(cfg.num_levels)) if B == 8 else pyrs[B])
    T0 = torch.eye(4, device=cuda).expand(B, 4, 4)
    calls = linearize.PREPARE_REFERENCE_CALLS
    launches = linearize.LAUNCHES_TRACK_LEVEL
    got = dense_tracker.track_batched(refs, curs, Ks, T0, cfg)
    assert linearize.PREPARE_REFERENCE_CALLS == calls
    assert linearize.LAUNCHES_TRACK_LEVEL - launches == len(
        cfg.tracked_levels)
    front = dense_tracker.front_route
    dense_tracker.front_route = lambda *args, **kwargs: False
    try:
        want = dense_tracker.track_batched(refs, curs, Ks, T0, cfg)
    finally:
        dense_tracker.front_route = front
    assert linearize.PREPARE_REFERENCE_CALLS - calls == len(
        cfg.tracked_levels)
    for field, a, b in zip(got._fields, got, want):
        if field == "stats":
            for f, x, y in zip(a._fields, a, b):
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert _bit_diff(x.float(), y.float()) == 0, f
        elif field == "log_likelihood":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
        elif field == "entropy":
            torch.testing.assert_close(a, b, rtol=0.0, atol=1e-3)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert _bit_diff(a.float(), b.float()) == 0, field


def test_odometry_front_copies_one_view(cuda, noisy9):
    """OdometryTracker.update's one host copy is a view of the level
    launches' output (no cat) on the kernel front, and gives the pose and
    log-likelihood of the result."""
    frames, _ = noisy9
    from dvo_slam_tpu_torch.models.odometry import OdometryTracker

    tracker = OdometryTracker(K640, TrackerConfig(), device=cuda)
    for k, (i, z) in enumerate(frames[:3]):
        tracker.update(i, z, float(k))
    res = tracker.last_result
    both = dense_tracker.pose_and_loglik(res)
    assert both.untyped_storage().data_ptr() == \
        res.transformation.untyped_storage().data_ptr()
    assert torch.equal(both[:16], res.transformation.reshape(16))
    assert torch.equal(both[-1], res.log_likelihood)


# ---- the chunked keyframe scan on the kernels: the scan step
# (csrc/keyframe_scan.cu), mode (b) through a device pointer table, the
# chunk's five launches a frame, and the lifetimes of the slabs the tables
# point at

def _smoke():
    """chip_smoke.py (the repository root's), for its scan-step cases."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "no_stats"])
@pytest.mark.parametrize("case", [*SMOKE.STEP_CASES,
                                  *(f"random{i}" for i in range(16))])
def test_scan_step_kernel_matches_plain(cuda, case, stats):
    """The scan step's kernel against its plain version
    (scan_step_plain: scan_step_reference on the same buffers) on every
    decision's cases and on random rows: the decisions and every copied
    field bit for bit, the poses (the fused pose, the carry's T_kf_prev,
    the chained odometry as the switch measurement) within 1e-5, the
    next frame's pointer table equal."""
    from dvo_slam_tpu_torch.ops import scan_step

    cfg = dataclasses.replace(TrackerConfig(), collect_stats=stats)
    seed = 1000 + int(case[6:]) if case.startswith("random") else \
        SMOKE.STEP_CASES.index(case)
    inp = SMOKE._step_inputs("random" if case.startswith("random") else case,
                             cfg, cuda, seed)
    before = scan_step.LAUNCHES_SCAN_STEP
    got, layout = SMOKE._run_step(scan_step.scan_step, inp, cfg)
    assert scan_step.LAUNCHES_SCAN_STEP - before == 1
    want, _ = SMOKE._run_step(scan_step.scan_step_plain, inp, cfg)
    bad, err = SMOKE._step_differences(got, want, layout)
    assert not bad, (bad, err)
    assert err <= 1e-5


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "no_stats"])
def test_scan_step_reads_level_rows_after_the_wait(cuda, stats):
    """The step launched, as on the main path, as a programmatic dependent
    of the launch before it: here a primary (dvo_late_copy), queued
    behind a spin kernel, that triggers its dependents 5 us in and writes
    the finest level's rows and lev_i only after a ~50 us spin, over NaN
    rows and -1 codes. The step starts while the primary spins (its
    stamps span more than 20 us) and still gives the plain version's
    bits on the final rows, so none of those reads comes before its grid
    dependency wait."""
    from dvo_slam_tpu_torch import _build
    from dvo_slam_tpu_torch.ops import scan_step

    cfg = dataclasses.replace(TrackerConfig(), collect_stats=stats)
    inp = SMOKE._step_inputs("accepted", cfg, cuda, 0)
    final, final_i = inp["lev"], inp["lev_i"]
    L, S = final.shape[1], final.shape[2]
    lev, lev_i = final.clone(), torch.full_like(final_i, -1)
    lev[:, L - 1] = float("nan")
    layout = scan_step.output_layout(L, cfg.max_iterations, stats)
    out = (torch.full((scan_step.row_width(layout),), 7.0, device=cuda),
           torch.full((scan_step.STATE_SIZE,), 7.0, device=cuda),
           torch.full((L, 2), 7, dtype=torch.int64, device=cuda))
    timing = scan_step.timing_buffer(cuda)
    # The primary's first launch loads its module (lazy loading), which
    # holds the host back; then a 1 ms spin, so that the host has issued
    # both launches before the card reaches the primary. The finest rows:
    # floats (L - 1) S .. 2 L S of lev (b = 1's coarser rows between them
    # are copied onto themselves).
    _build.launch("dvo_late_copy", cuda, (0, 0, 0, 0, 0, 0, 0, 0))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SMOKE.SPIN_HZ * 1e-3))
    span = slice((L - 1) * S, 2 * L * S)
    _build.launch("dvo_late_copy", cuda, (
        final.view(-1)[span].data_ptr(), lev.view(-1)[span].data_ptr(),
        4 * (span.stop - span.start), final_i.data_ptr(), lev_i.data_ptr(),
        4 * final_i.numel(), 5_000, 50_000))
    scan_step.scan_step_kernel(lev, lev_i, inp["state_in"],
                               inp["table_in"], inp["force"], inp["cur"],
                               *out, cfg, inp["scan_cfg"], timing=timing)
    torch.cuda.synchronize()
    assert torch.equal(lev, final) and torch.equal(lev_i, final_i)
    want, _ = SMOKE._run_step(scan_step.scan_step_plain, inp, cfg)
    bad, err = SMOKE._step_differences(out, want, layout)
    assert not bad, (bad, err)
    t = timing.cpu().numpy()
    assert t[1] - t[0] > 20_000, "the step did not start before the wait"


@pytest.mark.parametrize("level", [3, 2, 1])
def test_device_table_route_matches_host_pointers(cuda, noisy9, level):
    """Mode (b) and mode (a) reading each row's reference slab through a
    table of row pointers in device memory (SlabTable) give the bits of
    the same pointers passed among the launch's parameters, at B = 2 (the
    scan's rows) and B = 8; the plain version of the table route reads it
    back."""
    cfg = TrackerConfig()
    for B in (2, 8):
        rows, stacked, cur, K, T, sigma = _front_batch(noisy9, cuda, B,
                                                       level, cfg)
        slabs = tuple(stacked.unbind(0))
        pyrs = [(s,) for s in slabs]
        table = torch.tensor([s.data_ptr() for s in slabs],
                             dtype=torch.int64, device=cuda)
        got = []
        for ref in (linearize.RefSlabs(linearize.SlabTable(
                table, tuple(slabs[0].shape), pyrs, 0)),
                linearize.RefSlabs(slabs)):
            lin = linearize.linearize_kernels_batched(ref, cur, K, T, cfg,
                                                      sigma, True)
            out, out_i = linearize.track_level_kernels(ref, cur, K, T, cfg)
            got.append((lin, out, out_i))
        (lin_t, o_t, oi_t), (lin_p, o_p, oi_p) = got
        for field, a, b in zip(lin_t._fields, lin_t[:-1], lin_p[:-1]):
            assert _bit_diff(a, b) == 0, field
        assert _bit_diff(o_t, o_p) == 0 and torch.equal(oi_t, oi_p)
        ref = linearize.RefSlabs(linearize.SlabTable(
            table, tuple(slabs[0].shape), pyrs, 0))
        assert _bit_diff(ref.stacked(), stacked) == 0


def _ring_chunk(n, dev, start=0):
    frames, _ = _ring640(start + n)
    ii = torch.as_tensor(np.stack([f[0] for f in frames[start:]]),
                         device=dev)
    zz = torch.as_tensor(np.stack([f[1] for f in frames[start:]]),
                         device=dev)
    return ii, zz


@pytest.mark.parametrize("budget", [0.0, 0.5], ids=["full", "budget"])
@pytest.mark.parametrize("stats", [False, True],
                         ids=["no_stats", "stats"])
def test_chunk_on_kernels_matches_the_step_loop(cuda, monkeypatch, stats,
                                                budget):
    """track_keyframe_sequence on the kernel route (five launches a frame:
    pyramid 1, track_level 3, scan_step 1; no prepare_reference) against
    the same scan through the per-frame _step loop on the card, on the
    full grid and at a point budget: identical switch frames and
    decisions, poses within 1e-5 (the two fuse in f32 in another order,
    and each frame's level launches start from the fused pose). With the
    statistics: the same planes' shapes, and the first frame's (both
    routes' level launches start from the same carry) bit for bit."""
    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models import keyframe_scan
    from dvo_slam_tpu_torch.ops import scan_step

    ii, zz = _ring_chunk(12, cuda)
    force = torch.zeros(12, dtype=torch.bool, device=cuda)
    force[6] = True
    K = camera.intrinsics(*K640, device=cuda)
    cfg = TrackerConfig(point_budget_fraction=budget)
    slam_cfg = SlamConfig()
    counts = (pyramid.LAUNCHES_PYRAMID, linearize.LAUNCHES_TRACK_LEVEL,
              scan_step.LAUNCHES_SCAN_STEP, linearize.PREPARE_REFERENCE_CALLS)
    got = keyframe_scan.track_keyframe_sequence(ii, zz, K, cfg, slam_cfg,
                                                force_keyframe=force,
                                                with_stats=stats)
    after = (pyramid.LAUNCHES_PYRAMID, linearize.LAUNCHES_TRACK_LEVEL,
             scan_step.LAUNCHES_SCAN_STEP, linearize.PREPARE_REFERENCE_CALLS)
    assert [a - b for a, b in zip(after, counts)] == [12, 3 * 11, 11, 0]
    monkeypatch.setattr(keyframe_scan, "_kernel_route",
                        lambda *args: False)
    want = keyframe_scan.track_keyframe_sequence(ii, zz, K, cfg, slam_cfg,
                                                 force_keyframe=force,
                                                 with_stats=stats)
    assert scan_step.LAUNCHES_SCAN_STEP == after[2]
    for key in ("switch", "accept", "is_nan"):
        assert torch.equal(got[key], want[key]), key
    assert bool(got["switch"][5])
    for key in ("rel_pose", "Z_switch", "T_kf_meas", "T_odo_meas"):
        assert (got[key] - want[key]).abs().max().item() <= 1e-5, key
    assert ("stats" in got) == ("stats" in want) == stats
    if stats:
        for a, b in zip(got["stats"], want["stats"]):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert _bit_diff(a[0].float(), b[0].float()) == 0


def test_chunk_boundaries_on_kernels(cuda):
    """The kernel route split at arbitrary chunk boundaries (the carry's
    slot, table and PendingKeyframe chained) gives the whole sequence's
    outputs bit for bit."""
    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models import keyframe_scan

    ii, zz = _ring_chunk(12, cuda)
    force = torch.zeros(12, dtype=torch.bool, device=cuda)
    force[[4, 9]] = True
    K = camera.intrinsics(*K640, device=cuda)
    cfg, slam_cfg = TrackerConfig(), SlamConfig()
    runs = []
    for bounds in (((1, 12),), ((1, 3), (3, 4), (4, 9), (9, 12))):
        carry = keyframe_scan.init_carry(keyframe_scan.pyramid_from_stack(
            ii, zz, 0, cfg.num_levels))
        parts = []
        for a, b in bounds:
            carry, outs = keyframe_scan.track_keyframe_chunk(
                carry, ii[a:b], zz[a:b], K, cfg, slam_cfg,
                force_keyframe=force[a:b])
            parts.append(outs)
        runs.append({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    whole, split = runs
    for key in whole:
        assert _bit_diff(whole[key].float(), split[key].float()) == 0, key


def test_chunked_keyframe_outlives_its_chunk(cuda, monkeypatch):
    """Depth-2 pipelining with one keyframe (found in chunk 1 by a forced
    switch) held through chunks 2-5 with no switch, and every freed block
    refilled with NaN between the calls (so a slab the device tables still
    point at, were it freed, would be overwritten): the same poses and
    keyframes as the per-frame _step route of the same engine."""
    from dvo_slam_tpu_torch import SlamConfig
    from dvo_slam_tpu_torch.models import keyframe_scan
    from dvo_slam_tpu_torch.models.chunked_slam import ChunkedKeyframeSlam

    frames, _ = _ring640(8)
    # Small motions about the first frames: no switch unless forced.
    order = [0, 1, 2, 1, 0, 1, 2, 3, 2, 1, 0, 1]
    seq = [frames[k] for k in order]
    chunk = 2
    slam_cfg = SlamConfig(min_entropy_ratio=-1e30)
    cfg = TrackerConfig()
    slot = -(-pyramid.pyramid_size(H640, W640, cfg.num_levels) // 64) * 64

    def run():
        slam = ChunkedKeyframeSlam(K640, cfg, slam_cfg,
                                   enable_loop_closure=False, device=cuda)
        slam.init()
        slam.update_chunk(np.stack([seq[0][0]]), np.stack([seq[0][1]]),
                          [0.0])
        poses, in_flight = [], 0
        for c, k in enumerate(range(1, len(seq) - 1, chunk)):
            if c == 1:
                slam.force_keyframe()
            part = seq[k:k + chunk]
            slam.submit_chunk(np.stack([f[0] for f in part]),
                              np.stack([f[1] for f in part]),
                              [(k + j) / 30.0 for j in range(len(part))])
            in_flight += 1
            if in_flight == 2:
                poses += slam.collect_chunk()
                in_flight -= 1
            # Take and poison every block of a chunk's pyramid buffer's
            # size the allocator holds free.
            junk = [torch.full((chunk, slot), float("nan"), device=cuda)
                    for _ in range(4)]
            del junk
        while in_flight:
            poses += slam.collect_chunk()
            in_flight -= 1
        return slam, poses

    got_slam, got = run()
    monkeypatch.setattr(keyframe_scan, "_kernel_route",
                        lambda *args: False)
    want_slam, want = run()
    kf = [k.timestamp for k in got_slam.keyframes]
    assert kf == [k.timestamp for k in want_slam.keyframes]
    assert len(kf) == 2  # the init frame and chunk 1's forced switch
    assert len(got) == len(want) == len(seq) - 2
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-5

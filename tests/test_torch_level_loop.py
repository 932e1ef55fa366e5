"""The per-level IRLS loop: its route, its host loop against the JAX
package's vmapped ``while_loop``, and the layout of the cluster kernel's
outputs (csrc/linearize.cu modes (a) and (b)) as the Python side unpacks
them.

The card runs a level as one launch of mode (b) (``level_route``); the
CPU runs the host loop ``_track_level`` over the plain linearization,
which is mode (b)'s plain version. Here that host loop meets
``jax.vmap(dense_tracker._track_level)`` on the same numpy inputs: 64x48
noise-free synthetic frames at level 0, B = 2 rows against one current
frame (SLAM's dual alignment) and B = 8 rows each against its own (a
validation batch), one row's reference depth all NaN.

Tolerances: T within 1e-5 (f32 IRLS on both sides; reductions in another
order); per-iteration valid counts, accepted flags, iteration counts and
termination codes exact; per-iteration errors rtol 1e-4 (err_mean sums
log1p over ~3 000 points in f32: the two packages' orders part by
~1e-5 relative) and increment norms within 1e-5 (absolute: they fall to
~1e-6 near convergence).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import dense_tracker
from dvo_slam_tpu.ops import camera, linearize, pyramid
from dvo_slam_tpu.utils import se3_np, synthetic
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import dense_tracker as t_dense_tracker
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import linearize as t_linearize
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

W, H = 64, 48
K_TUPLE = (32.0, 32.0, (W - 1) / 2.0, (H - 1) / 2.0)
LEVEL = 0
CFG = TrackerConfig(num_levels=2, first_level=1, last_level=0)
NAN_ROW = 1  # the row whose reference depth is all NaN


def _port_cfg(cfg):
    return convert.tracker_config_from_fields(dataclasses.asdict(cfg))


# ---- which configs the level kernel takes

@pytest.mark.parametrize("estimator", ["tdist", "mad", "normal", "unit"])
@pytest.mark.parametrize("weighting", [True, False])
def test_level_route_by_estimator(estimator, weighting):
    cfg = _port_cfg(TrackerConfig(scale_estimator=estimator,
                                  use_weighting=weighting))
    want = weighting and estimator == "tdist"
    assert t_linearize.kernel_route(cfg) == want
    assert t_linearize.level_route(cfg) == want


@pytest.mark.parametrize("fields, want", [
    ({}, True),
    ({"lm_lambda_init": 1e-4}, True),
    ({"tdist_scale_warm_iters": 2}, True),
    ({"collect_stats": False}, True),
    ({"gradient_source": "reference", "use_depth": False}, True),
    ({"mu": 0.5}, False),
    ({"mu": 0.5, "lm_lambda_init": 1e-4}, False),
])
def test_level_route_by_option(fields, want):
    cfg = _port_cfg(dataclasses.replace(TrackerConfig(), **fields))
    assert t_linearize.kernel_route(cfg)
    assert t_linearize.level_route(cfg) == want


@pytest.mark.parametrize("N, C", [(1, 1), (300, 1), (301, 2), (1200, 2),
                                  (4800, 4), (19200, 8), (76800, 16),
                                  (307200, 16)])
def test_cluster_size(N, C):
    assert t_linearize.cluster_size(N) == C
    assert -(-N // C) <= 300 * C or C == 16


# ---- the host loop against jax.vmap of the JAX while_loop

@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_trajectory(10, radius=0.06)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(),
                                       np.asarray(K_TUPLE), W, H, poses)
    frames[NAN_ROW] = (frames[NAN_ROW][0],
                       np.full_like(frames[NAN_ROW][1], np.nan))
    return frames, poses


def _rows(B):
    """(reference, current) frame indices: B = 2 share current frame 2,
    B = 8 pair reference k with current k + 1."""
    if B == 2:
        return (0, NAN_ROW), (2, 2)
    return tuple(range(B)), tuple(range(1, B + 1))


def _inits(poses, refs, curs):
    rng = np.random.default_rng(3)
    return np.stack([
        (se3_np.inverse(poses[c]) @ poses[r]
         @ se3_np.exp(rng.normal(scale=3e-3, size=6))).astype(np.float32)
        for r, c in zip(refs, curs)])


def _jax_level(frames, B, cfg):
    frames, poses = frames
    refs, curs = _rows(B)
    K = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE),
                                  cfg.num_levels)[LEVEL]
    pyrs = [pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z),
                                  cfg.num_levels)[LEVEL] for i, z in frames]
    ref_slabs = jnp.stack([pyrs[r] for r in refs])
    shared = B == 2
    cur = pyrs[curs[0]] if shared else jnp.stack([pyrs[c] for c in curs])
    rd = jax.vmap(lambda s: linearize.prepare_reference(s, K, cfg))(ref_slabs)
    level = jax.jit(jax.vmap(
        lambda r, c, T: dense_tracker._track_level(r, c, K, T, cfg),
        in_axes=(0, None if shared else 0, 0)))
    T, fin, stats = level(rd, cur, jnp.asarray(_inits(poses, refs, curs)))
    return np.asarray(T), stats


def _port_level(frames, B, cfg, level_fn=t_dense_tracker._track_level):
    frames, poses = frames
    refs, curs = _rows(B)
    K = t_camera.pyramid_intrinsics(t_camera.intrinsics(*K_TUPLE,
                                                        device="cpu"),
                                    cfg.num_levels)[LEVEL]
    pyrs = [t_pyramid.build_pyramid(torch.from_numpy(i), torch.from_numpy(z),
                                    cfg.num_levels)[LEVEL] for i, z in frames]
    ref_slabs = torch.stack([pyrs[r] for r in refs])
    cur = pyrs[curs[0]] if B == 2 else torch.stack([pyrs[c] for c in curs])
    rd = t_linearize.prepare_reference(ref_slabs, K, cfg)
    T0 = torch.from_numpy(_inits(poses, refs, curs))
    return level_fn(rd, cur, K, T0, cfg), (rd, cur, K, T0)


# B, config fields. Every case has a row that runs to max_iterations:
# stopped by it (B2, B8: 3 iterations), by a rejected step at the last
# iteration (B2_reject) or by convergence at it (some rows of B8_lm_warm).
CASES = {"B2": (2, {"max_iterations": 3}),
         "B8": (8, {"max_iterations": 3}),
         "B2_reject": (2, {"max_iterations": 4}),
         "B8_lm_warm": (8, {"max_iterations": 4, "lm_lambda_init": 1e-4,
                            "tdist_scale_warm_iters": 2})}


@pytest.fixture(scope="module", params=sorted(CASES))
def level_pair(request, frames):
    B, fields = CASES[request.param]
    cfg = dataclasses.replace(CFG, **fields)
    port_cfg = _port_cfg(cfg)
    got, inputs = _port_level(frames, B, port_cfg)
    return B, port_cfg, got, _jax_level(frames, B, cfg), inputs


def test_host_loop_matches_vmapped_while_loop(level_pair):
    B, cfg, (T, fin, stats), (T_j, stats_j), _ = level_pair
    valid, error, delta, accepted, term = stats["per_iter"]
    v_j, e_j, d_j, a_j, term_j = (np.asarray(x) for x in
                                  stats_j["per_iter"][:5])
    iters = stats["iterations"]
    assert iters.dtype == torch.int32 and iters.shape == (B,)
    np.testing.assert_array_equal(iters.numpy(),
                                  np.asarray(stats_j["iterations"]))
    np.testing.assert_array_equal(term.numpy(), term_j)
    np.testing.assert_allclose(T.numpy(), T_j, atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), v_j)
    np.testing.assert_array_equal(accepted.numpy(), a_j)
    np.testing.assert_allclose(error.numpy(), e_j, rtol=1e-4)
    np.testing.assert_allclose(delta.numpy(), d_j, atol=1e-5)
    np.testing.assert_allclose(stats["error"].numpy(),
                               np.asarray(stats_j["error"]), rtol=1e-4)


def test_host_loop_rows_stop_apart(level_pair):
    """The NaN row stops after its first iteration with too few
    constraints and keeps its initial pose; another row runs to
    max_iterations; entries past a row's last iteration are zero."""
    B, cfg, (T, fin, stats), _, (_, _, _, T0) = level_pair
    valid, error, delta, accepted, term = stats["per_iter"]
    iters = stats["iterations"].tolist()
    assert iters[NAN_ROW] == 1
    assert int(term[NAN_ROW]) == t_dense_tracker.TERM_TOO_FEW_CONSTRAINTS
    assert float(fin.n_raw[NAN_ROW]) == 0.0
    assert torch.equal(T[NAN_ROW], T0[NAN_ROW])
    assert cfg.max_iterations in iters
    for b, n in enumerate(iters):
        if int(term[b]) == t_dense_tracker.TERM_ITERATIONS:
            assert n == cfg.max_iterations
        for x in (valid, error, delta, accepted):
            assert not x[b, n:].any()
        assert bool(accepted[b, 0])


def test_track_level_on_cpu_is_the_plain_host_loop(frames):
    """On a CPU slab ``track_level`` is the host loop over the plain
    linearization (mode (b)'s plain version), bit for bit."""
    cfg = _port_cfg(dataclasses.replace(CFG, max_iterations=4))
    got, inputs = _port_level(frames, 2, cfg, t_dense_tracker.track_level)
    want = t_dense_tracker._track_level(
        *inputs, cfg, linearize=t_linearize.linearize_batched_reference)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    for a, b in zip(got[2]["per_iter"], want[2]["per_iter"]):
        assert torch.equal(a, b)


# ---- the kernel's output layouts, unpacked by the Python side

def _pack_level(T, fin, stats, max_iterations):
    """A host loop's result in mode (b)'s output layout (the inverse of
    ``unpack_level``): what the kernel writes for the same rows."""
    B = T.shape[0]
    valid, error, delta, accepted, term = stats["per_iter"]
    best = torch.cat([fin.A.reshape(B, 36), fin.b, fin.err_mean[:, None],
                      fin.err_raw[:, None], fin.sigma.reshape(B, 4),
                      fin.n_raw[:, None], fin.log1p_sum[:, None]], dim=1)
    out = torch.cat([T.reshape(B, 16), best,
                     torch.stack([valid, error, delta, accepted.float()],
                                 dim=1).reshape(B, 4 * max_iterations)],
                    dim=1)
    out_i = torch.stack([stats["iterations"], term], dim=1).to(torch.int32)
    return out, out_i


def test_level_output_unpacks_to_the_host_loops_result(level_pair,
                                                       monkeypatch):
    """``_track_level_kernel`` reads mode (b)'s two output tensors into
    the host loop's result: given the host loop's rows packed in that
    layout (a stand-in for the launch), it returns them exactly."""
    B, cfg, (T, fin, stats), _, inputs = level_pair
    packed = _pack_level(T, fin, stats, cfg.max_iterations)
    assert packed[0].shape == (B, 66 + 4 * cfg.max_iterations)
    monkeypatch.setattr(t_linearize, "track_level_kernels",
                        lambda *args: packed)
    T_k, fin_k, stats_k = t_dense_tracker._track_level_kernel(*inputs, cfg)
    assert torch.equal(T_k, T)
    for field, a, b in zip(fin._fields, fin_k, fin):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), field
    assert torch.equal(stats_k["iterations"], stats["iterations"])
    assert torch.equal(stats_k["error"], stats["error"])
    for a, b in zip(stats_k["per_iter"], stats["per_iter"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_unpack_linearization_layout():
    B = 3
    out = torch.arange(B * 51, dtype=torch.float32).view(B, 51)
    lin = t_linearize.unpack_linearization(out)
    for b in range(B):
        o = out[b]
        assert torch.equal(lin.A[b], o[:36].view(6, 6))
        assert torch.equal(lin.b[b], o[36:42])
        for field, k in (("err_mean", 42), ("n_valid", 43), ("n_raw", 44),
                         ("log1p_sum", 49), ("err_raw", 50)):
            assert float(getattr(lin, field)[b]) == float(o[k]), field
        assert torch.equal(lin.sigma[b], o[45:49].view(2, 2))


def test_unpack_level_layout():
    B, M = 2, 5
    out = torch.arange(B * (66 + 4 * M), dtype=torch.float32).view(B, -1)
    out[:, 66 + 3 * M:] = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])
    out_i = torch.tensor([[4, 1], [1, 3]], dtype=torch.int32)
    lvl = t_linearize.unpack_level(out, out_i, M)
    for b in range(B):
        o = out[b]
        assert torch.equal(lvl.T[b], o[:16].view(4, 4))
        assert torch.equal(lvl.best[b], o[16:66])
        assert torch.equal(lvl.valid[b], o[66:66 + M])
        assert torch.equal(lvl.error[b], o[66 + M:66 + 2 * M])
        assert torch.equal(lvl.delta_norm[b], o[66 + 2 * M:66 + 3 * M])
    assert lvl.accepted.dtype == torch.bool
    assert lvl.accepted.tolist() == [[True, False, True, False, False]] * 2
    assert lvl.iterations.tolist() == [4, 1]
    assert lvl.termination.tolist() == [1, 3]


def _constants(text, names):
    got = {}
    for name in names:
        m = re.search(rf"\b{name} = (\d+)", text)
        assert m, name
        got[name] = int(m.group(1))
    return got


def test_kernel_source_layout_matches_python():
    """The offsets csrc/linearize.cu writes are the ones Python reads."""
    src = (Path(t_linearize.__file__).parents[1] / "csrc"
           / "linearize.cu").read_text()
    out = _constants(src, ["kOutA", "kOutB", "kOutErrMean", "kOutN",
                           "kOutNRaw", "kOutSigma", "kOutLog1p",
                           "kOutErrRaw", "kOutSize"])
    assert list(out.values()) == [0, 36, 42, 43, 44, 45, 49, 50,
                                  t_linearize._OUT_SIZE]
    best = _constants(src, ["kBestA", "kBestB", "kBestErr", "kBestErrRaw",
                            "kBestSigma", "kBestNRaw", "kBestLog1p",
                            "kBestSize"])
    d = t_dense_tracker
    assert list(best.values()) == [d._A, d._B, d._ERR, d._ERR_RAW, d._SIGMA,
                                   d._N_RAW, d._LOG1P, 50]
    level = _constants(src, ["kLevelT", "kLevelBest", "kLevelStats"])
    assert list(level.values()) == [t_linearize._LEVEL_T,
                                    t_linearize._LEVEL_BEST,
                                    t_linearize._LEVEL_STATS]
    term = _constants(src, ["kTermIterations", "kTermIncrement",
                            "kTermErrorIncreased", "kTermTooFew"])
    assert list(term.values()) == [d.TERM_ITERATIONS, d.TERM_INCREMENT,
                                   d.TERM_ERROR_INCREASED,
                                   d.TERM_TOO_FEW_CONSTRAINTS]
    m = re.search(r"kMaxCluster = (\d+)", src)
    assert int(m.group(1)) == t_linearize._MAX_CLUSTER


@pytest.mark.parametrize("level", [3, 2])
def test_gradient_at_the_optimum_is_f32_noise(level):
    """Why the card tests hold mode (b)'s final b by the step it asks for,
    ||A^-1 (b - b_ref)|| <= precision, and not by max|b|: at the pose the
    plain host loop converges to (640x480 orbit pair), the plain f32
    gradient is at least 1e-5 of its Cauchy-Schwarz scale sqrt(A_kk
    err_raw) away from an f64 evaluation of the same linearization
    (residuals of ~1e-3 rounded to ~1e-5 each), while the step that
    difference asks for stays below 0.2 * precision."""
    W6, H6 = 640, 480
    K6 = (525.0, 525.0, (W6 - 1) / 2.0, (H6 - 1) / 2.0)
    cfg = _port_cfg(TrackerConfig())
    poses = synthetic.orbit_trajectory(24, radius=0.06)
    frames = synthetic.render_sequence(synthetic.two_plane_scene(
        sharpness=2.0), np.asarray(K6), W6, H6, poses[:2])
    K = t_camera.pyramid_intrinsics(t_camera.intrinsics(*K6, device="cpu"),
                                    cfg.num_levels)[level]
    ref_slab, cur = (t_pyramid.build_pyramid(torch.from_numpy(i),
                                             torch.from_numpy(z),
                                             cfg.num_levels)[level]
                     for i, z in frames)
    rd = t_linearize.prepare_reference(ref_slab[None], K, cfg)
    T0 = se3_np.inverse(poses[1]) @ poses[0] @ se3_np.exp(
        np.array([2e-3, -1e-3, 1e-3, 1e-3, 2e-3, -1e-3]))
    T = t_dense_tracker._track_level(
        rd, cur, K, torch.as_tensor(T0, dtype=torch.float32)[None], cfg,
        linearize=t_linearize.linearize_batched_reference)[0][0]
    row = t_linearize.RefData(*(None if f is None else f[0] for f in rd))
    f32 = t_linearize.linearize_reference(row, cur, K, T, cfg)
    row64 = t_linearize.RefData(*(
        None if f is None else f.double() if f.is_floating_point() else f
        for f in row))
    f64 = t_linearize.linearize_reference(row64, cur.double(), K.double(),
                                          T.double(), cfg)
    A, b = f64.A.numpy(), f64.b.numpy()
    db = f32.b.double().numpy() - b
    scale = np.sqrt(np.diag(A) * float(f64.err_raw))
    assert (np.abs(db) / scale).max() >= 1e-5
    assert np.linalg.norm(np.linalg.solve(A, db)) <= 0.2 * cfg.precision

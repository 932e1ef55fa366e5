"""The frame's front of the port on the CPU: the pyramid, the reference
points the level kernel's slab route mirrors, and the track result the
level launches write, against the JAX package and against the port's own
eager front.

Small sizes (80x60 and 82x61), inputs from numpy seeds. Tolerances:
prepare_reference against the JAX package rtol 1e-6 on the point
coordinates (the same f32 operations in the same order; XLA may fold
a division into a product with the reciprocal) and the selection, the
intensities and the gradients exact; the assembled TrackResult of the
port's plain route against the JAX ``track`` as tests/test_torch_tracker.py
holds it (f32 IRLS on both sides, reductions in another order): the
transformation atol 1e-4, iterations per level within 1, valid pixels
within 2, log-likelihood, entropy, valid ratio and the levels' errors
rtol 1e-3. The kernel front's assembly (the views of the level launches'
output) against the eager front on the same rows exactly: its launches
are stood in for by the host loop packed in the kernel's layout, so both
compute the same numbers.
"""

import dataclasses
import re
from pathlib import Path

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

W, H = 80, 60
K_TUPLE = (40.0, 41.0, (W - 1) / 2, (H - 1) / 2)
CONFIGS = {
    "tdist": {},
    "photometric": {"use_depth": False},
    "reference_gradients": {"gradient_source": "reference"},
    "tdist_warm": {"tdist_scale_warm_iters": 2},
}
THRESHOLDS = {"off": {}, "on": {"intensity_grad_threshold": 2.0,
                                "depth_grad_threshold": 0.01}}
CFG4 = TrackerConfig(num_levels=4, first_level=3, last_level=0)
SRC = Path(t_linearize.__file__).parents[1] / "csrc"


def _port_cfg(cfg):
    return convert.tracker_config_from_fields(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def frames():
    """Four noisy 80x60 frames of the orbit (3 % depth dropout) and their
    poses."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    poses = synthetic.orbit_trajectory(8, radius=0.05)
    rng = np.random.default_rng(7)
    return [synthetic.add_sensor_noise(
        *scene.render(np.asarray(K_TUPLE), W, H, T), rng, dropout=0.03)
        for T in poses[:4]], poses


def _port_pyramids(frames, levels):
    return [t_pyramid.build_pyramid(torch.from_numpy(i), torch.from_numpy(z),
                                    levels) for i, z in frames]


@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prepare_reference_like_jax(frames, name, thresholds):
    """prepare_reference, the per-point computation the level kernel's
    slab route repeats, over the rows of a batch against the JAX
    package's, row by row."""
    cfg = TrackerConfig(**CONFIGS[name], **THRESHOLDS[thresholds])
    imgs, _ = frames
    K = camera.intrinsics(*K_TUPLE)
    t_K = t_camera.intrinsics(*K_TUPLE, device="cpu")
    rows = torch.stack([p[0] for p in _port_pyramids(imgs[:3], 1)])
    got = t_linearize.prepare_reference(rows, t_K, _port_cfg(cfg))
    for b, (i, z) in enumerate(imgs[:3]):
        slab = pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z), 1)[0]
        want = linearize.prepare_reference(slab, K, cfg)
        for field in want._fields:
            w = getattr(want, field)
            g = getattr(got, field)
            if w is None:
                assert g is None, field
                continue
            w, g = np.asarray(w), g[b].numpy()
            if field in ("px", "py", "pz"):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0.0,
                                           err_msg=field)
            else:
                np.testing.assert_array_equal(g, w, err_msg=field)
        if thresholds == "on":
            n = int(got.selected[b].sum())
            assert 0 < n < H * W


def _jax_track(pair, cfg):
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE),
                                   cfg.num_levels)
    pyr = [pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z),
                                 cfg.num_levels) for i, z in pair]
    return dense_tracker.track_jit(pyr[0], pyr[1], Ks,
                                   jnp.eye(4, dtype=jnp.float32), cfg)


def test_track_result_like_jax():
    """The TrackResult the port's plain route assembles (loglik, entropy,
    valid ratio, iterations, the levels' errors, the per-iteration
    statistics) against the JAX ``track`` at 80x60 with 4 levels, every
    level tracked."""
    scene = synthetic.two_plane_scene(sharpness=2.0)
    xi = np.array([0.01, -0.008, 0.006, 0.004, -0.003, 0.005])
    pair = [scene.render(np.asarray(K_TUPLE), W, H, T)
            for T in (np.eye(4), se3_np.inverse(se3_np.exp(xi)))]
    want = _jax_track(pair, CFG4)
    cfg = _port_cfg(CFG4)
    t_Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), cfg.num_levels)
    pyrs = _port_pyramids(pair, cfg.num_levels)
    got = convert.result_to_numpy(t_dense_tracker.track(
        pyrs[0], pyrs[1], t_Ks, torch.eye(4), cfg))
    np.testing.assert_allclose(got.transformation,
                               np.asarray(want.transformation), atol=1e-4)
    its, its_w = got.iterations, np.asarray(want.iterations)
    assert its.shape == (4,) and np.abs(its - its_w).max() <= 1
    assert abs(float(got.valid_pixels) - float(want.valid_pixels)) <= 2
    for field in ("log_likelihood", "entropy", "valid_ratio"):
        np.testing.assert_allclose(getattr(got, field),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-3, err_msg=field)
    same = its == its_w
    np.testing.assert_allclose(got.level_errors[same],
                               np.asarray(want.level_errors)[same], rtol=1e-3)
    s, ws = got.stats, want.stats
    assert s.valid.shape == (4, cfg.max_iterations)
    for lvl in np.flatnonzero(same):
        n = its[lvl]
        assert int(s.termination[lvl]) == int(ws.termination[lvl])
        np.testing.assert_array_equal(s.accepted[lvl],
                                      np.asarray(ws.accepted[lvl]))
        assert np.abs(s.valid[lvl, :n]
                      - np.asarray(ws.valid[lvl, :n])).max() <= 2
        assert not s.valid[lvl, n:].any()
    np.testing.assert_array_equal(s.window_miss, 0.0)


def test_build_pyramid_on_cpu_never_reaches_the_kernel(frames, monkeypatch):
    """CPU tensors take the plain version, for every input encoding, and
    never the kernel's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(t_pyramid, "build_pyramid_kernel", refuse)
    before = t_pyramid.LAUNCHES_PYRAMID
    i, z = frames[0][0]
    i8 = np.clip(np.round(i), 0, 255).astype(np.uint8)
    z16 = np.where(np.isfinite(z), np.round(z * 5000), 0).astype(np.uint16)
    for a, b in ((i, z), (i8, z16), (i8, t_pyramid.pack_depth12(z16))):
        got = t_pyramid.build_pyramid(torch.from_numpy(a), torch.from_numpy(b),
                                      4)
        want = t_pyramid.build_pyramid_reference(torch.from_numpy(a),
                                                 torch.from_numpy(b), 4)
        for g, w in zip(got, want):
            assert torch.equal(g.nan_to_num(-7.0), w.nan_to_num(-7.0))
    assert t_pyramid.LAUNCHES_PYRAMID == before


@pytest.mark.parametrize("case", ["f64 intensity", "u16 depth shape",
                                  "i32 depth", "packed odd width",
                                  "levels", "not on a card"])
def test_build_pyramid_kernel_rejects(case):
    """What the pyramid kernel does not take raises in its wrapper, before
    any launch (here, without a card, the input checks themselves)."""
    i = torch.rand(H, W) * 255
    z = torch.rand(H, W) + 0.5
    levels, err = 4, TypeError
    if case == "f64 intensity":
        i = i.double()
    elif case == "u16 depth shape":
        z = (z * 5000).to(torch.uint16)[:, :-1]
    elif case == "i32 depth":
        z = (z * 5000).to(torch.int32)
    elif case == "packed odd width":
        i = i[:, :-1]
        z = torch.zeros(H, 3 * ((W - 1) // 2), dtype=torch.uint8)
    elif case == "levels":
        levels, err = 7, ValueError
    else:
        err = ValueError
    with pytest.raises(err):
        t_pyramid.build_pyramid_kernel(i, z, levels)


@pytest.mark.parametrize("size", [(80, 60), (82, 61), (81, 47)])
def test_level_shapes(size):
    w, h = size
    got = t_pyramid.build_pyramid(torch.rand(h, w), torch.rand(h, w), 5)
    assert [tuple(x.shape[1:]) for x in got] == t_pyramid.level_shapes(h, w,
                                                                        5)


def test_front_route():
    """The kernel front: a CUDA device, whatever the estimator, weighting,
    motion prior or point budget (decided from the config and device
    alone)."""
    cfg = _port_cfg(TrackerConfig())
    route = t_dense_tracker.front_route
    assert route(cfg, "cuda") and route(cfg, torch.device("cuda", 1))
    assert not route(cfg, "cpu")
    for over in ({"scale_estimator": "mad"}, {"use_weighting": False},
                 {"mu": 0.1}, {"point_budget_fraction": 0.5},
                 {"point_budget_fraction": 0.25, "scale_estimator": "mad"}):
        assert route(dataclasses.replace(cfg, **over), "cuda"), over
    assert not route(dataclasses.replace(cfg, point_budget_fraction=0.5),
                     "cpu")
    assert route(dataclasses.replace(cfg, intensity_grad_threshold=1.0),
                 "cuda")


def test_slab_route_kernel_args(frames):
    """The slab route's launch arguments (built without a launch): a
    stacked tensor by its row stride (0 for one slab repeated), a sequence
    by row pointers; the gradient thresholds from the config; under a
    point budget N the budget's slots and the budget among the arguments
    (the global slot table only where the wrapper gives one); and what it
    refuses."""
    cfg = _port_cfg(dataclasses.replace(CFG4, intensity_grad_threshold=1.5,
                                        depth_grad_threshold=0.02))
    pyrs = _port_pyramids(frames[0][:3], 2)
    K = t_camera.intrinsics(*K_TUPLE, device="cpu")
    cur = pyrs[2][0]
    stacked = torch.stack([pyrs[0][0], pyrs[1][0]])
    T = torch.eye(4).expand(2, 4, 4)
    for rows, table, stride in (
            (stacked, 0, 6 * H * W), (pyrs[0][0].expand(2, 6, H, W), 0, 0),
            ((pyrs[0][0], pyrs[1][0]), 1, 0)):
        B, N, refs, _, ptrs = t_linearize._kernel_args(
            t_linearize.RefSlabs(rows), cur, K, T, cfg)
        assert (B, N) == (2, H * W) and refs[1:10] == (None,) * 9
        assert refs[11:17] == (stride, table, 1.5, 0.02, 0, None)
        assert refs[17] == N
        first = (rows[0] if table else rows).data_ptr()
        assert ptrs[0] == first
        if table:
            assert ptrs[1] == rows[1].data_ptr()
    budget_cfg = dataclasses.replace(cfg, point_budget_fraction=0.5)
    budget = t_linearize.compact_budget(H * W, 0.5, 128)
    assert t_linearize.ref_budget(budget_cfg, H, W) == budget == 2432
    slots = torch.empty((2, budget), dtype=torch.int32)
    for table in (None, slots):
        B, N, refs, _, _ = t_linearize._kernel_args(
            t_linearize.RefSlabs(stacked), cur, K, T, budget_cfg, table)
        assert (B, N) == (2, budget) and refs[17] == budget
        assert refs[15:17] == (budget, None if table is None
                               else slots.data_ptr())
    # The points route takes prepare_reference's compacted arrays, N their
    # slots, and passes no budget.
    ref = t_linearize.prepare_reference(stacked, K, budget_cfg)
    B, N, refs, _, _ = t_linearize._kernel_args(ref, cur, K, T, budget_cfg)
    assert (B, N) == (2, budget) and refs[15:17] == (0, None)
    bad = [
        (tuple([pyrs[0][0]] * 33), torch.eye(4).expand(33, 4, 4), cfg),
        (stacked[:, :, :-1], T, cfg),
        (stacked[:, :4], T, cfg),
        ((pyrs[0][0],), T, cfg),
        ((pyrs[0][0],), T, budget_cfg),
    ]
    for rows, T_b, c in bad:
        with pytest.raises(ValueError):
            t_linearize._kernel_args(t_linearize.RefSlabs(rows), cur, K, T_b,
                                     c)


def test_slab_table_kernel_args(frames):
    """The device-table route's launch arguments: the table's own address
    (the launch reads the row pointers), mode _TABLE_DEVICE, any B; its
    plain version reads the table back and stacks the slabs it points at;
    a table of another type, length or device, or slabs of another shape,
    raise before a launch."""
    cfg = _port_cfg(dataclasses.replace(CFG4, intensity_grad_threshold=1.5))
    pyrs = _port_pyramids(frames[0][:3], 2)
    K = t_camera.intrinsics(*K_TUPLE, device="cpu")
    cur = pyrs[2][0]
    rows = [pyrs[1], pyrs[0], pyrs[1]]
    table = torch.tensor([p[0].data_ptr() for p in rows])
    ref = t_linearize.RefSlabs(t_linearize.SlabTable(
        table, (6, H, W), pyrs, 0))
    T = torch.eye(4).expand(3, 4, 4)
    B, N, refs, _, ptr = t_linearize._kernel_args(ref, cur, K, T, cfg)
    assert (B, N) == (3, H * W) and refs[1:10] == (None,) * 9
    assert refs[10:15] == (table.data_ptr(), 0, t_linearize._TABLE_DEVICE,
                           1.5, 0.0) and ptr == table.data_ptr()
    assert torch.equal(ref.stacked().nan_to_num(-7.0),
                       torch.stack([p[0] for p in rows]).nan_to_num(-7.0))
    bad = [
        (table.int(), (6, H, W), T),
        (table[:2], (6, H, W), T),
        (table[::2], (6, H, W), T[:2]),
        (table, (6, H, W - 1), T),
        (table.to("meta"), (6, H, W), T),
    ]
    for t, shape, T_b in bad:
        with pytest.raises(ValueError):
            t_linearize._kernel_args(t_linearize.RefSlabs(
                t_linearize.SlabTable(t, shape, pyrs, 0)), cur, K, T_b, cfg)


def _stand_in_level_kernels(ref, cur, K, T, cfg, out=None, out_i=None):
    """track_level_kernels on the CPU: the host loop over the plain
    linearization, packed in mode (b)'s row layout, and the extras
    computed by the eager assembly's functions."""
    rd = t_linearize.reference_points(ref, K, cfg)
    T_b, fin, st = t_dense_tracker._track_level(
        rd, cur, K, T, cfg, linearize=t_linearize.linearize_batched_reference)
    B, M = T_b.shape[0], cfg.max_iterations
    valid, error, delta, accepted, term = st["per_iter"]
    best = torch.cat([fin.A.reshape(B, 36), fin.b, fin.err_mean[:, None],
                      fin.err_raw[:, None], fin.sigma.reshape(B, 4),
                      fin.n_raw[:, None], fin.log1p_sum[:, None]], dim=1)
    n_sel = rd.selected.sum(-1).float()
    extras = torch.stack([
        n_sel, t_dense_tracker.pose_entropy(fin.A),
        fin.n_raw / torch.clamp(n_sel, min=1.0)], dim=1)
    out[:] = torch.cat([T_b.reshape(B, 16),
                        t_linearize.tdist_loglik(fin, cfg)[:, None], best,
                        valid, error, delta, accepted.float(),
                        torch.zeros(B, M), extras], dim=1)
    out_i[:] = torch.stack([st["iterations"], term], dim=1)
    return out, out_i


def test_posterior_information_added_once(frames, monkeypatch):
    """With the motion prior, a level's record leaves the level as the
    posterior information A + mu I, added once: the eager front's result
    (the host loop's record through ``_final``) holds the data term plus
    mu I exactly and the entropy of that sum, and ``level_result``, given
    records that hold it (mode (b)'s, stood in for), takes them as they
    are: the same information and entropy, nothing added again."""
    mu = 0.5
    cfg = _port_cfg(dataclasses.replace(CFG4, max_iterations=6, mu=mu))
    imgs, _ = frames
    pyrs = _port_pyramids(imgs, cfg.num_levels)
    Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), cfg.num_levels)
    refs = tuple(pyrs[0][lvl][None] for lvl in range(cfg.num_levels))
    T0 = torch.eye(4)[None]
    want = t_dense_tracker.track_batched(refs, pyrs[3], Ks, T0, cfg)
    with monkeypatch.context() as m:
        m.setattr(t_dense_tracker, "_posterior", lambda best, cfg: best)
        data = t_dense_tracker.track_batched(refs, pyrs[3], Ks, T0, cfg)
    assert torch.equal(data.transformation, want.transformation)
    posterior = data.information + mu * torch.eye(6)
    assert torch.equal(want.information, posterior)
    assert torch.equal(want.entropy,
                       t_dense_tracker.pose_entropy(posterior))
    monkeypatch.setattr(t_linearize, "track_level_kernels",
                        _stand_in_level_kernels)
    got = t_dense_tracker._track_batched_kernels(refs, pyrs[3], Ks, T0, cfg)
    assert torch.equal(got.information, want.information)
    assert torch.equal(got.entropy, want.entropy)


@pytest.mark.parametrize("budget", [0.0, 0.5], ids=["full", "budget"])
@pytest.mark.parametrize("rows", ["B1", "B2_pointers", "B3_paired"])
def test_kernel_front_assembly(frames, monkeypatch, rows, budget):
    """The kernel front's TrackResult (every field a view of the level
    launches' output, each level starting from the pose the level above
    wrote) against the eager front on the same rows, with the launches
    stood in for on the CPU: every field equal, on the full grid and under
    a point budget (the selected count and valid ratio the compacted
    slots')."""
    cfg = _port_cfg(dataclasses.replace(CFG4, max_iterations=6,
                                        point_budget_fraction=budget))
    imgs, _ = frames
    pyrs = _port_pyramids(imgs, cfg.num_levels)
    B = int(rows[1])
    Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), cfg.num_levels)
    refs = tuple((tuple(p[lvl] for p in pyrs[:B]) if rows == "B2_pointers"
                  else torch.stack([p[lvl] for p in pyrs[:B]]))
                 for lvl in range(cfg.num_levels))
    curs = (tuple(torch.stack([p[lvl] for p in pyrs[1:B + 1]])
                  for lvl in range(cfg.num_levels))
            if rows.endswith("paired") else pyrs[3])
    T0 = torch.eye(4).expand(B, 4, 4)
    want = t_dense_tracker.track_batched(refs, curs, Ks, T0, cfg)
    monkeypatch.setattr(t_linearize, "track_level_kernels",
                        _stand_in_level_kernels)
    got = t_dense_tracker._track_batched_kernels(refs, curs, Ks, T0, cfg)
    for field, a, b in zip(got._fields, got, want):
        if field == "stats":
            for f, x, y in zip(a._fields, a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), f
        else:
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            assert a.shape == b.shape and a.dtype == b.dtype, field
            assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0)), field
    one = t_dense_tracker.row(got, 0)
    both = t_dense_tracker.pose_and_loglik(one)
    assert both.untyped_storage().data_ptr() == \
        got.transformation.untyped_storage().data_ptr()
    assert torch.equal(both[:16], one.transformation.reshape(16))
    assert torch.equal(both[-1], one.log_likelihood)
    eager = t_dense_tracker.pose_and_loglik(t_dense_tracker.row(want, 0))
    assert eager.shape == both.shape == (17,)
    assert torch.equal(eager, both)


def _constants(path, names):
    text = path.read_text()
    got = {}
    for name in names:
        m = re.search(rf"\b{name} = (\d+)", text)
        assert m, name
        got[name] = int(m.group(1))
    return got


def test_kernel_sources_front_layout_match_python():
    """The output layout and limits csrc/linearize.cu and csrc/pyramid.cu
    use are the ones the wrappers read and check."""
    lin = _constants(SRC / "linearize.cu", [
        "kLevelLoglik", "kLevelStats", "kStatPlanes", "kExtraSelected",
        "kExtraEntropy", "kExtraRatio", "kExtraSize", "kMaxRefRows"])
    L = t_linearize
    assert list(lin.values()) == [
        L._LEVEL_LOGLIK, L._LEVEL_STATS, L._STAT_PLANES, L._EXTRA_SELECTED,
        L._EXTRA_ENTROPY, L._EXTRA_RATIO, L._EXTRA_SIZE, L._MAX_REF_ROWS]
    assert L.level_row_size(7) == 67 + 5 * 7 + 3
    pyr = _constants(SRC / "pyramid.cu", ["kDepthF32", "kDepthU16",
                                          "kDepthPacked12", "kMaxLevels"])
    P = t_pyramid
    assert list(pyr.values()) == [P._DEPTH_F32, P._DEPTH_U16,
                                  P._DEPTH_PACKED12, P._MAX_LEVELS]


def test_loglik_constant():
    """The host constant of the kernel's log-likelihood is tdist_loglik's
    normaliser without its Sigma term."""
    cfg = _port_cfg(TrackerConfig())
    sigma = torch.eye(2)  # det 1: log_norm is the constant itself
    lin = t_linearize.Linearization(
        A=torch.eye(6), b=torch.zeros(6), err_mean=torch.tensor(0.0),
        n_valid=torch.tensor(1.0), n_raw=torch.tensor(1.0), sigma=sigma,
        log1p_sum=torch.tensor(0.0), err_raw=torch.tensor(0.0))
    np.testing.assert_allclose(float(t_linearize.tdist_loglik(lin, cfg)),
                               t_linearize.loglik_constant(cfg.tdist_dof),
                               rtol=1e-6)


def test_pose_and_loglik_needs_them_side_by_side():
    """``pose_and_loglik`` is one view of a pose and the log-likelihood
    stored right after it; a result holding them apart raises."""
    pose_ll = torch.arange(2 * 17, dtype=torch.float32).view(2, 17)
    T, ll = pose_ll[:, :16].unflatten(-1, (4, 4)), pose_ll[:, 16]
    res = t_dense_tracker.TrackResult(
        transformation=T[1], information=torch.eye(6),
        log_likelihood=ll[1], entropy=torch.tensor(0.0),
        error=torch.tensor(0.0), sigma=torch.eye(2),
        valid_pixels=torch.tensor(1.0), valid_ratio=torch.tensor(1.0),
        iterations=torch.zeros(4, dtype=torch.int32),
        level_errors=torch.zeros(4), stats=None,
        window_miss_frac=torch.tensor(0.0), escalated=torch.tensor(False))
    both = t_dense_tracker.pose_and_loglik(res)
    assert torch.equal(both, pose_ll[1])
    assert both.data_ptr() == pose_ll[1].data_ptr()
    with pytest.raises(ValueError):
        t_dense_tracker.pose_and_loglik(res._replace(
            log_likelihood=ll[1].clone()))
    with pytest.raises(ValueError):
        t_dense_tracker.pose_and_loglik(res._replace(
            log_likelihood=ll[0]))


def _frame_inputs(w, h, encoding):
    """Zeroed CPU inputs of a w x h frame in one of the kernel's
    encodings ("...@1": a contiguous view at one element's offset into a
    larger buffer)."""
    enc, _, shift = encoding.partition("@")
    i_t, z_t = {"f32": (torch.float32, torch.float32),
                "u8+u16": (torch.uint8, torch.uint16),
                "u8+packed12": (torch.uint8, torch.uint8)}[enc]
    zw = 3 * (w // 2) if enc == "u8+packed12" else w
    k = int(shift or 0)
    i = torch.zeros(h * w + k, dtype=i_t)[k:].view(h, w)
    z = torch.zeros(h * zw + k, dtype=z_t)[k:].view(h, zw)
    return i, z


@pytest.mark.parametrize("size, encoding, tma", [
    ((640, 480), "f32", True), ((640, 480), "u8+u16", True),
    ((640, 480), "u8+packed12", True), ((640, 470), "f32", True),
    ((642, 482), "f32", False), ((642, 482), "u8+u16", False),
    ((642, 482), "u8+packed12", False), ((82, 61), "f32", False),
    ((82, 61), "u8+u16", False), ((640, 480), "f32@1", False),
    ((640, 480), "u8+u16@1", False), ((640, 480), "u8+packed12@1", False)])
def test_tma_fill_predicate(size, encoding, tma):
    """The pyramid kernel's level-0 fill path: TMA where both inputs start
    16-B aligned with rows of a 16-B multiple (640 wide in every
    encoding), the scalar fill otherwise (642 and 82 wide: f32 rows of
    2 568 and 328 B, u16 of 1 284, packed of 963; a view at an odd offset)."""
    i, z = _frame_inputs(*size, encoding)
    assert i.is_contiguous() and z.is_contiguous()
    assert t_pyramid.tma_fill(i, z) is tma


@pytest.mark.parametrize("rows", [32, 40])
@pytest.mark.parametrize("size", [(640, 480), (642, 482), (82, 61), (32, 32)])
def test_kernel_grid(size, rows):
    """One CTA a 32-column tile of `rows` rows of level 0, the ragged edge
    included; the timing buffer has a row for each CTA of the smallest
    tiles."""
    w, h = size
    gx, gy = t_pyramid.kernel_grid(h, w, rows)
    assert (gx - 1) * 32 < w <= gx * 32 and (gy - 1) * rows < h <= gy * rows
    buf = t_pyramid.timing_buffer(h, w, "cpu")
    assert buf.shape[1] == t_pyramid._TIMING_SLOTS and buf.shape[0] >= gx * gy


@pytest.mark.parametrize("size, levels, sms, want", [
    ((640, 480), 4, 132, 40), ((640, 480), 1, 132, 40),
    ((640, 480), 5, 132, 32), ((640, 480), 6, 132, 32),
    ((640, 470), 4, 132, 40), ((642, 482), 4, 132, 32),
    ((82, 61), 4, 132, 32), ((80, 60), 3, 132, 32),
    ((640, 480), 4, 16, 40), ((640, 480), 4, 300, 32)])
def test_tile_rows(size, levels, sms, want):
    """The pyramid kernel's tile rows: 40 where it leaves the busiest SM
    fewer level-0 rows (640x480 on 132 SMs: 300 CTAs of 32 rows put 3 on
    some SMs, 240 of 40 at most 2), 32 past four levels and on a tie."""
    w, h = size
    got = t_pyramid.tile_rows(h, w, levels, sms)
    assert got == want and got in t_pyramid._TILE_ROWS
    assert got % (1 << (levels - 1)) == 0


@pytest.mark.parametrize("levels", [1, 4, 6])
def test_phase_times(levels):
    """The pyramid kernel's phase split from its stamps: clock64 spans
    converted by the CTAs' %globaltimer spans, one name a span, the
    launch from the first CTA's start to the last CTA's end."""
    rng = np.random.default_rng(levels)
    ctas, n = 6, 3 + 3 * levels
    # Two more rows than the launch had CTAs: left 0, and left out.
    buf = np.zeros((ctas + 2, t_pyramid._TIMING_SLOTS), np.int64)
    steps = rng.integers(10, 1000, size=(ctas, n - 1))
    start = rng.integers(0, 5000, size=ctas)
    run = buf[:ctas]
    run[:, 2] = 10**9 + start
    run[:, 3:2 + n] = run[:, 2:3] + np.cumsum(steps, axis=1)
    # 2 clocks a nanosecond: the CTAs' globaltimer spans are half theirs.
    run[:, 0] = 7000 + start
    run[:, 1] = run[:, 0] + steps.sum(1) // 2
    phases, span, cta = t_pyramid.phase_times(buf, levels)
    buf = run
    assert list(phases) == ["level-0 fill", "level-0 conversion and barrier",
                            *(f"level {lvl} {what}" for lvl in range(levels)
                              for what in ("downsample", "store", "barrier"))]
    ns = steps.sum(1).sum() / (buf[:, 1] - buf[:, 0]).sum()
    np.testing.assert_allclose(list(phases.values()),
                               steps.mean(0) / ns / 1e3, rtol=1e-12)
    assert span == (buf[:, 1].max() - buf[:, 0].min()) / 1e3
    assert cta == pytest.approx((buf[:, 1] - buf[:, 0]).mean() / 1e3)


def test_kernel_sources_pyramid_launch_match_python():
    """The tiles, fill paths and timing slots csrc/pyramid.cu uses are the
    ones the wrapper sizes its grid and buffers by and passes."""
    got = _constants(SRC / "pyramid.cu", ["kTile", "kTallTile", "kFillScalar",
                                          "kFillTma", "kTimingSlots"])
    P = t_pyramid
    assert list(got.values()) == [P._TILE, max(P._TILE_ROWS), P._FILL_SCALAR,
                                  P._FILL_TMA, P._TIMING_SLOTS]
    assert min(P._TILE_ROWS) == P._TILE
    assert "num_levels > 4" in (SRC / "pyramid.cu").read_text()
    assert P._TALL_LEVELS == 4
    # Stamps 0..4, then three a level: six levels fit.
    assert 5 + 3 * P._MAX_LEVELS <= P._TIMING_SLOTS

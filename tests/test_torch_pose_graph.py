"""The port's pose-graph optimizer against the JAX package's.

Mirrors tests/test_pose_graph.py's cases on the same numpy graphs, each
solved by both packages (f32 on both sides). Tolerances: optimized poses
within 1e-4 of the JAX package's (sums in another order; the JAX package
differentiates edges with jax.jacfwd, the port in closed form), robust
edge weights within 1e-3, chi2 rtol 1e-3; edge Jacobians within 1e-5 of
jax.jacfwd's over their largest entry. The same topology-only properties
the JAX tests assert (loop closed, false edge rejected, CG near dense,
padding invariance, adaptive GNC) are asserted on the port's results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import pose_graph
from dvo_slam_tpu.utils import se3_np
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import pose_graph as t_pose_graph
from torch_graphs import two_lap_ring


def _chain_graph(n=8, drift=0.02, seed=0, max_v=16, max_e=32, loop=True):
    """tests/test_pose_graph.py's drifted circle with one exact loop edge,
    as a host (numpy) graph."""
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        gt.append(se3_np.exp(np.array([np.sin(a), 1 - np.cos(a),
                                       0.1 * np.sin(a), 0, 0, a * 0.0])))
    g = t_pose_graph.empty_graph_host(max_v, max_e)
    T_est = [np.eye(4)]
    edges = []
    for k in range(n - 1):
        Z_true = se3_np.inverse(gt[k]) @ gt[k + 1]
        Z_noisy = Z_true @ se3_np.exp(rng.normal(scale=drift, size=6))
        T_est.append(T_est[-1] @ Z_noisy)
        edges.append((k, k + 1, Z_noisy, np.eye(6) * 1e2))
    if loop:
        edges.append((n - 1, 0, se3_np.inverse(gt[-1]) @ gt[0],
                      np.eye(6) * 1e4))
    for k in range(n):
        g.poses[k] = T_est[k] if k else np.eye(4)
    for e, (i, j, Zm, info) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = i, j
        g.measurements[e] = Zm
        g.information[e] = info
        g.edge_mask[e] = True
    g = g._replace(num_vertices=np.asarray(n, np.int32),
                   num_edges=np.asarray(len(edges), np.int32))
    return g, gt


def _jax_graph(g):
    return pose_graph.PoseGraph(*(jnp.asarray(x) for x in g))


def _both(g, **kw):
    want = pose_graph.optimize(_jax_graph(g), **kw)
    got = t_pose_graph.optimize(g, device="cpu", **kw)
    return got, want


def _assert_close(got, want):
    (g_opt, chi2, w), (j_opt, j_chi2, j_w) = got, want
    np.testing.assert_allclose(g_opt.poses.numpy(), np.asarray(j_opt.poses),
                               atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), atol=1e-3)
    np.testing.assert_allclose(float(chi2), float(j_chi2), rtol=1e-3,
                               atol=1e-6)


def _loop_err(poses, gt, last=7):
    T_last = np.asarray(poses[last], np.float64)
    T_first = np.asarray(poses[0], np.float64)
    Z_loop = se3_np.inverse(gt[-1]) @ gt[0]
    return np.linalg.norm(se3_np.log(
        se3_np.inverse(Z_loop) @ se3_np.inverse(T_last) @ T_first))


def test_residual_zero_and_jacobians_finite_for_consistent_edge():
    """The se3.log trap at the identity: a consistent edge's residual is
    exactly the identity, and its Jacobians must be finite (and match
    jax.jacfwd's)."""
    T_i = se3_np.exp(np.array([0.1, 0.2, -0.1, 0.05, 0.0, 0.1]))
    T_j = se3_np.exp(np.array([-0.2, 0.1, 0.3, 0.0, 0.1, -0.05]))
    Z = se3_np.inverse(T_i) @ T_j
    args = [x.astype(np.float32) for x in (T_i, T_j, Z)]
    e, Ji, Jj = t_pose_graph._edge_residual_and_jacobians(
        *(torch.from_numpy(a)[None] for a in args))
    np.testing.assert_allclose(e.numpy(), 0.0, atol=1e-5)
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    eye = torch.eye(4)[None]
    _, Ji0, Jj0 = t_pose_graph._edge_residual_and_jacobians(eye, eye, eye)
    np.testing.assert_array_equal(Jj0[0].numpy(), np.eye(6))
    np.testing.assert_array_equal(Ji0[0].numpy(), -np.eye(6))


def test_edge_jacobians_match_jacfwd():
    rng = np.random.default_rng(3)
    for scale in (0.0, 1e-4, 1e-2, 0.3):
        for _ in range(8):
            T_i = se3_np.exp(rng.normal(scale=0.5, size=6))
            T_j = se3_np.exp(rng.normal(scale=0.5, size=6))
            Z = (se3_np.inverse(T_i) @ T_j
                 @ se3_np.exp(rng.normal(scale=scale, size=6)))
            args = [x.astype(np.float32) for x in (T_i, T_j, Z)]
            e, Ji, Jj = pose_graph._edge_residual_and_jacobians(
                *(jnp.asarray(a) for a in args))
            te, tJi, tJj = t_pose_graph._edge_residual_and_jacobians(
                *(torch.from_numpy(a)[None] for a in args))
            np.testing.assert_allclose(te[0].numpy(), np.asarray(e),
                                       atol=1e-5)
            for a, b in ((tJi[0], Ji), (tJj[0], Jj)):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_optimize_closes_loop_like_jax():
    g, gt = _chain_graph(n=8, drift=0.03)
    got, want = _both(g, iterations=30, gnc_init=64.0)
    _assert_close(got, want)
    g_opt = got[0]
    assert _loop_err(g_opt.poses.numpy(), gt) < 0.3 * _loop_err(g.poses, gt)
    np.testing.assert_allclose(g_opt.poses[0].numpy(), np.eye(4), atol=1e-3)


def test_consistent_graph_stays_put_like_jax():
    g, _ = _chain_graph(n=6, drift=0.0, loop=True)
    got, want = _both(g, iterations=10)
    _assert_close(got, want)
    assert float(got[1]) < 1e-4
    np.testing.assert_allclose(got[0].poses[:6].numpy(), g.poses[:6],
                               atol=5e-3)


def test_false_loop_edge_rejected_like_jax():
    g, _ = _chain_graph(n=8, drift=0.01, max_e=32)
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 2, 6
    g.measurements[e] = se3_np.exp(np.array([1.5, -1.0, 0.8, 0.5, -0.4, 0.9]))
    g.information[e] = np.eye(6) * 1e4
    g.edge_mask[e] = True
    g = g._replace(num_edges=np.asarray(e + 1, np.int32))
    got, want = _both(g, iterations=30, use_robust=True)
    _assert_close(got, want)
    w = got[2].numpy()
    assert w[e] < 0.05 and w[:7].min() > 0.3


@pytest.mark.parametrize("padded", [False, True])
def test_cg_matches_dense_like_jax(padded):
    g, _ = _chain_graph(n=8, drift=0.03, max_v=32 if padded else 16,
                        max_e=64 if padded else 32)
    got_cg, want_cg = _both(g, iterations=30, gnc_init=64.0, solver="cg")
    _assert_close(got_cg, want_cg)
    dense = t_pose_graph.optimize(g, iterations=30, gnc_init=64.0,
                                  device="cpu")
    assert float(got_cg[1]) <= 1.05 * float(dense[1]) + 1e-6
    np.testing.assert_allclose(got_cg[0].poses[:8].numpy(),
                               dense[0].poses[:8].numpy(), atol=5e-3)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_padding_invariance(solver):
    small, _ = _chain_graph(n=6, drift=0.02, max_v=8, max_e=16)
    big, _ = _chain_graph(n=6, drift=0.02, max_v=32, max_e=64)
    o_small = t_pose_graph.optimize(small, iterations=15, solver=solver,
                                    device="cpu")[0]
    o_big = t_pose_graph.optimize(big, iterations=15, solver=solver,
                                  device="cpu")[0]
    np.testing.assert_allclose(o_small.poses[:6].numpy(),
                               o_big.poses[:6].numpy(), atol=2e-4)
    want = pose_graph.optimize(_jax_graph(big), iterations=15,
                               solver=solver)[0]
    np.testing.assert_allclose(o_big.poses.numpy(), np.asarray(want.poses),
                               atol=1e-4)


def test_adaptive_gnc_recovers_high_information_loop_like_jax():
    g, gt = _chain_graph(n=8, drift=0.05)
    g = g._replace(information=g.information * 1e4)
    loop = int(g.num_edges) - 1
    fixed, want_fixed = _both(g, iterations=30, gnc_init=16.0)
    adapt, want_adapt = _both(g, iterations=30, gnc_init=16.0,
                              gnc_adaptive=True)
    _assert_close(adapt, want_adapt)
    np.testing.assert_allclose(fixed[2].numpy(), np.asarray(want_fixed[2]),
                               atol=1e-3)
    assert float(fixed[2][loop]) < 0.05
    assert float(adapt[2][loop]) > 0.5
    assert (_loop_err(adapt[0].poses.numpy(), gt)
            < 0.3 * _loop_err(fixed[0].poses.numpy(), gt))


def test_solve_is_deterministic_and_not_pd_step_is_zeroed():
    """Two solves give the same bits (the duplicate-index sums run in a
    fixed order); a system that is not positive definite (NaN information
    on one edge) gives no step, as JAX's cho_factor NaN does."""
    g, _ = _chain_graph(n=8, drift=0.03)
    a = t_pose_graph.optimize(g, iterations=20, gnc_init=16.0,
                              gnc_adaptive=True, device="cpu")
    b = t_pose_graph.optimize(g, iterations=20, gnc_init=16.0,
                              gnc_adaptive=True, device="cpu")
    assert torch.equal(a[0].poses, b[0].poses) and torch.equal(a[2], b[2])
    bad = g._replace(information=g.information.copy())
    bad.information[0] = -np.eye(6) * 1e2
    out = t_pose_graph.optimize(bad, iterations=3, use_robust=False,
                                device="cpu")[0]
    want = pose_graph.optimize(_jax_graph(bad), iterations=3,
                               use_robust=False)[0]
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(want.poses),
                               atol=1e-4)
    assert torch.isfinite(out.poses).all()


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_stops_where_jax_does(solver, monkeypatch):
    """The LM loop exits after the step that converges, as the JAX
    while_loop does: fewer steps than asked, and the same result as a
    solve asked for exactly that many steps. _total_chi2 runs once per
    LM step."""
    g, _ = _chain_graph(n=6, drift=0.0, loop=True)
    ran = []
    total = t_pose_graph._total_chi2

    def counting(*args, **kwargs):
        ran.append(1)
        return total(*args, **kwargs)

    monkeypatch.setattr(t_pose_graph, "_total_chi2", counting)
    kw = dict(solver=solver, device="cpu")
    got = t_pose_graph.optimize(g, iterations=50, **kw)
    n = len(ran)
    assert 0 < n < 50
    exact = t_pose_graph.optimize(g, iterations=n, **kw)
    for a, b in zip(got, exact):
        assert torch.equal(getattr(a, "poses", a), getattr(b, "poses", b))
    want = pose_graph.optimize(_jax_graph(g), iterations=50, solver=solver)
    _assert_close(got, want)


def test_host_graph_helpers_like_jax():
    g, _ = _chain_graph(n=5, max_v=8, max_e=8)
    for got, want in (
        (t_pose_graph.grow(g, max_vertices=16, max_edges=12),
         pose_graph.grow(pose_graph.PoseGraph(*g), max_vertices=16,
                         max_edges=12)),
        (t_pose_graph.crop(g, 4, 6),
         pose_graph.crop(pose_graph.PoseGraph(*g), 4, 6)),
    ):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for n, m in ((1, 16), (17, 16), (100, 64), (0, 1)):
        assert t_pose_graph.bucket(n, m) == pose_graph.bucket(n, m)
    empty = t_pose_graph.empty_graph_host(4, 6)
    for x, y in zip(empty, pose_graph.empty_graph_host(4, 6)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    # The numpy carriers round-trip the JAX graph's arrays and dtypes.
    back = convert.pose_graph_to_numpy(convert.pose_graph_from_numpy(
        [np.asarray(x) for x in _jax_graph(g)]))
    for x, y in zip(back, g):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.asarray(y).dtype


@pytest.mark.parametrize("solver, M, device, route", [
    ("dense", 16, "cuda", "cluster"),
    ("dense", 32, "cuda", "cluster"),
    ("dense", 1, torch.device("cuda", 1), "cluster"),
    ("dense", 64, "cuda", "cluster"),
    ("dense", 128, "cuda", "cluster"),
    ("dense", 129, "cuda", "grid"),
    ("dense", 256, "cuda", "grid"),
    ("dense", 512, torch.device("cuda", 0), "grid"),
    ("dense", 1024, "cuda", "grid"),
    ("dense", 2560, "cuda", "grid"),
    ("cg", 1, "cuda", "grid"),
    ("cg", 16, "cuda", "grid"),
    ("cg", 64, torch.device("cuda", 1), "grid"),
    ("cg", 128, "cuda", "grid"),
    ("cg", 512, "cuda", "grid"),
    ("cg", 4096, "cuda", "grid"),
    ("dense", 16, "cpu", "host loop"),
    ("dense", 256, "cpu", "host loop"),
    ("cg", 16, "cpu", "host loop"),
    ("cg", 2560, torch.device("cpu"), "host loop"),
])
def test_graph_route(solver, M, device, route):
    """Every solve on a CUDA device is one kernel launch: a dense solve of
    at most KERNEL_MAX_VERTICES vertices on the cluster kernel, every
    other (CG at any size, dense past 128) on the grid kernel; the CPU
    takes the plain host loop. Decided by device, solver and size alone."""
    assert t_pose_graph.graph_route(solver, M, device) == route


NB = 16  # the kernel's panel width


def _panel_rows(n, C, rank):
    """Rows CTA `rank` of C holds: its panels p = rank, rank + C, ... of
    NB columns, each rows [p NB, n) of the lower triangle and row n, the
    right-hand side."""
    return sum(n + 1 - p * NB for p in range(-(-n // NB)) if p % C == rank)


def _layout(M, C):
    n = 6 * M
    return 4 * (_panel_rows(n, C, 0) * (NB + 1)
                + (n * (NB + 1) if C > 1 else 0) + n + 32 * M)


def _scratch(M, E, C):
    """Global scratch floats: the per-edge blocks and, in a cluster, every
    panel once (the broadcast the CTAs copy from)."""
    return 42 * E + (_panel_rows(6 * M, 1, 0) * (NB + 1) if C > 1 else 0)


def test_kernel_plan_sizes_shared_memory():
    """One CTA of 512 threads up to 32 vertices, then clusters of 4 to 16
    CTAs up to 128: a CTA holds its panels of the damped system's lower
    triangle (rows from the panel's first column on and the right-hand
    side's row, NB + 1 floats a row), in a cluster a copy of one panel, the
    right-hand side and two pose copies, and one CTA also the per-edge
    blocks where they fit, within an H100 CTA's 232 448 bytes; every M up
    to 128 has a layout."""
    assert t_pose_graph.kernel_plan(32, 64) == (
        128, 1, 512, _layout(32, 1) + 4 * 42 * 64, NB, 1, _scratch(32, 64, 1))
    assert t_pose_graph.kernel_plan(16, 64) == (
        128, 1, 512, _layout(16, 1) + 4 * 42 * 64, NB, 1, _scratch(16, 64, 1))
    assert t_pose_graph.kernel_plan(64, 128) == (
        128, 4, 512, _layout(64, 4), NB, 0, _scratch(64, 128, 4))
    assert t_pose_graph.kernel_plan(128, 4096) == (
        128, 16, 512, 176_332, NB, 0, _scratch(128, 4096, 16))
    # 4 096 edges do not fit beside one CTA's panels: global scratch.
    assert t_pose_graph.kernel_plan(32, 4096)[3:6] == (_layout(32, 1), NB, 0)
    for M in range(1, 129):
        limit, C, threads, nbytes, width, staged, scratch = \
            t_pose_graph.kernel_plan(M)
        assert (limit, threads, width, staged) == (128, 512, NB, int(C == 1))
        assert nbytes == _layout(M, C) <= 230_400 <= 232_448 - 2_048
        assert scratch == _scratch(M, 0, C)
        assert C == 1 if M <= 32 else C in (4, 8, 16)
        P = -(-6 * M // NB)
        assert C == 1 or -(-P // C) * NB <= 96
        assert C <= 2 or -(-P // (C // 2)) * NB > 96 or \
            _layout(M, C // 2) > 230_400
    for M in (0, 129, 256):
        assert t_pose_graph.kernel_plan(M)[1:4] == (0, 512, 0)


@pytest.mark.parametrize("M", [17, 33, 65, 100, 127])
def test_kernel_plan_deals_panels_block_cyclically(M):
    """Panel p (columns [p NB, (p + 1) NB), the last one ragged: 6M is no
    multiple of NB at these M) lives on CTA p mod C: the ranks' panels
    cover the lower triangle and the right-hand side's row once, rank 0
    holds the most, and its bytes are the plan's."""
    _, C, _, nbytes, width, _, _ = t_pose_graph.kernel_plan(M)
    n = 6 * M
    assert width == NB and C >= 1 and n % NB
    rows = [t_pose_graph._panel_floats(n, C, r) // (NB + 1) for r in range(C)]
    assert rows == [_panel_rows(n, C, r) for r in range(C)]
    assert sum(rows) == sum(n + 1 - p * NB for p in range(-(-n // NB)))
    assert max(rows) == rows[0]
    assert nbytes == _layout(M, C)


def test_kernel_pack_plans_skip_masked_edges():
    """The kernel's plans: the plain loop's, minus the masked edges'
    contributions (exact zeros: weight 0), in the plain order; the dense
    list coded as the kernel reads it (4 e + kind, -1 - v for a vertex's
    extra block); the non-empty lower blocks listed by column vertex."""
    g, _ = _chain_graph(n=8, drift=0.03, max_v=16, max_e=32)
    M, E = g.poses.shape[0], g.edge_i.shape[0]
    buf, where = t_pose_graph._pack(g)
    get = (lambda k: buf[where[k][0]:where[k][0] + where[k][1]].view(
        np.int32))
    mask = np.asarray(g.edge_mask, bool)
    vertex, dense = t_pose_graph._plan_targets(g)
    v_off, v_idx = t_pose_graph._csr(vertex, M)
    d_off, d_idx = t_pose_graph._csr(dense, M * M)
    kv_off, kv_idx = get("v_off"), get("v_idx")
    for v in range(M):
        plain = [c for c in v_idx[v_off[v]:v_off[v + 1]] if mask[c % E]]
        assert list(kv_idx[kv_off[v]:kv_off[v + 1]]) == plain
    codes, b_off = get("d_idx"), get("b_off")
    blocks = get("b_list").reshape(-1, 4)
    assert where["b_list"][0] % 4 == 0
    assert [tuple(r[:2]) for r in blocks] == sorted(
        {(s // M, s % M) for s in range(M * M)
         if s // M >= s % M and any(c >= 4 * E or mask[c % E]
                                    for c in d_idx[d_off[s]:d_off[s + 1]])},
        key=lambda ab: (ab[1], ab[0]))
    for a, b, u0, u1 in blocks:
        s = a * M + b
        plain = [c for c in d_idx[d_off[s]:d_off[s + 1]]
                 if c >= 4 * E or mask[c % E]]
        want = [4 * (c % E) + c // E if c < 4 * E else -1 - (c - 4 * E)
                for c in plain]
        assert list(codes[u0:u1]) == want
        assert b_off[b] <= list(blocks[:, 1]).index(b) < b_off[b + 1]
    assert b_off[M] == len(blocks)


def test_optimize_kernel_refuses_cpu_and_large_graphs():
    """The kernel route has no plain fallback: it refuses what it does not
    take instead of running the host loop."""
    g, _ = _chain_graph(n=6)
    with pytest.raises(ValueError):
        t_pose_graph.optimize_kernel(g, device="cpu")
    big = t_pose_graph.grow(g, max_vertices=256)
    with pytest.raises(ValueError):
        t_pose_graph.optimize_kernel(big, device="cuda")


def test_optimize_grid_refuses_the_cpu():
    """The grid route has no plain fallback either: a CPU device, a solver
    it does not know or a negative step count raise instead of running the
    host loop (before anything is built)."""
    g, _ = _chain_graph(n=6)
    for solver in t_pose_graph.SOLVERS:
        with pytest.raises(ValueError):
            t_pose_graph.optimize_grid(g, device="cpu", solver=solver)
    with pytest.raises(ValueError):
        t_pose_graph.optimize_grid(g, device="cuda", solver="qr")
    with pytest.raises(ValueError):
        t_pose_graph.optimize_grid(g, device="cuda", iterations=-1)


def _grid_floats(M, E, solver, ctas):
    """The grid kernel's scratch floats, each region rounded up to 4
    floats (16 bytes): per-CTA f64 partials (8 slots), the per-edge blocks
    (42 floats), two pose buffers; dense: the lower triangle's tiles and
    -g's row of tiles (32 x 32 floats each), 1 / L_ii, the step and the
    factorization's flags (three words a tile column and the pivot flag);
    CG: the preconditioner (36 a vertex) and seven 6-vectors a vertex."""
    up = (lambda n: -(-n // 4) * 4)
    floats = up(2 * 8 * ctas) + up(42 * E) + 2 * up(16 * M)
    if solver == "dense":
        Pt = -(-6 * M // 32)
        return (floats + up((Pt * (Pt + 1) // 2 + Pt) * 1024) + 2 * up(32 * Pt)
                + up(3 * Pt + 1))
    return floats + up(36 * M) + 7 * up(6 * M)


@pytest.mark.parametrize("M, E, solver", [
    (1, 0, "dense"), (129, 256, "dense"), (150, 256, "dense"),
    (256, 512, "dense"), (512, 1024, "dense"), (1024, 2048, "dense"),
    (2560, 4096, "dense"), (1, 0, "cg"), (64, 128, "cg"), (512, 1024, "cg"),
    (2560, 4096, "cg")])
@pytest.mark.parametrize("ctas", [1, 132])
def test_grid_plan_sizes(M, E, solver, ctas):
    """One CTA of 256 threads a streaming multiprocessor; a CTA's shared
    memory holds the diagonal tile (32 rows of 33 floats), its factor's
    column broadcast (two buffers of 32 floats) and a unit's two staged
    columns (32 rows of 64 + 4 floats each: units of 2 x 2 tiles), under
    the 48 KB a launch may ask without opting in; the dense system in
    ceil(6M / 32) tiles a side, whose lower triangle covers the damped
    system's (4.7 MB at M = 256, ~475 MB at 2 560)."""
    plan = t_pose_graph.grid_plan(M, E, solver, ctas)
    Pt = -(-6 * M // 32) if solver == "dense" else 0
    smem = 4 * (32 * 33 + 64 + 2 * 32 * 68)
    assert plan == (ctas, 256, smem, 32, Pt, _grid_floats(M, E, solver, ctas),
                    2)
    assert smem <= 48 * 1024
    if solver == "dense":
        n = 6 * M
        tiles = (Pt * (Pt + 1) // 2) * 1024
        assert n * (n + 1) // 2 <= tiles <= (n + 32) * (n + 64) // 2
    if (M, solver) == (256, "dense"):
        assert 4.7e6 < 4 * tiles < 4.9e6
    if (M, solver) == (2560, "dense"):
        assert 4.7e8 < 4 * plan[5] < 4.8e8


@pytest.mark.parametrize("bad", [(0, 64, "dense"), (16, -1, "dense"),
                                 (16, 64, "qr"), (16, 64, "cg", 0)])
def test_grid_plan_refuses(bad):
    M, E, solver, *ctas = bad
    with pytest.raises(ValueError):
        t_pose_graph.grid_plan(M, E, solver, *(ctas or [132]))


@pytest.mark.parametrize("dense", [True, False])
def test_grid_pack_plans_sum_in_the_plain_order(dense):
    """The grid kernel's upload: the vertex plan (the gradient, the CG
    preconditioner's block diagonal and its matvec all sum over it) holds,
    vertex by vertex, the plain loop's gather rows without the masked
    edges, in the same order; a dense solve adds the cluster kernel's
    dense plan and block list unchanged, a CG solve uploads no dense plan;
    the graph's own arrays are the same in both."""
    g, _ = _chain_graph(n=8, drift=0.03, max_v=32, max_e=64)
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 5, 2  # an edge against the chain's order
    g.edge_mask[e] = True
    buf, where = t_pose_graph._pack(g, dense)
    full, full_where = t_pose_graph._pack(g)
    assert ("d_idx" in where) is dense and ("b_list" in where) is dense
    for name, (a, n, is_int) in where.items():
        b, m, full_int = full_where[name]
        assert (n, is_int) == (m, full_int)
        np.testing.assert_array_equal(buf[a:a + n].view(np.int32),
                                      full[b:b + m].view(np.int32))
    M, E = g.poses.shape[0], g.edge_i.shape[0]
    mask = np.asarray(g.edge_mask, bool)
    topo = t_pose_graph._topology(g, "cpu")
    rows = {int(k): [int(x) for x in r if x != 2 * E]
            for k, r in zip(topo.vertex.keys, topo.vertex.gather)}
    a_off, _, _ = where["v_off"]
    a_idx, _, _ = where["v_idx"]
    off = buf[a_off:a_off + M + 1].view(np.int32)
    idx = buf[a_idx:a_idx + int(off[-1])].view(np.int32)
    for v in range(M):
        assert list(idx[off[v]:off[v + 1]]) == [
            c for c in rows.get(v, []) if mask[c % E]]


def _noisy_ring(M, n, seed, slots):
    """A seeded SLAM-like graph padded to M vertex and `slots` edge slots
    (tests/test_torch_kernels_cuda.py's): n keyframes on a 1 m ring,
    odometry edges with 5 mm / 0.01 rad noise chained into the initial
    poses, loop edges from the last third back to the first, one false
    loop edge; information scaled as a tracker's (1e4-1e6)."""
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
    g = t_pose_graph.empty_graph_host(M, slots)
    g.poses[:n] = np.stack(T_est)
    for e, (i, j, Zm, inf) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = i, j
        g.measurements[e], g.information[e] = Zm, inf
        g.edge_mask[e] = True
    return g._replace(num_vertices=np.asarray(n, np.int32),
                      num_edges=np.asarray(len(edges), np.int32))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ring_past_128_vertices_like_jax(solver):
    """A 150-keyframe noisy ring padded to 256 vertex slots (the grid
    kernel's route on the card), solved as the SLAM engine solves its
    graph (Cauchy, adaptive GNC from 16), through the JAX package and the
    port's CPU route, dense and CG: poses within 1e-4, weights within
    1e-3, chi2 rtol 1e-3 (_assert_close's tolerances: sums in another
    order, jax.jacfwd against the closed-form Jacobians); the false loop
    edge is rejected."""
    g = _noisy_ring(256, 150, seed=21, slots=512)
    got, want = _both(g, iterations=8, use_robust=True, cauchy_c=1.0,
                      gnc_init=16.0, gnc_adaptive=True, solver=solver)
    _assert_close(got, want)
    assert float(got[2][int(g.num_edges) - 1]) < 0.05


def _window(M, n, seed=0):
    """A SLAM window with a keyframe every frame (phase 5g's graphs): n
    keyframes padded to M slots, every pair of keyframes joined by an
    edge."""
    rng = np.random.default_rng(seed)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    g = t_pose_graph.empty_graph_host(M, len(pairs) + 8)
    for e, (i, j) in enumerate(pairs):
        g.edge_i[e], g.edge_j[e] = j, i
        g.measurements[e] = se3_np.exp(rng.normal(scale=0.01, size=6))
        g.information[e] = np.eye(6) * 1e3
        g.edge_mask[e] = True
    g.poses[:n] = [se3_np.exp(rng.normal(scale=0.1, size=6))
                   for _ in range(n)]
    return g._replace(num_vertices=np.asarray(n, np.int32),
                      num_edges=np.asarray(len(pairs), np.int32))


PATTERN_GRAPHS = {
    "chain": lambda: _chain_graph(n=40, drift=0.02, max_v=64, max_e=64,
                                  loop=False)[0],
    "noisy_ring256": lambda: _noisy_ring(256, 150, seed=21, slots=512),
    "two_lap_ring256": lambda: two_lap_ring(256),
    "window": lambda: _window(64, 40),
    "padded": lambda: _noisy_ring(256, 30, seed=5, slots=512),
}


@pytest.mark.parametrize("case", sorted(PATTERN_GRAPHS))
def test_grid_pattern_holds_the_factor(case):
    """The grid kernel's map of the dense factor (grid_pattern, uploaded by
    _pack with `grid`): every 32 x 32 tile that numpy's f64 Cholesky of the
    damped system (the plain _build_system in f64, damped as the host
    loop's first step) leaves nonzero is in the fill, with the diagonal and
    the -g row; nothing above the diagonal; the units hold every nonzero
    tile and no empty one, by unit column then row; each column's count is
    the units holding it; the uploaded words carry the fill's bits. On the
    rings at least half the tiles stay zero (the work the kernel skips)."""
    g = PATTERN_GRAPHS[case]()
    M = g.poses.shape[0]
    buf, where = t_pose_graph._pack(g, dense=True, grid=True)
    got = {k: buf[a:a + n].view(np.int32) for k, (a, n, _) in where.items()
           if k in ("b_list", "fill", "units", "col_units")}
    fill, units, col_units = t_pose_graph.grid_pattern(
        got["b_list"].reshape(-1, 4), M)
    Pt = -(-6 * M // 32)
    assert fill.shape == (Pt + 1, Pt)
    g64 = t_pose_graph.to_device(g, "cpu")
    g64 = g64._replace(poses=g64.poses.double(),
                       measurements=g64.measurements.double(),
                       information=g64.information.double())
    H, _, _, _ = t_pose_graph._build_system(
        g64, t_pose_graph._topology(g, "cpu"), True, 1.0)
    damped = (H + 1e-6 * torch.diag(torch.diagonal(H))
              + 1e-6 * torch.eye(6 * M, dtype=torch.float64)).numpy()
    L = np.zeros((32 * Pt, 32 * Pt))
    L[:6 * M, :6 * M] = np.linalg.cholesky(damped)
    held = np.abs(L).reshape(Pt, 32, Pt, 32).max(axis=(1, 3)) > 0
    assert not (held & ~fill[:Pt]).any()
    assert fill[np.arange(Pt), np.arange(Pt)].all() and fill[Pt].all()
    assert not np.triu(fill[:Pt], 1).any()
    if "ring" in case:
        assert fill[:Pt].sum() < 0.5 * Pt * (Pt + 1) / 2
    U, W = units >> 16, units & 0xffff
    assert list(zip(W, U)) == sorted(zip(W, U))
    in_units = set(zip(U.tolist(), W.tolist()))
    assert in_units == {(I // 2, J // 2) for I, J in zip(*np.nonzero(fill))}
    for j in range(Pt):
        assert col_units[j] == len({I // 2 for I in np.flatnonzero(fill[:, j])})
    np.testing.assert_array_equal(got["units"], units)
    np.testing.assert_array_equal(got["col_units"], col_units)
    words = got["fill"].view(np.uint32).reshape(Pt + 1, -1)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(Pt + 1, -1)[:, :Pt], fill)


@pytest.mark.parametrize("case", sorted(PATTERN_GRAPHS))
def test_fill_ops_counts_the_block_fill(case):
    """chip_smoke._fill_ops, the dense solve's operations in the graph
    kernels' bound, counts the 6 x 6 blocks that numpy's f64 Cholesky of
    the damped system over the real vertices leaves nonzero: per block
    column with d of them below the diagonal, b^3 / 3 + d b^3 + d (d - 1)
    b^3 + d b^2 (b + 1) for the factor, 4 d b^2 + 2 b^2 for the two solves
    (b = 6)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = PATTERN_GRAPHS[case]()
    nv = int(g.num_vertices)
    g64 = t_pose_graph.to_device(g, "cpu")
    g64 = g64._replace(poses=g64.poses.double(),
                       measurements=g64.measurements.double(),
                       information=g64.information.double())
    H, _, _, _ = t_pose_graph._build_system(
        g64, t_pose_graph._topology(g, "cpu"), True, 1.0)
    H = H[:6 * nv, :6 * nv]
    damped = (H + 1e-6 * torch.diag(torch.diagonal(H))
              + 1e-6 * torch.eye(6 * nv, dtype=torch.float64)).numpy()
    L = np.linalg.cholesky(damped)
    nz = np.abs(L).reshape(nv, 6, nv, 6).max(axis=(1, 3)) > 0
    d = np.tril(nz, -1).sum(0).astype(np.float64)
    b = 6.0
    want = (nv * b**3 / 3 + d.sum() * b**3 + (d * (d - 1)).sum() * b**3
            + d.sum() * b * b * (b + 1) + 4 * d.sum() * b * b
            + 2 * nv * b * b)
    assert smoke._fill_ops(g) == pytest.approx(want, rel=1e-12)


def _overflowing_gradient(g):
    """g plus an edge 0 -> 1 with a 2 m translation residual and
    translation information 2e38: its block of H stays finite, every pivot
    passes, and its gradient overflows f32 (a step that is not finite)."""
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 0, 1
    g.measurements[e] = (se3_np.inverse(g.poses[0]) @ g.poses[1]
                         @ se3_np.exp(np.array([-2.0, 0, 0, 0, 0, 0])))
    g.information[e] = np.diag([2e38] * 3 + [0.0] * 3)
    g.edge_mask[e] = True
    return g._replace(num_edges=np.asarray(e + 1, np.int32))


@pytest.mark.parametrize("case, solver, want", [
    ("loop_closure", "dense", "none"), ("loop_closure", "cg", "none"),
    ("not_pd", "dense", "pivot"), ("overflow", "dense", "not_finite"),
    ("overflow", "cg", "none")])
def test_last_zeroed_tells_why_a_step_was_zeroed(case, solver, want):
    """LAST_ZEROED after the plain loop: (iterations,) int32, per step why
    it came out zero: ZEROED_PIVOT where cholesky_ex met a pivot <= 0 (a
    negated information makes a diagonal block negative definite),
    ZEROED_NOT_FINITE where the step is not finite (an f32 gradient that
    overflows), ZEROED_NONE for a step used and past the last step; a
    zeroed step has norm 0 in LAST_STATS. CG meets the overflow in its stop
    test first: rr > tol^2 |b|^2 is false at |b|^2 = inf, so it runs no
    iteration and its zero step is used."""
    g, _ = _chain_graph(n=8, drift=0.03)
    if case == "not_pd":
        g = g._replace(information=g.information.copy())
        g.information[0] = -np.eye(6) * 1e2
    if case == "overflow":
        g = _overflowing_gradient(g)
    t_pose_graph.optimize(g, iterations=6, solver=solver, use_robust=False,
                          device="cpu")
    zeroed = t_pose_graph.LAST_ZEROED
    steps = int(t_pose_graph.LAST_STEPS)
    assert zeroed.dtype == torch.int32 and zeroed.shape == (6,)
    code = {"none": t_pose_graph.ZEROED_NONE,
            "pivot": t_pose_graph.ZEROED_PIVOT,
            "not_finite": t_pose_graph.ZEROED_NOT_FINITE}[want]
    assert int(zeroed[0]) == code
    assert not zeroed[steps:].any()
    norms = t_pose_graph.LAST_STATS[:steps, 2]
    assert torch.equal(norms[zeroed[:steps] != 0],
                       torch.zeros_like(norms[zeroed[:steps] != 0]))
    if want == "none":
        assert not zeroed.any() and 0 < steps


@pytest.mark.parametrize("padded", [False, True])
def test_kernel_plans_sum_in_the_plain_order(padded):
    """The kernel's CSR lists hold, slot by slot, the contributions the
    plain loop's gather plans sum, in the same order, neither holding a
    masked edge's (exact zeros); the packed upload keeps every array
    (integers bitwise)."""
    g, _ = _chain_graph(n=8, drift=0.03, max_v=32 if padded else 16,
                        max_e=64 if padded else 32)
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 5, 2  # an edge against the chain's order
    g.edge_mask[e] = True
    topo = t_pose_graph._topology(g, "cpu")
    targets = t_pose_graph._plan_targets(g)
    M = g.poses.shape[0]
    on = np.asarray(g.edge_mask, bool)
    for plan, tgt, size, keep in (
            (topo.vertex, targets[0], M, np.tile(on, 2)),
            (topo.dense, targets[1], M * M,
             np.concatenate([np.tile(on, 4), np.ones(M, bool)]))):
        off, idx = t_pose_graph._csr(tgt, size, keep)
        K = tgt.shape[0]
        rows = {int(k): [int(x) for x in r if x != K]
                for k, r in zip(plan.keys, plan.gather)}
        for s in range(size):
            assert list(idx[off[s]:off[s + 1]]) == rows.get(s, [])
    buf, where = t_pose_graph._pack(g)
    for name, want in (("poses", g.poses), ("Z", g.measurements),
                       ("info", g.information),
                       ("mask", g.edge_mask.astype(np.float32))):
        a, n, is_int = where[name]
        assert not is_int
        np.testing.assert_array_equal(buf[a:a + n], want.ravel())
    for name, want in (("edge_i", g.edge_i), ("edge_j", g.edge_j)):
        a, n, is_int = where[name]
        assert is_int
        np.testing.assert_array_equal(buf[a:a + n].view(np.int32), want)


@pytest.mark.parametrize("case", ["consistent_dense", "consistent_cg",
                                  "loop_closure", "zero_iterations"])
def test_last_steps_counts_the_plain_loop(case, monkeypatch):
    """LAST_STEPS after the plain loop is the number of LM steps it ran
    (one _total_chi2 call a step) as a 0-d int32 tensor; where the loop
    stops early, the JAX while_loop has stopped by that step too (asking
    it for exactly that many steps gives the same result bit for bit)."""
    if case.startswith("consistent"):
        g, _ = _chain_graph(n=6, drift=0.0, loop=True)
        kw = dict(iterations=50, solver=case.split("_")[1])
    elif case == "loop_closure":
        g, _ = _chain_graph(n=8, drift=0.03)
        kw = dict(iterations=30, gnc_init=64.0)
    else:
        g, _ = _chain_graph(n=8, drift=0.03)
        kw = dict(iterations=0)
    ran = []
    total = t_pose_graph._total_chi2

    def counting(*args, **kwargs):
        ran.append(1)
        return total(*args, **kwargs)

    monkeypatch.setattr(t_pose_graph, "_total_chi2", counting)
    got = t_pose_graph.optimize(g, device="cpu", **kw)
    steps = t_pose_graph.LAST_STEPS
    assert steps.dtype == torch.int32 and steps.dim() == 0
    assert int(steps) == len(ran) <= kw["iterations"]
    if case.startswith("consistent"):
        assert 0 < int(steps) < kw["iterations"]
        want = pose_graph.optimize(_jax_graph(g), **kw)
        stopped = pose_graph.optimize(_jax_graph(g),
                                      **dict(kw, iterations=int(steps)))
        for a, b in zip(want, stopped):
            np.testing.assert_array_equal(np.asarray(getattr(a, "poses", a)),
                                          np.asarray(getattr(b, "poses", b)))
        _assert_close(got, want)
    if case == "zero_iterations":
        np.testing.assert_array_equal(got[0].poses.numpy(), g.poses)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_last_stats_records_each_plain_step(solver):
    """LAST_STATS after the plain loop: (iterations, 4) f32, one row a
    step run (chi2, trial chi2, step norm, accept as 1 or 0) and zeros
    past the last; an accepted trial never raises the chi2, and at a
    constant Cauchy width the next step starts from the chi2 the accept
    test left (the trial's if accepted, else the step's own)."""
    g, _ = _chain_graph(n=8, drift=0.01)
    got = t_pose_graph.optimize(g, iterations=30, solver=solver, device="cpu")
    steps = int(t_pose_graph.LAST_STEPS)
    st = t_pose_graph.LAST_STATS.numpy()
    assert st.shape == (30, 4) and st.dtype == np.float32
    assert 0 < steps < 30
    assert not st[steps:].any()
    chi2, trial, norm, accept = st[:steps].T
    assert set(accept) <= {0.0, 1.0}
    assert (trial[accept == 1] <= chi2[accept == 1]).all()
    np.testing.assert_allclose(chi2[1:], np.where(accept[:-1] == 1,
                                                  trial[:-1], chi2[:-1]),
                               rtol=1e-5)
    assert accept[-1] == 1 and norm[-1] < 1e-8
    np.testing.assert_allclose(float(got[1]), trial[-1], rtol=1e-5)


def test_cpu_route_counts_no_kernel_launch():
    """The host loop leaves the graph kernel's launch counters alone."""
    g, _ = _chain_graph(n=8, drift=0.03)
    before = (t_pose_graph.LAUNCHES, dict(t_pose_graph.LAUNCHES_BY_M))
    t_pose_graph.optimize(g, iterations=5, device="cpu")
    assert (t_pose_graph.LAUNCHES, t_pose_graph.LAUNCHES_BY_M) == before


def _stats_run(accept, trial_rel=(), steps=None):
    """A (LAST_STEPS, LAST_STATS) pair of `len(accept)` steps at chi2 10,
    trial chi2 10 (1 + trial_rel[k]) (-1e-2 where not given)."""
    n = len(accept)
    st = np.zeros((8, 4), np.float32)
    rel = list(trial_rel) + [-1e-2] * (n - len(trial_rel))
    for k in range(n):
        st[k] = (10.0, 10.0 * (1 + rel[k]), 1e-3, accept[k])
    return (n if steps is None else steps), st


@pytest.mark.parametrize("runs, want", [
    # the same decisions and step count: no parting
    ((_stats_run([1, 1, 1]), _stats_run([1, 1, 1])), None),
    # accept decisions part at step 1 on trials within 1e-4 of chi2: a tie
    ((_stats_run([1, 1, 1], [-1e-2, -5e-5]),
      _stats_run([1, 0, 1], [-1e-2, 6e-5])), (1, True)),
    # they part at step 1 on a trial that moves chi2 by 1e-2: no tie
    ((_stats_run([1, 1, 1], [-1e-2, -1e-2]),
      _stats_run([1, 0, 1], [-1e-2, 1e-2])), (1, False)),
    # the same decisions, one run stops a step early: its last step, a tie
    ((_stats_run([1, 1, 1], [-1e-2, -1e-2, -2e-5]),
      _stats_run([1, 1, 1, 1], [-1e-2, -1e-2, -3e-5])), (2, True)),
])
def test_graph_parted(runs, want):
    """chip_smoke's _graph_parted, the rule the card tests and phase 5f
    hold the graph kernel and the host loop to: where two LM runs' accept
    decisions part, and whether both runs' trials there lie within the
    final chi2's tolerance (1e-4 relative) of the current chi2."""
    from chip_smoke import _graph_parted

    assert _graph_parted(*runs) == want

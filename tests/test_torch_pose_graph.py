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


@pytest.mark.parametrize("solver, M, device, kernel", [
    ("dense", 16, "cuda", True),
    ("dense", 32, "cuda", True),
    ("dense", 1, torch.device("cuda", 1), True),
    ("dense", 64, "cuda", True),
    ("dense", 128, "cuda", True),
    ("dense", 129, "cuda", False),
    ("dense", 256, "cuda", False),
    ("dense", 2560, "cuda", False),
    ("cg", 16, "cuda", False),
    ("cg", 4096, "cuda", False),
    ("dense", 16, "cpu", False),
    ("cg", 16, "cpu", False),
])
def test_graph_route(solver, M, device, kernel):
    """A dense solve of at most KERNEL_MAX_VERTICES vertices on a CUDA
    device is one kernel launch; the CPU, CG and larger dense graphs take
    the plain host loop. Decided by device, solver and size alone."""
    assert t_pose_graph.graph_route(solver, M, device) is kernel


def test_kernel_plan_sizes_shared_memory():
    """One CTA of 512 threads up to 32 vertices, then clusters of 2 to 16
    CTAs up to 128: a CTA holds at most 192 columns of the damped system
    (6M rows of w + 1 floats), the right-hand side, two pose copies and,
    in a cluster, the pivot column and y, within an H100 CTA's 232 448
    bytes."""
    def shared(M, C):
        n = 6 * M
        w = -(-n // C)
        return 4 * (n * (w + 1) + n + 32 * M + (2 * n if C > 1 else 0))

    assert t_pose_graph.kernel_plan(32) == (128, 1, 512, 153_088)
    assert t_pose_graph.kernel_plan(16) == (128, 1, 512,
                                            4 * (96 * 97 + 96 + 512))
    assert t_pose_graph.kernel_plan(64) == (128, 4, 512, shared(64, 4))
    assert t_pose_graph.kernel_plan(128) == (128, 16, 512, 176_128)
    for M in range(1, 129):
        limit, C, threads, nbytes = t_pose_graph.kernel_plan(M)
        assert C in (1, 2, 4, 8, 16) and nbytes == shared(M, C)
        assert -(-6 * M // C) <= 192 and nbytes <= 232_448 - 2_048
        assert C == 1 or -(-6 * M // (C // 2)) > 192 or \
            shared(M, C // 2) > 230_400
    for M in (0, 129, 256):
        assert t_pose_graph.kernel_plan(M)[1:] == (0, 512, 0)


def test_optimize_kernel_refuses_cpu_and_large_graphs():
    """The kernel route has no plain fallback: it refuses what it does not
    take instead of running the host loop."""
    g, _ = _chain_graph(n=6)
    with pytest.raises(ValueError):
        t_pose_graph.optimize_kernel(g, device="cpu")
    big = t_pose_graph.grow(g, max_vertices=256)
    with pytest.raises(ValueError):
        t_pose_graph.optimize_kernel(big, device="cuda")


@pytest.mark.parametrize("padded", [False, True])
def test_kernel_plans_sum_in_the_plain_order(padded):
    """The kernel's CSR lists hold, slot by slot, the contributions the
    plain loop's gather plans sum, in the same order; the packed upload
    keeps every array (integers bitwise)."""
    g, _ = _chain_graph(n=8, drift=0.03, max_v=32 if padded else 16,
                        max_e=64 if padded else 32)
    e = int(g.num_edges)
    g.edge_i[e], g.edge_j[e] = 5, 2  # an edge against the chain's order
    g.edge_mask[e] = True
    topo = t_pose_graph._topology(g, "cpu")
    targets = t_pose_graph._plan_targets(g)
    M = g.poses.shape[0]
    for plan, tgt, size in ((topo.vertex, targets[0], M),
                            (topo.dense, targets[1], M * M)):
        off, idx = t_pose_graph._csr(tgt, size)
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

"""The pixel route's split mode (ops/linearize.py::track_level_split,
csrc/linearize.cu's split_stage_kernel) on the CPU: what can be checked
without a card.

- The stage plan against the JAX package: one stage, and one all-reduce,
  for each psum the JAX pixel-sharded linearization must wait on before
  the next (the longest chain of psums through its jaxpr, traced with a
  "pixel" axis; the Sigma fixed point's loop counted at its trip count,
  cold and warm).
- The launch arguments: the band's rows and first image row, the band's
  own compaction budget, the state, stage buffer, kept points and slot
  table, named by the C signature of dvo_track_level_split.
- The stage buffer's and state's layout constants in the .cu source
  against Python's.
- A 2-rank gloo world on the CPU: the sharded tracker on CPU tensors
  still runs the plain host loop (the split route is the card's), and the
  split route's host loop over a stand-in kernel launches stage plan x
  iterations + 1 stages, all-reduces after each but the last, ends a
  level where every row is done or at max_iterations, and raises on every
  rank, without hanging, where the ranks' done flags part; the graph
  issue (nccl's), its units captured by a recording stand-in for the CUDA
  graph, issues the same sequence.
- The graph issue's workspace key, the t-distribution launches' grid
  plan (split_ctas), the phase-timing reader, and the kernel's reading of
  its iteration (stage 0 of iteration 0 only, so one unit serves every
  iteration).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.core import Literal

from dvo_slam_tpu.config import TrackerConfig as JaxTrackerConfig
from dvo_slam_tpu.ops import camera as jcam
from dvo_slam_tpu.ops import linearize as jlin
from dvo_slam_tpu.ops import pyramid as jpyr
from dvo_slam_tpu.utils import se3_np, synthetic
from dvo_slam_tpu_torch import TrackerConfig, _build
from dvo_slam_tpu_torch import parallel as t_parallel
from dvo_slam_tpu_torch.ops import linearize as t_lin
from dvo_slam_tpu_torch.ops import pyramid as t_pyr

import torch_sharded_cases as cases

PLAN_CONFIGS = {
    "tdist": {},
    "tdist_warm": {"tdist_scale_warm_iters": 2},
    "tdist_3_steps": {"tdist_scale_iters": 3},
    "normal_tukey": {"scale_estimator": "normal", "influence": "tukey"},
    "mad_huber": {"scale_estimator": "mad", "influence": "huber"},
    "unit_t": {"scale_estimator": "unit", "influence": "tdist"},
    "unweighted": {"use_weighting": False},
    "mu": {"mu": 0.1},
    "budget": {"point_budget_fraction": 0.5},
}


def _psum_depth(jaxpr, depths, trips):
    """The longest chain of psums from jaxpr's inputs (at ``depths``) to
    each of its outputs: a psum adds one to its input's, a scan runs its
    body ``length`` times, a while loop ``trips`` times (the Sigma fixed
    point's traced trip count), a call or a cond its sub-jaxpr(s)."""
    depth = dict(zip(jaxpr.invars, depths))

    def get(v):
        return 0 if isinstance(v, Literal) else depth.get(v, 0)

    for eqn in jaxpr.eqns:
        ins = [get(v) for v in eqn.invars]
        p, name = eqn.params, eqn.primitive.name
        if name == "psum":
            outs = [max(ins) + 1] * len(eqn.outvars)
        elif name == "scan":
            nc, nk = p["num_consts"], p["num_carry"]
            carry, ys = ins[nc:nc + nk], []
            for _ in range(p["length"]):
                o = _psum_depth(p["jaxpr"].jaxpr, ins[:nc] + carry
                                + ins[nc + nk:], trips)
                carry = [max(a, b) for a, b in zip(carry, o[:nk])]
                ys = o[nk:]
            outs = carry + ys
        elif name == "while":
            cn, bn = p["cond_nconsts"], p["body_nconsts"]
            carry = ins[cn + bn:]
            for _ in range(trips):
                o = _psum_depth(p["body_jaxpr"].jaxpr,
                                ins[cn:cn + bn] + carry, trips)
                carry = [max(a, b) for a, b in zip(carry, o)]
            outs = carry
        elif name == "cond":
            outs = [max(x) for x in zip(*(
                _psum_depth(br.jaxpr, ins[1:], trips)
                for br in p["branches"]))]
        elif "jaxpr" in p or "call_jaxpr" in p:
            sub = p.get("jaxpr", p.get("call_jaxpr"))
            outs = _psum_depth(getattr(sub, "jaxpr", sub), ins, trips)
        else:
            outs = [max(ins, default=0)] * len(eqn.outvars)
        depth.update(zip(eqn.outvars, outs))
    return [get(v) for v in jaxpr.outvars]


def _jax_psum_chain(fields, trips):
    """The longest psum chain of the JAX package's linearization with a
    "pixel" axis under the config ``fields``, a warm-started iteration's
    (its Sigma loop ``trips`` long)."""
    cfg = JaxTrackerConfig(**fields)
    rng = np.random.default_rng(0)
    i = jnp.asarray(rng.uniform(0.0, 1.0, (12, 16)), jnp.float32)
    z = jnp.asarray(rng.uniform(1.0, 2.0, (12, 16)), jnp.float32)
    slab = jpyr.build_pyramid(i, z, 1)[0]
    K = jcam.intrinsics(10.0, 10.0, 7.5, 5.5)
    ref = jlin.prepare_reference(slab, K, cfg)

    def one(T, sigma, warm):
        return jlin.linearize(ref, slab, K, T, cfg, axis_name="pixel",
                              sigma_init=sigma, sigma_warm=warm)

    closed = jax.make_jaxpr(one, axis_env=[("pixel", 2)])(
        jnp.eye(4), jnp.eye(2), jnp.asarray(True))
    return max(_psum_depth(closed.jaxpr, [0, 0, 0], trips))


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_stage_plan_is_the_jax_psum_chain(name):
    """One stage a link of the JAX package's chain of psums, cold (the
    Sigma loop at tdist_scale_iters) and warm (at tdist_scale_warm_iters
    where it is set): 2 + the steps on the t-distribution (7 at the
    defaults), 1 for every other estimator and without weighting; a point
    budget and the motion prior change nothing."""
    fields = PLAN_CONFIGS[name]
    cfg = TrackerConfig(**fields)
    plan = t_lin.stage_plan(cfg)
    warm = cfg.tdist_scale_warm_iters or cfg.tdist_scale_iters
    assert plan.cold == _jax_psum_chain(fields, cfg.tdist_scale_iters)
    assert plan.warm == _jax_psum_chain(fields, warm)
    tdist = cfg.use_weighting and cfg.scale_estimator == "tdist"
    assert plan == ((2 + cfg.tdist_scale_iters, 2 + warm) if tdist
                    else (1, 1))


def test_stage_plan_counts_no_more_than_the_plain_route():
    """The plain pixel route all-reduces once a _sums call: the valid
    count, the moments, each Sigma step, the log1p and error sums, A and
    b (4 + the steps a row and iteration); the split route one
    collective a stage for all rows."""
    cfg = TrackerConfig()
    assert t_lin.stage_plan(cfg).cold == 2 + cfg.tdist_scale_iters
    assert t_lin.stage_plan(cfg).cold < 4 + cfg.tdist_scale_iters


def _c_params(name):
    """The parameter names of the extern "C" function ``name`` in csrc/."""
    text = "".join(p.read_text() for p in _build._sources())
    m = re.search(rf'extern "C" \w+ {name}\(([^)]*)\)', text)
    assert m, name
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


def _band_inputs(B, H, W, paired):
    rng = np.random.default_rng(1)
    slabs = [t_pyr.build_pyramid(
        torch.as_tensor(rng.uniform(0.0, 1.0, (H, W)), dtype=torch.float32),
        torch.as_tensor(rng.uniform(1.0, 2.0, (H, W)), dtype=torch.float32),
        1)[0] for _ in range(B + 1)]
    ref = torch.stack(slabs[:B])
    cur = torch.stack(slabs[1:]) if paired else slabs[B]
    K = torch.tensor([20.0, 20.0, (W - 1) / 2, (H - 1) / 2])
    T = torch.eye(4).expand(B, 4, 4).contiguous()
    return ref, cur, K, T


@pytest.mark.parametrize("frac", [0.0, 0.5])
@pytest.mark.parametrize("paired", [False, True])
def test_split_args_pack_the_band(frac, paired):
    """The band's rows (ref_H) and first image row (row0), its own budget
    (N, and the budget compact_reference gives prepare_reference of the
    band), the whole current slabs (H, and their stride), the state, the
    stage buffer, the kept points and the slot table, by the C
    signature's names; the
    stage, steps, iteration and stream follow."""
    B, H, W, ranks = 3, 24, 40, 2
    ref, cur, K, T = _band_inputs(B, H, W, paired)
    cfg = TrackerConfig(point_budget_fraction=frac)
    h = H // ranks
    band = ref[:, :, h:].contiguous()
    a = t_lin.split_args(t_lin.RefSlabs(band), cur, K, T, cfg, h)
    names = _c_params("dvo_track_level_split")
    assert len(a.args) + 4 == len(names) == len(
        _build._entry_points()["dvo_track_level_split"][0])
    assert names[-4:] == ["stage", "steps", "iter", "stream"]
    got = dict(zip(names, a.args))
    budget = t_lin.ref_budget(cfg, h, W)
    assert got["ref_H"] == h and got["row0"] == h
    assert got["H"] == H and got["W"] == W and got["B"] == B
    assert got["budget"] == budget
    assert budget == (t_lin.compact_budget(h * W, frac, 128) if frac else 0)
    assert got["N"] == (budget or h * W)
    assert got["slab_stride"] == (6 * H * W if paired else 0)
    assert got["ref_table"] == t_lin._TABLE_STRIDE
    assert got["ref_stride"] == 6 * h * W
    assert got["C"] == t_lin.cluster_size(got["N"])
    assert a.state.shape == (B, t_lin._SPLIT_STATE_WORDS)
    assert a.state.dtype == torch.float32
    assert a.sums.shape == (B, t_lin._SPLIT_SUMS)
    assert a.sums.dtype == torch.float64
    assert got["state"] == a.state.data_ptr()
    assert got["sums"] == a.sums.data_ptr()
    # The kept points: a row's N points of 37 bytes in planes, rounded up
    # to 16 bytes, then 256 CTAs' partial sums of 32 doubles; the
    # t-distribution's CTAs a row (1 SM off the card).
    assert got["points"] == a.points.data_ptr()
    assert a.points.dtype == torch.uint8
    assert a.points.numel() == B * (-(-37 * got["N"] // 16) * 16
                                    + 256 * 32 * 8)
    assert got["ctas"] == t_lin.split_ctas(got["N"], B, 1) == 1
    assert got["timing"] is None
    # The ticket of each row's CTAs starts at 0.
    assert not a.state.any()
    if frac:
        assert a.slots.shape == (B, budget) and a.slots.dtype == torch.int32
        assert got["slots"] == a.slots.data_ptr()
    else:
        assert a.slots is None and got["slots"] is None
    M = cfg.max_iterations
    assert a.out.shape == (B, t_lin.level_row_size(M))
    assert a.out_i.shape == (B, 2) and a.out_i.dtype == torch.int32
    # prepare_reference of the band at its row offset compacts to the same
    # slot count.
    pts = t_lin.prepare_reference(band, K, cfg, row_offset=h)
    assert pts.px.shape == (B, got["N"])


def test_split_args_refuse_what_the_kernel_does_not_take():
    ref, cur, K, T = _band_inputs(2, 24, 40, False)
    cfg = TrackerConfig()
    band = ref[:, :, :12].contiguous()
    pts = t_lin.prepare_reference(band, K, cfg)
    with pytest.raises(ValueError, match="RefSlabs"):
        t_lin.split_args(pts, cur, K, T, cfg, 0)
    with pytest.raises(ValueError, match="row >= 0"):
        t_lin.split_args(t_lin.RefSlabs(band), cur, K, T, cfg, -1)
    with pytest.raises(ValueError, match="reference slabs"):
        t_lin.split_args(t_lin.RefSlabs(ref[:, :, :12, :20].contiguous()),
                         cur, K, T, cfg, 0)
    with pytest.raises(ValueError, match="mu >= 0"):
        t_lin.split_args(t_lin.RefSlabs(band), cur, K, T,
                         TrackerConfig(mu=-1.0), 0)


def test_split_source_constants_match_python():
    """The stage buffer's columns, its width, the state's floats a row, the
    finish stage's code and a kept point's floats in csrc/linearize.cu are
    the wrapper's."""
    text = (_build.CSRC / "linearize.cu").read_text()
    want = {"kSumValid": t_lin._SUM_VALID,
            "kSumSelected": t_lin._SUM_SELECTED,
            "kSumDone": t_lin._SUM_DONE, "kSumSteps": t_lin._SUM_STEPS,
            "kSplitSums": t_lin._SPLIT_SUMS,
            "kSplitStateWords": t_lin._SPLIT_STATE_WORDS,
            "kSplitTicketWord": t_lin._SPLIT_TICKET_WORD,
            "kStageFinish": t_lin._STAGE_FINISH,
            "kNormalSums": 29, "kPointFloats": (t_lin._POINT_BYTES - 1) // 4,
            "kSplitThreads": t_lin._SPLIT_THREADS,
            "kMaxSplitCtas": t_lin._MAX_SPLIT_CTAS,
            "kPartialStride": t_lin._PARTIAL_STRIDE,
            "kSplitTimingSlots": t_lin._SPLIT_TIMING_SLOTS}
    for name, value in want.items():
        m = re.search(rf"\b{name} = (\d+)", text)
        assert m and int(m.group(1)) == value, name
    # The state's fields: 3 poses, the record, 7 floats, 6 ints and the
    # ticket.
    assert 3 * 16 + 50 + 7 + 6 + 1 <= t_lin._SPLIT_STATE_WORDS


def test_split_verdict():
    """All rows done on every rank ends the level; none, or some rows on
    every rank, goes on with the live rows' largest Sigma steps; a row
    done on some ranks only raises."""
    flags = torch.tensor([[2.0, 0.0], [2.0, 0.0]], dtype=torch.float64)
    assert t_lin.split_verdict(flags, 2) == (True, 0)
    flags = torch.tensor([[0.0, 10.0], [2.0, 0.0], [0.0, 4.0]],
                         dtype=torch.float64)
    assert t_lin.split_verdict(flags, 2) == (False, 5)
    with pytest.raises(RuntimeError, match="parted"):
        t_lin.split_verdict(torch.tensor([[1.0, 5.0]]), 2)
    with pytest.raises(RuntimeError, match="parted"):
        t_lin.split_verdict(torch.tensor([[0.0, 5.0], [3.0, 0.0]]), 4)


W_, H_ = 32, 16
SCENARIOS = (
    ({"max_iterations": 6}, (3, 3), 5),  # every row done after 3
    ({"max_iterations": 6}, (1, 1), 5),  # every row done after 1
    ({"max_iterations": 4}, (9, 9), 5),  # max_iterations, then the finish
    ({"max_iterations": 6, "scale_estimator": "mad",
      "influence": "huber"}, (2, 2), 0),
    ({"max_iterations": 6, "tdist_scale_warm_iters": 2}, (4, 4), 2),
    ({"max_iterations": 6, "scale_estimator": "normal",
      "influence": "tukey"}, (2, 3), 0),  # the ranks part
)


@pytest.fixture(scope="module")
def cpu_world():
    scene = synthetic.two_plane_scene()
    K = (W_ * 0.8, W_ * 0.8, (W_ - 1) / 2, (H_ - 1) / 2)
    xi = np.array([0.01, -0.005, 0.008, 0.004, -0.003, 0.005])
    i0, z0 = scene.render(np.asarray(K), W_, H_, np.eye(4))
    cur = [scene.render(np.asarray(K), W_, H_,
                        se3_np.inverse(se3_np.exp(xi * s)))
           for s in (1.0, -0.6)]
    cfg = TrackerConfig(num_levels=2, first_level=1, last_level=0,
                        max_iterations=8)
    inp = {"K": K, "cfg": dataclasses.asdict(cfg),
           "ref_i": np.stack([i0] * 2), "ref_z": np.stack([z0] * 2),
           "cur_i": np.stack([c[0] for c in cur]),
           "cur_z": np.stack([c[1] for c in cur]), "scenarios": SCENARIOS}
    ranks = t_parallel.spawn(cases.run_cpu_pixel_route, 2, "cpu", (inp,),
                             timeout_s=240)
    return inp, ranks


def test_cpu_pixel_group_runs_the_plain_host_loop(cpu_world):
    """On CPU tensors a pixel group of two ranks takes the eager front's
    host loop over the all-reduced plain linearization (no split launch):
    the split route is the card's alone. Both ranks return the same bits,
    within 5e-5 of the single-process tracker (tests/test_sharded.py's
    tolerance)."""
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import camera

    inp, ranks = cpu_world
    for r in ranks:
        assert r["routes"] == (True, False, True)
        assert r["grouped"] > 0 and r["split_launches"] == 0
        for a, b in zip(jax.tree.leaves(r["pairs"]),
                        jax.tree.leaves(ranks[0]["pairs"])):
            np.testing.assert_array_equal(a, b)
    cfg = TrackerConfig(**inp["cfg"])
    L = cfg.num_levels
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*inp["K"],
                                                     device="cpu"), L)
    refs = cases._pyramids(inp["ref_i"], inp["ref_z"], L, "cpu")
    curs = cases._pyramids(inp["cur_i"], inp["cur_z"], L, "cpu")
    one = dense_tracker.track_batched(refs, curs, Ks,
                                      torch.eye(4).expand(2, 4, 4), cfg)
    np.testing.assert_allclose(ranks[0]["pairs"].transformation,
                               one.transformation.numpy(), atol=5e-5)


@pytest.mark.parametrize("s", range(len(SCENARIOS)))
def test_split_host_loop_launches_and_stops(cpu_world, s):
    """The split route's host loop over a stand-in kernel: iteration k
    launches stage 0 then, on the t-distribution, the Sigma steps and the
    normal equations (stage_plan's count), every launch followed by one
    all-reduce but the finish; the level ends at the first stage 0 whose
    all-reduced done flags say every row is done (launches: iterations x
    stages + 1), or after max_iterations with the finish stage; the warm
    iterations take the steps stage 0 reports. Where the ranks' done flags
    part, every rank raises at the same launch."""
    fields, stops, steps = SCENARIOS[s]
    cfg = TrackerConfig(**fields)
    M = cfg.max_iterations
    got = [r["scenarios"][s] for r in cpu_world[1]]
    assert got[0]["launches"] == got[1]["launches"]
    assert got[0]["collectives"] == got[1]["collectives"]
    tdist = cfg.use_weighting and cfg.scale_estimator == "tdist"
    if stops[0] != stops[1]:
        assert all("parted" in g["error"] for g in got)
        assert got[0]["launches"][-1] == (0, 0, min(stops))
        return
    assert got[0]["error"] is None
    want, n_steps = [], cfg.tdist_scale_iters if tdist else 0
    for k in range(M):
        want.append((0, n_steps, k))
        if 0 < k and stops[0] <= k:
            break
        if k > 0 and tdist:
            n_steps = steps
        if tdist:
            want += [(j, n_steps, k) for j in range(1, n_steps + 2)]
    else:
        want.append((t_lin._STAGE_FINISH, n_steps, M))
    assert got[0]["launches"] == want
    n_it = min(stops[0], M)
    plan = t_lin.stage_plan(cfg)
    stages = plan.cold + (n_it - 1) * plan.warm
    assert len(want) == stages + 1
    assert got[0]["collectives"] == stages + (n_it < M)


def _events(r):
    """A scenario run's issue as (stage, steps) launches and all-reduces."""
    return [e if e[0] == "all_reduce" else e[:3] for e in r["events"]]


@pytest.mark.parametrize("s", range(len(SCENARIOS)))
def test_split_graph_issue_sequence(cpu_world, s):
    """The graph issue's loop (nccl's: the level's first stage eager, a
    captured unit replayed an iteration, the last iteration's stages and
    the finish eager), its units captured by a recording stand-in for the
    CUDA graph, issues the eager issue's sequence of stages, Sigma steps
    and all-reduces, with the same all-reduce count, and the same error on
    every rank where the ranks part; it captures one unit a Sigma step
    count (cold, and warm where tdist_scale_warm_iters differs) and
    replays one an iteration but the first and the last."""
    fields, stops, steps = SCENARIOS[s]
    cfg = TrackerConfig(**fields)
    for r in cpu_world[1]:
        eager, graph = r["scenarios"][s], r["graph_scenarios"][s]
        assert _events(graph) == _events(eager)
        assert [x[:2] for x in graph["launches"]] == [
            x[:2] for x in eager["launches"]]
        assert graph["collectives"] == eager["collectives"]
        assert (graph["error"] is None) == (eager["error"] is None)
        if eager["error"] is not None:
            assert "parted" in graph["error"]
        assert eager["captures"] == eager["replays"] == 0
        units = [x for x in eager["launches"] if x[0] == 0 and x[2] > 0]
        assert graph["replays"] == len(units)
        tdist = cfg.use_weighting and cfg.scale_estimator == "tdist"
        warm = cfg.tdist_scale_warm_iters or cfg.tdist_scale_iters
        want = 1 if not tdist or len(units) < 2 else len(
            {cfg.tdist_scale_iters, warm})
        assert graph["captures"] == min(want, len(units))


class _Group:
    """A stand-in process group: a workspace key only."""


def test_split_workspace_key(monkeypatch):
    """The split route's workspace: the same shapes, rows and config under
    one group give the same one (its graphs serve the call); a new level
    shape, batch, band, stage plan or group a new one, with its own
    buffers. It is kept with its group (parallel.group_state) until the
    group is destroyed (parallel.destroy), and each fill zeroes its
    rows' carry (the CTA tickets)."""
    from dvo_slam_tpu_torch import parallel

    ref, cur, K, T = _band_inputs(2, 24, 40, False)
    cfg, g, g2 = TrackerConfig(), _Group(), _Group()
    band = t_lin.RefSlabs(ref[:, :, :12].contiguous())
    destroyed = []
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda group=None: destroyed.append(group))
    monkeypatch.setattr(parallel, "_GROUP_STATE", {})
    ws = t_lin.split_workspace(band, cur, T, cfg, g, 12)
    assert t_lin.split_workspace(band, cur, T, cfg, g, 12) is ws
    # The same key from other tensors of the same shapes.
    again = t_lin.RefSlabs(ref[:, :, 12:].contiguous())
    assert t_lin.split_workspace(again, cur.clone(), T.clone(), cfg, g,
                                 12) is ws
    ref3, cur3, _, T3 = _band_inputs(3, 24, 40, False)
    ref_w, cur_w, _, _ = _band_inputs(2, 24, 48, False)
    others = [
        t_lin.split_workspace(band, cur3, T3, cfg, g, 12),  # B
        t_lin.split_workspace(t_lin.RefSlabs(ref_w[:, :, :12]
                                             .contiguous()),
                              cur_w, T, cfg, g, 12),  # shape
        t_lin.split_workspace(t_lin.RefSlabs(ref[:, :, :8]
                                             .contiguous()),
                              cur, T, cfg, g, 8),  # band
        t_lin.split_workspace(band, cur, T, TrackerConfig(
            tdist_scale_warm_iters=2), g, 12),  # stage plan
        t_lin.split_workspace(band, cur, T, TrackerConfig(
            scale_estimator="mad", influence="huber"), g, 12),
        t_lin.split_workspace(band, cur, T, cfg, g2, 12),  # group
    ]
    for o in others:
        assert o is not ws and o.a.sums.data_ptr() != ws.a.sums.data_ptr()
    assert len(parallel.group_state(g)) == len(others)
    assert list(parallel.group_state(g2).values()) == [others[-1]]
    # Its launches read the workspace's buffers: the reference rows by
    # its device table, the copies of the current slab, K and T.
    got = dict(zip(_c_params("dvo_track_level_split"), ws.a.args))
    assert got["ref_table"] == t_lin._TABLE_DEVICE
    assert got["ref_rows"] == ws.table.data_ptr()
    assert got["slab"] == ws.cur.data_ptr()
    assert got["K"] == ws.K.data_ptr()
    assert got["T_init"] == ws.T.data_ptr()
    ws.a.state[:, t_lin._SPLIT_TICKET_WORD] = 1.0
    ws.fill(again, cur, K, T)
    assert ws.table.tolist() == [again.rows[b].data_ptr()
                                 for b in range(2)]
    assert torch.equal(ws.cur, cur) and torch.equal(ws.K, K)
    assert torch.equal(ws.T, T)
    assert not ws.a.state.any()
    # Dropped (with their graphs) as their group is destroyed, before it.
    parallel.destroy(g)
    assert destroyed == [g] and g not in parallel._GROUP_STATE
    assert t_lin.split_workspace(band, cur, T, cfg, g, 12) is not ws
    assert t_lin.split_workspace(band, cur, T, cfg, g2, 12) is others[-1]
    parallel.destroy()
    assert destroyed == [g, None] and not parallel._GROUP_STATE


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_split_grid_plan_covers_each_point_once(level, frac):
    """The t-distribution launches' plain CTAs over a band of 640x480's
    level (half its rows, or its budget slots): every point in exactly one
    CTA, no CTA empty, at most 256 a row, one thread a point where the
    card holds the batch in one wave of two CTAs an SM, and no more than
    one wave's CTAs otherwise (H100: 132 SMs; and a card a tenth of it)."""
    W, H = 640 >> level, 480 >> level
    h = H // 2
    cfg = TrackerConfig(point_budget_fraction=frac)
    N = t_lin.ref_budget(cfg, h, W) or h * W
    for sms in (132, 13):
        for B in (1, 2, 8, 16, 32):
            ctas = t_lin.split_ctas(N, B, sms)
            P = -(-N // ctas)
            owner = np.full(N, -1)
            for r in range(ctas):
                lo, hi = r * P, min((r + 1) * P, N)
                assert lo < hi, (N, B, ctas)
                assert (owner[lo:hi] == -1).all()
                owner[lo:hi] = r
            assert (owner >= 0).all()
            assert 1 <= ctas <= t_lin._MAX_SPLIT_CTAS
            if B * -(-N // t_lin._SPLIT_THREADS) <= 2 * sms:
                assert P <= t_lin._SPLIT_THREADS
            assert B * ctas <= max(B, 2 * sms)


def test_split_phase_times_reads_the_stamps():
    """The phase-timing reader: clock64 spans in order (carry, decision,
    pass, reduction, barrier, write-out), converted by the CTA's
    %globaltimer span over its clock64 span (here 2 ns a clock)."""
    t = np.zeros(t_lin._SPLIT_TIMING_SLOTS, np.int64)
    t[0], t[1] = 1_000_000, 1_000_000 + 2 * 6_000
    t[2:] = 50_000 + np.cumsum([0, 500, 1_000, 1_500, 2_000, 250, 750])
    phases, span = t_lin.split_phase_times(t)
    assert list(phases) == list(t_lin._SPLIT_PHASES)
    np.testing.assert_allclose(list(phases.values()),
                               [1.0, 2.0, 3.0, 4.0, 0.5, 1.5])
    assert span == 12.0


def test_split_kernel_reads_its_iteration_only_at_the_first_stage():
    """dvo_track_level_split's iter reaches the kernel as split_iter, read
    only for the level's first launch (stage 0 of iteration 0): a unit
    captured at iteration k replays right at any other."""
    text = (_build.CSRC / "linearize.cu").read_text()
    uses = re.findall(r".*\bsplit_iter\b.*", text)
    reads = [u for u in uses
             if re.search(r"\bp\.split_iter\b(?!\s*=[^=])", u)]
    assert reads and all(
        re.search(r"const bool first = stage == 0 && p\.split_iter == 0;", u)
        for u in reads), reads

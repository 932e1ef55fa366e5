"""The rank side of tests/test_torch_sharded.py: what each rank of the
spawned world runs (the port only; this module imports no JAX, so the
ranks start without it).

``run`` builds the three meshes of a 4-rank world, (2, 2), (4, 1) and
(1, 4), in the same order on every rank, runs every case on each and
returns numpy results keyed by (case, mesh shape), each gathered to the
whole batch, so the test compares them with single-process runs and with
the JAX package.
"""

import numpy as np
import torch

MESHES = ((2, 2), (4, 1), (1, 4))


def _pyramids(intensities, depths, levels, device):
    from dvo_slam_tpu_torch.ops import pyramid

    pyrs = [pyramid.build_pyramid(torch.from_numpy(i).to(device),
                                  torch.from_numpy(z).to(device), levels)
            for i, z in zip(intensities, depths)]
    return tuple(torch.stack(lvl) for lvl in zip(*pyrs))


def _np(tree):
    """A TrackResult, tensor, or dict of them, as numpy."""
    from dvo_slam_tpu_torch import convert

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return convert.to_numpy(tree)
    return convert.result_to_numpy(tree)


def run(rank, world_size, device, inp):
    """Every case on every mesh; ``inp`` as test_torch_sharded._inputs."""
    from dvo_slam_tpu_torch import TrackerConfig, SlamConfig
    from dvo_slam_tpu_torch.ops import camera
    from dvo_slam_tpu_torch.ops import linearize as lin_ops
    from dvo_slam_tpu_torch.parallel import batch_slam, sharded

    calls = {"grouped": 0}
    plain = lin_ops.linearize_batched_reference

    def counted(*args, **kw):
        calls["grouped"] += kw.get("group") is not None
        return plain(*args, **kw)

    lin_ops.linearize_batched_reference = counted

    cfg = TrackerConfig(**inp["cfg"])
    budget_cfg = TrackerConfig(**{**inp["cfg"], "point_budget_fraction": 0.5})
    L = cfg.num_levels
    K = camera.intrinsics(*inp["K"], device=device)
    Ks = camera.pyramid_intrinsics(K, L)
    refs = _pyramids(inp["ref_i"], inp["ref_z"], L, device)
    curs = _pyramids(inp["cur_i"], inp["cur_z"], L, device)
    B = refs[0].shape[0]
    T0 = torch.eye(4, device=device).expand(B, 4, 4).contiguous()
    g = inp["graph"]
    seq = {k: torch.from_numpy(v).to(device) for k, v in inp["seqs"].items()}
    seq_K = camera.intrinsics(*inp["seq_K"], device=device)
    seq_cfg = TrackerConfig(**inp["seq_cfg"])
    slam_cfg = SlamConfig(**inp["slam_cfg"])

    out = {}
    for shape in MESHES:
        mesh = sharded.make_mesh(world_size, *shape)
        out[("coordinate", shape)] = tuple(mesh.get_coordinate())
        pixel = mesh.get_group("pixel")
        out[("pixel_route", shape)] = lin_ops.pixel_route(pixel)

        for name, c in (("pairs", cfg), ("pairs_budget", budget_cfg)):
            if name == "pairs_budget" and shape != (2, 2):
                continue
            before = calls["grouped"]
            res = sharded.sharded_track_pairs(mesh, c)(
                sharded.shard_pyramid(refs, mesh),
                sharded.shard_pyramid(curs, mesh, pixel=False), Ks,
                sharded.shard_rows(T0, mesh).contiguous())
            out[(name, shape)] = _np(sharded.gather_rows(res, mesh))
            out[(name + "_grouped_calls", shape)] = calls["grouped"] - before

        cand = tuple(lvl[:inp["fleet_B"]] for lvl in refs)
        new = tuple(lvl[0] for lvl in curs)
        fwd, bwd = sharded.sharded_validation_fleet(mesh, cfg)(
            cand, new, Ks, torch.from_numpy(inp["fleet_T"]).to(device))
        out[("fleet", shape)] = (_np(fwd), _np(bwd))

        build = sharded.sharded_pose_graph_build(mesh)
        H, gv = build(*(sharded.shard_rows(
            torch.from_numpy(g[k]).to(device), mesh) if k != "poses"
            else torch.from_numpy(g[k]).to(device)
            for k in ("poses", "ei", "ej", "Z", "info", "mask")))
        out[("graph", shape)] = (H.cpu().numpy(), gv.cpu().numpy())

        out[("sequences", shape)] = _np(batch_slam.track_sequences_sharded(
            mesh, seq["i"], seq["z"], seq_K, seq_cfg))
        out[("keyframes", shape)] = _np(
            batch_slam.keyframe_sequences_sharded(
                mesh, seq["i"], seq["z"], seq_K, seq_cfg, slam_cfg,
                force_keyframe=seq["force"]))
    return out


def single(inp, device="cpu"):
    """The same cases in one process, without a mesh: the batched tracker,
    the batched validation rows, the graph's own assembly, and the
    sequence fleets' batched forms."""
    from dvo_slam_tpu_torch import TrackerConfig, SlamConfig
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models import pose_graph as pg
    from dvo_slam_tpu_torch.ops import camera, se3
    from dvo_slam_tpu_torch.parallel import batch_slam

    cfg = TrackerConfig(**inp["cfg"])
    budget_cfg = TrackerConfig(**{**inp["cfg"], "point_budget_fraction": 0.5})
    L = cfg.num_levels
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*inp["K"],
                                                     device=device), L)
    refs = _pyramids(inp["ref_i"], inp["ref_z"], L, device)
    curs = _pyramids(inp["cur_i"], inp["cur_z"], L, device)
    B = refs[0].shape[0]
    T0 = torch.eye(4, device=device).expand(B, 4, 4).contiguous()
    out = {"pairs": _np(dense_tracker.track_batched(refs, curs, Ks, T0, cfg)),
           "pairs_budget": _np(dense_tracker.track_batched(
               refs, curs, Ks, T0, budget_cfg))}
    nB = inp["fleet_B"]
    cand = tuple(lvl[:nB] for lvl in refs)
    news = tuple(lvl[:1].expand(nB, *lvl.shape[1:]).contiguous()
                 for lvl in curs)
    Tf = torch.from_numpy(inp["fleet_T"]).to(device)
    out["fleet"] = (
        _np(dense_tracker.track_batched(cand, news, Ks, Tf, cfg)),
        _np(dense_tracker.track_batched(news, cand, Ks,
                                        se3.inverse(Tf).contiguous(), cfg)))
    g = inp["graph"]
    M, E = g["poses"].shape[0], g["ei"].shape[0]
    graph = pg.PoseGraph(
        poses=g["poses"], num_vertices=np.asarray(M, np.int32),
        edge_i=g["ei"], edge_j=g["ej"], measurements=g["Z"],
        information=g["info"], edge_mask=g["mask"],
        num_edges=np.asarray(E, np.int32))
    dev_graph = pg.to_device(graph, device)
    H, gv, _, _ = pg._build_system(dev_graph, pg._topology(graph, device),
                                   False, 1.0)
    out["graph"] = (H.cpu().numpy(), gv.cpu().numpy())
    seq = {k: torch.from_numpy(v).to(device) for k, v in inp["seqs"].items()}
    seq_K = camera.intrinsics(*inp["seq_K"], device=device)
    seq_cfg = TrackerConfig(**inp["seq_cfg"])
    out["sequences"] = _np(batch_slam.track_sequences_batched(
        seq["i"], seq["z"], seq_K, seq_cfg))
    out["keyframes"] = _np(batch_slam.keyframe_sequences_batched(
        seq["i"], seq["z"], seq_K, seq_cfg, SlamConfig(**inp["slam_cfg"]),
        force_keyframe=seq["force"]))
    return out


def card_pairs(inp, device):
    """The card test's pairs: frame b against b + 1 of ``inp["frames"]``,
    pyramids on `device` with the default TrackerConfig's levels."""
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import camera

    L = TrackerConfig().num_levels
    frames = inp["frames"]
    B = len(frames) - 1
    refs = _pyramids([f[0] for f in frames[:B]], [f[1] for f in frames[:B]],
                     L, device)
    curs = _pyramids([f[0] for f in frames[1:]], [f[1] for f in frames[1:]],
                     L, device)
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*inp["K"],
                                                     device=device), L)
    return refs, curs, Ks, torch.from_numpy(inp["T0"]).to(device)


def run_card_pixel(rank, world_size, device, inp):
    """One rank of the card test's world: the pairs of ``card_pairs`` with
    the reference rows split over all ranks (mesh (1, world_size)); the
    gathered poses and valid counts, and this rank's launch counts (the
    split route's stage launches and all-reduces, the standalone sampler's
    and the level kernel's launches, prepare_reference calls)."""
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import linearize, sampler
    from dvo_slam_tpu_torch.parallel import sharded

    refs, curs, Ks, T0 = card_pairs(inp, device)
    mesh = sharded.make_mesh(world_size, 1, world_size)

    def counts():
        return {"sample_slab": sampler.LAUNCHES,
                "track_level": linearize.LAUNCHES_TRACK_LEVEL,
                "split": linearize.LAUNCHES_TRACK_LEVEL_SPLIT,
                "collectives": linearize.COLLECTIVES_SPLIT,
                "prepare_reference": linearize.PREPARE_REFERENCE_CALLS}

    before = counts()
    res = sharded.sharded_track_pairs(mesh, TrackerConfig())(
        sharded.shard_pyramid(refs, mesh), curs, Ks, T0)
    after = counts()
    res = sharded.gather_rows(res, mesh)
    return {"T": res.transformation.cpu().numpy(),
            "valid": res.valid_pixels.cpu().numpy(),
            "iterations": res.iterations.cpu().numpy(),
            "launches": {k: after[k] - before[k] for k in after}}


SPLIT_CONFIGS = {
    "default": {},
    "budget": {"point_budget_fraction": 0.5},
    "mad_huber": {"scale_estimator": "mad", "influence": "huber"},
    "mu": {"mu": 0.1},
}
SPLIT_CASES = tuple((name, B, level) for name in SPLIT_CONFIGS
                    for B in (1, 2, 8) for level in (3, 2, 1))


def run_card_split(rank, world_size, device, inp):
    """One rank of the card test's split cases (SPLIT_CASES: a config,
    B pairs of ``card_pairs``, one pyramid level): the level tracked from
    ``inp["T0"]`` over this rank's band of the reference rows by the split
    route (``linearize.track_level_split``) and by the plain pixel route
    (the host loop over the plain linearization, every sum all-reduced
    over the world, prepare_reference of the band at its row offset).
    Per case: both routes' poses and valid counts, the split route's
    iterations, and its stage launches and all-reduces; or the error the
    split route raised where the ranks' decisions parted."""
    import functools

    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import linearize, sampler

    refs, curs, Ks, T0 = card_pairs(inp, device)
    group = dist.group.WORLD
    out = {}
    for name, B, level in SPLIT_CASES:
        cfg = TrackerConfig(**SPLIT_CONFIGS[name])
        h = refs[level].shape[-2] // world_size
        band = refs[level][:B, :, rank * h:(rank + 1) * h].contiguous()
        cur, K, T = curs[level][:B], Ks[level], T0[:B].contiguous()
        before = (linearize.LAUNCHES_TRACK_LEVEL_SPLIT,
                  linearize.COLLECTIVES_SPLIT)
        try:
            lvl = linearize.unpack_level(*linearize.track_level_split(
                linearize.RefSlabs(band), cur, K, T, cfg, group,
                row0=rank * h), cfg.max_iterations)
        except RuntimeError as e:
            # Ranks whose decisions part raise alike; the plain route
            # would call mismatched collectives there, so it is not run.
            out[(name, B, level)] = {"error": str(e)}
            continue
        counts = (linearize.LAUNCHES_TRACK_LEVEL_SPLIT - before[0],
                  linearize.COLLECTIVES_SPLIT - before[1])
        T_p, fin, _ = dense_tracker._track_level(
            linearize.prepare_reference(band, K, cfg, row_offset=rank * h),
            cur, K, T, cfg, linearize=functools.partial(
                linearize.linearize_batched_reference,
                sample=sampler.sample_slab, group=group))
        out[(name, B, level)] = {
            "error": None, "T": lvl.T.cpu().numpy(),
            "valid": lvl.best[:, dense_tracker._N_RAW].cpu().numpy(),
            "iterations": lvl.iterations.cpu().numpy(),
            "T_plain": T_p.cpu().numpy(),
            "valid_plain": fin.n_raw.cpu().numpy(),
            "launches": counts[0], "collectives": counts[1]}
    return out


def run_cpu_pixel_route(rank, world_size, device, inp):
    """One rank of tests/test_torch_pixel_split.py's CPU world: the pairs
    of ``inp`` through the sharded tracker (every rank a band of rows),
    with the routes the tracker picks, the plain linearization's grouped
    calls and the split launches; then, per scenario, the split route's
    host loop over a stand-in for its kernel: the launches' (stage,
    steps, iteration), the all-reduces, and the error raised, if any."""
    import torch
    import torch.distributed as dist

    from dvo_slam_tpu_torch import TrackerConfig, parallel
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.ops import camera
    from dvo_slam_tpu_torch.ops import linearize as lin_ops
    from dvo_slam_tpu_torch.parallel import sharded

    calls = {"grouped": 0}
    plain = lin_ops.linearize_batched_reference

    def counted(*args, **kw):
        calls["grouped"] += kw.get("group") is not None
        return plain(*args, **kw)

    lin_ops.linearize_batched_reference = counted
    cfg = TrackerConfig(**inp["cfg"])
    L = cfg.num_levels
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*inp["K"], device=device),
                                   L)
    refs = _pyramids(inp["ref_i"], inp["ref_z"], L, device)
    curs = _pyramids(inp["cur_i"], inp["cur_z"], L, device)
    B = refs[0].shape[0]
    T0 = torch.eye(4).expand(B, 4, 4).contiguous()
    mesh = sharded.make_mesh(world_size, 1, world_size)
    group = mesh.get_group("pixel")
    split_before = lin_ops.LAUNCHES_TRACK_LEVEL_SPLIT
    res = sharded.sharded_track_pairs(mesh, cfg)(
        sharded.shard_pyramid(refs, mesh), curs, Ks, T0)
    out = {"pairs": _np(res), "grouped": calls["grouped"],
           "split_launches": lin_ops.LAUNCHES_TRACK_LEVEL_SPLIT - split_before,
           "routes": (lin_ops.pixel_route(group),
                      dense_tracker.front_route(cfg, "cpu", group),
                      dense_tracker.front_route(cfg, "cuda", group))}

    # The host loop over a stand-in kernel, once a scenario of
    # inp["scenarios"] (config fields, each rank's stop, Sigma steps):
    # stage 0 of iteration k > 0 reports every row done once k >= the
    # rank's stop (the decision of iteration k - 1; k counted as the
    # kernel counts it in its carry, by the stage 0 launches so far, not
    # read from the launch's iteration argument). Each scenario runs
    # twice: issued eagerly (gloo's issue), then as the graph issue builds
    # it (lin_ops.graph_issue forced), its units captured by a recording
    # stand-in for the CUDA graph that issues what it recorded on replay.
    # Every launch and all-reduce is logged in order as issued.
    real_args, saved_launch = lin_ops.split_args, lin_ops._build.launch
    saved = (lin_ops.graph_issue, lin_ops._capture, dist.all_reduce)
    band = refs[L - 1][:, :, :refs[L - 1].shape[-2] // world_size].contiguous()
    out["scenarios"], out["graph_scenarios"] = [], []
    for fields, stops, steps in inp["scenarios"]:
        for graph in (False, True):
            seen = {"launches": [], "events": [], "captures": 0}

            def capture(*args, seen=seen, **kw):
                seen["a"] = real_args(*args, **kw)
                return seen["a"]

            def fake_split(name, dev, args, stop=stops[rank], steps=steps,
                           seen=seen):
                assert name == "dvo_track_level_split"
                code = args[-3]
                seen["launches"].append(tuple(args[-3:]))
                seen["events"].append(("stage", code, args[-2]))
                sums = seen["a"].sums
                sums.zero_()
                if code == 0:
                    k = sum(x[0] == 0 for x in seen["launches"]) - 1
                    sums[:, lin_ops._SUM_DONE] = float(0 < k and stop <= k)
                    sums[:, lin_ops._SUM_STEPS] = float(steps)

            def all_reduce(t, *args, seen=seen, **kw):
                seen["events"].append(("all_reduce",))
                return saved[2](t, *args, **kw)

            def record(device, fn, seen=seen):
                calls = []
                launch, reduce = lin_ops._build.launch, dist.all_reduce
                lin_ops._build.launch = lambda *a: calls.append((True, a))
                dist.all_reduce = lambda *a, **kw: calls.append((False, a, kw))
                try:
                    fn()
                finally:
                    lin_ops._build.launch, dist.all_reduce = launch, reduce
                seen["captures"] += 1

                class Recorded:
                    def replay(self):
                        for c in calls:
                            if c[0]:
                                lin_ops._build.launch(*c[1])
                            else:
                                dist.all_reduce(*c[1], **c[2])
                return Recorded()

            counts = (lin_ops.COLLECTIVES_SPLIT, lin_ops.REPLAYS_SPLIT)
            lin_ops.split_args, lin_ops._build.launch = capture, fake_split
            dist.all_reduce = all_reduce
            # A new workspace a run (its split_args captured).
            parallel.group_state(group).clear()
            if graph:
                lin_ops.graph_issue = lambda group: True
                lin_ops._capture = record
            try:
                lin_ops.track_level_split(
                    lin_ops.RefSlabs(band), curs[L - 1], Ks[L - 1], T0,
                    TrackerConfig(**fields), group,
                    row0=rank * band.shape[-2])
                error = None
            except RuntimeError as e:
                error = str(e)
            finally:
                lin_ops.split_args, lin_ops._build.launch = (real_args,
                                                             saved_launch)
                lin_ops.graph_issue, lin_ops._capture, dist.all_reduce = saved
                parallel.group_state(group).clear()
            out["graph_scenarios" if graph else "scenarios"].append({
                "launches": seen["launches"], "events": seen["events"],
                "error": error, "captures": seen["captures"],
                "collectives": lin_ops.COLLECTIVES_SPLIT - counts[0],
                "replays": lin_ops.REPLAYS_SPLIT - counts[1]})
    dist.barrier()
    return out

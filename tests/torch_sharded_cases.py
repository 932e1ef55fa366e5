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
    gathered poses and valid counts, and this rank's launch counts."""
    from dvo_slam_tpu_torch import TrackerConfig
    from dvo_slam_tpu_torch.ops import linearize, sampler
    from dvo_slam_tpu_torch.parallel import sharded

    refs, curs, Ks, T0 = card_pairs(inp, device)
    mesh = sharded.make_mesh(world_size, 1, world_size)
    before = (sampler.LAUNCHES, linearize.LAUNCHES_TRACK_LEVEL)
    res = sharded.sharded_track_pairs(mesh, TrackerConfig())(
        sharded.shard_pyramid(refs, mesh), curs, Ks, T0)
    res = sharded.gather_rows(res, mesh)
    return {"T": res.transformation.cpu().numpy(),
            "valid": res.valid_pixels.cpu().numpy(),
            "launches": {"sample_slab": sampler.LAUNCHES - before[0],
                         "track_level": (linearize.LAUNCHES_TRACK_LEVEL
                                         - before[1])}}

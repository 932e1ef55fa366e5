"""Sharded tracking and pose-graph assembly over a ``DeviceMesh``
(counterpart of ``dvo_slam_tpu/parallel/sharded.py``).

The JAX package wraps one program in ``shard_map`` over a ('batch',
'pixel') mesh. Here each rank of a ``torch.distributed`` world calls the
same functions on its own shard:

  * Tracking: reference pyramids split over ``batch`` (independent
    alignments) and their rows over ``pixel``; current pyramids split over
    ``batch`` only (warped lookups cross row bands). Every sum of the IRLS
    linearization is all-reduced over the pixel group
    (``dense_tracker.track_batched(..., pixel_group=...)``), so the ranks
    of one batch shard compute the same result.
  * The validation fleet: candidates x directions on ``batch`` (forward
    rows [0, B), backward rows [B, 2B)).
  * Pose-graph assembly: edges split over ``batch``; each rank assembles
    its edges' part of the dense 6M x 6M system with the graph's
    deterministic sum plans, and the parts are all-reduced.

``shard_rows``, ``shard_pyramid`` and ``gather_rows`` cut global inputs
into a rank's shard and put the shards' outputs back together (every rank
gets the whole), so a caller can compare against a single-process run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker

AXES = ("batch", "pixel")


def mesh_shape(n: int, dp: Optional[int] = None,
               sp: Optional[int] = None) -> tuple:
    """(dp, sp) of a mesh of n ranks, deriving only the missing axis (the
    JAX package's make_mesh: by default sp = 2 where n is even)."""
    if dp is None and sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp must equal n_devices: {dp}*{sp} != {n}")
    return dp, sp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: Optional[int] = None):
    """A ('batch', 'pixel') ``DeviceMesh`` over the ranks of the default
    process group (every rank calls it). n_devices must be the world size.
    Its device type is "cuda" under nccl, else "cpu" (gloo ranks may still
    hold CUDA tensors)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh spans the world's {dist.get_world_size()} "
                         f"ranks, not {n}")
    dp, sp = mesh_shape(n, dp, sp)
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.arange(n).reshape(dp, sp), mesh_dim_names=AXES)


def _part(n: int, parts: int, index: int) -> slice:
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} shards")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def shard_rows(x, mesh, axis: str = "batch", dim: int = 0):
    """This rank's equal part of x along ``dim``, split over the mesh axis
    ``axis`` (a view)."""
    i = AXES.index(axis)
    sl = _part(x.shape[dim], mesh.shape[i], mesh.get_coordinate()[i])
    return x[(slice(None),) * (dim % x.dim()) + (sl,)]


def shard_pyramid(pyr, mesh, pixel: bool = True):
    """This rank's shard of a pyramid of (B, 6, H, W) levels: rows of B
    over ``batch`` and, with ``pixel``, rows of H over ``pixel``
    (contiguous copies)."""
    out = []
    for lvl in pyr:
        lvl = shard_rows(lvl, mesh, "batch", 0)
        if pixel:
            lvl = shard_rows(lvl, mesh, "pixel", -2)
        out.append(lvl.contiguous())
    return tuple(out)


def gather_rows(tree, mesh, axis: str = "batch"):
    """The inverse of ``shard_rows`` along dim 0 for every tensor of tree
    (a tensor, or nested tuples, NamedTuples, lists and dicts of them;
    other leaves pass through): each rank's rows are put in their place in
    zeros and summed over the axis's group, so every rank gets the whole.
    Exact (x + 0 = x); bool tensors travel as uint8."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    parts = mesh.shape[AXES.index(axis)]
    index = mesh.get_coordinate()[AXES.index(axis)]

    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        full = x.new_zeros((x.shape[0] * parts,) + x.shape[1:],
                           dtype=torch.uint8 if x.dtype == torch.bool
                           else x.dtype)
        full[_part(full.shape[0], parts, index)] = x
        dist.all_reduce(full, group=group)
        return full.bool() if x.dtype == torch.bool else full

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(tree)


def sharded_track_pairs(mesh, cfg: TrackerConfig):
    """The batched tracker with pairs over ``batch`` and reference rows
    over ``pixel``.

    Returns fn(ref_pyrs, cur_pyrs, Ks, T_inits) -> TrackResult of this
    rank's rows, on this rank's shard: ref_pyrs levels (B / dp, 6, H / sp,
    W) (``shard_pyramid``), cur_pyrs levels (B / dp, 6, H, W)
    (``shard_pyramid(..., pixel=False)``), T_inits (B / dp, 4, 4). Every
    level's H must split over ``pixel``. The ranks of one batch shard
    return the same result."""
    group = mesh.get_group("pixel")

    def fn(ref_pyrs, cur_pyrs, Ks, T_inits):
        return dense_tracker.track_batched(ref_pyrs, cur_pyrs, Ks, T_inits,
                                           cfg, pixel_group=group)

    return fn


def sharded_validation_fleet(mesh, cfg: TrackerConfig):
    """Loop-closure validation fleet over the mesh: B candidates x two
    directions on ``batch`` (forward cand -> new alignments rows [0, B),
    backward new -> cand rows [B, 2B) from the inverse initial poses),
    reference rows on ``pixel``.

    Returns fn(cand_pyrs, new_pyr, Ks, T_inits) -> (fwd, bwd) TrackResults
    with leading dim B, on every rank: cand_pyrs levels (B, 6, H, W),
    new_pyr levels (6, H, W), T_inits (B, 4, 4), the whole inputs on every
    rank (each takes its shard). 2B must split over ``batch`` (pad
    candidates as models/constraints.py does)."""
    from dvo_slam_tpu_torch.ops import se3

    track = sharded_track_pairs(mesh, cfg)

    def fn(cand_pyrs, new_pyr, Ks, T_inits):
        B = T_inits.shape[0]
        news = tuple(lvl.expand((B,) + lvl.shape) for lvl in new_pyr)
        refs = tuple(torch.cat([c, n]) for c, n in zip(cand_pyrs, news))
        curs = tuple(torch.cat([n, c]) for c, n in zip(cand_pyrs, news))
        T2 = torch.cat([T_inits, se3.inverse(T_inits)])
        res = track(shard_pyramid(refs, mesh),
                    shard_pyramid(curs, mesh, pixel=False), Ks,
                    shard_rows(T2, mesh).contiguous())
        res = gather_rows(res, mesh)
        return (dense_tracker.row(res, slice(0, B)),
                dense_tracker.row(res, slice(B, 2 * B)))

    return fn


def sharded_pose_graph_build(mesh):
    """Edge-sharded pose-graph assembly (all-reduced over ``batch``).

    Returns fn(poses, edge_i, edge_j, Z, info, mask) -> (H (6M, 6M),
    g (6M,)): poses (M, 4, 4) whole on every rank; this rank's edges
    (``shard_rows`` over ``batch``): edge_i, edge_j (E / dp,) indices
    (tensors or arrays; the sum plans are built from host copies), Z
    (E / dp, 4, 4), info (E / dp, 6, 6), mask (E / dp,) bool. The masked
    information, no robust weight and no gauge prior, as the JAX
    package's. Duplicate targets are summed with the graph's host-built
    plans (models/pose_graph._scatter_sum), never an atomic scatter-add:
    the same inputs give the same bits."""
    import torch.distributed as dist

    from dvo_slam_tpu_torch.models import pose_graph as pg

    group = mesh.get_group("batch")

    def fn(poses, edge_i, edge_j, Z, info, mask):
        M = poses.shape[0]
        dev = poses.device
        ei_h = np.asarray(torch.as_tensor(edge_i).cpu(), np.int64)
        ej_h = np.asarray(torch.as_tensor(edge_j).cpu(), np.int64)
        ei = torch.as_tensor(ei_h, device=dev)
        ej = torch.as_tensor(ej_h, device=dev)
        e, Ji, Jj = pg._edge_residual_and_jacobians(poses[ei], poses[ej], Z)
        winfo = mask.to(poses.dtype)[:, None, None] * info
        JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
        Hij = JiT @ winfo @ Jj
        we = (winfo @ e[..., None])
        H = pg._scatter_sum(
            torch.cat([JiT @ winfo @ Ji, JjT @ winfo @ Jj, Hij,
                       Hij.transpose(-1, -2)]),
            pg._plan(np.concatenate([ei_h * M + ei_h, ej_h * M + ej_h,
                                     ei_h * M + ej_h, ej_h * M + ei_h]),
                     M * M, dev))
        g = pg._scatter_sum(
            torch.cat([(JiT @ we)[..., 0], (JjT @ we)[..., 0]]),
            pg._plan(np.concatenate([ei_h, ej_h]), M, dev))
        Hg = torch.cat([H.reshape(-1), g.reshape(-1)])
        dist.all_reduce(Hg, group=group)
        H = Hg[:M * M * 36].view(M, M, 6, 6)
        return (H.transpose(1, 2).reshape(6 * M, 6 * M),
                Hg[M * M * 36:].clone())

    return fn

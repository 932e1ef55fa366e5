"""Batched SE(3) pose-graph optimizer, the g2o replacement (counterpart of
``dvo_slam_tpu/models/pose_graph.py``; reference keyframe_graph.cpp's g2o
SparseOptimizer with EdgeSE3, Levenberg-Marquardt and a Cauchy kernel).

The graph is padded to fixed capacities exactly as in the JAX package:
(M, 4, 4) vertex poses with vertex 0 gauge-fixed by a strong prior, (E,)
edges with (E, 4, 4) measurements Z = T_i^{-1} T_j, (E, 6, 6) information
and a validity mask. Per-edge residual e = log(Z^{-1} T_i^{-1} T_j), exact
edge Jacobians in closed form (the JAX package differentiates with
``jax.jacfwd``; tests hold the two together), the dense
6M x 6M system solved by Cholesky or the matrix-free block-Jacobi CG, and
the LM accept/reject loop with the adaptive GNC anneal, all in f32 (the
edge Jacobian in f64). The JAX package runs this through XLA as one
``jax.jit`` with a ``lax.while_loop`` over the LM steps, not Pallas.

Three routes (``graph_route``), picked by device, solver and size alone.
Every solve on a CUDA device is ONE kernel launch that runs the whole LM
loop on the card, as the JAX ``while_loop`` runs it, with nothing read
back to the host; a build or launch error raises, and nothing falls back:

- "cluster": a dense solve of at most ``KERNEL_MAX_VERTICES`` (128)
  vertices is one launch of csrc/pose_graph.cu (``optimize_kernel``; one
  CTA up to 32 vertices, a cluster of up to 16 past that,
  ``kernel_plan``).
- "grid": every other CUDA solve (``solver="cg"`` at any size, a dense
  graph past 128 vertices) is one cooperative launch of
  csrc/pose_graph_grid.cu (``optimize_grid``; one CTA a streaming
  multiprocessor, the dense system's nonzero 32 x 32 tiles (the host's
  symbolic fill, ``grid_pattern``) or the block-Jacobi CG with its own
  loop on the card, ``grid_plan``).
- "host loop": the CPU runs the plain host loop ``optimize_reference``,
  both kernels' plain version: ``torch`` / ``torch.linalg`` ops, reading
  its stop flag back once per LM step (and the CG loop its stop test once
  per CG step) and exiting where the JAX ``while_loop`` does.

Sums with duplicate indices (the gradient, the block diagonal, the dense
H, the CG matvec) follow a host-built plan in a fixed order, never
``index_add_``: CUDA's atomic scatter-add sums in no fixed order, and two
solves of one graph must give the same bits. The plan depends only on the
topology, which the caller holds on the host; the kernels take the same
plans as CSR lists.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dvo_slam_tpu_torch.ops import se3

_GAUGE_WEIGHT = 1e6
_JITTER = 1e-6

# The graph kernel (csrc/pose_graph.cu): a cluster of up to 16 CTAs holds
# the damped 6M x 6M f32 system's lower triangle in shared memory, in panels
# of 16 columns dealt block-cyclically over the CTAs, which bounds M
# (dvo_pose_graph_plan; kernel_plan mirrors it).
KERNEL_MAX_VERTICES = 128
KERNEL_THREADS = 512
KERNEL_PANEL_WIDTH = 16
_KERNEL_SINGLE_CTA = 32  # one CTA up to this M
_KERNEL_MAX_CLUSTER = 16
_KERNEL_MAX_COLUMNS = 96  # columns a CTA of a cluster holds
_KERNEL_SMEM_BUDGET = 230_400  # dynamic shared memory bytes a CTA may ask
_KERNEL_EDGE_FLOATS = 42  # per-edge slot: P (36), gj (6)
# The grid kernel (csrc/pose_graph_grid.cu): one CTA of 256 threads a
# streaming multiprocessor, all co-resident (a cooperative launch); the
# dense system in 32 x 32 tiles, owned and updated in units of 2 x 2 tiles
# (dvo_pose_graph_grid_plan; grid_plan mirrors it).
SOLVERS = ("dense", "cg")
GRID_THREADS = 256
GRID_TILE = 32
_GRID_UNIT_ROWS = 2 * GRID_TILE
# Per-CTA f64 partials: max, chi2, trial, final, p.Ap, r.z, r.r, b.b.
_GRID_SLOTS = 8
# Kernel launches since the last reset (plain integers; callers reset them
# to 0 to count the launches of one run): optimize_kernel's (LAUNCHES) and
# optimize_grid's (LAUNCHES_GRID), and both kernels' launches by vertex
# slots M (callers clear it).
LAUNCHES = 0
LAUNCHES_GRID = 0
LAUNCHES_BY_M = {}
# The last solve's LM step count, a 0-d int32 tensor on its device (the
# kernel's output, or the host loop's count), and its per-step statistics,
# (iterations, 4) f32: each step's chi2, trial chi2, step norm and accept
# flag (1 or 0), zero past the last step. For tests and the smoke.
LAST_STEPS = None
LAST_STATS = None
# Why each step of the last solve came out zero, (iterations,) int32 on its
# device: ZEROED_NONE (the step was used), ZEROED_PIVOT (the dense
# factorization met a pivot <= 0) or ZEROED_NOT_FINITE (a step that is not
# finite), ZEROED_NONE past the last step. Written by the grid kernel and
# the host loop; None after a solve on the cluster kernel.
LAST_ZEROED = None
ZEROED_NONE, ZEROED_PIVOT, ZEROED_NOT_FINITE = 0, 1, 2


class PoseGraph(NamedTuple):
    """Padded pose-graph state. The orchestrators keep it as host numpy
    arrays (``empty_graph_host``); ``optimize`` uploads it."""

    poses: object  # (M, 4, 4) vertex poses (world <- keyframe)
    num_vertices: object  # () int32
    edge_i: object  # (E,) int32 source vertex
    edge_j: object  # (E,) int32 target vertex
    measurements: object  # (E, 4, 4) Z: T_i^{-1} T_j measured
    information: object  # (E, 6, 6)
    edge_mask: object  # (E,) bool
    num_edges: object  # () int32


def empty_graph_host(max_vertices: int, max_edges: int) -> PoseGraph:
    """An empty padded graph of host numpy arrays."""
    return PoseGraph(
        poses=np.tile(np.eye(4, dtype=np.float32), (max_vertices, 1, 1)),
        num_vertices=np.asarray(0, np.int32),
        edge_i=np.zeros(max_edges, np.int32),
        edge_j=np.zeros(max_edges, np.int32),
        measurements=np.tile(np.eye(4, dtype=np.float32), (max_edges, 1, 1)),
        information=np.tile(np.eye(6, dtype=np.float32), (max_edges, 1, 1)),
        edge_mask=np.zeros(max_edges, bool),
        num_edges=np.asarray(0, np.int32),
    )


def grow(graph: PoseGraph, max_vertices: int = None,
         max_edges: int = None) -> PoseGraph:
    """Re-pad a host graph to larger capacities (contents preserved)."""
    M_old = graph.poses.shape[0]
    E_old = graph.edge_i.shape[0]
    M = max(max_vertices or M_old, M_old)
    E = max(max_edges or E_old, E_old)
    poses = np.asarray(graph.poses)
    measurements = np.asarray(graph.measurements)
    information = np.asarray(graph.information)
    eye4 = np.eye(4, dtype=poses.dtype)
    eye6 = np.eye(6, dtype=information.dtype)
    return PoseGraph(
        poses=np.concatenate(
            [poses, np.tile(eye4, (M - M_old, 1, 1))]
        ) if M > M_old else poses.copy(),
        num_vertices=np.asarray(graph.num_vertices),
        edge_i=np.pad(np.asarray(graph.edge_i), (0, E - E_old)),
        edge_j=np.pad(np.asarray(graph.edge_j), (0, E - E_old)),
        measurements=np.concatenate(
            [measurements, np.tile(eye4, (E - E_old, 1, 1))]
        ) if E > E_old else measurements.copy(),
        information=np.concatenate(
            [information, np.tile(eye6, (E - E_old, 1, 1))]
        ) if E > E_old else information.copy(),
        edge_mask=np.pad(np.asarray(graph.edge_mask), (0, E - E_old)),
        num_edges=np.asarray(graph.num_edges),
    )


def bucket(n: int, minimum: int) -> int:
    """Next power-of-two capacity >= n (floored at `minimum`)."""
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    return b


def crop(graph: PoseGraph, max_vertices: int, max_edges: int) -> PoseGraph:
    """View of the leading [0:max_vertices) x [0:max_edges) region."""
    M = min(max_vertices, graph.poses.shape[0])
    E = min(max_edges, graph.edge_i.shape[0])
    if M == graph.poses.shape[0] and E == graph.edge_i.shape[0]:
        return graph
    return PoseGraph(
        poses=graph.poses[:M],
        num_vertices=graph.num_vertices,
        edge_i=graph.edge_i[:E],
        edge_j=graph.edge_j[:E],
        measurements=graph.measurements[:E],
        information=graph.information[:E],
        edge_mask=graph.edge_mask[:E],
        num_edges=graph.num_edges,
    )


def to_device(graph: PoseGraph, device) -> PoseGraph:
    """A host graph's arrays as tensors on `device` (f32 poses,
    measurements and information; int64 indices; bool mask; host ints for
    the counts)."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return PoseGraph(
        poses=t(graph.poses, torch.float32),
        num_vertices=int(graph.num_vertices),
        edge_i=t(graph.edge_i, torch.int64),
        edge_j=t(graph.edge_j, torch.int64),
        measurements=t(graph.measurements, torch.float32),
        information=t(graph.information, torch.float32),
        edge_mask=t(graph.edge_mask, torch.bool),
        num_edges=int(graph.num_edges),
    )


# ---------------------------------------------------------------- sum plans

class _Plan(NamedTuple):
    """A deterministic scatter-add of K values into `size` slots: slot
    keys[u] receives values[gather[u, 0]] + values[gather[u, 1]] + ...
    (increasing value index; K marks an empty entry, a zero row)."""

    keys: torch.Tensor  # (U,) distinct target slots
    gather: torch.Tensor  # (U, D) value indices, K-padded
    size: int


def _plan(targets: np.ndarray, size: int, device, keep=None) -> _Plan:
    """The plan of K values into `size` slots by `targets`; with `keep`
    (bool per value), only the kept values are summed (the others' slots
    receive nothing from them)."""
    targets = np.asarray(targets, np.int64)
    K = targets.shape[0]
    order = np.argsort(targets, kind="stable")
    if keep is not None:
        order = order[np.asarray(keep, bool)[order]]
    keys, starts, counts = np.unique(targets[order], return_index=True,
                                     return_counts=True)
    D = int(counts.max()) if counts.size else 1
    gather = np.full((keys.size, D), K, np.int64)
    for d in range(D):
        has = counts > d
        gather[has, d] = order[starts[has] + d]
    return _Plan(torch.as_tensor(keys, device=device),
                 torch.as_tensor(gather, device=device), size)


def _scatter_sum(values, plan: _Plan):
    """(K, ...) values summed into (plan.size, ...) slots, in a fixed order."""
    padded = torch.cat([values, torch.zeros_like(values[:1])])
    out = values.new_zeros((plan.size,) + values.shape[1:])
    out[plan.keys] = padded[plan.gather].sum(1)
    return out


class _Topology(NamedTuple):
    """The sum plans of one graph's edge structure (host-built)."""

    vertex: _Plan  # 2E contributions [edge_i; edge_j] -> M vertices
    dense: _Plan  # 4E + M blocks -> M * M (dense H)


def _plan_targets(graph: PoseGraph):
    """The target slots of the two sums of a host graph: the per-edge
    gradients [gi; gj] into M vertices, and the blocks [Hii; Hjj; Hij;
    Hij^T; extra] into the M * M blocks of the dense H."""
    M = graph.poses.shape[0]
    ei = np.asarray(graph.edge_i, np.int64)
    ej = np.asarray(graph.edge_j, np.int64)
    vid = np.arange(M)
    return (np.concatenate([ei, ej]),
            np.concatenate([ei * M + ei, ej * M + ej, ei * M + ej,
                            ej * M + ei, vid * M + vid]))


def _topology(graph: PoseGraph, device) -> _Topology:
    """The plans over the unmasked edges, as the kernels' (``_pack``): a
    masked edge's blocks and gradient are exact zeros (weight 0), and a
    padded graph's masked edges all sit on vertex 0, whose slot would
    otherwise gather every padded slot (a 256-slot graph with 16 384 edge
    slots asked for ~73 GB)."""
    M = graph.poses.shape[0]
    vertex, dense = _plan_targets(graph)
    on = np.asarray(graph.edge_mask, bool)
    return _Topology(vertex=_plan(vertex, M, device, np.tile(on, 2)),
                     dense=_plan(dense, M * M, device, np.concatenate(
                         [np.tile(on, 4), np.ones(M, bool)])))


def _csr(targets: np.ndarray, size: int, keep=None):
    """A plan as CSR lists: slot s sums values idx[off[s]:off[s + 1]], in
    increasing value index (the order of ``_plan``'s gather rows); with
    `keep` (bool per value), only the kept values."""
    targets = np.asarray(targets, np.int64)
    idx = np.argsort(targets, kind="stable")
    if keep is not None:
        idx = idx[np.asarray(keep, bool)[idx]]
    off = np.zeros(size + 1, np.int32)
    np.cumsum(np.bincount(targets[idx], minlength=size), out=off[1:])
    return off, idx.astype(np.int32)


# --------------------------------------------------------------- residuals

def edge_residual(T_i, T_j, Z):
    """e = log(Z^{-1} T_i^{-1} T_j) in R^6; batches over leading dims."""
    return se3.log(se3.inverse(Z) @ se3.inverse(T_i) @ T_j)


def _so3_hat(w):
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(*w.shape[:-1], 3, 3)


def _jl_inv(xi):
    """Inverse left Jacobian of SE(3) at twists xi (E, 6), (v, w) order:
    log(exp(d) exp(xi)) = xi + Jl^{-1}(xi) d + O(d^2). Closed form
    (Barfoot, State Estimation for Robotics, eqs. 7.86 and 7.95) with
    Taylor branches at small angles; f64 in, f64 out."""
    rho, phi = xi[:, :3], xi[:, 3:]
    t2 = (phi * phi).sum(-1)
    small = t2 < 1e-4
    t2s = torch.where(small, 1.0, t2)
    t = torch.sqrt(t2s)
    s, c = torch.sin(t), torch.cos(t)
    # Jl3^{-1} = I - Phi/2 + k Phi^2; Q = Q(rho, phi) of Jl.
    k = torch.where(small, 1 / 12 + t2 / 720,
                    1 / t2s - (1 + c) / (2 * t * s))
    a = torch.where(small, 1 / 6 - t2 / 120, (t - s) / (t2s * t))
    b = torch.where(small, 1 / 24 - t2 / 720,
                    (t2s + 2 * c - 2) / (2 * t2s * t2s))
    d = torch.where(small, 1 / 120 - t2 / 2520,
                    (2 * t - 3 * s + t * c) / (2 * t2s * t2s * t))
    Phi, P = _so3_hat(phi), _so3_hat(rho)
    PhiP, PPhi = Phi @ P, P @ Phi
    PhiPPhi = PhiP @ Phi
    Phi2 = Phi @ Phi
    co = (lambda x: x[:, None, None])
    Q = (0.5 * P + co(a) * (PhiP + PPhi + PhiPPhi)
         + co(b) * (Phi @ PhiP + PPhi @ Phi - 3.0 * PhiPPhi)
         + co(d) * (PhiPPhi @ Phi + Phi @ PhiPPhi))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(Phi.shape)
    J3i = eye - 0.5 * Phi + co(k) * Phi2
    top = torch.cat([J3i, -J3i @ Q @ J3i], dim=-1)
    bottom = torch.cat([torch.zeros_like(J3i), J3i], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _edge_residual_and_jacobians(T_i, T_j, Z):
    """Per-edge residual (E, 6) and exact Jacobians (E, 6, 6) wrt LEFT
    increments on T_i and T_j of
    e(d_i, d_j) = log(Z^{-1} (exp(d_i) T_i)^{-1} exp(d_j) T_j) at 0.

    The JAX package takes them by forward-mode autodiff; here they are the
    closed form of the same derivative: with A = Z^{-1} T_i^{-1}, a left
    increment d_j moves the error by exp(Ad_A d_j) and d_i by
    exp(-Ad_A d_i), so J_j = Jl^{-1}(e) Ad_A = -J_i. Computed in f64 (the
    small-angle coefficients cancel in f32) and returned in the poses'
    dtype. Finite at a consistent edge (e = 0: J_j = Ad_A)."""
    e = edge_residual(T_i, T_j, Z)
    A = se3.inverse(Z.double()) @ se3.inverse(T_i.double())
    Jj = _jl_inv(e.double()) @ se3.adjoint(A)
    Jj = Jj.to(T_i.dtype)
    return e, -Jj, Jj


def _robust_edge_weight(chi2, cauchy_c, use_robust):
    """Cauchy IRLS weight rho'(s) = 1 / (1 + s / c^2)."""
    if not use_robust:
        return torch.ones_like(chi2)
    return 1.0 / (1.0 + chi2 / (cauchy_c * cauchy_c))


def _chi2(e, info):
    return torch.einsum("ea,eab,eb->e", e, info, e)


def _build_blocks(graph: PoseGraph, topo: _Topology, use_robust, cauchy_c):
    """Per-edge Hessian blocks and the per-vertex gradient (the block-sparse
    GN system). Returns ((Hii, Hjj, Hij, extra), g (M, 6), total robust
    chi2, per-edge weights)."""
    M = graph.poses.shape[0]
    P = graph.poses
    e, Ji, Jj = _edge_residual_and_jacobians(P[graph.edge_i],
                                             P[graph.edge_j],
                                             graph.measurements)
    chi2 = _chi2(e, graph.information)
    w = (_robust_edge_weight(chi2, cauchy_c, use_robust)
         * graph.edge_mask.to(P.dtype))
    winfo = w[:, None, None] * graph.information  # (E, 6, 6)

    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    Hii = JiT @ winfo @ Ji
    Hjj = JjT @ winfo @ Jj
    Hij = JiT @ winfo @ Jj
    we = (winfo @ e[..., None])[..., 0]
    gi = (JiT @ we[..., None])[..., 0]
    gj = (JjT @ we[..., None])[..., 0]
    g = _scatter_sum(torch.cat([gi, gj]), topo.vertex)

    # Gauge fix on vertex 0 (g2o setFixed) + identity on inactive (padded)
    # vertices so the system stays SPD.
    eye6 = torch.eye(6, dtype=P.dtype, device=P.device)
    inactive = (torch.arange(M, device=P.device)
                >= graph.num_vertices).to(P.dtype)
    extra = inactive[:, None, None] * eye6
    extra[0] += _GAUGE_WEIGHT * eye6

    total_chi2 = (w * chi2).sum()
    return (Hii, Hjj, Hij, extra), g, total_chi2, w


def _block_diag(topo: _Topology, blocks):
    """Per-vertex (6, 6) diagonal blocks of H (incl. gauge/inactive)."""
    Hii, Hjj, _, extra = blocks
    return _scatter_sum(torch.cat([Hii, Hjj]), topo.vertex) + extra


def _block_matvec(graph: PoseGraph, topo: _Topology, blocks, diag_damp, x):
    """y = (H + diag_damp) @ x without materializing H; x, y (M, 6)."""
    Hii, Hjj, Hij, extra = blocks
    xi = x[graph.edge_i][..., None]
    xj = x[graph.edge_j][..., None]
    yi = (Hii @ xi + Hij @ xj)[..., 0]
    yj = (Hij.transpose(-1, -2) @ xi + Hjj @ xj)[..., 0]
    y = _scatter_sum(torch.cat([yi, yj]), topo.vertex)
    y = y + (extra @ x[..., None])[..., 0]
    return y + diag_damp * x


def _solve_cg(graph: PoseGraph, topo: _Topology, blocks, lam, b, maxiter,
              tol=1e-6):
    """Block-Jacobi-preconditioned conjugate gradient for (H + damping)
    x = b; b, x (M, 6)."""
    dtype = b.dtype
    D = _block_diag(topo, blocks)
    diag_vec = torch.diagonal(D, dim1=-2, dim2=-1)  # (M, 6)
    diag_damp = lam * diag_vec + _JITTER
    D_damped = D + torch.diag_embed(diag_damp)
    L, _ = torch.linalg.cholesky_ex(D_damped)
    eye6 = torch.eye(6, dtype=dtype, device=b.device).expand(D.shape)
    Minv = torch.cholesky_solve(eye6, L)  # (M, 6, 6)

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    bnorm2 = torch.clamp((b * b).sum(), min=1e-30)
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = (r * p).sum()
    rr = (r * r).sum()
    k = 0
    while k < maxiter and bool(rr > tol * tol * bnorm2):
        Ap = _block_matvec(graph, topo, blocks, diag_damp, p)
        pAp = (p * Ap).sum()
        alpha = torch.where(pAp > 0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = torch.where(rz > 0, rz_new / rz, 0.0)
        p = z + beta * p
        rz, rr = rz_new, (r * r).sum()
        k += 1
    return x


def _build_system(graph: PoseGraph, topo: _Topology, use_robust, cauchy_c):
    """Dense H (6M, 6M), g (6M,), total robust chi2, per-edge weights."""
    M = graph.poses.shape[0]
    (Hii, Hjj, Hij, extra), g, total_chi2, w = _build_blocks(
        graph, topo, use_robust, cauchy_c)
    H = _scatter_sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2), extra]),
                     topo.dense)  # (M * M, 6, 6), row-major vertex pairs
    H_flat = H.view(M, M, 6, 6).transpose(1, 2).reshape(6 * M, 6 * M)
    return H_flat, g.reshape(6 * M), total_chi2, w


def _total_chi2(graph: PoseGraph, use_robust, cauchy_c):
    """Robust total chi2 (residuals only; the LM accept test)."""
    P = graph.poses
    e = edge_residual(P[graph.edge_i], P[graph.edge_j], graph.measurements)
    chi2 = _chi2(e, graph.information)
    return (_robust_edge_weight(chi2, cauchy_c, use_robust)
            * graph.edge_mask.to(P.dtype) * chi2).sum()


def _apply_delta(poses, delta, num_vertices):
    """Left-multiply per-vertex increments, masked to active vertices."""
    M = poses.shape[0]
    active = (torch.arange(M, device=poses.device) < num_vertices)[:, None]
    d = torch.where(active, delta.reshape(M, 6), 0.0)
    return se3.exp(d) @ poses


def graph_route(solver: str, M: int, device) -> str:
    """The route ``optimize`` takes, by name: "cluster" (one launch of
    csrc/pose_graph.cu: a dense solve of 1 to ``KERNEL_MAX_VERTICES``
    vertices on a CUDA device), "grid" (one cooperative launch of
    csrc/pose_graph_grid.cu: every other CUDA solve, CG at any size and
    dense past the cluster kernel's limit) or "host loop" (the plain
    ``optimize_reference``: the CPU)."""
    if torch.device(device).type != "cuda":
        return "host loop"
    if solver == "dense" and 1 <= M <= KERNEL_MAX_VERTICES:
        return "cluster"
    return "grid"


def _panel_floats(n: int, C: int, rank: int) -> int:
    """Floats of CTA `rank`'s panels: p = rank, rank + C, ... as rows
    [p nb, n] of nb + 1 floats (nb the panel width; row n carries the
    right-hand side)."""
    nb = KERNEL_PANEL_WIDTH
    return sum((n + 1 - p * nb) * (nb + 1)
               for p in range(rank, -(-n // nb), C))


def _kernel_layout_bytes(M: int, C: int) -> int:
    n = 6 * M
    return 4 * (_panel_floats(n, C, 0)
                + (n * (KERNEL_PANEL_WIDTH + 1) if C > 1 else 0) + n + 32 * M)


def kernel_plan(M: int, E: int = 0):
    """``(largest M, CTAs per cluster, threads per CTA, dynamic shared
    memory bytes per CTA, panel width, per-edge blocks staged in shared
    memory, global scratch floats)`` of the graph kernel at M vertices and
    E edge slots, as csrc/pose_graph.cu's ``dvo_pose_graph_plan`` gives
    them. The damped system's lower triangle and the right-hand side's
    row are cut into panels of nb = 16 columns; panel p lives on CTA p mod
    C as rows [p nb, 6M] of nb + 1 floats. A CTA holds its panels, in a
    cluster a copy of one panel (6M rows of nb + 1), the right-hand side
    and two pose copies; one CTA up to M = 32, past that the fewest CTAs (a
    power of two from 4 up to 16: two never hold 33 vertices' panels) that
    hold at most 96 columns each and fit the budget. One CTA also stages
    the E per-edge blocks (42 floats each) where they fit (an LM step
    3-5 % faster at M = 16 and 32 than from global scratch on an H100).
    C = 0 and 0 bytes past the limit. The global scratch
    holds the per-edge blocks and, in a cluster, every factored panel once
    (the other CTAs copy it from there)."""
    nb = KERNEL_PANEL_WIDTH
    C = 0
    if 1 <= M <= _KERNEL_SINGLE_CTA:
        C = 1
    elif _KERNEL_SINGLE_CTA < M <= KERNEL_MAX_VERTICES:
        P = -(-6 * M // nb)
        C = next((c for c in (4, 8, _KERNEL_MAX_CLUSTER)
                  if -(-P // c) * nb <= _KERNEL_MAX_COLUMNS
                  and _kernel_layout_bytes(M, c) <= _KERNEL_SMEM_BUDGET), 0)
    if not C:
        return (KERNEL_MAX_VERTICES, 0, KERNEL_THREADS, 0, nb, 0, 0)
    nbytes = _kernel_layout_bytes(M, C)
    staged = (C == 1 and nbytes + 4 * _KERNEL_EDGE_FLOATS * E
              <= _KERNEL_SMEM_BUDGET)
    return (KERNEL_MAX_VERTICES, C, KERNEL_THREADS,
            nbytes + (4 * _KERNEL_EDGE_FLOATS * E if staged else 0), nb,
            int(staged), _KERNEL_EDGE_FLOATS * E
            + (_panel_floats(6 * M, 1, 0) if C > 1 else 0))


def _grid_layout(M: int, E: int, solver: str, ctas: int):
    """The grid kernel's global scratch, as csrc/pose_graph_grid.cu's
    ``layout`` cuts it: (total floats, tiles a side of the dense system (0
    for CG)). Each region starts at a 16-byte boundary: per-CTA f64
    partials, the per-edge blocks, two pose buffers; dense: the tiles of
    the lower triangle and -g's row, 1 / L_ii, the step and the
    factorization's flags (a word a tile column for each of col_done,
    diag_ready and x_ready, and the pivot flag); CG: per vertex the
    preconditioner and seven 6-vectors (the damping, x, r, z, two p and
    Ap)."""
    up = (lambda n: (n + 3) & ~3)
    floats = (up(2 * _GRID_SLOTS * ctas) + up(_KERNEL_EDGE_FLOATS * E)
              + 2 * up(16 * M))
    if solver != "dense":
        return floats + up(36 * M) + 7 * up(6 * M), 0
    Pt = -(-6 * M // GRID_TILE)
    return (floats + up((Pt * (Pt + 1) // 2 + Pt) * GRID_TILE * GRID_TILE)
            + 2 * up(GRID_TILE * Pt) + up(3 * Pt + 1)), Pt


def grid_plan(M: int, E: int, solver: str, ctas: int):
    """``(CTAs, threads per CTA, dynamic shared memory bytes per CTA, tile
    width, tiles a side of the dense system (0 for CG), global scratch
    floats, barrier words)`` of one solve on the grid kernel, as
    csrc/pose_graph_grid.cu's ``dvo_pose_graph_grid_plan(M, E, solver,
    ctas, out)`` gives them. One CTA of 256 threads a streaming
    multiprocessor (`ctas`, the caller's count); a CTA's shared memory holds
    the diagonal tile (32 rows of 33 floats), its factor's column broadcast
    (two buffers of 32 floats) and a unit's two staged columns (32 rows of
    64 + 4 floats each); the dense system is
    ceil(6M / 32) tiles a side, its lower triangle and -g's row of tiles in
    global scratch (4.7 MB at M = 256, 475 MB at 2 560; only the tiles of
    the symbolic fill are touched)."""
    if M < 1 or E < 0 or ctas < 1 or solver not in SOLVERS:
        raise ValueError(f"no grid plan for M = {M}, E = {E}, solver "
                         f"{solver!r}, {ctas} CTAs")
    floats, Pt = _grid_layout(M, E, solver, ctas)
    smem = 4 * (GRID_TILE * (GRID_TILE + 1) + 2 * GRID_TILE
                + 2 * GRID_TILE * (_GRID_UNIT_ROWS + 4))
    return (ctas, GRID_THREADS, smem, GRID_TILE, Pt, floats, 2)


def grid_pattern(b_list: np.ndarray, M: int):
    """The grid kernel's map of the dense factor, from the dense plan's
    block list (``_dense_plan``: the non-empty 6 x 6 blocks (a, b), a >=
    b, of the damped system's lower triangle) at M vertex slots, with Pt =
    ceil(6M / 32) tiles a side:

    - fill, (Pt + 1, Pt) bool: tile (I, J) of the factor is nonzero (J <=
      I; row Pt is the right-hand side's, -g then y, full). The tile-level
      symbolic Cholesky: a tile is nonzero where a block meets it or on the
      diagonal (padded identity rows are diagonal only), and tile (I, K) is
      nonzero where some j < K has (I, j) and (K, j) nonzero; column K's
      rows are those of its own and of its children in the elimination tree
      (the columns whose first row below the diagonal is K), so the pass is
      one union a column.
    - units, (n,) int32 U << 16 | W: the units of 2 x 2 tiles (rows 2U,
      2U + 1; columns 2W, 2W + 1) that hold a nonzero tile, by W then U (the
      order the kernel deals them over its CTAs).
    - col_units, (Pt,) int32: the units that hold a nonzero tile of column
      j (the count the kernel waits for before column j is read).
    """
    T = GRID_TILE
    Pt = -(-6 * M // T)
    A = np.zeros((Pt, Pt), bool)
    a = np.asarray(b_list, np.int64).reshape(-1, 4)[:, 0]
    b = np.asarray(b_list, np.int64).reshape(-1, 4)[:, 1]
    for dr in (0, 5):  # a block spans at most two tiles each way
        for dc in (0, 5):
            A[(6 * a + dr) // T, (6 * b + dc) // T] = True
    A = np.tril(A)
    L = np.zeros((Pt, Pt), bool)  # column K: its rows below the diagonal
    children = [[] for _ in range(Pt)]
    for K in range(Pt):
        col = A[:, K].copy()
        for c in children[K]:
            col |= L[:, c]
        col[:K + 1] = False
        L[:, K] = col
        below = np.flatnonzero(col)
        if below.size:
            children[below[0]].append(K)
    fill = np.zeros((Pt + 1, Pt), bool)
    fill[:Pt] = L | np.eye(Pt, dtype=bool)
    fill[Pt] = True
    Ur, Wc = Pt // 2 + 1, (Pt + 1) // 2
    F = np.zeros((2 * Ur, 2 * Wc), bool)
    F[:Pt + 1, :Pt] = fill
    held = F.reshape(Ur, 2, Wc, 2).any(axis=(1, 3))
    W, U = np.nonzero(held.T)
    units = ((U << 16) | W).astype(np.int32)
    col_units = F[:, :Pt].reshape(Ur, 2, Pt).any(axis=1).sum(0)
    return fill, units, col_units.astype(np.int32)


def _fill_words(fill: np.ndarray) -> np.ndarray:
    """A fill pattern as the kernel reads it: row I's bits in
    ceil(Pt / 32) uint32 words, bit J % 32 of word J / 32."""
    rows, Pt = fill.shape
    padded = np.zeros((rows, 32 * -(-Pt // 32)), bool)
    padded[:, :Pt] = fill
    return np.packbits(padded, axis=1, bitorder="little").view("<u4")


def optimize(graph: PoseGraph, iterations: int = 20, use_robust: bool = True,
             cauchy_c: float = 1.0, gnc_init: float = 1.0,
             gnc_decay: float = 0.5, solver: str = "dense",
             gnc_adaptive: bool = False, device="cuda"):
    """Levenberg-Marquardt over the padded pose graph (the JAX package's
    ``optimize``; see its docstring for the solver and GNC rationale).

    graph: host numpy arrays of one padded graph; it is uploaded to
    `device` (the card unless the caller asks for "cpu").
    solver: "dense" (6M x 6M Cholesky) or "cg" (block-Jacobi CG).
    Runs at most ``iterations`` LM steps and stops after the first step
    that converges, as the JAX ``while_loop`` does. ``graph_route`` picks
    the route: on a CUDA device every solve is one kernel launch that
    reads nothing back to the host (``optimize_kernel`` for a dense graph
    of at most 128 vertices, ``optimize_grid`` for every other), on the
    CPU the plain host loop, which reads its stop flag back once per step
    (``optimize_reference``).
    Returns (optimized PoseGraph of tensors, final chi2, per-edge robust
    weights at the base cauchy_c), all on the device.
    """
    kw = dict(iterations=iterations, use_robust=use_robust,
              cauchy_c=cauchy_c, gnc_init=gnc_init, gnc_decay=gnc_decay,
              gnc_adaptive=gnc_adaptive, device=device)
    route = graph_route(solver, graph.poses.shape[0], device)
    if route == "cluster":
        return optimize_kernel(graph, **kw)
    if route == "grid":
        return optimize_grid(graph, solver=solver, **kw)
    return optimize_reference(graph, solver=solver, **kw)


def _dense_plan(targets: np.ndarray, keep: np.ndarray, M: int):
    """The dense plan: its index list (``_csr(targets, M * M, keep)``'s),
    the non-empty blocks of its lower triangle (row vertex a >= column
    vertex b), ordered by b then a, as (K, 4) int32 rows (a, b, first, end:
    the block's range of the index list) and the (M + 1,) offsets of each
    column vertex's rows: (d_idx, b_off, b_list). Built from the non-empty
    blocks alone, with no pass over the M * M slots (6f's 2 560-vertex
    graph has 6.6M slots and ~11 000 contributions)."""
    targets = np.asarray(targets, np.int64)
    idx = np.argsort(targets, kind="stable")
    idx = idx[np.asarray(keep, bool)[idx]]
    slots, first, counts = np.unique(targets[idx], return_index=True,
                                     return_counts=True)
    a, b = slots // M, slots % M
    sel = np.nonzero(a >= b)[0]
    sel = sel[np.argsort(b[sel] * M + a[sel], kind="stable")]
    rows = np.stack([a[sel], b[sel], first[sel], first[sel] + counts[sel]],
                    axis=1)
    return (idx.astype(np.int32),
            np.searchsorted(b[sel], np.arange(M + 1)).astype(np.int32),
            rows.astype(np.int32).reshape(-1, 4))


def _codes(d_idx: np.ndarray, E: int) -> np.ndarray:
    """The dense plan's index list as the kernel reads it: contribution ci
    of edge e = ci mod E and kind ci // E (Hii, Hjj, Hij, Hij^T) as 4 e +
    kind, vertex v's extra block (ci = 4E + v) as -1 - v."""
    ci = np.asarray(d_idx, np.int64)
    kind, e = np.divmod(ci, max(E, 1))
    return np.where(ci < 4 * E, 4 * e + kind,
                    -1 - (ci - 4 * E)).astype(np.int32)


def _pack(graph: PoseGraph, dense: bool = True, grid: bool = False):
    """A host graph, its CSR sum plans over the unmasked edges and (with
    `dense`) the dense plan's block list as one f32 buffer, int32 arrays
    stored bitwise, the block list at a 16-byte boundary: (buffer, {name:
    (offset, length, is_int32)}). CG needs the vertex plan only; a dense
    solve on the grid kernel (`grid`) adds its map of the factor
    (``grid_pattern``: the fill's bits, the units, their count a column)."""
    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    vertex, targets = _plan_targets(graph)
    # A masked edge's blocks and gradient are exact zeros (weight 0), so
    # the kernels' plans leave them out (a padded graph's masked edges all
    # sit on vertex 0).
    on = np.asarray(graph.edge_mask, bool)
    v_off, v_idx = _csr(vertex, M, np.tile(on, 2))
    f32 = (lambda x: np.asarray(x, np.float32).ravel())
    i32 = (lambda x: np.asarray(x, np.int32).ravel().view(np.float32))
    parts = {
        "poses": f32(graph.poses), "Z": f32(graph.measurements),
        "info": f32(graph.information), "mask": f32(graph.edge_mask),
        "edge_i": i32(graph.edge_i), "edge_j": i32(graph.edge_j),
        "v_off": i32(v_off), "v_idx": i32(v_idx),
    }
    if dense:
        d_idx, b_off, b_list = _dense_plan(targets, np.concatenate(
            [np.tile(on, 4), np.ones(M, bool)]), M)
        parts["d_idx"] = i32(_codes(d_idx, E))
        parts["b_off"] = i32(b_off)
        at = sum(x.size for x in parts.values())
        parts["pad"] = np.zeros(-at % 4, np.float32)
        parts["b_list"] = i32(b_list)
        if grid:
            fill, units, col_units = grid_pattern(b_list, M)
            parts["fill"] = _fill_words(fill).ravel().view(np.float32)
            parts["units"] = i32(units)
            parts["col_units"] = i32(col_units)
    at, where = 0, {}
    for name, x in parts.items():
        where[name] = (at, x.size, name.startswith(("edge", "v_", "d_",
                                                     "b_", "fill", "units",
                                                     "col_")))
        at += x.size
    return np.concatenate(list(parts.values())), where


def _upload(graph: PoseGraph, device, dense: bool, grid: bool = False):
    """The packed graph and plans (``_pack``) on `device`, from pinned
    memory in one non-blocking copy: {name: view} (int32 views of the
    integer arrays). Call with `device` current."""
    buf, where = _pack(graph, dense, grid)
    host = torch.empty(buf.size, dtype=torch.float32, pin_memory=True)
    host.numpy()[:] = buf
    dev = host.to(device, non_blocking=True)
    ints = dev.view(torch.int32)
    return {k: (ints if is_int else dev)[a:a + n]
            for k, (a, n, is_int) in where.items()}


def _outputs(M: int, E: int, iterations: int, device):
    """One solve's output buffer (poses (M, 16), chi2, weights (E,), stats
    (iterations, 4)) and its step count."""
    return (torch.empty(16 * M + 1 + E + 4 * iterations, dtype=torch.float32,
                        device=device),
            torch.empty((), dtype=torch.int32, device=device))


def _solved(graph: PoseGraph, view, out, steps, iterations: int, kernel: str,
            zeroed=None):
    """Count the launch of `kernel` ("cluster" or "grid"), set LAST_STEPS,
    LAST_STATS and LAST_ZEROED (`zeroed`, the grid kernel's), and return
    ``optimize``'s outputs as views of the uploaded graph and the output
    buffer."""
    global LAUNCHES, LAUNCHES_GRID, LAST_STEPS, LAST_STATS, LAST_ZEROED
    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    if kernel == "cluster":
        LAUNCHES += 1
    else:
        LAUNCHES_GRID += 1
    LAUNCHES_BY_M[M] = LAUNCHES_BY_M.get(M, 0) + 1
    LAST_STEPS = steps
    LAST_STATS = out[16 * M + 1 + E:].view(iterations, 4)
    LAST_ZEROED = zeroed
    solved = PoseGraph(
        poses=out[:16 * M].view(M, 4, 4),
        num_vertices=int(graph.num_vertices),
        edge_i=view["edge_i"].to(torch.int64),
        edge_j=view["edge_j"].to(torch.int64),
        measurements=view["Z"].view(E, 4, 4),
        information=view["info"].view(E, 6, 6),
        edge_mask=view["mask"] != 0,
        num_edges=int(graph.num_edges),
    )
    return solved, out[16 * M], out[16 * M + 1:16 * M + 1 + E]


def _check_timing(timing, size: int, device):
    if timing is not None and (not timing.is_cuda
                               or timing.dtype != torch.int64
                               or timing.numel() < size
                               or not timing.is_contiguous()):
        raise ValueError(f"timing must be a contiguous int64 tensor of at "
                         f"least {size} elements on {device}")


def _raise_on(lib, name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.dvo_error_string(rc).decode()} (CUDA "
                           f"error {rc})")


def optimize_kernel(graph: PoseGraph, iterations: int = 20,
                    use_robust: bool = True, cauchy_c: float = 1.0,
                    gnc_init: float = 1.0, gnc_decay: float = 0.5,
                    gnc_adaptive: bool = False, device="cuda", timing=None):
    """A dense ``optimize`` as one launch of csrc/pose_graph.cu on the
    current stream of the CUDA `device`: the graph and its sum plans go up
    in one non-blocking copy from pinned memory, and nothing is read back
    (no host sync). Sets ``LAST_STEPS`` and ``LAST_STATS``.

    timing: None (the main path), or an int64 tensor of ``4 + 7 *
    iterations`` elements on `device` that the kernel fills with its phase
    stamps (``phase_times`` reads them)."""
    from dvo_slam_tpu_torch import _build

    device = torch.device(device)
    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    if device.type != "cuda" or not 1 <= M <= KERNEL_MAX_VERTICES:
        raise ValueError(f"the graph kernel takes 1 <= M <= "
                         f"{KERNEL_MAX_VERTICES} vertices on a CUDA device, "
                         f"not M = {M} on {device}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    _check_timing(timing, 4 + 7 * iterations, device)
    lib = _build.load()
    with torch.cuda.device(device):
        view = _upload(graph, device, dense=True)
        scratch = torch.empty(max(kernel_plan(M, E)[6], 1),
                              dtype=torch.float32, device=device)
        out, steps = _outputs(M, E, iterations, device)
        rc = lib.dvo_pose_graph(
            *(view[k].data_ptr() for k in ("poses", "Z", "info", "mask",
                                            "edge_i", "edge_j", "v_off",
                                            "v_idx", "d_idx", "b_off",
                                            "b_list")),
            M, E, int(graph.num_vertices), int(iterations), int(use_robust),
            float(cauchy_c), float(gnc_init), float(gnc_decay),
            int(gnc_adaptive), scratch.data_ptr(), out.data_ptr(),
            out[16 * M:].data_ptr(), out[16 * M + 1:].data_ptr(),
            out[16 * M + 1 + E:].data_ptr(), steps.data_ptr(),
            None if timing is None else timing.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "dvo_pose_graph", rc)
    return _solved(graph, view, out, steps, iterations, "cluster")


def grid_timing_size(iterations: int) -> int:
    """Elements of the grid kernel's int64 phase-timing buffer."""
    return 4 + 8 * iterations


def optimize_grid(graph: PoseGraph, iterations: int = 20,
                  use_robust: bool = True, cauchy_c: float = 1.0,
                  gnc_init: float = 1.0, gnc_decay: float = 0.5,
                  gnc_adaptive: bool = False, device="cuda", timing=None,
                  solver: str = "dense"):
    """``optimize`` as one cooperative launch of csrc/pose_graph_grid.cu on
    the current stream of the CUDA `device`, for any M and either solver
    (one CTA a streaming multiprocessor of the card, ``grid_plan``): the
    graph and its sum plans go up in one non-blocking copy from pinned
    memory, the scratch is allocated here, and nothing is read back (no
    host sync). Sets ``LAST_STEPS`` and ``LAST_STATS``; counts the launch in
    ``LAUNCHES_GRID`` and ``LAUNCHES_BY_M``. Raises on a CPU device, on a
    build or launch error, and where the card cannot hold the grid at once;
    it never runs the host loop.

    timing: None (the main path), or an int64 tensor of
    ``grid_timing_size(iterations)`` elements on `device` that the kernel
    fills with its phase stamps and, per step, its CG iterations
    (``grid_phase_times`` reads them)."""
    from dvo_slam_tpu_torch import _build

    device = torch.device(device)
    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    if device.type != "cuda" or M < 1:
        raise ValueError(f"the grid kernel takes M >= 1 vertices on a CUDA "
                         f"device, not M = {M} on {device}")
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    _check_timing(timing, grid_timing_size(iterations), device)
    lib = _build.load()
    dense = solver == "dense"
    with torch.cuda.device(device):
        ctas = _build.sm_count(torch.cuda.current_device())
        plan = grid_plan(M, E, solver, ctas)
        view = _upload(graph, device, dense, grid=dense)
        scratch = torch.empty(plan[5], dtype=torch.float32, device=device)
        bar = torch.zeros(plan[6], dtype=torch.int32, device=device)
        out, steps = _outputs(M, E, iterations, device)
        zeroed = torch.empty(iterations, dtype=torch.int32, device=device)
        names = ("d_idx", "b_off", "b_list", "fill", "units", "col_units")
        rc = lib.dvo_pose_graph_grid(
            *(view[k].data_ptr() for k in ("poses", "Z", "info", "mask",
                                            "edge_i", "edge_j", "v_off",
                                            "v_idx")),
            *((view[k].data_ptr() for k in names)
              if dense else (None,) * len(names)),
            view["units"].numel() if dense else 0,
            M, E, int(graph.num_vertices), int(iterations), int(use_robust),
            float(cauchy_c), float(gnc_init), float(gnc_decay),
            int(gnc_adaptive), SOLVERS.index(solver), ctas,
            scratch.data_ptr(), bar.data_ptr(), out.data_ptr(),
            out[16 * M:].data_ptr(), out[16 * M + 1:].data_ptr(),
            out[16 * M + 1 + E:].data_ptr(), steps.data_ptr(),
            zeroed.data_ptr() if iterations else None,
            None if timing is None else timing.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "dvo_pose_graph_grid", rc)
    return _solved(graph, view, out, steps, iterations, "grid", zeroed)


PHASES = ("edge pass", "assembly", "factorization", "solves", "exp(delta)",
          "trial chi2")
# The grid kernel's CG solves stamp the same boundaries under these names.
PHASES_CG = ("edge pass", "preconditioner", "CG iterations", "step test",
             "exp(delta)", "trial chi2")


def phase_times(timing, steps: int, stride: int = 7, phases=PHASES):
    """A graph kernel's phase split of one solve from its filled ``timing``
    buffer (host numpy int64) and the steps it ran: ({phase: device us per
    LM step}, the launch's device us from its first stamp to its last).
    clock64 stamps are converted to time by the launch's own %globaltimer
    span. `stride`: the buffer's slots a step (7 on the cluster kernel)."""
    t = np.asarray(timing, np.int64)
    ns_per_clock = (t[2] - t[0]) / max(int(t[3] - t[1]), 1)
    stamps = t[4:4 + stride * steps].reshape(steps, stride)[:, :7]
    per_step = (np.diff(stamps.astype(np.float64), axis=1).sum(0)
                * ns_per_clock / 1e3 / max(steps, 1))
    return dict(zip(phases, per_step.tolist())), (t[2] - t[0]) / 1e3


def grid_phase_times(timing, steps: int, solver: str = "dense"):
    """``phase_times`` of the grid kernel's buffer (8 slots a step, the
    last its CG iterations): ({phase: us per step}, the launch's us, [CG
    iterations of each step] (zeros for dense))."""
    t = np.asarray(timing, np.int64)
    split, span = phase_times(t, steps, 8,
                              PHASES if solver == "dense" else PHASES_CG)
    return split, span, t[4:4 + 8 * steps].reshape(steps, 8)[:, 7].tolist()


def optimize_reference(graph: PoseGraph, iterations: int = 20,
                       use_robust: bool = True, cauchy_c: float = 1.0,
                       gnc_init: float = 1.0, gnc_decay: float = 0.5,
                       solver: str = "dense", gnc_adaptive: bool = False,
                       device="cuda"):
    """``optimize`` as a host loop of ``torch`` ops on `device`, for every
    solver and size: the graph kernel's plain version. Each LM step reads
    its stop flag back to the host (one sync). Sets ``LAST_STEPS``,
    ``LAST_STATS`` and ``LAST_ZEROED``."""
    global LAST_STEPS, LAST_STATS, LAST_ZEROED
    device = torch.device(device)
    g0 = to_device(graph, device)
    topo = _topology(graph, device)
    dtype = g0.poses.dtype
    M = g0.poses.shape[0]
    eye = torch.eye(6 * M, dtype=dtype, device=device)

    anneal0 = torch.full((), gnc_init, dtype=dtype, device=device)
    if gnc_adaptive:
        # Start the annealed width at the worst ACTIVE edge's residual
        # scale: c_eff0^2 = max(chi2) => that edge begins at weight 0.5.
        chi2_edges = edge_chi2(g0) * g0.edge_mask.to(dtype)
        anneal0 = torch.maximum(
            anneal0, torch.sqrt(torch.clamp(chi2_edges.max(), min=1.0))
            / cauchy_c)

    g_cur = g0
    lam = torch.full((), 1e-6, dtype=dtype, device=device)
    steps, stats, zeroed = 0, [], []
    for k in range(iterations):
        anneal = torch.clamp(anneal0 * gnc_decay ** k, min=1.0)
        c_eff = cauchy_c * anneal
        if solver == "cg":
            blocks, g, chi2, _ = _build_blocks(g_cur, topo, use_robust, c_eff)
            delta = _solve_cg(g_cur, topo, blocks, lam, -g,
                              maxiter=4 * M).reshape(6 * M)
            ok = torch.isfinite(delta).all()
            why = torch.where(ok, ZEROED_NONE, ZEROED_NOT_FINITE)
        else:
            H, g, chi2, _ = _build_system(g_cur, topo, use_robust, c_eff)
            damped = H + lam * torch.diag(torch.diagonal(H)) + _JITTER * eye
            # cholesky_ex does not raise on a matrix that is not positive
            # definite (JAX's cho_factor gives NaN there): info != 0 makes
            # the step non-finite, and the step is zeroed.
            L, info = torch.linalg.cholesky_ex(damped)
            delta = torch.cholesky_solve(-g[:, None], L)[:, 0]
            ok = (info == 0) & torch.isfinite(delta).all()
            why = torch.where(info != 0, ZEROED_PIVOT, torch.where(
                ok, ZEROED_NONE, ZEROED_NOT_FINITE))
        zeroed.append(why)
        delta = torch.where(ok, delta, 0.0)
        new_poses = _apply_delta(g_cur.poses, delta, g_cur.num_vertices)
        chi2_new = _total_chi2(g_cur._replace(poses=new_poses), use_robust,
                               c_eff)

        accept = chi2_new <= chi2
        g_cur = g_cur._replace(
            poses=torch.where(accept, new_poses, g_cur.poses))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9,
                          1e6)
        step = torch.linalg.vector_norm(delta)
        steps = k + 1
        stats.append((chi2, chi2_new, step, accept))
        # Don't stop while the robust kernel is still annealing.
        if bool(accept & (step < 1e-8) & (anneal <= 1.0)):
            break
    LAST_STEPS = torch.full((), steps, dtype=torch.int32, device=device)
    LAST_STATS = torch.zeros((iterations, 4), dtype=dtype, device=device)
    LAST_ZEROED = torch.full((iterations,), ZEROED_NONE, dtype=torch.int32,
                             device=device)
    if stats:
        LAST_STATS[:steps] = torch.stack(
            [torch.stack(col).to(dtype) for col in zip(*stats)], dim=1)
        LAST_ZEROED[:steps] = torch.stack(zeroed).to(torch.int32)
    _, _, chi2, weights = _build_blocks(g_cur, topo, use_robust, cauchy_c)
    return g_cur, chi2, weights


def edge_chi2(graph: PoseGraph):
    """Per-edge (unweighted) chi^2 of a graph of tensors."""
    P = graph.poses
    e = edge_residual(P[graph.edge_i], P[graph.edge_j], graph.measurements)
    return _chi2(e, graph.information)

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

Two routes (``graph_route``), picked by device, solver and size alone:

- A dense solve of at most ``KERNEL_MAX_VERTICES`` (128) vertices on a
  CUDA device runs as ONE launch of csrc/pose_graph.cu
  (``optimize_kernel``; one CTA up to 32 vertices, a cluster of up to 16
  past that, ``kernel_plan``): the whole LM loop on the card, as the JAX
  ``while_loop`` runs it, with nothing read back to the host. A build or
  launch error raises; nothing falls back.
- Every other call (the CPU, ``solver="cg"``, a dense graph past the
  kernel's limit) runs the plain host loop ``optimize_reference``, the
  kernel's plain version: ``torch`` / ``torch.linalg`` ops, reading its
  stop flag back once per LM step (and the CG loop its stop test once per
  CG step) and exiting where the JAX ``while_loop`` does.

Sums with duplicate indices (the gradient, the block diagonal, the dense
H, the CG matvec) follow a host-built plan in a fixed order, never
``index_add_``: CUDA's atomic scatter-add sums in no fixed order, and two
solves of one graph must give the same bits. The plan depends only on the
topology, which the caller holds on the host; the kernel takes the same
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
# the damped 6M x 6M f32 system in shared memory, a slab of columns each,
# which bounds M (dvo_pose_graph_plan; kernel_plan mirrors it).
KERNEL_MAX_VERTICES = 128
KERNEL_THREADS = 512
_KERNEL_MAX_CLUSTER = 16
_KERNEL_MAX_COLUMNS = 192  # columns a CTA holds
_KERNEL_SMEM_BUDGET = 230_400  # dynamic shared memory bytes a CTA may ask
_KERNEL_EDGE_FLOATS = 42  # per-edge scratch: P (36), gj (6)
# Kernel launches made by optimize_kernel since the last reset (plain
# integer; callers reset it to 0 to count the launches of one run), and
# the same launches by vertex slots M (callers clear it).
LAUNCHES = 0
LAUNCHES_BY_M = {}
# The last solve's LM step count, a 0-d int32 tensor on its device (the
# kernel's output, or the host loop's count), and its per-step statistics,
# (iterations, 4) f32: each step's chi2, trial chi2, step norm and accept
# flag (1 or 0), zero past the last step. For tests and the smoke.
LAST_STEPS = None
LAST_STATS = None


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


def _plan(targets: np.ndarray, size: int, device) -> _Plan:
    targets = np.asarray(targets, np.int64)
    K = targets.shape[0]
    order = np.argsort(targets, kind="stable")
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
    M = graph.poses.shape[0]
    vertex, dense = _plan_targets(graph)
    return _Topology(vertex=_plan(vertex, M, device),
                     dense=_plan(dense, M * M, device))


def _csr(targets: np.ndarray, size: int):
    """A plan as CSR lists: slot s sums values idx[off[s]:off[s + 1]], in
    increasing value index (the order of ``_plan``'s gather rows)."""
    targets = np.asarray(targets, np.int64)
    off = np.zeros(size + 1, np.int32)
    np.cumsum(np.bincount(targets, minlength=size), out=off[1:])
    return off, np.argsort(targets, kind="stable").astype(np.int32)


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


def graph_route(solver: str, M: int, device) -> bool:
    """True where ``optimize`` runs as one launch of csrc/pose_graph.cu: a
    dense solve of at most ``KERNEL_MAX_VERTICES`` vertices on a CUDA
    device. False: the plain host loop ``optimize_reference`` (the CPU,
    ``solver="cg"``, or a dense graph past the kernel's limit)."""
    return (torch.device(device).type == "cuda" and solver == "dense"
            and 1 <= M <= KERNEL_MAX_VERTICES)


def _kernel_shared_bytes(M: int, C: int) -> int:
    n = 6 * M
    w = -(-n // C)
    return 4 * (n * (w + 1) + n + 32 * M + (2 * n if C > 1 else 0))


def kernel_plan(M: int):
    """``(largest M, CTAs per cluster, threads per CTA, dynamic shared
    memory bytes per CTA)`` of the graph kernel at M vertices, as
    csrc/pose_graph.cu's ``dvo_pose_graph_plan`` gives them. One cluster
    per solve, of the fewest CTAs (a power of two up to 16) whose column
    slabs fit: a CTA holds w = ceil(6M / C) <= 192 columns of the damped
    system as 6M rows of w + 1 floats, the right-hand side, two copies of
    the poses and, in a cluster, the pivot column and y (C = 1 up to
    M = 32, 4 at 64, 16 at 128; 0 and 0 bytes past the limit)."""
    C = 0
    if 1 <= M <= KERNEL_MAX_VERTICES:
        C = next((c for c in (1, 2, 4, 8, _KERNEL_MAX_CLUSTER)
                  if -(-6 * M // c) <= _KERNEL_MAX_COLUMNS
                  and _kernel_shared_bytes(M, c) <= _KERNEL_SMEM_BUDGET), 0)
    return (KERNEL_MAX_VERTICES, C, KERNEL_THREADS,
            _kernel_shared_bytes(M, C) if C else 0)


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
    the route: one launch of the graph kernel, which reads nothing back
    to the host (``optimize_kernel``), or the plain host loop, which reads
    its stop flag back once per step (``optimize_reference``).
    Returns (optimized PoseGraph of tensors, final chi2, per-edge robust
    weights at the base cauchy_c), all on the device.
    """
    kw = dict(iterations=iterations, use_robust=use_robust,
              cauchy_c=cauchy_c, gnc_init=gnc_init, gnc_decay=gnc_decay,
              gnc_adaptive=gnc_adaptive, device=device)
    if graph_route(solver, graph.poses.shape[0], device):
        return optimize_kernel(graph, **kw)
    return optimize_reference(graph, solver=solver, **kw)


def _pack(graph: PoseGraph):
    """A host graph and its CSR sum plans as one f32 buffer, int32 arrays
    stored bitwise: (buffer, {name: (offset, length, is_int32)})."""
    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    vertex, dense = _plan_targets(graph)
    v_off, v_idx = _csr(vertex, M)
    d_off, d_idx = _csr(dense, M * M)
    f32 = (lambda x: np.asarray(x, np.float32).ravel())
    i32 = (lambda x: np.asarray(x, np.int32).ravel().view(np.float32))
    parts = {
        "poses": f32(graph.poses), "Z": f32(graph.measurements),
        "info": f32(graph.information), "mask": f32(graph.edge_mask),
        "edge_i": i32(graph.edge_i), "edge_j": i32(graph.edge_j),
        "v_off": i32(v_off), "v_idx": i32(v_idx),
        "d_off": i32(d_off), "d_idx": i32(d_idx),
    }
    at, where = 0, {}
    for name, x in parts.items():
        where[name] = (at, x.size, name.startswith(("edge", "v_", "d_")))
        at += x.size
    return np.concatenate(list(parts.values())), where


def optimize_kernel(graph: PoseGraph, iterations: int = 20,
                    use_robust: bool = True, cauchy_c: float = 1.0,
                    gnc_init: float = 1.0, gnc_decay: float = 0.5,
                    gnc_adaptive: bool = False, device="cuda"):
    """A dense ``optimize`` as one launch of csrc/pose_graph.cu on the
    current stream of the CUDA `device`: the graph and its sum plans go up
    in one non-blocking copy from pinned memory, and nothing is read back
    (no host sync). Sets ``LAST_STEPS`` and ``LAST_STATS``."""
    global LAUNCHES, LAST_STEPS, LAST_STATS
    from dvo_slam_tpu_torch import _build

    device = torch.device(device)
    M, E = graph.poses.shape[0], graph.edge_i.shape[0]
    if device.type != "cuda" or not 1 <= M <= KERNEL_MAX_VERTICES:
        raise ValueError(f"the graph kernel takes 1 <= M <= "
                         f"{KERNEL_MAX_VERTICES} vertices on a CUDA device, "
                         f"not M = {M} on {device}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    lib = _build.load()
    buf, where = _pack(graph)
    host = torch.empty(buf.size, dtype=torch.float32, pin_memory=True)
    host.numpy()[:] = buf
    with torch.cuda.device(device):
        dev = host.to(device, non_blocking=True)
        ints = dev.view(torch.int32)
        view = {k: (ints if is_int else dev)[a:a + n]
                for k, (a, n, is_int) in where.items()}
        scratch = torch.empty(max(E, 1) * _KERNEL_EDGE_FLOATS,
                              dtype=torch.float32, device=device)
        out = torch.empty(16 * M + 1 + E + 4 * iterations,
                          dtype=torch.float32, device=device)
        steps = torch.empty((), dtype=torch.int32, device=device)
        rc = lib.dvo_pose_graph(
            *(view[k].data_ptr() for k in ("poses", "Z", "info", "mask",
                                            "edge_i", "edge_j", "v_off",
                                            "v_idx", "d_off", "d_idx")),
            M, E, int(graph.num_vertices), int(iterations), int(use_robust),
            float(cauchy_c), float(gnc_init), float(gnc_decay),
            int(gnc_adaptive), scratch.data_ptr(), out.data_ptr(),
            out[16 * M:].data_ptr(), out[16 * M + 1:].data_ptr(),
            out[16 * M + 1 + E:].data_ptr(), steps.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dvo_pose_graph failed: "
                           f"{lib.dvo_error_string(rc).decode()} (CUDA "
                           f"error {rc})")
    LAUNCHES += 1
    LAUNCHES_BY_M[M] = LAUNCHES_BY_M.get(M, 0) + 1
    LAST_STEPS = steps
    LAST_STATS = out[16 * M + 1 + E:].view(iterations, 4)
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


def optimize_reference(graph: PoseGraph, iterations: int = 20,
                       use_robust: bool = True, cauchy_c: float = 1.0,
                       gnc_init: float = 1.0, gnc_decay: float = 0.5,
                       solver: str = "dense", gnc_adaptive: bool = False,
                       device="cuda"):
    """``optimize`` as a host loop of ``torch`` ops on `device`, for every
    solver and size: the graph kernel's plain version. Each LM step reads
    its stop flag back to the host (one sync). Sets ``LAST_STEPS`` and
    ``LAST_STATS``."""
    global LAST_STEPS, LAST_STATS
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
    steps, stats = 0, []
    for k in range(iterations):
        anneal = torch.clamp(anneal0 * gnc_decay ** k, min=1.0)
        c_eff = cauchy_c * anneal
        if solver == "cg":
            blocks, g, chi2, _ = _build_blocks(g_cur, topo, use_robust, c_eff)
            delta = _solve_cg(g_cur, topo, blocks, lam, -g,
                              maxiter=4 * M).reshape(6 * M)
            ok = torch.isfinite(delta).all()
        else:
            H, g, chi2, _ = _build_system(g_cur, topo, use_robust, c_eff)
            damped = H + lam * torch.diag(torch.diagonal(H)) + _JITTER * eye
            # cholesky_ex does not raise on a matrix that is not positive
            # definite (JAX's cho_factor gives NaN there): info != 0 makes
            # the step non-finite, and the step is zeroed.
            L, info = torch.linalg.cholesky_ex(damped)
            delta = torch.cholesky_solve(-g[:, None], L)[:, 0]
            ok = (info == 0) & torch.isfinite(delta).all()
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
    if stats:
        LAST_STATS[:steps] = torch.stack(
            [torch.stack(col).to(dtype) for col in zip(*stats)], dim=1)
    _, _, chi2, weights = _build_blocks(g_cur, topo, use_robust, cauchy_c)
    return g_cur, chi2, weights


def edge_chi2(graph: PoseGraph):
    """Per-edge (unweighted) chi^2 of a graph of tensors."""
    P = graph.poses
    e = edge_residual(P[graph.edge_i], P[graph.edge_j], graph.measurements)
    return _chi2(e, graph.information)

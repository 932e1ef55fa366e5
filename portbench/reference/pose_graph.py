"""Plain pose-graph solve: Levenberg-Marquardt on SE(3) edges with a
Cauchy kernel (g2o's EdgeSE3 with a robust kernel, as DVO-SLAM's keyframe
graph runs it), dense normal equations, vertex 0 held by a strong prior.

An edge (i, j) measures Z = T_i^-1 T_j (world <- camera poses); its
residual is e = log(Z^-1 T_i^-1 T_j) and its Cauchy weight 1 / (1 +
e' info e / c^2), recomputed every step (iteratively re-weighted least
squares). A step is kept when the weighted chi2 does not rise.

``polish`` starts from given poses and runs the annealed solve to its
end: from a solution of the same graph it moves the poses little, from
poses the solve never reached (drift left in, or a solve that returned
its start) it moves them by the drift.
"""

from __future__ import annotations

import torch

from portbench.reference import se3
from portbench.reference.precision import mm

_GAUGE = 1e6
_JITTER = 1e-6


def _jl_inv(xi):
    """Inverse left Jacobian of SE(3) at (E, 6) twists (Barfoot, State
    Estimation for Robotics, eqs. 7.86 and 7.95), Taylor branches at small
    angles."""
    rho, phi = xi[:, :3], xi[:, 3:]
    t2 = (phi * phi).sum(-1)
    small = t2 < 1e-4
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    s, c = torch.sin(t), torch.cos(t)
    k = torch.where(small, 1 / 12 + t2 / 720, 1 / t2s - (1 + c) / (2 * t * s))
    a = torch.where(small, 1 / 6 - t2 / 120, (t - s) / (t2s * t))
    b = torch.where(small, 1 / 24 - t2 / 720,
                    (t2s + 2 * c - 2) / (2 * t2s * t2s))
    d = torch.where(small, 1 / 120 - t2 / 2520,
                    (2 * t - 3 * s + t * c) / (2 * t2s * t2s * t))
    Phi, P = se3.hat(phi), se3.hat(rho)
    PhiP, PPhi = mm(Phi, P), mm(P, Phi)
    PhiPPhi = mm(PhiP, Phi)

    def co(x):
        return x[:, None, None]

    Q = (0.5 * P + co(a) * (PhiP + PPhi + PhiPPhi)
         + co(b) * (mm(Phi, PhiP) + mm(PPhi, Phi) - 3.0 * PhiPPhi)
         + co(d) * (mm(PhiPPhi, Phi) + mm(Phi, PhiPPhi)))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(Phi.shape)
    J3 = eye - 0.5 * Phi + co(k) * mm(Phi, Phi)
    top = torch.cat([J3, -mm(mm(J3, Q), J3)], dim=-1)
    return torch.cat([top, torch.cat([torch.zeros_like(J3), J3], -1)], -2)


def _terms(P, ei, ej, Z, info, w_mask, c):
    e = se3.log(mm(mm(se3.inverse(Z), se3.inverse(P[ei])), P[ej]))
    chi2 = torch.einsum("ea,eab,eb->e", e, info, e)
    w = w_mask / (1.0 + chi2 / (c * c))
    return e, chi2, w


def _step(P, ei, ej, Z, info, mask, c, lam):
    M = P.shape[0]
    e, chi2, w = _terms(P, ei, ej, Z, info, mask, c)
    Jj = mm(_jl_inv(e), se3.adjoint(mm(se3.inverse(Z), se3.inverse(P[ei]))))
    Ji = -Jj
    winfo = w[:, None, None] * info
    H = torch.zeros(M, M, 6, 6, dtype=P.dtype, device=P.device)
    g = torch.zeros(M, 6, dtype=P.dtype, device=P.device)
    for a, Ja in ((ei, Ji), (ej, Jj)):
        g.index_add_(0, a, mm(Ja.transpose(-1, -2),
                              mm(winfo, e[..., None]))[..., 0])
        for b, Jb in ((ei, Ji), (ej, Jj)):
            H.index_put_((a, b), mm(mm(Ja.transpose(-1, -2), winfo), Jb),
                         accumulate=True)
    H = H.transpose(1, 2).reshape(6 * M, 6 * M)
    H[:6, :6] += _GAUGE * torch.eye(6, dtype=P.dtype, device=P.device)
    damped = H + lam * torch.diag(torch.diagonal(H)) + _JITTER * torch.eye(
        6 * M, dtype=P.dtype, device=P.device)
    delta = torch.linalg.solve(damped, -g.reshape(6 * M)).reshape(M, 6)
    return delta, (w * chi2).sum()


def polish(poses, edge_i, edge_j, Z, info, mask, cauchy_c=1.0,
           iterations=100, gnc_init=16.0, dtype=torch.float64,
           device="cpu"):
    """Run the solve from ``poses`` (M, 4, 4) on the graph's edges (mask
    False: left out). Returns the solved poses in ``dtype``.

    The kernel's width is annealed (graduated non-convexity, as DVO-SLAM's
    solves run): it starts at the larger of ``gnc_init`` and the worst
    edge's residual scale (that edge at weight 1/2), halves every step and
    stops at ``cauchy_c``; a step is kept when it does not raise the
    weighted chi2 at the step's width. From a start whose loop edges are
    far off (drift left unsolved) the wide kernel pulls them in, where a
    plain Cauchy kernel would take them for outliers and stay."""
    kw = {"dtype": dtype, "device": device}
    P = torch.as_tensor(poses, **kw)
    ei = torch.as_tensor(edge_i, dtype=torch.int64, device=device)
    ej = torch.as_tensor(edge_j, dtype=torch.int64, device=device)
    Z = torch.as_tensor(Z, **kw)
    info = torch.as_tensor(info, **kw)
    mask = torch.as_tensor(mask, **kw)
    lam = 1e-6
    tiny = 1e-12 if dtype == torch.float64 else 1e-8
    chi2_0 = _terms(P, ei, ej, Z, info, mask, cauchy_c)[1] * mask
    anneal0 = max(gnc_init,
                  float(torch.sqrt(torch.clamp(chi2_0.max(), min=1.0)))
                  / cauchy_c)
    for k in range(iterations):
        anneal = max(anneal0 * 0.5 ** k, 1.0)
        c = cauchy_c * anneal
        delta, chi2 = _step(P, ei, ej, Z, info, mask, c, lam)
        if not bool(torch.isfinite(delta).all()):
            break
        P_new = mm(se3.exp(delta), P)
        t = _terms(P_new, ei, ej, Z, info, mask, c)
        accept = bool((t[2] * t[1]).sum() <= chi2)
        if accept:
            P = P_new
        lam = min(max(lam * (0.5 if accept else 4.0), 1e-9), 1e6)
        if (accept and anneal <= 1.0
                and float(torch.linalg.vector_norm(delta)) < tiny):
            break
    return P

"""Plain dense RGB-D tracker: coarse-to-fine iteratively re-weighted
Gauss-Newton on the bivariate photometric and geometric error with the
bivariate t-distribution's scale fixed point (Kerl, Sturm, Cremers, ICRA
2013; dvo_core's DenseTracker), over B pairs at once.

Per point every quantity is float32. The sums over points (the valid
count, the residual moments of each scale step, the log-likelihood terms
and the 6x6 normal equations) accumulate in ``sums``: float64 states what
the configurations run, float32 is the control one step below it. The
acceptance test, the scale, the solve and the entropy take the sums'
dtype; poses stay float32.

Only what the benchmark's configurations set is implemented: the
t-distribution scale and weights, both residuals, gradients of the current
frame, Gauss-Newton with rollback, no motion prior and every selected
pixel. ``Settings.of`` refuses any other configuration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import se3
from portbench.reference.precision import mm, tf32

_EPS = 1e-12
_JITTER = 1e-8
LOG_TWO_PI_E = math.log(2.0 * math.pi * math.e)


class Settings(NamedTuple):
    levels: tuple  # tracked levels, coarse to fine
    num_levels: int
    max_iterations: int
    precision: float
    dof: float
    scale_iters: int
    floor_i: float
    floor_z: float

    @classmethod
    def of(cls, tracker: dict):
        """From a configuration's ``tracker`` section (TrackerConfig's
        fields), refusing what this reference does not implement."""
        need = {"use_weighting": True, "scale_estimator": "tdist",
                "influence": "tdist", "use_depth": True,
                "gradient_source": "current", "mu": 0.0,
                "lm_lambda_init": 0.0, "tdist_scale_warm_iters": 0,
                "point_budget_fraction": 0.0,
                "intensity_grad_threshold": 0.0,
                "depth_grad_threshold": 0.0}
        for key, want in need.items():
            if tracker[key] != want:
                raise ValueError(f"the reference tracker needs {key} = "
                                 f"{want!r}, got {tracker[key]!r}")
        return cls(
            tuple(range(tracker["first_level"], tracker["last_level"] - 1,
                        -1)),
            tracker["num_levels"], tracker["max_iterations"],
            tracker["precision"], tracker["tdist_dof"],
            tracker["tdist_scale_iters"], tracker["min_intensity_sigma"],
            tracker["min_depth_sigma"])


def level_intrinsics(K, levels):
    """Per level (fx, fy, cx, cy) as float32 tensors: a full-resolution
    pixel centre u maps to (u + 0.5) s - 0.5 at scale s."""
    K = torch.as_tensor(K, dtype=torch.float32)
    out = []
    for lvl in range(levels):
        s = 0.5 ** lvl
        fx, fy, cx, cy = K.unbind()
        out.append(torch.stack([fx * s, fy * s, (cx + 0.5) * s - 0.5,
                                (cy + 0.5) * s - 0.5]))
    return out


def points(ref, K):
    """Back-projected reference pixels of (B, 6, H, W) slabs: (px, py, pz,
    i1, selected), each (B, N); a pixel is selected where its depth is
    finite."""
    B, _, H, W = ref.shape
    fx, fy, cx, cy = K.to(ref.device).unbind()
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                       device=ref.device),
                          torch.arange(W, dtype=torch.float32,
                                       device=ref.device), indexing="ij")
    u, v = u.reshape(-1), v.reshape(-1)
    z = ref[:, 1].reshape(B, H * W)
    sel = torch.isfinite(z)
    zs = torch.where(sel, z, torch.ones_like(z))
    return ((u - cx) / fx * zs, (v - cy) / fy * zs, zs,
            ref[:, 0].reshape(B, H * W), sel)


def _sample(cur, u, v):
    """Bilinear samples (B, 6, N) of (B, 6, H, W) slabs at (B, N) points,
    and whether the whole 2x2 footprint lies inside."""
    B, C, H, W = cur.shape
    N = u.shape[-1]
    u0, v0 = torch.floor(u), torch.floor(v)
    inb = (u0 >= 0) & (v0 >= 0) & (u0 <= W - 2) & (v0 <= H - 2)
    zero = torch.zeros_like(u0)
    x0 = torch.where(u0 >= 0, torch.clamp(u0, max=W - 2), zero)
    y0 = torch.where(v0 >= 0, torch.clamp(v0, max=H - 2), zero)
    fu, fv = (u - x0)[:, None], (v - y0)[:, None]
    base = y0.to(torch.int64) * W + x0.to(torch.int64)
    corners = torch.tensor([0, 1, W, W + 1], device=u.device)
    idx = (base[:, None, :] + corners[None, :, None]).reshape(B, 1, 4 * N)
    s = torch.gather(cur.reshape(B, C, H * W), 2,
                     idx.expand(B, C, 4 * N)).reshape(B, C, 4, N)
    s00, s01, s10, s11 = s.unbind(2)
    top = s00 + fu * (s01 - s00)
    bot = s10 + fu * (s11 - s10)
    return top + fv * (bot - top), inb


def linearize(pts, cur, K, T, st: Settings, sums):
    """One linearization of B rows at poses T (B, 4, 4) float32: a dict of
    the normal equations A (B, 6, 6) and b (B, 6), the acceptance error,
    the valid count and the scale, in the sums' dtype."""
    px, py, pz, i1, sel = pts
    fx, fy, cx, cy = K.to(T.device).unbind()
    R = T[:, :3, :3]
    t = T[:, :3, 3]

    def r(i, j):
        return R[:, i, j][:, None]

    X = r(0, 0) * px + r(0, 1) * py + r(0, 2) * pz + t[:, 0:1]
    Y = r(1, 0) * px + r(1, 1) * py + r(1, 2) * pz + t[:, 1:2]
    Z = r(2, 0) * px + r(2, 1) * py + r(2, 2) * pz + t[:, 2:3]
    zi = 1.0 / torch.where(Z.abs() < 1e-8,
                           torch.where(Z < 0, -1e-8, 1e-8), Z)
    smp, inb = _sample(cur, fx * X * zi + cx, fy * Y * zi + cy)
    i2, z2 = smp[:, 0], smp[:, 1]
    grads = smp[:, 2:]  # dI/dx, dI/dy, dZ/dx, dZ/dy
    rI = i2 - i1
    rZ = z2 - Z
    valid = (sel & inb & (Z > 1e-6) & torch.isfinite(rI)
             & torch.isfinite(rZ) & torch.isfinite(grads[:, 2:]).all(1))
    vF = valid.to(torch.float32)
    r2 = torch.where(valid[:, None], torch.stack([rI, rZ], 1), 0.0)
    rI, rZ = r2[:, 0], r2[:, 1]

    def S(x):
        return x.to(sums).sum(-1)

    n_raw = S(vF)
    n = torch.clamp(n_raw, min=1.0)
    m = torch.stack([rI * rI, rI * rZ, rZ * rZ], 1)  # (B, 3, N)
    floor = torch.tensor([st.floor_i ** 2, 0.0, st.floor_z ** 2],
                         dtype=sums, device=T.device)
    nu = st.dof

    def scale(w):
        return S(m if w is None else w[:, None] * m) / n[:, None] + floor

    def weights(sig):
        a, bq, c = sig.to(torch.float32)[:, :, None].unbind(1)
        det = torch.clamp(a * c - bq * bq, min=_EPS)
        maha = (c * m[:, 0] - 2.0 * bq * m[:, 1] + a * m[:, 2]) / det
        return det, maha, (nu + 2.0) / (nu + maha) * vF

    sig = scale(None)
    for _ in range(st.scale_iters):
        sig = scale(weights(sig)[2])
    det32, maha, w = weights(sig)
    log1p_sum = S(torch.log1p(maha / nu) * vF)
    a, bq, c = sig.unbind(1)
    det = torch.clamp(a * c - bq * bq, min=_EPS)
    err = 0.5 * torch.log(det) + (nu + 2.0) / 2.0 * log1p_sum / n

    # Analytic Jacobian of the projection and of the warped depth.
    A_, B_ = fx * zi, fy * zi
    C_, D_ = -fx * X * zi * zi, -fy * Y * zi * zi
    o = torch.zeros_like(A_)
    Ju = torch.stack((A_, o, C_, C_ * Y, A_ * Z - C_ * X, -A_ * Y), 1)
    Jv = torch.stack((o, B_, D_, -B_ * Z + D_ * Y, -D_ * X, B_ * X), 1)
    Jz = torch.stack((o, o, torch.ones_like(Z), Y, -X, o), 1)
    g = torch.where(valid[:, None], grads, 0.0)
    JI = g[:, 0:1] * Ju + g[:, 1:2] * Jv
    JZ = torch.where(valid[:, None], g[:, 2:3] * Ju + g[:, 3:4] * Jv - Jz,
                     0.0)
    sig32 = sig.to(torch.float32)
    p00 = (sig32[:, 2:3] / det32[:, 0:1])[:, :, None]
    p01 = (-sig32[:, 1:2] / det32[:, 0:1])[:, :, None]
    p11 = (sig32[:, 0:1] / det32[:, 0:1])[:, :, None]
    w3 = w[:, None]
    GI = w3 * p00 * JI + w3 * p01 * JZ
    GZ = w3 * p01 * JI + w3 * p11 * JZ
    JI, JZ, GI, GZ = (tf32(x) for x in (JI, JZ, GI, GZ))
    A = S(JI[:, :, None] * GI[:, None] + JZ[:, :, None] * GZ[:, None])
    # The upper triangle's sums, mirrored (A is symmetric).
    A = torch.triu(A) + torch.triu(A, 1).transpose(-1, -2)
    b = S(GI * tf32(rI)[:, None] + GZ * tf32(rZ)[:, None])
    return {"A": A, "b": b, "err": err, "n_raw": n_raw,
            "log1p": log1p_sum, "sigma": sig}


def solve(A, b):
    """Gauss-Newton step of A x = -b (Jacobi-scaled Cholesky) for (B, 6, 6)
    systems, NaN where A is not positive definite. On the host in numpy,
    in the systems' dtype: a batch of 6x6 factorizations is a few
    microseconds there and far longer as solver launches on the card."""
    A_h = A.detach().cpu().numpy()
    b_h = b.detach().cpu().numpy()
    diag = np.diagonal(A_h, axis1=-2, axis2=-1)
    s = 1.0 / np.sqrt(np.maximum(diag + _JITTER, _JITTER))
    As = (A_h + _JITTER * np.eye(6, dtype=A_h.dtype)) * s[:, :, None] \
        * s[:, None, :]
    dx = np.full(b_h.shape, np.nan, dtype=b_h.dtype)
    for r in range(len(As)):
        try:
            L = np.linalg.cholesky(As[r])
        except np.linalg.LinAlgError:
            continue
        y = np.linalg.solve(L, -b_h[r] * s[r])
        dx[r] = np.linalg.solve(L.T, y) * s[r]
    return torch.as_tensor(dx, device=A.device)


def _select(mask, new, old):
    return {k: torch.where(mask.reshape(-1, *([1] * (v.dim() - 1))), v,
                           old[k]) for k, v in new.items()}


def track_level(pts, cur, K, T_init, st: Settings, sums):
    """One level's IRLS loop over B rows in lockstep: the pose of each
    row's last accepted evaluation, that evaluation, and the iterations
    each row ran. A row stops when its error rises (the step is rolled
    back), its step is shorter than the precision, or fewer than 6 points
    are valid."""
    B = T_init.shape[0]
    dev = T_init.device
    T_cur = T_best = T_init
    best = None
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    for k in range(st.max_iterations):
        lin = linearize(pts, cur, K, T_cur, st, sums)
        if best is None:
            accept = torch.ones(B, dtype=torch.bool, device=dev)
            T_base, new_best = T_cur, lin
        else:
            accept = lin["err"] <= best["err"]
            T_base = torch.where(accept[:, None, None], T_cur, T_best)
            new_best = _select(accept, lin, best)
        delta = solve(new_best["A"], new_best["b"])
        delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True),
                            delta, torch.zeros_like(delta))
        T_next = mm(se3.exp(delta.to(torch.float32)), T_base)
        stop = ((~accept) | (torch.linalg.vector_norm(delta, dim=-1)
                             < st.precision) | (new_best["n_raw"] < 6))
        if best is not None:
            live = ~done
            T_next = torch.where(live[:, None, None], T_next, T_cur)
            T_base = torch.where(live[:, None, None], T_base, T_best)
            new_best = _select(live, new_best, best)
            stop = stop | done
        iters += (~done).to(torch.int64)
        T_cur, T_best, best = T_next, T_base, new_best
        done = stop
        if bool(done.all()):
            break
    return T_best, best, iters


def track(ref, cur, Ks, T_init, st: Settings, sums=torch.float64):
    """Coarse-to-fine tracking of B pairs: ref and cur are per-level
    (B, 6, H, W) slabs (a (6, H, W) current slab is shared by the rows),
    T_init (B, 4, 4) maps reference camera coordinates to the current
    camera's. Returns a dict: T (B, 4, 4) float32, information (B, 6, 6)
    and entropy (B,) in the sums' dtype, valid_ratio (B,), nan (B,)
    bool, iterations (B, levels)."""
    T = T_init.to(torch.float32)
    B = T.shape[0]
    iters = []
    for lvl in st.levels:
        c = cur[lvl]
        if c.dim() == 3:
            c = c.expand(B, *c.shape)
        pts = points(ref[lvl], Ks[lvl])
        T, best, its = track_level(pts, c, Ks[lvl], T, st, sums)
        iters.append(its)
    info = best["A"]
    logdet = torch.as_tensor(
        np.linalg.slogdet(info.detach().cpu().numpy())[1], device=T.device)
    entropy = 0.5 * (6.0 * LOG_TWO_PI_E - logdet)
    a, bq, c = best["sigma"].unbind(-1)
    det = torch.clamp(a * c - bq * bq, min=_EPS)
    nu = st.dof
    log_norm = (math.lgamma((nu + 2.0) / 2.0) - math.lgamma(nu / 2.0)
                - math.log(nu * math.pi) - 0.5 * torch.log(det))
    loglik = (torch.clamp(best["n_raw"], min=1.0) * log_norm
              - (nu + 2.0) / 2.0 * best["log1p"])
    n_sel = pts[4].sum(-1).to(best["n_raw"].dtype)
    nan = ~(torch.isfinite(T).all(-1).all(-1) & torch.isfinite(loglik))
    return {"T": T, "information": info, "entropy": entropy,
            "valid_ratio": best["n_raw"] / torch.clamp(n_sel, min=1.0),
            "nan": nan, "iterations": torch.stack(iters, 1)}

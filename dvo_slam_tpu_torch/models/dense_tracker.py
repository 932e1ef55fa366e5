"""Dense RGB-D tracker: coarse-to-fine robust IRLS image alignment
(counterpart of ``dvo_slam_tpu/models/dense_tracker.py``; reference
DenseTracker::match).

The JAX package runs each level's IRLS loop as a ``lax.while_loop`` on the
device. Here it is a host loop over device tensors with the same carry
semantics: every carried quantity is updated with ``torch.where`` on the
device, and the loop reads one boolean back (``done.item()``) per
iteration. Gauss-Newton rollback (lambda = 0: revert and stop) and
adaptive Levenberg-Marquardt (lambda > 0) share that one path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.ops import least_squares, linearize as lin_ops, se3

# Termination reasons, per level (reference IterationStats/LevelStats).
TERM_ITERATIONS = 0  # hit max_iterations
TERM_INCREMENT = 1  # ||delta_xi|| < precision
TERM_ERROR_INCREASED = 2  # GN rollback
TERM_TOO_FEW_CONSTRAINTS = 3  # < 6 valid constraints


class TrackStats(NamedTuple):
    """Per-iteration statistics, (num_tracked_levels, max_iterations) and
    coarse level first; entries past iterations[level] are zero."""

    valid: torch.Tensor  # valid constraint count at each evaluation
    error: torch.Tensor  # acceptance NLL of each evaluation
    delta_norm: torch.Tensor  # ||delta_xi|| of each solved increment
    accepted: torch.Tensor  # bool: evaluation accepted (vs rolled back)
    termination: torch.Tensor  # (num_tracked_levels,) int32 TERM_* codes
    # Points masked by the TPU sampler's row window: constant zeros here.
    window_miss: torch.Tensor = None


class TrackResult(NamedTuple):
    """Equivalent of DenseTracker::Result."""

    transformation: torch.Tensor  # (4, 4) ref-cam -> cur-cam
    information: torch.Tensor  # (6, 6) JtWJ at convergence
    log_likelihood: torch.Tensor  # scalar, bivariate t log-likelihood
    entropy: torch.Tensor  # scalar, 0.5 ln((2 pi e)^6 det A^{-1})
    error: torch.Tensor  # scalar, acceptance error (finest level)
    sigma: torch.Tensor  # (2, 2) final residual scale matrix
    valid_pixels: torch.Tensor  # scalar, valid constraints at finest level
    valid_ratio: torch.Tensor  # valid / selected at finest level
    iterations: torch.Tensor  # (num_tracked_levels,) int32
    level_errors: torch.Tensor  # (num_tracked_levels,)
    stats: Optional[TrackStats] = None  # cfg.collect_stats
    # TPU window-miss fraction and gather escalation flag: always 0 and
    # False here (the gather kernel has no window); kept for the same API.
    window_miss_frac: torch.Tensor = 0.0
    escalated: torch.Tensor = False

    def is_nan(self):
        """Reference Result::isNaN; reduces only the matrix axes. Works on
        tensors and on convert.result_to_numpy's arrays."""
        T = torch.as_tensor(self.transformation)
        t_ok = torch.isfinite(T).all(dim=-1).all(dim=-1)
        return ~(t_ok & torch.isfinite(torch.as_tensor(self.log_likelihood)))


def pose_entropy(information):
    """H = 0.5 * ln((2 pi e)^6 det(information^{-1})), from log|det|."""
    logdet = torch.linalg.slogdet(information).logabsdet
    return 0.5 * (6.0 * math.log(2.0 * math.pi * math.e) - logdet)


_ENTROPY_DENOM_FLOOR = 1.0


def entropy_ratio(h_cur: float, h_ref: float) -> float:
    """Sign-safe entropy ratio (reference
    TrackingResultEvaluation::ratioWithFirst): degradation gives a smaller
    ratio for either sign of the entropies."""
    h_cur = float(h_cur)
    h_ref = float(h_ref)
    if not (np.isfinite(h_cur) and np.isfinite(h_ref)):
        return -np.inf  # conservative: treat unknown quality as degraded
    return 1.0 - (h_cur - h_ref) / max(abs(h_ref), _ENTROPY_DENOM_FLOOR)


# The accepted linearization's fields, carried as one (50,) vector so one
# torch.where per iteration keeps them all: offsets of A (36), b (6),
# err_mean, err_raw, sigma (4), n_raw and log1p_sum.
_A, _B, _ERR, _ERR_RAW, _SIGMA, _N_RAW, _LOG1P = 0, 36, 42, 43, 44, 48, 49


def _flat(lin):
    return torch.cat([lin.A.reshape(36), lin.b, lin.err_mean.reshape(1),
                      lin.err_raw.reshape(1), lin.sigma.reshape(4),
                      lin.n_raw.reshape(1), lin.log1p_sum.reshape(1)])


def _track_level(ref_data, cur_slab, K, T_init, cfg: TrackerConfig):
    """IRLS loop for one pyramid level. Returns (T, Linearization of the
    last accepted evaluation, stats dict)."""
    dtype, dev = T_init.dtype, T_init.device
    use_lm = cfg.lm_lambda_init > 0.0
    if cfg.mu > 0.0:
        eye6 = torch.eye(6, dtype=dtype, device=dev)

    T_cur = T_best = T_init
    best = None  # _flat of the last accepted linearization
    sigma_best = None
    # torch.full, not torch.tensor: no host-to-device copy and sync.
    lam = torch.full((), cfg.lm_lambda_init if use_lm else 0.0, dtype=dtype,
                     device=dev)
    # Per-iteration stats (valid, error, delta_norm, accepted), stacked and
    # zero-padded to max_iterations after the loop.
    per_iter = ([], [], [], [])

    k = 0
    while True:
        # Warm-start the scale fixed point from the last accepted Sigma.
        lin = lin_ops.linearize(ref_data, cur_slab, K, T_cur, cfg,
                                sigma_init=sigma_best, sigma_warm=k > 0)
        # Accepted state (reference Revertable<T>: keep best, revert else).
        if k == 0:
            accept = torch.ones((), dtype=torch.bool, device=dev)
            T_base = T_cur
            best = _flat(lin)
        else:
            accept = lin.err_mean <= best[_ERR]
            T_base = torch.where(accept, T_cur, T_best)
            best = torch.where(accept, _flat(lin), best)
        A_best = best[_A:_B].view(6, 6)
        b_best = best[_B:_ERR]
        sigma_best = best[_SIGMA:_N_RAW].view(2, 2)
        n_valid_best = best[_N_RAW]

        if use_lm:
            lam = torch.where(
                accept,
                torch.clamp(lam * cfg.lm_lambda_down, min=1e-12),
                torch.clamp(lam * cfg.lm_lambda_up, max=cfg.lm_lambda_max),
            )
            rejected_stop = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            # Pure GN: error increase => revert and stop.
            rejected_stop = ~accept

        A_solve, b_solve = A_best, b_best
        if cfg.mu > 0.0:
            # Motion prior on the solve operands only; the carried A/b stay
            # the pure data term (else each rejection stacks another mu*I).
            xi_prior = se3.log(T_base @ se3.inverse(T_init))
            A_solve = A_best + cfg.mu * eye6
            b_solve = b_best + cfg.mu * xi_prior
        delta = least_squares.solve(A_solve, b_solve, lam)
        # All finite <=> x * 0 == 0 everywhere (inf * 0 and NaN * 0 are NaN).
        delta = torch.where((delta * 0.0 == 0.0).all(), delta, 0.0)
        T_next = se3.exp(delta) @ T_base
        delta_norm = torch.linalg.vector_norm(delta)

        converged = delta_norm < cfg.precision
        too_few = n_valid_best < 6
        if cfg.collect_stats:
            for acc, x in zip(per_iter, (lin.n_raw, lin.err_mean, delta_norm,
                                         accept)):
                acc.append(x)
        T_cur, T_best = T_next, T_base
        k += 1
        if k >= cfg.max_iterations:
            break
        if bool((rejected_stop | converged | too_few).item()):
            break

    stats = {"iterations": k, "error": best[_ERR]}
    if cfg.collect_stats:
        # The last iteration's reason; first matching wins (priority
        # mirrors the stop test).
        term = torch.where(
            rejected_stop, TERM_ERROR_INCREASED,
            torch.where(too_few, TERM_TOO_FEW_CONSTRAINTS,
                        torch.where(converged, TERM_INCREMENT,
                                    TERM_ITERATIONS)),
        ).to(torch.int32)
        pad = cfg.max_iterations - k
        stats["per_iter"] = (
            *(torch.nn.functional.pad(torch.stack(x), (0, pad))
              for x in per_iter[:3]),
            torch.cat([torch.stack(per_iter[3]),
                       torch.zeros(pad, dtype=torch.bool, device=dev)]),
            term,
        )
    A_final = A_best
    if cfg.mu > 0.0:
        # Posterior information: data term + the prior's mu*I, added once.
        A_final = A_final + cfg.mu * eye6
    final = lin_ops.Linearization(
        A=A_final, b=b_best, err_mean=best[_ERR],
        n_valid=torch.clamp(n_valid_best, min=1.0), n_raw=n_valid_best,
        sigma=sigma_best, log1p_sum=best[_LOG1P], err_raw=best[_ERR_RAW],
    )
    return T_best, final, stats


def track(ref_pyr, cur_pyr, Ks, T_init, cfg: TrackerConfig) -> TrackResult:
    """Align the current frame to the reference frame (DenseTracker::match).

    ref_pyr / cur_pyr: tuples of per-level (6, H, W) slabs (finest first)
    from ops.pyramid.build_pyramid; Ks: tuple of per-level (4,)
    intrinsics; T_init: (4, 4) f32 initial estimate (reference cam ->
    current cam), all on one device.
    """
    T = T_init
    dev, dtype = T_init.device, T_init.dtype
    levels = cfg.tracked_levels  # coarse -> fine
    level_data = {lvl: lin_ops.prepare_reference(ref_pyr[lvl], Ks[lvl], cfg)
                  for lvl in levels}

    iters, errs, per_iter = [], [], []
    fin = None
    for lvl in levels:
        T, fin, stats = _track_level(level_data[lvl], cur_pyr[lvl], Ks[lvl],
                                     T, cfg)
        iters.append(stats["iterations"])
        errs.append(stats["error"])
        if cfg.collect_stats:
            per_iter.append(stats["per_iter"])

    # Information / log-likelihood come from the finest level's last
    # accepted linearization (T is that pose).
    loglik = lin_ops.tdist_loglik(fin, cfg)
    n_selected = level_data[levels[-1]].selected.sum().to(dtype)
    information = fin.A
    zero = torch.zeros((), dtype=dtype, device=dev)

    track_stats = None
    if cfg.collect_stats:
        track_stats = TrackStats(
            valid=torch.stack([p[0] for p in per_iter]),
            error=torch.stack([p[1] for p in per_iter]),
            delta_norm=torch.stack([p[2] for p in per_iter]),
            accepted=torch.stack([p[3] for p in per_iter]),
            termination=torch.stack([p[4] for p in per_iter]),
            window_miss=torch.zeros((len(levels), cfg.max_iterations),
                                    dtype=dtype, device=dev),
        )

    return TrackResult(
        transformation=T,
        information=information,
        log_likelihood=loglik,
        entropy=pose_entropy(information),
        error=fin.err_mean,
        sigma=fin.sigma,
        valid_pixels=fin.n_raw,
        valid_ratio=fin.n_raw / torch.clamp(n_selected, min=1.0),
        iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
        level_errors=torch.stack(errs),
        stats=track_stats,
        window_miss_frac=zero,
        escalated=torch.zeros((), dtype=torch.bool, device=dev),
    )

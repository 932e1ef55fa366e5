"""Dense RGB-D tracker: coarse-to-fine robust IRLS image alignment
(counterpart of ``dvo_slam_tpu/models/dense_tracker.py``; reference
DenseTracker::match).

The JAX package runs each level's IRLS loop as a ``lax.while_loop`` on the
device, and batches pairs with ``jax.vmap`` over it. ``track_level`` runs
one level for B rows:

- on a CUDA slab with ``linearize.level_route(cfg)`` (the t-distribution,
  no motion prior): one launch of the cluster kernel's mode (b)
  (csrc/linearize.cu), one cluster per row, the whole loop on the card
  and no host sync (``_track_level_kernel``);
- elsewhere: ``_track_level``, one host loop per level over (B, ...)
  device tensors with the same carry semantics: every carried quantity is
  updated with ``torch.where`` on the device, every row is linearized in
  every iteration (one batched call), a row whose stop test has fired
  keeps its carry frozen, and the loop reads the rows' done flags back
  once per iteration. Over ``linearize_batched_reference`` it is the
  plain version of mode (b).

``track`` is ``track_batched`` at B = 1. Gauss-Newton rollback
(lambda = 0: revert and stop) and adaptive Levenberg-Marquardt
(lambda > 0) share both paths.

Pixel sharding (parallel/sharded.py; the JAX package's ``axis_name``):
with a ``pixel_group``, a ``torch.distributed`` process group whose ranks
each hold a band of the reference rows, each rank prepares its rows at
``row_offset = rank * rows``, and where ``linearize.pixel_route(group)``
holds (more than one rank) every level runs the host loop over
``linearize_batched_reference`` with each sum all-reduced over the group
(on the card gathering through csrc/sampler.cu): neither kernel mode can
reduce across processes inside a launch. Every branch of that loop (the
accept test, the lambda update, the stop test and the termination code)
reads only all-reduced values, so all ranks take the same path and the
same collectives. The selected count is all-reduced too.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.ops import least_squares, linearize as lin_ops
from dvo_slam_tpu_torch.ops import sampler, se3

# Termination reasons, per level (reference IterationStats/LevelStats).
TERM_ITERATIONS = 0  # hit max_iterations
TERM_INCREMENT = 1  # ||delta_xi|| < precision
TERM_ERROR_INCREASED = 2  # GN rollback
TERM_TOO_FEW_CONSTRAINTS = 3  # < 6 valid constraints


class TrackStats(NamedTuple):
    """Per-iteration statistics, (num_tracked_levels, max_iterations) and
    coarse level first (a batch puts B in front); entries past
    iterations[level] are zero."""

    valid: torch.Tensor  # valid constraint count at each evaluation
    error: torch.Tensor  # acceptance NLL of each evaluation
    delta_norm: torch.Tensor  # ||delta_xi|| of each solved increment
    accepted: torch.Tensor  # bool: evaluation accepted (vs rolled back)
    termination: torch.Tensor  # (num_tracked_levels,) int32 TERM_* codes
    # Points masked by the TPU sampler's row window: constant zeros here.
    window_miss: torch.Tensor = None


class TrackResult(NamedTuple):
    """Equivalent of DenseTracker::Result (a batch puts B in front of
    every field)."""

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
    """H = 0.5 * ln((2 pi e)^6 det(information^{-1})), from log|det|;
    (..., 6, 6) -> (...)."""
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


# The accepted linearization's fields, carried as one (B, 50) tensor so
# one torch.where per iteration keeps them all: offsets of A (36), b (6),
# err_mean, err_raw, sigma (4), n_raw and log1p_sum.
_A, _B, _ERR, _ERR_RAW, _SIGMA, _N_RAW, _LOG1P = 0, 36, 42, 43, 44, 48, 49


def _flat(lin):
    B = lin.A.shape[0]
    return torch.cat([lin.A.reshape(B, 36), lin.b, lin.err_mean[:, None],
                      lin.err_raw[:, None], lin.sigma.reshape(B, 4),
                      lin.n_raw[:, None], lin.log1p_sum[:, None]], dim=1)


def _final(best, cfg: TrackerConfig):
    """The Linearization of each row's last accepted evaluation, from its
    (B, 50) record."""
    B = best.shape[0]
    A_final = best[:, _A:_B].view(B, 6, 6)
    if cfg.mu > 0.0:
        # Posterior information: data term + the prior's mu*I, added once.
        A_final = A_final + cfg.mu * torch.eye(6, dtype=best.dtype,
                                               device=best.device)
    n_valid_best = best[:, _N_RAW]
    return lin_ops.Linearization(
        A=A_final, b=best[:, _B:_ERR], err_mean=best[:, _ERR],
        n_valid=torch.clamp(n_valid_best, min=1.0), n_raw=n_valid_best,
        sigma=best[:, _SIGMA:_N_RAW].view(B, 2, 2),
        log1p_sum=best[:, _LOG1P], err_raw=best[:, _ERR_RAW],
    )


def track_level(ref_data, cur_slab, K, T_init, cfg: TrackerConfig):
    """IRLS loop for one pyramid level over B rows. ref_data holds (B, N)
    points, cur_slab is (6, H, W) shared or (B, 6, H, W), and T_init
    (B, 4, 4). Returns (T (B, 4, 4), Linearization of each row's last
    accepted evaluation, stats dict: "iterations" (B,) int32, "error" (B,)
    and with cfg.collect_stats "per_iter" = (valid, error, delta_norm,
    accepted, termination)). A CUDA slab on ``level_route(cfg)`` runs the
    level kernel, anything else the host loop."""
    if cur_slab.device.type == "cuda" and lin_ops.level_route(cfg):
        return _track_level_kernel(ref_data, cur_slab, K, T_init, cfg)
    return _track_level(ref_data, cur_slab, K, T_init, cfg)


def _track_level_kernel(ref_data, cur_slab, K, T_init, cfg: TrackerConfig):
    """``track_level`` as one launch of the cluster kernel's mode (b)."""
    lvl = lin_ops.unpack_level(
        *lin_ops.track_level_kernels(ref_data, cur_slab, K, T_init, cfg),
        cfg.max_iterations)
    stats = {"iterations": lvl.iterations, "error": lvl.best[:, _ERR]}
    if cfg.collect_stats:
        stats["per_iter"] = (lvl.valid, lvl.error, lvl.delta_norm,
                             lvl.accepted, lvl.termination)
    return lvl.T, _final(lvl.best, cfg), stats


def _track_level(ref_data, cur_slab, K, T_init, cfg: TrackerConfig,
                 linearize=None):
    """``track_level`` as a host loop over B rows in lockstep, one
    ``linearize`` call per iteration (by default ``linearize_batched``,
    looked up at the call; ``linearize_batched_reference`` for the plain
    version of mode (b), and on the pixel route with every sum all-reduced
    over the pixel group)."""
    linearize = linearize or lin_ops.linearize_batched
    dtype, dev = T_init.dtype, T_init.device
    B = T_init.shape[0]
    use_lm = cfg.lm_lambda_init > 0.0
    if cfg.mu > 0.0:
        eye6 = torch.eye(6, dtype=dtype, device=dev)

    T_cur = T_best = T_init
    best = None  # _flat of each row's last accepted linearization
    sigma_best = None
    # torch.full, not torch.tensor: no host-to-device copy and sync.
    lam = torch.full((B,), cfg.lm_lambda_init if use_lm else 0.0, dtype=dtype,
                     device=dev)
    # Per-iteration stats (valid, error, delta_norm, accepted), each (B,),
    # stacked and zero-padded to max_iterations after the loop.
    per_iter = ([], [], [], [])
    # Host mirror of the rows' done flags (read once per iteration) and
    # their iteration counts; `done` is the device copy that freezes rows.
    done_host = np.zeros(B, bool)
    iters = np.zeros(B, np.int64)
    done = None
    # Each row's stop reasons at its last iteration (rejected, too few,
    # converged), for the termination codes built after the loop.
    flags = None

    k = 0
    while True:
        # Warm-start the scale fixed point from the last accepted Sigma.
        # Every row is linearized, the frozen ones too (vmap semantics).
        lin = linearize(ref_data, cur_slab, K, T_cur, cfg,
                        sigma_init=sigma_best, sigma_warm=k > 0)
        # Accepted state (reference Revertable<T>: keep best, revert else).
        if k == 0:
            accept = torch.ones(B, dtype=torch.bool, device=dev)
            T_base = T_cur
            new_best = _flat(lin)
        else:
            accept = lin.err_mean <= best[:, _ERR]
            T_base = torch.where(accept[:, None, None], T_cur, T_best)
            new_best = torch.where(accept[:, None], _flat(lin), best)

        if use_lm:
            new_lam = torch.where(
                accept,
                torch.clamp(lam * cfg.lm_lambda_down, min=1e-12),
                torch.clamp(lam * cfg.lm_lambda_up, max=cfg.lm_lambda_max),
            )
            rejected_stop = torch.zeros(B, dtype=torch.bool, device=dev)
        else:
            new_lam = lam
            # Pure GN: error increase => revert and stop.
            rejected_stop = ~accept

        A_solve = new_best[:, _A:_B].view(B, 6, 6)
        b_solve = new_best[:, _B:_ERR]
        if cfg.mu > 0.0:
            # Motion prior on the solve operands only; the carried A/b stay
            # the pure data term (else each rejection stacks another mu*I).
            xi_prior = se3.log(T_base @ se3.inverse(T_init))
            A_solve = A_solve + cfg.mu * eye6
            b_solve = b_solve + cfg.mu * xi_prior
        delta = least_squares.solve(A_solve, b_solve, new_lam)
        # All finite <=> x * 0 == 0 everywhere (inf * 0 and NaN * 0 are NaN).
        delta = torch.where((delta * 0.0 == 0.0).all(-1, keepdim=True),
                            delta, 0.0)
        T_next = se3.exp(delta) @ T_base
        delta_norm = torch.linalg.vector_norm(delta, dim=-1)

        converged = delta_norm < cfg.precision
        too_few = new_best[:, _N_RAW] < 6
        stop = rejected_stop | converged | too_few
        stats = (lin.n_raw, lin.err_mean, delta_norm, accept)
        new_flags = (rejected_stop, too_few, converged)
        if done_host.any():
            # Rows whose stop test fired earlier keep their carry: the new
            # values are selected away, never used (vmap-of-while).
            live = ~done
            T_next = torch.where(live[:, None, None], T_next, T_cur)
            T_base = torch.where(live[:, None, None], T_base, T_best)
            new_best = torch.where(live[:, None], new_best, best)
            new_lam = torch.where(live, new_lam, lam)
            stop = stop | done
            stats = tuple(torch.where(live, x, torch.zeros_like(x))
                          for x in stats)
            if cfg.collect_stats:
                new_flags = tuple(torch.where(live, x, y)
                                  for x, y in zip(new_flags, flags))
        if cfg.collect_stats:
            for acc, x in zip(per_iter, stats):
                acc.append(x)
            flags = new_flags
        T_cur, T_best, best, lam = T_next, T_base, new_best, new_lam
        sigma_best = best[:, _SIGMA:_N_RAW].view(B, 2, 2)
        iters += ~done_host
        k += 1
        if k >= cfg.max_iterations:
            break
        done = stop
        done_host = done.cpu().numpy()
        if done_host.all():
            break

    stats = {"iterations": torch.tensor(iters, dtype=torch.int32, device=dev),
             "error": best[:, _ERR]}
    if cfg.collect_stats:
        # Each row's last reason; first matching wins (priority mirrors
        # the stop test).
        rejected_stop, too_few, converged = flags
        term = torch.where(
            rejected_stop, TERM_ERROR_INCREASED,
            torch.where(too_few, TERM_TOO_FEW_CONSTRAINTS,
                        torch.where(converged, TERM_INCREMENT,
                                    TERM_ITERATIONS)),
        ).to(torch.int32)
        pad = cfg.max_iterations - k
        stats["per_iter"] = (
            *(torch.nn.functional.pad(torch.stack(x, dim=1), (0, pad))
              for x in per_iter[:3]),
            torch.cat([torch.stack(per_iter[3], dim=1),
                       torch.zeros((B, pad), dtype=torch.bool, device=dev)],
                      dim=1),
            term,
        )
    return T_best, _final(best, cfg), stats


def track_batched(ref_pyrs, cur_pyrs, Ks, T_inits, cfg: TrackerConfig,
                  pixel_group=None) -> TrackResult:
    """B reference pyramids tracked together (the JAX package's vmap over
    ``track``): one ``track_level`` per tracked level.

    ref_pyrs: tuple of per-level (B, 6, H, W) slabs; cur_pyrs: per-level
    (6, H, W) slabs shared by every row (SLAM's dual alignment: keyframe
    and previous frame against the current frame) or (B, 6, H, W), one
    current pyramid per row (loop-closure validation); T_inits: (B, 4, 4).
    Every field of the result has a leading B.

    pixel_group: a process group over which each ref_pyrs level holds
    this rank's band of rows (rank r: rows [r h, (r + 1) h) of every
    level, h the slab's height here), the current pyramids whole; every
    rank gets the same result. None: whole reference slabs."""
    T = T_inits
    dev, dtype = T_inits.device, T_inits.dtype
    B = T_inits.shape[0]
    levels = cfg.tracked_levels  # coarse -> fine
    sharded = lin_ops.pixel_route(pixel_group)
    rank = 0
    if sharded:
        import torch.distributed as dist

        rank = dist.get_rank(pixel_group)
    level_data = {lvl: lin_ops.prepare_reference(
        ref_pyrs[lvl], Ks[lvl], cfg,
        row_offset=rank * ref_pyrs[lvl].shape[-2]) for lvl in levels}

    iters, errs, per_iter = [], [], []
    fin = None
    for lvl in levels:
        if sharded:
            T, fin, stats = _track_level(
                level_data[lvl], cur_pyrs[lvl], Ks[lvl], T, cfg,
                linearize=functools.partial(
                    lin_ops.linearize_batched_reference,
                    sample=sampler.sample_slab, group=pixel_group))
        else:
            T, fin, stats = track_level(level_data[lvl], cur_pyrs[lvl],
                                        Ks[lvl], T, cfg)
        iters.append(stats["iterations"])
        errs.append(stats["error"])
        if cfg.collect_stats:
            per_iter.append(stats["per_iter"])

    # Information / log-likelihood come from the finest level's last
    # accepted linearization (T is that pose).
    loglik = lin_ops.tdist_loglik(fin, cfg)
    n_selected = level_data[levels[-1]].selected.sum(-1).to(dtype)
    if sharded:
        dist.all_reduce(n_selected, group=pixel_group)
    information = fin.A
    zero = torch.zeros(B, dtype=dtype, device=dev)

    track_stats = None
    if cfg.collect_stats:
        track_stats = TrackStats(
            valid=torch.stack([p[0] for p in per_iter], dim=1),
            error=torch.stack([p[1] for p in per_iter], dim=1),
            delta_norm=torch.stack([p[2] for p in per_iter], dim=1),
            accepted=torch.stack([p[3] for p in per_iter], dim=1),
            termination=torch.stack([p[4] for p in per_iter], dim=1),
            window_miss=torch.zeros((B, len(levels), cfg.max_iterations),
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
        iterations=torch.stack(iters, dim=1),
        level_errors=torch.stack(errs, dim=1),
        stats=track_stats,
        window_miss_frac=zero,
        escalated=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def track(ref_pyr, cur_pyr, Ks, T_init, cfg: TrackerConfig,
          pixel_group=None) -> TrackResult:
    """Align the current frame to the reference frame (DenseTracker::match).

    ref_pyr / cur_pyr: tuples of per-level (6, H, W) slabs (finest first)
    from ops.pyramid.build_pyramid; Ks: tuple of per-level (4,)
    intrinsics; T_init: (4, 4) f32 initial estimate (reference cam ->
    current cam), all on one device; pixel_group as in ``track_batched``.
    The batched tracker at B = 1.
    """
    res = track_batched(tuple(lvl[None] for lvl in ref_pyr), cur_pyr, Ks,
                        T_init[None], cfg, pixel_group)
    return row(res, 0)


# The JAX package's name for the form with one current pyramid per row;
# track_batched takes both forms.
track_pairs_batched = track_batched


def row(res: TrackResult, b) -> TrackResult:
    """Row b (an index, or a slice of rows) of a batched TrackResult
    (views)."""
    stats = (None if res.stats is None
             else TrackStats(*(x[b] for x in res.stats)))
    return TrackResult(*(x[b] for x in res[:10]), stats,
                       *(x[b] for x in res[11:]))

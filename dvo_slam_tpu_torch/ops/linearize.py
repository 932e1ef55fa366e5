"""One IRLS linearization of the bivariate photometric + geometric error
(counterpart of ``dvo_slam_tpu/ops/linearize.py``; reference
computeResidualsSse + computeScaleSse/computeWeightsSse + the SSE 6x6 rank
updates), and the wrappers of the cluster kernel that runs it, or a whole
pyramid level's IRLS loop, on the card.

warp -> project -> bilinear sample -> bivariate residual -> t-distribution
Sigma fixed point -> weights -> analytic Jacobian -> weighted 6x6 normal
equations.

``linearize`` (one pair: ``linearize_batched`` at B = 1) dispatches on
the current slab's device:

- a CPU tensor goes to ``linearize_reference``, the plain PyTorch version:
  per-point quantities stay flat (N,) tensors and the Jacobian is 12
  scalar planes, as in the JAX package. Invalid points are zeroed with
  ``torch.where`` before any sum (NaN * 0 = NaN). Its pieces are
  ``residuals_reference`` (the residual pass), ``tdist_step_reference``
  (one Sigma step) and ``normal_equations_reference``.
- a CUDA tensor goes to mode (a) of csrc/linearize.cu, one launch of
  thread-block clusters (one cluster per batch row: the residual pass with
  the bilinear gather inside it, the Sigma steps and the normal equations,
  the points kept in shared memory), with no host sync, when
  ``kernel_route(cfg)``: the t-distribution branch (``use_weighting`` and
  ``scale_estimator == "tdist"``, the default), with either gradient
  source, ``use_depth`` on or off and the Sigma warm start. The other
  scale estimators (``mad``, ``normal``, ``unit``) and
  ``use_weighting=False`` run ``linearize_reference`` on the card,
  gathering with the standalone sampler kernel (``sampler.sample_slab``,
  csrc/sampler.cu): the config alone picks that route. A failed build or
  launch raises; nothing falls back to the plain version.

``track_level_kernels`` is mode (b) of the same kernel: a pyramid level's
whole IRLS loop (models/dense_tracker.py's ``_track_level``) for B rows in
one launch, for the configs ``level_route(cfg)`` accepts (those of
``kernel_route`` without the motion prior, ``mu == 0``).

``linearize_batched`` takes a batch of B problems (the JAX package's vmap
over the tracker): reference points (B, N), poses (B, 4, 4), Sigma seeds
(B, 2, 2), and one current slab (6, H, W) shared by every row or one per
row (B, 6, H, W). Its plain version is ``linearize_batched_reference``:
``linearize_reference`` row by row.

``prepare_reference`` builds the reference points: the full grid with a
selection mask, or, with ``cfg.point_budget_fraction > 0``, the selected
points compacted to a fixed slot count (``compact_reference``); the
kernels take either N. The plain linearization takes an optional
``group``, a ``torch.distributed`` process group over which the points
are sharded (pixel rows, parallel/sharded.py): every sum the JAX package
``psum``s is all-reduced over it. ``pixel_route(group)`` says when the
tracker takes that route.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.ops import pyramid as pyr
from dvo_slam_tpu_torch.ops import robust, sampler

_EPS = 1e-12

# Launches of csrc/linearize.cu since the last reset (plain integers;
# callers reset them to 0 to count the launches of one run): mode (a)
# (``linearize_kernels_batched``) and mode (b) (``track_level_kernels``),
# and both by batch size, keyed ("linearize", B) and ("track_level", B)
# (callers clear it with the counts).
LAUNCHES_LINEARIZE = 0
LAUNCHES_TRACK_LEVEL = 0
LAUNCHES_BY_BATCH = {}

# Layouts of the kernel's outputs (csrc/linearize.cu kOut* and kLevel*):
# mode (a)'s Linearization vector; mode (b)'s row: the pose (16), the
# tracker's record of the last accepted linearization (50), then the
# statistics (4, max_iterations).
_OUT_SIZE = 51
_LEVEL_T, _LEVEL_BEST, _LEVEL_STATS = 0, 16, 66
# Clusters of at most 16 CTAs (a non-portable size on Hopper).
_MAX_CLUSTER = 16


class RefData(NamedTuple):
    """Per-level reference-frame tensors, all (N,), or (B, N) for a batch.
    The gradient planes are set only for cfg.gradient_source ==
    "reference"."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    i1: torch.Tensor
    selected: torch.Tensor  # bool
    gix: Optional[torch.Tensor] = None
    giy: Optional[torch.Tensor] = None
    gzx: Optional[torch.Tensor] = None
    gzy: Optional[torch.Tensor] = None


class Residuals(NamedTuple):
    """Per-point output of the residual pass, all (N,) except the counts.
    Invalid points have rI = rZ = 0."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    zi: torch.Tensor
    gix: torch.Tensor
    giy: torch.Tensor
    gzx: torch.Tensor
    gzy: torch.Tensor
    rI: torch.Tensor
    rZ: torch.Tensor
    valid: torch.Tensor  # bool
    vF: torch.Tensor  # valid as the working dtype
    n_raw: torch.Tensor  # scalar valid count
    n: torch.Tensor  # n_raw floored at 1


class Linearization(NamedTuple):
    A: torch.Tensor  # (6, 6)
    b: torch.Tensor  # (6,)
    err_mean: torch.Tensor  # scalar acceptance metric
    n_valid: torch.Tensor  # scalar, floored at 1 (safe divisor)
    n_raw: torch.Tensor  # scalar, true valid count (0 possible)
    sigma: torch.Tensor  # (2, 2)
    log1p_sum: torch.Tensor  # sum over valid of log1p(maha/dof)
    err_raw: torch.Tensor  # sum of w * maha (diagnostics)
    # Points masked by the TPU sampler's row window: always 0 here (the
    # gather kernel has no window); kept so callers see the same fields.
    n_window_miss: float = 0.0


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _sums(group, *xs):
    """The sums of xs (0-d tensors each), all-reduced over the process
    group ``group`` where it is not None (the JAX package's ``psum`` over
    a pixel axis): one collective for all of them."""
    if group is None:
        return tuple(x.sum() for x in xs)
    import torch.distributed as dist

    out = torch.stack([x.sum() for x in xs])
    dist.all_reduce(out, group=group)
    return out.unbind()


def prepare_reference(ref_slab, K, cfg: TrackerConfig,
                      row_offset: int = 0) -> RefData:
    """Back-project and select reference pixels (PointSelection).
    ref_slab: (6, H, W), or (B, 6, H, W) for a batch of (B, N) points.

    ``row_offset``: the image row of the slab's first row (a pixel shard's
    rows start there, models/dense_tracker.py). With
    ``cfg.point_budget_fraction > 0`` the points are compacted to
    ``compact_budget`` slots (the same budget for every row of a batch)."""
    H, W = ref_slab.shape[-2:]
    lead = ref_slab.shape[:-3]
    dtype, device = ref_slab.dtype, ref_slab.device
    fx, fy, cx, cy = K.unbind()
    v, u = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    u = u.reshape(-1)
    v = v.reshape(-1)
    if row_offset:
        v = v + row_offset

    def plane(ch):
        # Contiguous (B, N): the kernels step from row to row by N (a copy
        # for a batch; a view of one slab).
        return ref_slab[..., ch, :, :].reshape(*lead, H * W).contiguous()

    z = plane(pyr.CH_Z)
    i1 = plane(pyr.CH_I)
    selected = torch.isfinite(z)
    if cfg.intensity_grad_threshold > 0.0:
        gi = torch.hypot(plane(pyr.CH_IDX), plane(pyr.CH_IDY))
        selected &= gi >= cfg.intensity_grad_threshold
    if cfg.depth_grad_threshold > 0.0:
        gz = torch.hypot(plane(pyr.CH_ZDX), plane(pyr.CH_ZDY))
        selected &= torch.isfinite(gz) & (gz >= cfg.depth_grad_threshold)
    grads = {}
    if cfg.gradient_source == "reference":
        gix = plane(pyr.CH_IDX)
        giy = plane(pyr.CH_IDY)
        grads["gix"] = _where0(torch.isfinite(gix), gix)
        grads["giy"] = _where0(torch.isfinite(giy), giy)
        if cfg.use_depth:
            # Reference-side depth gradients are constants, so their
            # finiteness folds into point selection.
            gzx = plane(pyr.CH_ZDX)
            gzy = plane(pyr.CH_ZDY)
            selected &= torch.isfinite(gzx) & torch.isfinite(gzy)
            grads["gzx"] = _where0(torch.isfinite(gzx), gzx)
            grads["gzy"] = _where0(torch.isfinite(gzy), gzy)
    z_safe = torch.where(selected, z, torch.ones_like(z))
    px = (u - cx) / fx * z_safe
    py = (v - cy) / fy * z_safe
    ref = RefData(px=px, py=py, pz=z_safe, i1=i1, selected=selected, **grads)
    if cfg.point_budget_fraction > 0.0:
        ref = compact_reference(ref, compact_budget(
            H * W, cfg.point_budget_fraction, _COMPACT_TILE_GATHER))
    return ref


# Points per slot tile under compaction: the JAX package's gather-path
# tile (its Pallas path rounds to 2048; the port has only the gather).
_COMPACT_TILE_GATHER = 128


def compact_budget(n_points: int, frac: float, tile: int) -> int:
    """Static slot count for compact_reference: round_up(frac * n) to a
    tile multiple, at least one tile, never more than a tile-rounded n."""
    want = max(math.ceil(frac * n_points), 1)
    up = lambda x: ((x + tile - 1) // tile) * tile  # noqa: E731
    return min(up(want), up(n_points))


def compact_reference(ref: RefData, budget: int) -> RefData:
    """Compact (N,) or (B, N) reference points to ``budget`` slots of
    selected points (the reference's PointSelection keeps compacted arrays;
    the full grid with a mask is the default): a stable stream compaction,
    the JAX package's semantics exactly.

    - count <= budget: the selected points, in row-major order.
    - count > budget: uniform row-major decimation; slot j holds the first
      selected point whose slot map ``rank * budget // count`` lands on j,
      i.e. the point of rank ``ceil(j * count / budget)``.
    - Slots past ``min(count, budget)`` replicate the last filled slot and
      are unselected; with no point selected every field is 0.

    The map is inverted and gathered: slot j computes the rank it takes
    and finds that point with ``searchsorted`` on the cumulative ranks.
    Nothing is scattered, so duplicate writes (nondeterministic in CUDA's
    ``index_put_``) cannot occur and the result is the same bits on every
    device and run. int64 throughout: ``j * count`` cannot overflow, so
    the JAX package's split int32 arithmetic is not needed. ``count``
    stays a device tensor (no host sync)."""
    sel = ref.selected
    ranks = torch.cumsum(sel, dim=-1)  # int64, (..., N)
    count = ranks[..., -1:]  # (..., 1)
    nfill = torch.clamp(count, max=budget)
    slots = torch.arange(budget, device=sel.device)
    # Slot j's rank, ceil(j * max(count, budget) / budget): j itself under
    # budget, the decimation map's first writer over it. Tail slots take
    # the last filled slot's point.
    j = torch.minimum(slots, nfill - 1)
    rank = (j * torch.clamp(count, min=budget) + (budget - 1)) // budget
    # The first point whose cumulative rank passes `rank`: the point of
    # that rank. count == 0 finds none (N), clamped and zeroed below.
    idx = torch.clamp(torch.searchsorted(ranks, rank, right=True),
                      max=sel.shape[-1] - 1)
    fields = ref[:4] + ref[5:]  # all but `selected`
    present = [k for k, f in enumerate(fields) if f is not None]
    table = torch.stack([fields[k] for k in present])
    out = torch.where(count > 0, torch.gather(
        table, -1, idx.expand(table.shape[:-1] + idx.shape[-1:])), 0.0)
    cols = dict(zip(present, out.unbind()))
    return RefData(
        px=cols[0], py=cols[1], pz=cols[2], i1=cols[3],
        selected=slots < nfill, gix=cols.get(4), giy=cols.get(5),
        gzx=cols.get(6), gzy=cols.get(7),
    )


def tdist_weights_reference(a, bq, c, sII, sIZ, sZZ, vF, cfg):
    """t-distribution weights under Sigma = [[a, bq], [bq, c]]:
    ``(det, p00, p01, p11, maha, w)``, w zero at invalid points."""
    nu = cfg.tdist_dof
    det = torch.clamp(a * c - bq * bq, min=_EPS)
    p00, p01, p11 = c / det, -bq / det, a / det
    maha = p00 * sII + 2.0 * p01 * sIZ + p11 * sZZ
    w = (nu + 2.0) / (nu + maha) * vF
    return det, p00, p01, p11, maha, w


def tdist_step_reference(a, bq, c, sII, sIZ, sZZ, vF, n, cfg, group=None):
    """One step of the bivariate t-distribution scale fixed point (the
    plain version of the kernel's Sigma step): the weighted moments under
    Sigma = [[a, bq], [bq, c]], summed over ``group`` too where it is not
    None. Returns the next (a, bq, c)."""
    w = tdist_weights_reference(a, bq, c, sII, sIZ, sZZ, vF, cfg)[5]
    s_ii, s_iz, s_zz = _sums(group, w * sII, w * sIZ, w * sZZ)
    a = s_ii / n + cfg.min_intensity_sigma**2
    bq = s_iz / n
    c = s_zz / n + cfg.min_depth_sigma**2
    return a, bq, c


def _tdist_scale(sII, sIZ, sZZ, vF, n, cfg, sigma_init, sigma_warm,
                 group=None):
    """Bivariate t-distribution scale fixed point on the residual moments
    (summed over ``group`` too where it is not None). Returns the Sigma
    entries (a, bq, c)."""
    floor_II = cfg.min_intensity_sigma**2
    floor_ZZ = cfg.min_depth_sigma**2
    s_ii, s_iz, s_zz = _sums(group, sII, sIZ, sZZ)
    a = s_ii / n + floor_II
    bq = s_iz / n
    c = s_zz / n + floor_ZZ
    n_fp = cfg.tdist_scale_iters
    if sigma_init is not None and cfg.tdist_scale_warm_iters > 0:
        # Warm start from the previous iteration's Sigma: the trip count
        # depends on it, so this option costs the plain version one host
        # sync (the kernels decide it on the device).
        if sigma_warm and bool(torch.isfinite(sigma_init).all()):
            a = torch.clamp(sigma_init[0, 0], min=floor_II)
            bq = sigma_init[0, 1]
            c = torch.clamp(sigma_init[1, 1], min=floor_ZZ)
            n_fp = cfg.tdist_scale_warm_iters
    for _ in range(n_fp):
        a, bq, c = tdist_step_reference(a, bq, c, sII, sIZ, sZZ, vF, n, cfg,
                                        group)
    return a, bq, c


def warp(ref: RefData, K, T):
    """Transform the reference points by T (4, 4) and project them:
    ``(X, Y, Z, 1/Z, u, v)``, all (N,)."""
    fx, fy, cx, cy = K.unbind()
    R, t = T[:3, :3], T[:3, 3]
    px, py, pz = ref.px, ref.py, ref.pz
    X = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
    Y = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
    Z = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    # Sign-preserving guard: never flip a behind-the-camera point forward.
    zi = 1.0 / torch.where(Z.abs() < 1e-8,
                           torch.where(Z < 0, -1e-8, 1e-8), Z)
    return X, Y, Z, zi, fx * X * zi + cx, fy * Y * zi + cy


def residuals_reference(ref: RefData, cur_slab, K, T, cfg: TrackerConfig,
                        sample=sampler.sample_slab_reference,
                        group=None) -> Residuals:
    """Warp, bilinear sample, bivariate residual and validity of every
    reference point at pose T: the plain version of the kernel's residual
    pass. ``sample`` is the gather, ``(slab, u, v) -> (samples, inb)``:
    the plain sampler, or ``sampler.sample_slab`` (its kernel on a CUDA
    slab). The valid count is summed over ``group`` too where it is not
    None."""
    C = cur_slab.shape[0]
    dtype = cur_slab.dtype
    X, Y, Z, zi, u, v = warp(ref, K, T)

    # --- bilinear sample ---
    # "reference" gradient mode samples only [I] / [I, Z].
    ref_grad = cfg.gradient_source == "reference"
    n_smp = ((2 if cfg.use_depth else 1) if ref_grad else C)
    smp, inb = sample(cur_slab[:n_smp], u, v)
    chans = smp.unbind(0)

    i2 = chans[pyr.CH_I]
    z2 = (chans[pyr.CH_Z] if cfg.use_depth or not ref_grad
          else torch.zeros_like(i2))
    if ref_grad:
        gix, giy = ref.gix, ref.giy
        zero_g = torch.zeros_like(i2)
        gzx = ref.gzx if cfg.use_depth else zero_g
        gzy = ref.gzy if cfg.use_depth else zero_g
    else:
        gix = chans[pyr.CH_IDX]
        giy = chans[pyr.CH_IDY]
        gzx = chans[pyr.CH_ZDX]
        gzy = chans[pyr.CH_ZDY]

    # --- residuals + validity ---
    rI = i2 - ref.i1
    rZ = z2 - Z
    valid = ref.selected & inb & (Z > 1e-6) & torch.isfinite(rI)
    if cfg.use_depth:
        # Photometric-only tracking must not require finite current depth.
        valid &= torch.isfinite(rZ) & torch.isfinite(gzx) & torch.isfinite(gzy)
    vF = valid.to(dtype)
    rI = _where0(valid, rI)
    rZ = _where0(valid, rZ) if cfg.use_depth else torch.zeros_like(rI)
    (n_raw,) = _sums(group, vF)
    n = torch.clamp(n_raw, min=1.0)
    return Residuals(X=X, Y=Y, Z=Z, zi=zi, gix=gix, giy=giy, gzx=gzx,
                     gzy=gzy, rI=rI, rZ=rZ, valid=valid, vF=vF, n_raw=n_raw,
                     n=n)


def normal_equations_reference(res: Residuals, w, p00, p01, p11, K,
                               cfg: TrackerConfig, group=None):
    """Analytic Jacobian and the weighted 6x6 normal equations ``(A, b)``
    (with the weights ``w``: the plain version of the kernel's
    normal-equations pass), summed over ``group`` too where it is not
    None."""
    fx, fy = K[0], K[1]
    X, Y, Z, zi, valid = res.X, res.Y, res.Z, res.zi, res.valid
    # J_pi = [[A, 0, C], [0, B, D]]; dp'/dxi = [I3 | -hat(p')].
    A_ = fx * zi
    B_ = fy * zi
    C_ = -fx * X * zi * zi
    D_ = -fy * Y * zi * zi
    zero = torch.zeros_like(A_)
    Ju = (A_, zero, C_, C_ * Y, A_ * Z - C_ * X, -A_ * Y)
    Jv = (zero, B_, D_, -B_ * Z + D_ * Y, -D_ * X, B_ * X)
    # d p'_z / d xi = [0, 0, 1, Y, -X, 0]
    Jg3 = (zero, zero, torch.ones_like(Z), Y, -X, zero)

    gix = _where0(valid, res.gix)
    giy = _where0(valid, res.giy)
    gzx = _where0(valid, res.gzx)
    gzy = _where0(valid, res.gzy)
    JI = [gix * Ju[k] + giy * Jv[k] for k in range(6)]
    if cfg.use_depth:
        JZ = [_where0(valid, gzx * Ju[k] + gzy * Jv[k] - Jg3[k])
              for k in range(6)]
    else:
        JZ = [zero] * 6

    # --- weighted normal equations: one (6, 2N) x (2N, 6) product ---
    wI = w * p00
    wX = w * p01
    wZ = w * p11
    GI = [wI * JI[k] + wX * JZ[k] for k in range(6)]
    GZ = [wX * JI[k] + wZ * JZ[k] for k in range(6)]
    J6 = torch.stack([torch.cat([JI[k], JZ[k]]) for k in range(6)])
    G6 = torch.stack([torch.cat([GI[k], GZ[k]]) for k in range(6)])
    A, b = J6 @ G6.T, G6 @ torch.cat([res.rI, res.rZ])
    if group is not None:
        import torch.distributed as dist

        Ab = torch.cat([A.reshape(36), b])
        dist.all_reduce(Ab, group=group)
        A, b = Ab[:36].view(6, 6), Ab[36:]
    return A, b


def kernel_route(cfg: TrackerConfig) -> bool:
    """True where ``linearize`` on a CUDA tensor runs mode (a) of
    csrc/linearize.cu, False where it runs ``linearize_reference`` on the
    card (the scale estimators other than the t-distribution)."""
    return cfg.use_weighting and cfg.scale_estimator == "tdist"


def pixel_route(group) -> bool:
    """True where the tracker runs a pixel-sharded level (reference rows
    split over the ranks of the ``torch.distributed`` process group
    ``group``): a group of more than one rank. There the tracker runs its
    host loop over ``linearize_batched_reference`` with every sum
    all-reduced over the group (on the card gathering with the standalone
    sampler kernel), since neither mode of csrc/linearize.cu can reduce
    across processes inside a launch. The group picks the route, as
    ``mu > 0`` picks the host loop; a group of one rank, or None, leaves
    the routes of ``kernel_route`` and ``level_route``."""
    if group is None:
        return False
    import torch.distributed as dist

    return dist.get_world_size(group) > 1


def level_route(cfg: TrackerConfig) -> bool:
    """True where the tracker runs a level's IRLS loop on a CUDA tensor as
    one launch of mode (b) (``track_level_kernels``): ``kernel_route``'s
    configs without the motion prior (``mu == 0``; GN or LM, the Sigma warm
    start, ``collect_stats`` on or off). Elsewhere the tracker runs its host
    loop over ``linearize_batched``."""
    return kernel_route(cfg) and cfg.mu == 0.0


def cluster_size(N: int) -> int:
    """CTAs per cluster (one cluster per batch row) for N reference points:
    the smallest power of two C <= 16 with 300 C^2 >= N, so a CTA holds at
    most 300 C points (4 at 80x60, 8 at 160x120, 16 at 320x240)."""
    C = 1
    while C < _MAX_CLUSTER and 300 * C * C < N:
        C *= 2
    return C


def linearize(ref: RefData, cur_slab, K, T, cfg: TrackerConfig,
              sigma_init=None, sigma_warm=False) -> Linearization:
    """One IRLS linearization of the current slab against the reference
    points at pose T (4, 4): ``linearize_batched`` at B = 1, returning
    row 0; see the module docstring for the route each device and config
    takes.

    ``sigma_init`` / ``sigma_warm``: with cfg.tdist_scale_warm_iters > 0,
    the previous iteration's (2, 2) Sigma and a host bool (False on a
    level's first iteration) that seed the fixed point.
    """
    one = linearize_batched(
        RefData(*(None if f is None else f[None] for f in ref)), cur_slab, K,
        T[None], cfg, None if sigma_init is None else sigma_init[None],
        sigma_warm)
    return Linearization(*(f[0] for f in one[:-1]))


def linearize_batched(ref: RefData, cur_slab, K, T, cfg: TrackerConfig,
                      sigma_init=None, sigma_warm=False) -> Linearization:
    """B linearizations at once: ``ref`` holds (B, N) points, T is
    (B, 4, 4), ``sigma_init`` (B, 2, 2), and ``cur_slab`` is one (6, H, W)
    slab shared by every row or (B, 6, H, W), one per row. Returns a
    Linearization whose every field has a leading B. Off the kernels'
    route each row runs ``linearize_reference``; a CUDA slab still gathers
    with the sampler kernel there, a CPU slab with the plain sampler."""
    _check_device(cur_slab)
    if cur_slab.device.type == "cuda" and kernel_route(cfg):
        return linearize_kernels_batched(ref, cur_slab, K, T, cfg,
                                         sigma_init, sigma_warm)
    return linearize_batched_reference(ref, cur_slab, K, T, cfg, sigma_init,
                                       sigma_warm, sample=sampler.sample_slab)


def linearize_batched_reference(ref: RefData, cur_slab, K, T,
                                cfg: TrackerConfig, sigma_init=None,
                                sigma_warm=False,
                                sample=sampler.sample_slab_reference,
                                group=None) -> Linearization:
    """``linearize_batched`` in plain PyTorch: ``linearize_reference`` row
    by row, stacked (the plain version of the batched kernels); ``group``
    as in ``linearize_reference``."""
    paired = cur_slab.dim() == 4
    rows = [linearize_reference(
        RefData(*(None if f is None else f[b] for f in ref)),
        cur_slab[b] if paired else cur_slab, K, T[b], cfg,
        None if sigma_init is None else sigma_init[b], sigma_warm,
        sample=sample, group=group) for b in range(T.shape[0])]
    return Linearization(*(torch.stack(f) for f in zip(*(r[:-1]
                                                         for r in rows))))


def _check_device(cur_slab):
    if cur_slab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linearize runs on cpu or cuda, not "
                         f"{cur_slab.device}")


# Per-(device, stream, B, N) copies of the last mode (a) call's residual
# pass: (rI, rZ, valid), each (B, N), allocated once and reused.
_RESIDUALS = {}


def kernel_residuals(device, N, B=None):
    """``(rI, rZ, valid)`` of the residual pass of the last mode (a) call
    over B rows of N points on the current stream of ``device``: each
    (B, N), or (N,) for B None (a single-pair ``linearize``). Views: the
    next such call overwrites them. For comparing the kernel with
    ``residuals_reference``."""
    device = torch.device(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    rI, rZ, valid = _RESIDUALS[(device, stream, 1 if B is None else B, N)]
    if B is None:
        return rI[0], rZ[0], valid[0]
    return rI, rZ, valid


def _check(ref: RefData, cur_slab, K, T):
    H, W = cur_slab.shape[-2:]
    if H < 2 or W < 2:
        raise ValueError(f"want a slab of H, W >= 2, got {H}x{W}")
    for name, t in (("cur_slab", cur_slab), ("K", K), ("T", T),
                    ("ref.px", ref.px)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != cur_slab.device:
            raise ValueError(f"{name} on {t.device}, slab on "
                             f"{cur_slab.device}")
    B = T.shape[0]
    if T.shape != (B, 4, 4) or ref.px.dim() != 2 or ref.px.shape[0] != B:
        raise ValueError(f"want T (B, 4, 4) and (B, N) reference points, got "
                         f"{tuple(T.shape)} and {tuple(ref.px.shape)}")
    if cur_slab.dim() == 4 and cur_slab.shape[0] != B:
        raise ValueError(f"{cur_slab.shape[0]} current slabs for {B} rows")
    if not all(f is None or f.is_contiguous() for f in ref):
        raise ValueError("the reference points must be contiguous")
    if not cur_slab.is_contiguous():
        raise ValueError("cur_slab must be contiguous")


def _kernel_args(ref: RefData, cur_slab, K, T, cfg: TrackerConfig):
    """The arguments the two entry points of csrc/linearize.cu share, from
    B to warm_iters, after the checks."""
    if not kernel_route(cfg):
        raise ValueError("the linearization kernel covers the "
                         "t-distribution scale estimator only")
    _check(ref, cur_slab, K, T)
    C, H, W = cur_slab.shape[-3:]
    B, N = ref.px.shape
    ref_grad = cfg.gradient_source == "reference"
    if C < ((2 if cfg.use_depth else 1) if ref_grad else 6):
        raise ValueError(f"the slab has {C} channels, too few for {cfg}")
    return (
        B, ref.px.data_ptr(), ref.py.data_ptr(), ref.pz.data_ptr(),
        ref.i1.data_ptr(), ref.selected.data_ptr(),
        ref.gix.data_ptr() if ref_grad else None,
        ref.giy.data_ptr() if ref_grad else None,
        ref.gzx.data_ptr() if ref_grad and cfg.use_depth else None,
        ref.gzy.data_ptr() if ref_grad and cfg.use_depth else None,
        # Row b's slab starts b * stride floats in; 0 shares one slab.
        N, cur_slab.data_ptr(), C * H * W if cur_slab.dim() == 4 else 0, H, W,
        K.data_ptr(), T.data_ptr(), int(cfg.use_depth), int(ref_grad),
        cfg.tdist_dof, cfg.min_intensity_sigma**2, cfg.min_depth_sigma**2,
        cfg.tdist_scale_iters, cfg.tdist_scale_warm_iters)


def _launch(name, device, args):
    """Call the entry point `name` of the kernel library with `args` and
    the current stream of `device` (made the current device around the
    call); raise with the CUDA error if it did not launch."""
    from dvo_slam_tpu_torch import _build

    lib = _build.load()
    # The ctypes launch runs in the current CUDA context: make it the slab's.
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.dvo_error_string(rc).decode()} (CUDA "
                           f"error {rc})")


def level_plan(device, N):
    """``(C, points per CTA, kept in shared memory, dynamic shared memory
    bytes per CTA)`` of a launch over N points on ``device``."""
    from dvo_slam_tpu_torch import _build

    C = cluster_size(N)
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = _build.load().dvo_level_plan(N, C, out)
    if rc != 0:
        raise RuntimeError(f"dvo_level_plan failed: CUDA error {rc}")
    return C, out[0], bool(out[1]), out[2]


def unpack_linearization(out) -> Linearization:
    """The Linearization (fields with a leading B) in mode (a)'s (B, 51)
    output: views, and the fields in the order of csrc/linearize.cu's
    kOut* offsets."""
    B = out.shape[0]
    err_mean, n_valid, n_raw, *_, log1p_sum, err_raw = out[:, 42:].unbind(-1)
    return Linearization(
        A=out[:, :36].view(B, 6, 6), b=out[:, 36:42], err_mean=err_mean,
        n_valid=n_valid, n_raw=n_raw, sigma=out[:, 45:49].view(B, 2, 2),
        log1p_sum=log1p_sum, err_raw=err_raw,
    )


class LevelResult(NamedTuple):
    """Mode (b)'s outputs for B rows (views of its two output tensors but
    ``accepted``)."""

    T: torch.Tensor  # (B, 4, 4) the level's pose (last accepted)
    best: torch.Tensor  # (B, 50) the tracker's record of that linearization
    valid: torch.Tensor  # (B, max_iterations) per-iteration statistics,
    error: torch.Tensor  # zero past each row's last iteration
    delta_norm: torch.Tensor
    accepted: torch.Tensor  # bool
    iterations: torch.Tensor  # (B,) int32
    termination: torch.Tensor  # (B,) int32 TERM_* code


def unpack_level(out, out_i, max_iterations) -> LevelResult:
    """Mode (b)'s outputs from its (B, 66 + 4 max_iterations) float and
    (B, 2) int32 tensors (csrc/linearize.cu's kLevel* offsets)."""
    B = out.shape[0]
    stats = out[:, _LEVEL_STATS:].view(B, 4, max_iterations)
    return LevelResult(
        T=out[:, _LEVEL_T:_LEVEL_BEST].view(B, 4, 4),
        best=out[:, _LEVEL_BEST:_LEVEL_STATS], valid=stats[:, 0],
        error=stats[:, 1], delta_norm=stats[:, 2], accepted=stats[:, 3] != 0,
        iterations=out_i[:, 0], termination=out_i[:, 1])


def linearize_kernels_batched(ref: RefData, cur_slab, K, T,
                              cfg: TrackerConfig, sigma_init=None,
                              sigma_warm=False) -> Linearization:
    """``linearize_batched`` on the card through mode (a) of
    csrc/linearize.cu, for the t-distribution branch: one launch of one
    cluster per row on the current stream of the slab's device, with no
    host sync. ``sigma_warm`` is one host bool for the whole batch (all
    rows enter a level together)."""
    global LAUNCHES_LINEARIZE
    K, T = K.contiguous(), T.contiguous()
    args = _kernel_args(ref, cur_slab, K, T, cfg)
    B, N = ref.px.shape
    warm = (sigma_init is not None and cfg.tdist_scale_warm_iters > 0
            and bool(sigma_warm))
    if warm:
        sigma_init = sigma_init.to(torch.float32).contiguous()
    dev = cur_slab.device
    with torch.cuda.device(dev):
        key = (dev, torch.cuda.current_stream().cuda_stream, B, N)
    res = _RESIDUALS.get(key)
    if res is None:
        res = _RESIDUALS[key] = (
            torch.empty((B, N), dtype=torch.float32, device=dev),
            torch.empty((B, N), dtype=torch.float32, device=dev),
            torch.empty((B, N), dtype=torch.bool, device=dev))
    out = torch.empty((B, _OUT_SIZE), dtype=torch.float32, device=dev)
    _launch("dvo_linearize", dev, (
        *args, sigma_init.data_ptr() if warm else None, int(warm),
        cluster_size(N), out.data_ptr(), *(t.data_ptr() for t in res)))
    LAUNCHES_LINEARIZE += 1
    LAUNCHES_BY_BATCH[("linearize", B)] = (
        LAUNCHES_BY_BATCH.get(("linearize", B), 0) + 1)
    return unpack_linearization(out)


def track_level_kernels(ref: RefData, cur_slab, K, T_init,
                        cfg: TrackerConfig):
    """A pyramid level's IRLS loop for B rows on the card: mode (b) of
    csrc/linearize.cu, one launch of one cluster per row on the current
    stream of the slab's device, no host sync. Arguments as
    ``linearize_batched`` (T_init (B, 4, 4)). Returns mode (b)'s raw
    outputs ``(out (B, 66 + 4 max_iterations) f32, out_i (B, 2) int32)``
    for ``unpack_level``."""
    global LAUNCHES_TRACK_LEVEL
    if not level_route(cfg):
        raise ValueError("the level kernel covers level_route's configs "
                         "only (the t-distribution, mu == 0)")
    if cfg.max_iterations < 1:
        raise ValueError("the level kernel needs max_iterations >= 1")
    K, T_init = K.contiguous(), T_init.contiguous()
    args = _kernel_args(ref, cur_slab, K, T_init, cfg)
    B, N = ref.px.shape
    dev = cur_slab.device
    out = torch.empty((B, _LEVEL_STATS + 4 * cfg.max_iterations),
                      dtype=torch.float32, device=dev)
    out_i = torch.empty((B, 2), dtype=torch.int32, device=dev)
    use_lm = cfg.lm_lambda_init > 0.0
    _launch("dvo_track_level", dev, (
        *args, cfg.max_iterations, cfg.precision,
        cfg.lm_lambda_init if use_lm else 0.0, cfg.lm_lambda_up,
        cfg.lm_lambda_down, cfg.lm_lambda_max, cluster_size(N),
        out.data_ptr(), out_i.data_ptr()))
    LAUNCHES_TRACK_LEVEL += 1
    LAUNCHES_BY_BATCH[("track_level", B)] = (
        LAUNCHES_BY_BATCH.get(("track_level", B), 0) + 1)
    return out, out_i


def linearize_reference(ref: RefData, cur_slab, K, T, cfg: TrackerConfig,
                        sigma_init=None, sigma_warm=False,
                        sample=sampler.sample_slab_reference,
                        group=None) -> Linearization:
    """``linearize`` in plain PyTorch, for every config, on any device;
    ``sample`` as in ``residuals_reference``.

    ``group``: a ``torch.distributed`` process group over which the
    reference points are sharded (pixel rows), or None. Every sum the JAX
    package ``psum``s over its pixel axis (the valid count, the residual
    moments and each Sigma step's, the log1p sum, A, b and err_raw) is
    all-reduced over it, so every rank gets the same Linearization; the
    robust scales of the other estimators stay per rank, as there. With
    None nothing is reduced and the result is the same bits as
    before."""
    dtype = cur_slab.dtype
    res = residuals_reference(ref, cur_slab, K, T, cfg, sample, group)
    rI, rZ, valid, vF, n = res.rI, res.rZ, res.valid, res.vF, res.n

    # --- robust scale + weights (bivariate t-distribution default) ---
    sII = rI * rI
    sIZ = rI * rZ
    sZZ = rZ * rZ
    if cfg.use_weighting and cfg.scale_estimator == "tdist":
        nu = cfg.tdist_dof
        a, bq, c = _tdist_scale(sII, sIZ, sZZ, vF, n, cfg,
                                sigma_init, sigma_warm, group)
        det, p00, p01, p11, maha, w = tdist_weights_reference(
            a, bq, c, sII, sIZ, sZZ, vF, cfg)
        log1p_sum, err_raw = _sums(group, torch.log1p(maha / nu) * vF,
                                   w * maha)
        err_mean = 0.5 * torch.log(det) + (nu + 2.0) / 2.0 * log1p_sum / n
    else:
        if cfg.use_weighting:
            scale_fn = robust.SCALE_FNS[cfg.scale_estimator]
            s_i = torch.clamp(scale_fn(rI, valid), min=cfg.min_intensity_sigma)
            s_z = torch.clamp(scale_fn(rZ, valid), min=cfg.min_depth_sigma)
        else:
            s_i = torch.ones((), dtype=dtype, device=rI.device)
            s_z = torch.ones((), dtype=dtype, device=rI.device)
        a, bq, c = s_i * s_i, torch.zeros_like(s_i), s_z * s_z
        p00, p01, p11 = 1.0 / a, torch.zeros_like(s_i), 1.0 / c
        maha = p00 * sII + p11 * sZZ
        if cfg.use_weighting:
            x = torch.sqrt(maha)
            inf_fn = robust.INFLUENCE_FNS[cfg.influence]
            if cfg.influence == "huber":
                w = inf_fn(x, k=cfg.huber_k)
            elif cfg.influence == "tukey":
                w = inf_fn(x, b=cfg.tukey_b)
            elif cfg.influence == "tdist":
                w = inf_fn(x, dof=cfg.tdist_dof)
            else:
                w = inf_fn(x)
            w = w * vF
        else:
            w = vF
        log1p_sum, err_raw = _sums(
            group, torch.log1p(maha / cfg.tdist_dof) * vF, w * maha)
        err_sum = err_raw
        if cfg.use_weighting:
            err_mean = err_sum / n + torch.log(torch.clamp(a * c, min=_EPS))
        else:
            err_mean = err_sum / n

    if not cfg.use_depth:
        # Keep the depth channel inert: precision row/col zero.
        p01 = torch.zeros_like(p01)
        p11 = torch.zeros_like(p11)

    Amat, bvec = normal_equations_reference(res, w, p00, p01, p11, K, cfg,
                                            group)

    sigma = torch.stack([torch.stack([a, bq]), torch.stack([bq, c])])
    return Linearization(
        A=Amat, b=bvec, err_mean=err_mean, n_valid=n, n_raw=res.n_raw,
        sigma=sigma, log1p_sum=log1p_sum, err_raw=err_raw,
    )


def tdist_loglik(lin: Linearization, cfg: TrackerConfig):
    """Bivariate t log-likelihood from a Linearization (Result.LogLikelihood);
    works on a batched one row by row."""
    nu = cfg.tdist_dof
    p = 2.0
    s = lin.sigma
    det = torch.clamp(s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0],
                      min=_EPS)
    lg = [torch.lgamma(torch.full((), x, dtype=det.dtype, device=det.device))
          for x in ((nu + p) / 2.0, nu / 2.0)]
    log_norm = (lg[0] - lg[1] - (p / 2.0) * math.log(nu * math.pi)
                - 0.5 * torch.log(det))
    return lin.n_valid * log_norm - (nu + p) / 2.0 * lin.log1p_sum

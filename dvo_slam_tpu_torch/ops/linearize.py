"""One IRLS linearization of the bivariate photometric + geometric error
(counterpart of ``dvo_slam_tpu/ops/linearize.py``; reference
computeResidualsSse + computeScaleSse/computeWeightsSse + the SSE 6x6 rank
updates), and the wrappers of the cluster kernel that runs it, or a whole
pyramid level's IRLS loop, on the card.

warp -> project -> bilinear sample -> bivariate residual -> robust scale
(the t-distribution Sigma fixed point by default) -> weights -> analytic
Jacobian -> weighted 6x6 normal equations.

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
  the bilinear gather inside it, the robust scale, the weights and the
  normal equations, the points kept in shared memory), with no host sync,
  for every config: the t-distribution branch (the default; either
  gradient source, ``use_depth`` on or off, the Sigma warm start), the
  other scale estimators (``unit``, ``normal``, ``mad``: a radix select of
  the median on the card) under each influence function, and
  ``use_weighting=False``. A failed build or launch raises; nothing falls
  back to the plain version.

``track_level_kernels`` is mode (b) of the same kernel: a pyramid level's
whole IRLS loop (models/dense_tracker.py's ``_track_level``) for B rows in
one launch, for every config, the motion prior (``mu > 0``) included.

``track_level_split`` is its split mode, for the pixel route (a row's
reference rows split over the ranks of a ``torch.distributed`` process
group, parallel/sharded.py): the level's loop cut where the JAX package
``psum``s (``stage_plan``), a stage launch over the rank's band each,
every stage's partial sums all-reduced over the group between launches,
and the IRLS decisions taken on the card from the all-reduced totals.
Under nccl each iteration's stages and all-reduces are one CUDA graph
replay (``graph_issue``); under gloo they are issued one by one.

``linearize_batched`` takes a batch of B problems (the JAX package's vmap
over the tracker): reference points (B, N), poses (B, 4, 4), Sigma seeds
(B, 2, 2), and one current slab (6, H, W) shared by every row or one per
row (B, 6, H, W). Its plain version is ``linearize_batched_reference``:
``linearize_reference`` row by row.

``prepare_reference`` builds the reference points: the full grid with a
selection mask, or, with ``cfg.point_budget_fraction > 0``, the selected
points compacted to a fixed slot count (``compact_reference``); the
kernels take either N. The kernels also take the reference level's slabs
themselves (``RefSlabs``, the slab route, for every config; by a row
stride, by row pointers among the launch's parameters, or by a
``SlabTable`` of row pointers in device memory, which the chunked
keyframe scan's step kernel writes) and compute each point in the
residual pass with ``prepare_reference``'s arithmetic, the same bits;
under compaction each launch first builds its rows' slot tables on the
card (which pixel each of the ``ref_budget`` slots takes, as
``compact_reference``), so nothing on the host touches the reference.
``prepare_reference`` is the plain version of that route
(``reference_points``). The plain linearization takes an optional
``group``, a ``torch.distributed`` process group over which the points
are sharded (pixel rows, parallel/sharded.py): every sum the JAX package
``psum``s is all-reduced over it (one all-reduce a sum of the JAX
package's, row by row), the plain version of the split mode.
``pixel_route(group)`` says when the tracker takes the pixel route.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dvo_slam_tpu_torch import _build
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
# The split mode's stage launches (``track_level_split``) and the
# all-reduces of its stage buffer, since the last reset.
LAUNCHES_TRACK_LEVEL_SPLIT = 0
COLLECTIVES_SPLIT = 0
# Under nccl the split route replays a CUDA graph of each iteration's
# stages and all-reduces: the graphs captured (one a workspace and unit)
# and replayed since the last reset. A replay's launches and all-reduces
# count in the two counts above.
CAPTURES_SPLIT = 0
REPLAYS_SPLIT = 0
# Calls of prepare_reference since the last reset (a plain integer): the
# slab route makes none.
PREPARE_REFERENCE_CALLS = 0

# Layouts of the kernel's outputs (csrc/linearize.cu kOut*, kLevel* and
# kExtra*): mode (a)'s Linearization vector; mode (b)'s row: the pose (16),
# the log-likelihood of the level's record (right after the pose: one view
# holds both, ``dense_tracker.pose_and_loglik``), the tracker's record of
# the last accepted linearization (50), the statistics (5,
# max_iterations: valid, error, delta_norm, accepted, and zeros for the
# TPU sampler's window misses), then the extras: the level's selected
# count and the track result's entropy and valid ratio from the level's
# record (the finest level's are the result's).
_OUT_SIZE = 53
_OUT_MAD = 51  # the MAD scale's selected |rI|, |rZ| (kOutMad)
_LEVEL_T, _LEVEL_LOGLIK, _LEVEL_BEST, _LEVEL_STATS = 0, 16, 17, 67
_STAT_PLANES = 5
_EXTRA_SELECTED, _EXTRA_ENTROPY, _EXTRA_RATIO = 0, 1, 2
_EXTRA_SIZE = 3
# Clusters of at most 16 CTAs (a non-portable size on Hopper).
_MAX_CLUSTER = 16
# Reference slabs passed by row pointer (csrc/linearize.cu kMaxRefRows),
# and where the slab route finds a row's slab (kTable*): at a stride from
# the first, by a row pointer among the launch's parameters, or by a row
# pointer in a table in device memory.
_MAX_REF_ROWS = 32
_TABLE_STRIDE, _TABLE_PARAMS, _TABLE_DEVICE = 0, 1, 2
# The split mode's stage buffer (csrc/linearize.cu kSum*, kSplitSums): a
# row's stage sums in the first columns, then its valid and selected
# counts, its done flag and the Sigma steps its iteration takes; the
# state's floats a row (kSplitStateWords) and the word of its CTA ticket
# (kSplitTicketWord, 0 between launches); the stage code of a level's
# last launch (kStageFinish).
_SUM_VALID, _SUM_SELECTED, _SUM_DONE, _SUM_STEPS = 29, 30, 31, 32
_SPLIT_SUMS = 33
_SPLIT_STATE_WORDS = 112
_SPLIT_TICKET_WORD = 10
_STAGE_FINISH = 1024
# The split mode's phase-timing buffer (csrc/linearize.cu
# kSplitTimingSlots): %globaltimer at row 0's rank-0 CTA's start and end,
# then clock64 at its start and at the end of each phase of _SPLIT_PHASES.
_SPLIT_TIMING_SLOTS = 9
_SPLIT_PHASES = ("carry", "decision", "pass", "reduction", "barrier",
                 "write-out")
# Bytes of a point the split mode keeps between its launches (csrc/
# linearize.cu kPointBytes: 9 floats and the valid flag).
_POINT_BYTES = 37
# The split mode's t-distribution launches (csrc/linearize.cu
# kSplitThreads, kMaxSplitCtas, kPartialStride): threads a CTA, CTAs a row
# at most, doubles of a CTA's partial sums.
_SPLIT_THREADS = 256
_MAX_SPLIT_CTAS = 256
_PARTIAL_STRIDE = 32
# The kernel's codes of the scale estimators (use_weighting off: "none")
# and influence functions (csrc/linearize.cu kEst*, kInf*).
_ESTIMATORS = {"tdist": 0, "unit": 1, "normal": 2, "mad": 3, "none": 4}
_INFLUENCES = {"unit": 0, "huber": 1, "tukey": 2, "tdist": 3}


def level_row_size(max_iterations: int) -> int:
    """Floats of one row of mode (b)'s output."""
    return _LEVEL_STATS + _STAT_PLANES * max_iterations + _EXTRA_SIZE


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


class SlabTable(NamedTuple):
    """Row pointers to (6, H, W) slabs held in device memory, where a
    launch reads them (the chunked keyframe scan's tables, whose keyframe
    entry a kernel writes: ops/scan_step.py): ``table`` a (B,) int64
    tensor on the slabs' device, row b the data pointer of a contiguous
    slab of ``shape`` among ``pyramids`` (tuples of every level's slab),
    at ``level``. ``pyramids`` holds every slab the table may point at
    (the host cannot tell which without reading the table) and is what
    keeps them alive."""

    table: torch.Tensor
    shape: tuple
    pyramids: object
    level: int

    def slabs(self):
        """The slabs the table points at, read back from the device (a
        host sync: for the plain versions only)."""
        by_ptr = {p[self.level].data_ptr(): p[self.level]
                  for p in self.pyramids}
        return [by_ptr[int(x)] for x in self.table.tolist()]


class RefSlabs(NamedTuple):
    """A level's reference as its (6, H, W) slabs, for the slab route: the
    kernels compute each point (back-projection, selection, reference
    gradients) from the slab, as ``prepare_reference`` does. ``rows``: a
    (B, 6, H, W) tensor whose rows are contiguous (row b at a stride, 0
    repeating one slab), a sequence of B (6, H, W) contiguous tensors (at
    most 32: row pointers, no stack), or a ``SlabTable`` (row pointers in
    device memory, any B)."""

    rows: object

    def stacked(self):
        """The rows as one (B, 6, H, W) tensor (a stack of a sequence or
        of a table's slabs)."""
        r = self.rows
        if isinstance(r, torch.Tensor):
            return r
        if isinstance(r, SlabTable):
            r = r.slabs()
        return torch.stack(list(r))


def reference_points(ref, K, cfg: TrackerConfig) -> RefData:
    """A level's reference as (B, N) points: ``ref`` itself, or
    ``prepare_reference`` of a RefSlabs' rows (the slab route's plain
    version)."""
    if isinstance(ref, RefSlabs):
        return prepare_reference(ref.stacked(), K, cfg)
    return ref


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
    global PREPARE_REFERENCE_CALLS
    PREPARE_REFERENCE_CALLS += 1
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
    budget = ref_budget(cfg, H, W)
    return compact_reference(ref, budget) if budget else ref


# Points per slot tile under compaction: the JAX package's gather-path
# tile (its Pallas path rounds to 2048; the port has only the gather).
_COMPACT_TILE_GATHER = 128


def compact_budget(n_points: int, frac: float, tile: int) -> int:
    """Static slot count for compact_reference: round_up(frac * n) to a
    tile multiple, at least one tile, never more than a tile-rounded n."""
    want = max(math.ceil(frac * n_points), 1)
    up = lambda x: ((x + tile - 1) // tile) * tile  # noqa: E731
    return min(up(want), up(n_points))


def ref_budget(cfg: TrackerConfig, H: int, W: int) -> int:
    """The compaction slots of an H x W level under ``cfg`` (0: the full
    grid, ``point_budget_fraction`` 0): the N of its reference points."""
    if cfg.point_budget_fraction <= 0.0:
        return 0
    return compact_budget(H * W, cfg.point_budget_fraction,
                          _COMPACT_TILE_GATHER)


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


def pixel_route(group) -> bool:
    """True where the tracker runs a pixel-sharded level (reference rows
    split over the ranks of the ``torch.distributed`` process group
    ``group``): a group of more than one rank. A launch cannot wait on
    another process, so there the card runs the split mode
    (``track_level_split``: stage launches with the group's all-reduces
    between them), and the CPU its plain version, the host loop over
    ``linearize_batched_reference`` with every sum all-reduced over the
    group. The group alone picks the route; a group of one rank, or None,
    leaves the kernels' route."""
    if group is None:
        return False
    import torch.distributed as dist

    return dist.get_world_size(group) > 1


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
    Linearization whose every field has a leading B. A CUDA slab runs mode
    (a); a CPU slab runs ``linearize_reference`` row by row (gathering
    through ``sampler.sample_slab``, the plain sampler there). ``ref`` may
    be ``RefSlabs`` (N then ``ref_budget`` slots under compaction)."""
    _check_device(cur_slab)
    if cur_slab.device.type == "cuda":
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
    ref = reference_points(ref, K, cfg)
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
# pass: (rI, rZ, valid), each (B, N), allocated once and reused; and the
# same call's MAD elements, a (B, 2) view of its output.
_RESIDUALS = {}
_MAD_ELEMENTS = {}


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


def kernel_mad_elements(device, N, B=None):
    """The MAD elements of the last mode (a) call over B rows of N points
    on the current stream of ``device``: per row the |rI| and |rZ| that
    ``robust.scale_mad`` reads from its sort (before the 1.4826 factor;
    +inf with no valid point, 0 under the other estimators), (B, 2), or
    (2,) for B None. For holding the kernel's selection to the plain
    version's, bit for bit."""
    device = torch.device(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    out = _MAD_ELEMENTS[(device, stream, 1 if B is None else B, N)]
    return out[0] if B is None else out


def _check(ref, cur_slab, K, T, cfg: TrackerConfig, ref_H=None):
    """Raise on inputs the kernels do not take; returns (B, N). ``ref_H``:
    the reference slabs' rows where they are a pixel band (None: the
    current slab's H)."""
    H, W = cur_slab.shape[-2:]
    if H < 2 or W < 2:
        raise ValueError(f"want a slab of H, W >= 2, got {H}x{W}")
    ref_H = H if ref_H is None else ref_H
    B = T.shape[0]
    if isinstance(ref, RefSlabs) and isinstance(ref.rows, SlabTable):
        t = ref.rows.table
        if (t.dtype != torch.int64 or t.shape != (B,) or t.stride(0) != 1
                or t.device != cur_slab.device):
            raise ValueError(f"want a ({B},) int64 table of row pointers on "
                             f"{cur_slab.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if tuple(ref.rows.shape) != (pyr.NUM_CHANNELS, ref_H, W):
            raise ValueError(f"want ({pyr.NUM_CHANNELS}, {ref_H}, {W}) "
                             f"reference slabs, got {tuple(ref.rows.shape)}")
        named = []
        N = ref_budget(cfg, ref_H, W) or ref_H * W
    elif isinstance(ref, RefSlabs):
        rows = (list(ref.rows) if not isinstance(ref.rows, torch.Tensor)
                else [ref.rows[b] for b in range(ref.rows.shape[0])])
        if isinstance(ref.rows, torch.Tensor) and ref.rows.dim() != 4:
            raise ValueError("want (B, 6, H, W) reference slabs")
        if len(rows) != B or (not isinstance(ref.rows, torch.Tensor)
                              and B > _MAX_REF_ROWS):
            raise ValueError(f"{len(rows)} reference slabs for {B} rows (a "
                             f"sequence takes at most {_MAX_REF_ROWS})")
        for r in rows:
            if tuple(r.shape) != (pyr.NUM_CHANNELS, ref_H, W) or (
                    not r.is_contiguous()):
                raise ValueError(f"want contiguous ({pyr.NUM_CHANNELS}, "
                                 f"{ref_H}, {W}) reference slabs, got "
                                 f"{tuple(r.shape)}")
        named = [("reference slab", r) for r in rows]
        N = ref_budget(cfg, ref_H, W) or ref_H * W
    else:
        named = [("ref.px", ref.px)]
        if ref.px.dim() != 2 or ref.px.shape[0] != B:
            raise ValueError(f"want (B, N) reference points for {B} rows, got "
                             f"{tuple(ref.px.shape)}")
        if not all(f is None or f.is_contiguous() for f in ref):
            raise ValueError("the reference points must be contiguous")
        N = ref.px.shape[1]
    for name, t in (("cur_slab", cur_slab), ("K", K), ("T", T), *named):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != cur_slab.device:
            raise ValueError(f"{name} on {t.device}, slab on "
                             f"{cur_slab.device}")
    if T.shape != (B, 4, 4) or T[0].stride() != (4, 1):
        raise ValueError(f"want T (B, 4, 4), each row contiguous, got "
                         f"{tuple(T.shape)}")
    if cur_slab.dim() == 4 and cur_slab.shape[0] != B:
        raise ValueError(f"{cur_slab.shape[0]} current slabs for {B} rows")
    if not cur_slab.is_contiguous():
        raise ValueError("cur_slab must be contiguous")
    return B, N


def _kernel_args(ref, cur_slab, K, T, cfg: TrackerConfig, slots=None,
                 ref_H=None):
    """The arguments of the entry points of csrc/linearize.cu after the
    checks: ``(B, N, refs, scale, table)``, refs from B to K, scale from
    use_depth to the scale floors (T goes between them), and the ctypes
    array of the slab route's row pointers, which must live until the
    launch. On the slab route under compaction N is the budget and
    ``slots`` the global slot table (``_slot_table``; None where the
    launch keeps it in shared memory). ``ref_H``: a pixel band's rows
    (``_check``). A config the kernel has no code for raises."""
    estimator = cfg.scale_estimator if cfg.use_weighting else "none"
    if estimator not in _ESTIMATORS or cfg.influence not in _INFLUENCES:
        raise ValueError(f"the linearization kernel has no scale estimator "
                         f"{estimator!r} or influence {cfg.influence!r}")
    B, N = _check(ref, cur_slab, K, T, cfg, ref_H)
    C, H, W = cur_slab.shape[-3:]
    ref_H = H if ref_H is None else ref_H
    ref_grad = cfg.gradient_source == "reference"
    if C < ((2 if cfg.use_depth else 1) if ref_grad else 6):
        raise ValueError(f"the slab has {C} channels, too few for {cfg}")
    if isinstance(ref, RefSlabs):
        if isinstance(ref.rows, SlabTable):
            # The table's device address itself: the launch reads it.
            table = ref.rows.table.data_ptr()
            stride, by_table = 0, _TABLE_DEVICE
        elif isinstance(ref.rows, torch.Tensor):
            table = (ctypes.c_void_p * 1)(ref.rows.data_ptr())
            stride, by_table = ref.rows.stride(0), _TABLE_STRIDE
        else:
            table = (ctypes.c_void_p * B)(*(r.data_ptr() for r in ref.rows))
            stride, by_table = 0, _TABLE_PARAMS
        points = (None,) * 9 + (table, stride, by_table,
                                cfg.intensity_grad_threshold,
                                cfg.depth_grad_threshold,
                                ref_budget(cfg, ref_H, W),
                                None if slots is None else slots.data_ptr())
    else:
        table = None
        points = (
            ref.px.data_ptr(), ref.py.data_ptr(), ref.pz.data_ptr(),
            ref.i1.data_ptr(), ref.selected.data_ptr(),
            ref.gix.data_ptr() if ref_grad else None,
            ref.giy.data_ptr() if ref_grad else None,
            ref.gzx.data_ptr() if ref_grad and cfg.use_depth else None,
            ref.gzy.data_ptr() if ref_grad and cfg.use_depth else None,
            None, 0, 0, 0.0, 0.0, 0, None)
    refs = (B, *points,
            # Row b's slab starts b * stride floats in; 0 shares one slab.
            N, cur_slab.data_ptr(), C * H * W if cur_slab.dim() == 4 else 0,
            H, W, K.data_ptr())
    scale = (int(cfg.use_depth), int(ref_grad), cfg.tdist_dof,
             cfg.min_intensity_sigma**2, cfg.min_depth_sigma**2,
             cfg.tdist_scale_iters, cfg.tdist_scale_warm_iters,
             _ESTIMATORS[estimator], _INFLUENCES[cfg.influence], cfg.huber_k,
             cfg.tukey_b, cfg.min_intensity_sigma, cfg.min_depth_sigma)
    return B, N, refs, scale, table


def level_plan(device, N, compact=False):
    """``(C, points per CTA, kept in shared memory, dynamic shared memory
    bytes per CTA, slot table in shared memory)`` of a launch over N
    points on ``device`` (``compact``: N compaction slots on the slab
    route; the last field is False without compaction)."""
    C = cluster_size(N)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = _build.load().dvo_level_plan(N, C, int(compact), out)
    if rc != 0:
        raise RuntimeError(f"dvo_level_plan failed: CUDA error {rc}")
    return C, out[0], bool(out[1]), out[2], bool(out[3])


# Per (device, N): whether a compacted launch over N slots keeps its slot
# tables in shared memory (level_plan's last field).
_SLOTS_SHARED = {}


def _slot_table(ref, cur_slab, B, cfg: TrackerConfig):
    """The global (B, budget) int32 slot table of a compacted slab-route
    launch whose slot tables do not fit in shared memory (a new tensor on
    the slab's device), else None."""
    budget = ref_budget(cfg, *cur_slab.shape[-2:])
    if not budget or not isinstance(ref, RefSlabs):
        return None
    key = (cur_slab.device, budget)
    if key not in _SLOTS_SHARED:
        _SLOTS_SHARED[key] = level_plan(cur_slab.device, budget, True)[4]
    if _SLOTS_SHARED[key]:
        return None
    return torch.empty((B, budget), dtype=torch.int32, device=cur_slab.device)


def unpack_linearization(out) -> Linearization:
    """The Linearization (fields with a leading B) in mode (a)'s (B, 53)
    output: views, and the fields in the order of csrc/linearize.cu's
    kOut* offsets (the MAD elements past them are not a field)."""
    B = out.shape[0]
    err_mean, n_valid, n_raw, *_, log1p_sum, err_raw = out[
        :, 42:_OUT_MAD].unbind(-1)
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
    """Mode (b)'s outputs from its (..., level_row_size) float and (..., 2)
    int32 tensors (csrc/linearize.cu's kLevel* offsets; the statistics'
    first four planes)."""
    M = max_iterations
    stats = out[..., _LEVEL_STATS:_LEVEL_STATS + 4 * M].unflatten(-1, (4, M))
    return LevelResult(
        T=out[..., _LEVEL_T:_LEVEL_LOGLIK].unflatten(-1, (4, 4)),
        best=out[..., _LEVEL_BEST:_LEVEL_STATS], valid=stats[..., 0, :],
        error=stats[..., 1, :], delta_norm=stats[..., 2, :],
        accepted=stats[..., 3, :] != 0, iterations=out_i[..., 0],
        termination=out_i[..., 1])


def _rows_of(T):
    """T (B, 4, 4) with contiguous rows, and its row stride in floats (a
    strided view, such as the last level's poses in mode (b)'s output,
    is passed as it is)."""
    if T.stride()[1:] != (4, 1):
        T = T.contiguous()
    return T, T.stride(0)


def linearize_kernels_batched(ref, cur_slab, K, T, cfg: TrackerConfig,
                              sigma_init=None,
                              sigma_warm=False) -> Linearization:
    """``linearize_batched`` on the card through mode (a) of
    csrc/linearize.cu, for every config: one launch of one cluster per row
    on the current stream of the slab's device, with no host sync.
    ``ref``: RefData, or RefSlabs (the slab route). ``sigma_warm`` is one
    host bool for the whole batch (all rows enter a level together); it
    and ``sigma_init`` matter to the t-distribution only, as in the JAX
    package."""
    global LAUNCHES_LINEARIZE
    K, T = K.contiguous(), T.contiguous()
    slots = _slot_table(ref, cur_slab, T.shape[0], cfg)
    B, N, refs, scale, _table = _kernel_args(ref, cur_slab, K, T, cfg, slots)
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
    _MAD_ELEMENTS[key] = out[:, _OUT_MAD:]
    _build.launch("dvo_linearize", dev, (
        *refs, T.data_ptr(), *scale,
        sigma_init.data_ptr() if warm else None, int(warm),
        cluster_size(N), out.data_ptr(), *(t.data_ptr() for t in res)))
    LAUNCHES_LINEARIZE += 1
    LAUNCHES_BY_BATCH[("linearize", B)] = (
        LAUNCHES_BY_BATCH.get(("linearize", B), 0) + 1)
    return unpack_linearization(out)


def loglik_constant(nu: float) -> float:
    """lgamma((nu + 2) / 2) - lgamma(nu / 2) - log(nu pi): the part of the
    bivariate t log-likelihood's normaliser that depends on the degrees of
    freedom only (``tdist_loglik``), in f64 on the host."""
    return (math.lgamma((nu + 2.0) / 2.0) - math.lgamma(nu / 2.0)
            - math.log(nu * math.pi))


def track_level_kernels(ref, cur_slab, K, T_init, cfg: TrackerConfig,
                        out=None, out_i=None):
    """A pyramid level's IRLS loop for B rows on the card: mode (b) of
    csrc/linearize.cu, one launch of one cluster per row on the current
    stream of the slab's device, no host sync. Arguments as
    ``linearize_batched`` (``ref`` RefData or RefSlabs; T_init (B, 4, 4),
    its rows contiguous, at any row stride). Writes, and returns, mode
    (b)'s raw outputs ``(out (B, level_row_size) f32, out_i (B, 2) int32)``
    for ``unpack_level``: new tensors, or the given ones (views whose rows
    are contiguous, at any row stride: a level's slot in a buffer of all
    levels). Each row holds the log-likelihood of the level's record at
    ``_LEVEL_LOGLIK`` and ends with the extras (``_EXTRA_*``): the
    selected count and the entropy and valid ratio of that record. With
    ``cfg.mu > 0`` the record's A is the posterior information A + mu I
    (the kernel adds the prior once, as the level ends)."""
    global LAUNCHES_TRACK_LEVEL
    if cfg.max_iterations < 1:
        raise ValueError("the level kernel needs max_iterations >= 1")
    if not cfg.mu >= 0.0:
        raise ValueError(f"the level kernel needs mu >= 0, got {cfg.mu}")
    K = K.contiguous()
    T_init, T_stride = _rows_of(T_init)
    slots = _slot_table(ref, cur_slab, T_init.shape[0], cfg)
    B, N, refs, scale, _table = _kernel_args(ref, cur_slab, K, T_init, cfg,
                                             slots)
    dev = cur_slab.device
    out, out_i = _level_outputs(out, out_i, B, cfg, dev)
    _build.launch("dvo_track_level", dev, (
        *refs, T_init.data_ptr(), T_stride, *scale,
        *_loop_args(cfg, N, out, out_i)))
    LAUNCHES_TRACK_LEVEL += 1
    LAUNCHES_BY_BATCH[("track_level", B)] = (
        LAUNCHES_BY_BATCH.get(("track_level", B), 0) + 1)
    return out, out_i


def _level_outputs(out, out_i, B, cfg: TrackerConfig, dev):
    """Mode (b)'s (B, level_row_size) f32 and (B, 2) int32 outputs: new
    tensors, or the given ones checked (rows contiguous, any row
    stride)."""
    S = level_row_size(cfg.max_iterations)
    if out is None:
        out = torch.empty((B, S), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, 2), dtype=torch.int32, device=dev)
    for t, size, dtype in ((out, S, torch.float32), (out_i, 2, torch.int32)):
        if (t.shape != (B, size) or t.stride(1) != 1 or t.dtype != dtype
                or t.device != dev):
            raise ValueError(f"want a ({B}, {size}) {dtype} output with "
                             f"contiguous rows on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return out, out_i


def _loop_args(cfg: TrackerConfig, N, out, out_i):
    """Mode (b)'s arguments from max_iterations to the log-likelihood
    constant (the IRLS loop, the cluster size and the outputs)."""
    use_lm = cfg.lm_lambda_init > 0.0
    return (cfg.max_iterations, cfg.precision,
            cfg.lm_lambda_init if use_lm else 0.0, cfg.lm_lambda_up,
            cfg.lm_lambda_down, cfg.lm_lambda_max, cfg.mu, cluster_size(N),
            out.data_ptr(), out.stride(0), out_i.data_ptr(), out_i.stride(0),
            loglik_constant(cfg.tdist_dof))


class StagePlan(NamedTuple):
    """Stage launches of one IRLS iteration on the split route, each
    followed by one all-reduce of the stage buffer: a level's first
    iteration (``cold``) and a later one (``warm``; the Sigma warm start's
    shorter fixed point where ``tdist_scale_warm_iters > 0`` and the
    carried Sigma is finite)."""

    cold: int
    warm: int


def stage_plan(cfg: TrackerConfig) -> StagePlan:
    """The split route's stages an iteration under ``cfg``: where the JAX
    package's pixel-sharded linearization (dvo_slam_tpu/ops/linearize.py)
    must wait on a psum. The t-distribution: the residual pass (valid
    count and moments), one stage a Sigma step, the normal equations
    (log1p and error sums, A, b): 2 + the steps. Every other estimator
    takes its scale per rank with no psum, so its count, A, b and sums
    reduce together: one stage. Point budgets and the motion prior add
    none."""
    if cfg.use_weighting and cfg.scale_estimator == "tdist":
        warm = cfg.tdist_scale_warm_iters or cfg.tdist_scale_iters
        return StagePlan(2 + cfg.tdist_scale_iters, 2 + warm)
    return StagePlan(1, 1)


class SplitArgs(NamedTuple):
    """One split-route level's launch arguments and buffers."""

    args: tuple  # dvo_track_level_split's, up to stage, steps, iter, stream
    # (the last of them timing: null)
    state: torch.Tensor  # (B, _SPLIT_STATE_WORDS) f32, the rows' carry
    sums: torch.Tensor  # (B, _SPLIT_SUMS) f64, the stage buffer
    points: torch.Tensor  # uint8, the points kept between launches
    slots: Optional[torch.Tensor]  # (B, budget) int32 under compaction
    out: torch.Tensor  # mode (b)'s outputs
    out_i: torch.Tensor
    keep: object  # what the pointers point at (alive until the last launch)


def split_args(ref, cur_slab, K, T_init, cfg: TrackerConfig,
               row0: int) -> SplitArgs:
    """The arguments of the split route's launches over a rank's band:
    ``ref`` RefSlabs of B (6, h, W) bands of reference rows starting at
    image row ``row0``, ``cur_slab`` the whole current slabs (6, H, W) or
    (B, 6, H, W); the compaction budget is the band's own
    (``ref_budget(cfg, h, W)``, as ``prepare_reference`` of the band
    compacts); the state, stage buffer, kept points and slot table new
    tensors on the slab's device; the t-distribution's CTAs a row
    ``split_ctas`` on the slab's card (1 SM off the card, where nothing
    launches); new outputs in ``track_level_kernels``' layout."""
    if not isinstance(ref, RefSlabs):
        raise ValueError("the split route reads the reference band's slabs "
                         "(RefSlabs)")
    if cfg.max_iterations < 1:
        raise ValueError("the level kernel needs max_iterations >= 1")
    if not cfg.mu >= 0.0:
        raise ValueError(f"the level kernel needs mu >= 0, got {cfg.mu}")
    if row0 < 0:
        raise ValueError(f"a band starts at image row >= 0, not {row0}")
    h = _band_rows(ref)
    K = K.contiguous()
    T_init, T_stride = _rows_of(T_init)
    B, dev = T_init.shape[0], cur_slab.device
    budget = ref_budget(cfg, h, cur_slab.shape[-1])
    slots = (torch.empty((B, budget), dtype=torch.int32, device=dev)
             if budget else None)
    B, N, refs, scale, table = _kernel_args(ref, cur_slab, K, T_init, cfg,
                                            slots, ref_H=h)
    out, out_i = _level_outputs(None, None, B, cfg, dev)
    # Zeroed: each row's CTA ticket starts the level at 0.
    state = torch.zeros((B, _SPLIT_STATE_WORDS), dtype=torch.float32,
                        device=dev)
    sums = torch.empty((B, _SPLIT_SUMS), dtype=torch.float64, device=dev)
    points = torch.empty(B * split_points_bytes(N), dtype=torch.uint8,
                         device=dev)
    sms = _build.sm_count(dev.index) if dev.type == "cuda" else 1
    args = (*refs, T_init.data_ptr(), T_stride, *scale,
            *_loop_args(cfg, N, out, out_i), h, row0, state.data_ptr(),
            sums.data_ptr(), points.data_ptr(), split_ctas(N, B, sms), None)
    return SplitArgs(args, state, sums, points, slots, out, out_i,
                     (table, K, T_init))


def split_points_bytes(N: int) -> int:
    """Bytes of one row of the split mode's buffer (csrc/linearize.cu
    split_row_bytes): the N points it keeps between its launches, 37 bytes
    each (planes of N floats, then the valid flags), rounded up to 16
    bytes; then the partial sums of up to _MAX_SPLIT_CTAS CTAs."""
    return ((_POINT_BYTES * N + 15) // 16 * 16
            + _MAX_SPLIT_CTAS * _PARTIAL_STRIDE * 8)


def split_ctas(N: int, B: int, sms: int) -> int:
    """Plain CTAs a row of the split mode's t-distribution launches (of
    _SPLIT_THREADS threads, two resident an SM) over N points at B rows on
    a card of ``sms`` SMs: a point a thread while the B rows' CTAs fit in
    one wave, else the most that do (at least one, at most
    _MAX_SPLIT_CTAS); then as few as hold the same points a CTA, so that
    none is empty. CTA r takes points [r P, min((r + 1) P, N)), P =
    ceil(N / CTAs)."""
    ctas = max(1, min(-(-N // _SPLIT_THREADS), (2 * sms) // B,
                      _MAX_SPLIT_CTAS))
    return -(-N // -(-N // ctas))



def split_timing_buffer(device):
    """A zeroed phase-timing buffer for a split stage launch (put its
    data pointer in place of the launch's null ``timing`` argument):
    (_SPLIT_TIMING_SLOTS,) int64."""
    return torch.zeros((_SPLIT_TIMING_SLOTS,), dtype=torch.int64,
                       device=device)


def split_phase_times(timing):
    """A split stage launch's phase split from its filled timing buffer
    (host numpy int64, (_SPLIT_TIMING_SLOTS,)): ({phase of _SPLIT_PHASES:
    device us}, row 0's rank-0 CTA's device us from its start to its
    end). clock64 spans are converted by the CTA's %globaltimer span over
    its clock64 span."""
    t = np.asarray(timing, np.int64)
    ns = float(t[1] - t[0])
    ns_per_clock = ns / max(float(t[8] - t[2]), 1.0)
    return ({name: float(t[3 + i] - t[2 + i]) * ns_per_clock / 1e3
             for i, name in enumerate(_SPLIT_PHASES)}, ns / 1e3)


def split_verdict(flags, world: int):
    """The host's reading of a stage 0's all-reduced done flags and Sigma
    steps (``flags`` (B, 2): each summed over the ``world`` ranks):
    ``(all rows done, the Sigma steps of the iteration's live rows)``.
    Ranks that disagree on a row's done flag would go on to call
    different collectives (the plain route's gloo aborts on the mismatch,
    the JAX package's rendezvous times out): raise instead, on every rank
    alike, since all read the same totals."""
    done = [float(x) for x in flags[:, 0]]
    if any(0.0 < d < world for d in done):
        raise RuntimeError(
            "the pixel ranks' IRLS decisions parted (a row stopped on some "
            "ranks and not on others; off the t-distribution each rank "
            "weighs its error by its own scale, as the JAX package does): "
            f"done flags summed over {world} ranks {done}")
    live = [int(round(float(s) / world)) for d, s in zip(done, flags[:, 1])
            if d == 0.0]
    return not live, max(live, default=0)


def _split_flags(sums):
    """A stage 0's all-reduced done flags and Sigma steps, (B, 2), on the
    host (the split route's one read an iteration)."""
    return sums[:, _SUM_DONE:_SUM_STEPS + 1].cpu()


class _EagerIssue:
    """Issues a split level's stages one by one: a launch, then the
    all-reduce of the stage buffer (none after the finish)."""

    def __init__(self, launch, all_reduce, tdist):
        self.launch, self.all_reduce, self.tdist = launch, all_reduce, tdist

    def stage(self, code, steps, k):
        self.launch(code, steps, k)
        if code != _STAGE_FINISH:
            self.all_reduce()

    def stages(self, steps, k):
        """Iteration k's stages after its stage 0: the Sigma steps and the
        normal equations (none off the t-distribution)."""
        if self.tdist:
            for j in range(1, steps + 2):
                self.stage(j, steps, k)

    def unit(self, steps, k):
        """The loop's repeating unit: iteration k's stages after its stage
        0, then stage 0 of iteration k + 1 (which first takes iteration
        k's decision)."""
        self.stages(steps, k)
        self.stage(0, steps, k + 1)


class _GraphIssue(_EagerIssue):
    """Issues the repeating unit as one CUDA graph replay: the unit of
    each Sigma step count (cold and warm) captured once into ``units``
    (a workspace's, so later calls at its shapes replay it), from the
    eager unit's launches and all-reduces (``_capture``; the kernel
    reads its iteration only at stage 0 of iteration 0, which no unit
    holds, so one unit serves every iteration). The launches and
    all-reduces of a replay count as issued."""

    def __init__(self, launch, all_reduce, tdist, units, device):
        super().__init__(launch, all_reduce, tdist)
        self.units, self.device = units, device

    def unit(self, steps, k):
        global LAUNCHES_TRACK_LEVEL_SPLIT, COLLECTIVES_SPLIT, REPLAYS_SPLIT
        if steps not in self.units:
            before = (LAUNCHES_TRACK_LEVEL_SPLIT, COLLECTIVES_SPLIT)
            graph = _capture(self.device,
                             lambda: _EagerIssue.unit(self, steps, k))
            counts = (LAUNCHES_TRACK_LEVEL_SPLIT - before[0],
                      COLLECTIVES_SPLIT - before[1])
            # A capture launches nothing.
            LAUNCHES_TRACK_LEVEL_SPLIT, COLLECTIVES_SPLIT = before
            self.units[steps] = (graph, counts)
        graph, (launches, collectives) = self.units[steps]
        _replay(graph)
        LAUNCHES_TRACK_LEVEL_SPLIT += launches
        COLLECTIVES_SPLIT += collectives
        REPLAYS_SPLIT += 1


def _capture(device, fn):
    """A CUDA graph of what ``fn`` issues on ``device``: captured on a
    side stream in thread-local mode (the process group's watchdog thread
    goes on querying its events meanwhile), ordered after the current
    stream's work. A failed capture raises."""
    global CAPTURES_SPLIT
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        current.wait_stream(side)
    CAPTURES_SPLIT += 1
    return graph


def _replay(graph):
    """One replay of a captured unit on the current stream."""
    graph.replay()


def graph_issue(group) -> bool:
    """Whether the split route issues each iteration as one CUDA graph
    replay: under nccl, whose all-reduce runs on the card's stream and is
    captured with the launches. gloo's goes through the host; its issue
    stays eager."""
    import torch.distributed as dist

    return dist.get_backend(group) == "nccl"


class _Workspace:
    """A split level's buffers shared by every call at one key, so that
    the graphs one call captures serve the next (a graph holds its
    launches' pointers): the current slabs, intrinsics and initial poses
    copied in, the reference rows by a device table of row pointers
    (``SlabTable``), the split args' state, stage buffer, kept points,
    slot table and outputs, and the captured units by Sigma steps."""

    def __init__(self, cur_slab, cfg, row0, h, B):
        dev, W = cur_slab.device, cur_slab.shape[-1]
        self.cur = torch.empty(cur_slab.shape, dtype=torch.float32,
                               device=dev)
        self.table = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.K = torch.empty((4,), dtype=torch.float32, device=dev)
        self.T = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
        self.a = split_args(
            RefSlabs(SlabTable(self.table, (pyr.NUM_CHANNELS, h, W), None,
                               0)),
            self.cur, self.K, self.T, cfg, row0)
        self.units = {}

    def fill(self, ref, cur_slab, K, T_init):
        """This call's inputs into the workspace, on the current stream
        (the row pointers from pinned memory, no host sync), and the rows'
        carry zeroed (its CTA tickets start the call at 0)."""
        rows = ref.rows
        if isinstance(rows, SlabTable):
            self.table.copy_(rows.table)
        else:
            rows = rows.unbind(0) if isinstance(rows, torch.Tensor) else rows
            ptrs = torch.tensor([r.data_ptr() for r in rows],
                                dtype=torch.int64,
                                pin_memory=self.table.is_cuda)
            self.table.copy_(ptrs, non_blocking=True)
        self.cur.copy_(cur_slab)
        self.K.copy_(K)
        self.T.copy_(T_init)
        self.a.state.zero_()


def _band_rows(ref) -> int:
    rows = ref.rows
    if isinstance(rows, SlabTable):
        return rows.shape[-2]
    return (rows if isinstance(rows, torch.Tensor) else rows[0]).shape[-2]


def split_workspace(ref, cur_slab, T_init, cfg: TrackerConfig, group,
                    row0: int):
    """The workspace of a split level's call under ``group`` (see
    ``_Workspace``): the one made for the same (device, current slab
    shape, band rows, B, first row, config) before, else a new one, kept
    with the group (``parallel.group_state``) until it is destroyed
    (``parallel.destroy``)."""
    from .. import parallel

    h, B = _band_rows(ref), T_init.shape[0]
    key = ("split", cur_slab.device, tuple(cur_slab.shape), h, B, row0, cfg)
    kept = parallel.group_state(group)
    if key not in kept:
        kept[key] = _Workspace(cur_slab, cfg, row0, h, B)
    return kept[key]


def _split_loop(issue, cfg: TrackerConfig, flags, world: int):
    """A split level's loop over ``issue``: stage 0 of iteration 0, then a
    unit an iteration, each followed by the one read of the done flags
    (``flags()``, ``split_verdict``), until every row is done; past
    max_iterations - 1 units the last iteration's stages and the finish,
    which takes its decision."""
    steps = cfg.tdist_scale_iters if issue.tdist else 0
    issue.stage(0, steps, 0)
    for k in range(cfg.max_iterations - 1):
        issue.unit(steps, k)
        done, steps = split_verdict(flags(), world)
        if done:
            return
    issue.stages(steps, cfg.max_iterations - 1)
    issue.stage(_STAGE_FINISH, steps, cfg.max_iterations)


def track_level_split(ref, cur_slab, K, T_init, cfg: TrackerConfig, group,
                      row0: int = 0, out=None, out_i=None):
    """A pyramid level's IRLS loop for B rows on the pixel route on the
    card: the split mode of csrc/linearize.cu over this rank's band
    (``split_args``), its stage buffer all-reduced over the
    ``torch.distributed`` process group ``group`` after every stage launch.
    An iteration is ``stage_plan(cfg)`` stage launches and as many
    all-reduces; stage 0 of every later iteration first takes the one
    before's decision on the card, from the all-reduced totals, the same
    bits on every rank. The host reads the rows' done flags once an
    iteration, after stage 0's all-reduce (``split_verdict``); a level
    ends when every row is done, or after max_iterations with one more
    launch that takes the last decision.

    The launches run over a workspace kept with the group for the call's
    shapes (``split_workspace``): the inputs are copied in, the outputs
    out. The issue (``graph_issue``): under nccl the level's first stage,
    and its last iteration's stages and finish, are issued eagerly and
    every other iteration's stages and all-reduces, from the Sigma steps
    to the next stage 0, by one replay of a CUDA graph (``_GraphIssue``,
    kept in the workspace): one capture a shape and unit, every later
    call replays it. Under gloo, whose all-reduce goes through the host,
    every stage is issued eagerly. Writes, and returns, mode (b)'s
    outputs (``track_level_kernels``'). A failed build, launch, capture
    or replay raises; nothing falls back to the eager issue or the plain
    route."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    dev = cur_slab.device
    if not isinstance(ref, RefSlabs):
        raise ValueError("the split route reads the reference band's "
                         "slabs (RefSlabs)")
    ws = split_workspace(ref, cur_slab, T_init, cfg, group, row0)
    _check(ref, cur_slab, K, _rows_of(T_init)[0], cfg, ref_H=_band_rows(ref))
    out, out_i = _level_outputs(out, out_i, T_init.shape[0], cfg, dev)
    ws.fill(ref, cur_slab, K, T_init)
    a = ws.a

    def launch(code, steps, k):
        global LAUNCHES_TRACK_LEVEL_SPLIT
        _build.launch("dvo_track_level_split", dev, (*a.args, code, steps, k))
        LAUNCHES_TRACK_LEVEL_SPLIT += 1

    def all_reduce():
        global COLLECTIVES_SPLIT
        dist.all_reduce(a.sums, group=group)
        COLLECTIVES_SPLIT += 1

    tdist = stage_plan(cfg).cold > 1
    issue = (_GraphIssue(launch, all_reduce, tdist, ws.units, dev)
             if graph_issue(group) else _EagerIssue(launch, all_reduce, tdist))
    _split_loop(issue, cfg, lambda: _split_flags(a.sums), world)
    out.copy_(a.out)
    out_i.copy_(a.out_i)
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

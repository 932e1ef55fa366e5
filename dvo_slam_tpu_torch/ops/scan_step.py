"""The keyframe scan's per-frame decisions, and their kernel
(counterpart of the body of ``dvo_slam_tpu/models/keyframe_scan.py::
_make_step`` after the tracker: ``_entropy_ratio_jnp``,
``_fuse_relative_poses_jnp`` and the where-chain of ``step``).

After a frame's dual alignment (the keyframe and the previous frame
against the new frame, B = 2), the scan decides on the device whether the
frame becomes a keyframe (acceptance, the sign-safe entropy ratio against
the keyframe's first entropy, the forced flag), fuses the keyframe
measurement with the chained odometry (one information-weighted
Gauss-Newton step), picks the switch measurement, and carries the
keyframe, the poses and the entropy history to the next frame.

``scan_step_reference`` is those decisions in plain PyTorch, on a
TrackResult, the carry dict and the current pyramid: the per-frame
route's ``keyframe_scan._step`` calls it. ``scan_step`` runs the same
decisions on the raw buffers of the chunked scan's kernel route
(models/keyframe_scan.py ``_track_chunk_kernels``):

- frame k's rows of the level launches' output (``lev`` (2, levels,
  ``level_row_size``) f32, ``lev_i`` (2, levels, 2) int32: the finest
  level's pose, log-likelihood, information and extras, every level's
  iterations and statistics);
- the carry slot k (``state_in``, STATE_SIZE floats: the keyframe-relative
  pose, the next frame's odometry initial pose, the last odometry, the
  first entropy and its flag) and the table of reference slab pointers
  (``table_in`` (levels, 2) int64: the keyframe's and the previous
  frame's slab a tracked level);
- ``force`` (a 0-d bool) and the frame's tracked slabs (``cur``);

and writes frame k's packed output row (``output_layout``), carry slot
k + 1 and the table of frame k + 1 (row 0 the keyframe's slab: frame k's
where it switched; row 1 frame k's slab). On a CUDA tensor ``scan_step``
launches csrc/keyframe_scan.cu (``scan_step_kernel``), one small CTA, as a
programmatic dependent of the launch before it (the finest level's); on a
CPU tensor it runs ``scan_step_plain``, which computes the same buffers
through ``scan_step_reference`` (its kf swap over the pointer values).
The plain version on the card is ``scan_step_plain`` called directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from dvo_slam_tpu_torch import _build
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.ops import linearize as lin_ops
from dvo_slam_tpu_torch.ops import se3

# Launches of csrc/keyframe_scan.cu since the last reset (a plain integer;
# callers reset it to 0 to count the launches of one run).
LAUNCHES_SCAN_STEP = 0

# The carry slot (csrc/keyframe_scan.cu kState*): the keyframe-relative
# pose of the previous frame, the odometry initial pose of the next frame
# (the last odometry, or the identity without use_initial_estimate; with
# the first, the next frame's two initial poses as one (2, 4, 4) view),
# the last odometry, the keyframe's first entropy and whether it is set
# (int32 bits).
_STATE_T_KF_PREV, _STATE_ODO_INIT, _STATE_LAST_ODO = 0, 16, 32
_STATE_H_FIRST, _STATE_HAS_FIRST, STATE_SIZE = 48, 49, 50

# The kernel's phase-timing buffer (csrc/keyframe_scan.cu kTimingSlots):
# %globaltimer at the start and end, clock64 at the phase boundaries
# _PHASE_SLOTS and at the end (_CLOCK_END).
_TIMING_SLOTS = 13
_PHASE_SLOTS = {"before the wait": (2, 3), "loads": (3, 4),
                "finite checks": (4, 5), "T_alt": (5, 6), "log": (6, 7),
                "elimination": (7, 8), "exp": (8, 9),
                "decided writes": (9, 10), "copies": (2, 11)}
_CLOCK_START, _CLOCK_END = 2, 12

# Kinds of the packed row's entries: every entry is 4 bytes, booleans and
# integers stored as int32 bits (read on the device as views, on the host
# by ``host_arrays``).
F32, I32, BOOL = "f32", "i32", "bool"
# The fields models/chunked_slam.py's walk reads, in the order of the
# packed row, and the TrackStats planes that follow them with stats.
FIELDS = ("rel_pose", "switch", "Z_switch", "info_switch", "entropy",
          "entropy_ratio", "accept", "valid_ratio", "T_kf_meas",
          "T_odo_meas", "info_pair", "is_nan", "iterations")
STAT_FIELDS = ("valid", "error", "delta_norm", "accepted", "termination")


class Field(NamedTuple):
    name: str
    shape: tuple  # per frame
    kind: str
    offset: int  # floats into the row


@functools.lru_cache(maxsize=None)
def output_layout(levels: int, max_iterations: int, with_stats: bool):
    """The packed output row of one frame (csrc/keyframe_scan.cu kOut*):
    FIELDS, then with stats the five TrackStats planes of both alignments
    ((2, levels, max_iterations) each; termination (2, levels)). Returns
    a tuple of Field; ``row_width`` gives its floats."""
    L, M = levels, max_iterations
    shapes = (((4, 4), F32), ((), BOOL), ((4, 4), F32), ((6, 6), F32),
              ((), F32), ((), F32), ((), BOOL), ((), F32), ((4, 4), F32),
              ((4, 4), F32), ((2, 6, 6), F32), ((2,), BOOL), ((2, L), I32))
    specs = list(zip(FIELDS, shapes))
    if with_stats:
        specs += list(zip(STAT_FIELDS, (((2, L, M), F32), ((2, L, M), F32),
                                        ((2, L, M), F32), ((2, L, M), BOOL),
                                        ((2, L), I32))))
    out, at = [], 0
    for name, (shape, kind) in specs:
        out.append(Field(name, shape, kind, at))
        at += int(np.prod(shape, dtype=np.int64))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def row_width(layout) -> int:
    last = layout[-1]
    return last.offset + int(np.prod(last.shape, dtype=np.int64))


def _column(packed, f: Field):
    """Field f of an (n, row_width) packed tensor as a view in its dtype,
    (n, *shape)."""
    width = int(np.prod(f.shape, dtype=np.int64))
    col = packed[:, f.offset:f.offset + width]
    if f.kind == I32:
        col = col.view(torch.int32)
    elif f.kind == BOOL:
        # The low byte of each little-endian int32 0 or 1.
        col = col.view(torch.uint8)[:, ::4].view(torch.bool)
    return col.unflatten(-1, f.shape) if f.shape else col[:, 0]


def field_views(packed, layout) -> dict:
    """The scan's outputs (``keyframe_scan.track_keyframe_chunk``'s dict:
    FIELDS, and the stats as one tuple) as views of a packed (n,
    row_width) f32 tensor."""
    out = {f.name: _column(packed, f) for f in layout
           if f.name in FIELDS}
    stats = [_column(packed, f) for f in layout if f.name in STAT_FIELDS]
    if stats:
        out["stats"] = tuple(stats)
    return out


def pack(outs, layout):
    """The scan's outputs (a dict of tensors with a leading n, the stats as
    one tuple) packed into an (n, row_width) f32 tensor (one cat)."""
    stats = dict(zip(STAT_FIELDS, outs.get("stats", ())))
    cols = []
    for f in layout:
        t = outs[f.name] if f.name in FIELDS else stats[f.name]
        t = t.reshape(t.shape[0], -1)
        if f.kind != F32:
            t = t.to(torch.int32).view(torch.float32)
        cols.append(t)
    return torch.cat(cols, dim=1)


def host_arrays(host, layout):
    """numpy arrays of the fields of a packed (n, row_width) f32 numpy
    array, in their dtypes (f32, int32, bool), in the layout's order."""
    out = []
    n = host.shape[0]
    for f in layout:
        width = int(np.prod(f.shape, dtype=np.int64))
        col = host[:, f.offset:f.offset + width]
        if f.kind != F32:
            col = col.view(np.int32)
        if f.kind == BOOL:
            col = col != 0
        out.append(col.reshape(n, *f.shape).copy())
    return out


def state_of(carry, use_initial_estimate: bool):
    """A carry's slot (STATE_SIZE f32) built on its device from the carry
    dict (one cat)."""
    T = carry["T_kf_prev"]
    odo = carry["last_odo"]
    init = odo if use_initial_estimate else torch.eye(
        4, dtype=torch.float32, device=T.device)
    return torch.cat([T.reshape(16), init.reshape(16), odo.reshape(16),
                      carry["H_first"].reshape(1).to(torch.float32),
                      carry["has_first"].reshape(1).to(torch.int32).view(
                          torch.float32)])


def carry_of(state) -> dict:
    """The carry dict's pose and entropy entries as views of a carry slot:
    T_kf_prev, last_odo (4, 4), H_first (0-d f32), has_first (0-d
    bool)."""
    return {
        "T_kf_prev": state[_STATE_T_KF_PREV:_STATE_T_KF_PREV + 16].view(4, 4),
        "last_odo": state[_STATE_LAST_ODO:_STATE_LAST_ODO + 16].view(4, 4),
        "H_first": state[_STATE_H_FIRST],
        "has_first": state[_STATE_HAS_FIRST:_STATE_HAS_FIRST + 1].view(
            torch.uint8)[0].view(torch.bool),
    }


def inits_of(state):
    """The (2, 4, 4) initial poses of the frame a carry slot precedes (the
    keyframe-relative pose and the odometry initial pose), a view."""
    return state[_STATE_T_KF_PREV:_STATE_ODO_INIT + 16].view(2, 4, 4)


def entropy_ratio(h_cur, h_ref, has_ref):
    """Sign-safe entropy ratio (dense_tracker.entropy_ratio) on 0-d
    tensors. No reference yet -> 1.0 even for non-finite h_cur (the host
    orchestrator keeps tracking until a finite first entropy establishes
    history; only WITH history does non-finite entropy force a switch)."""
    ref = torch.where(has_ref, h_ref, h_cur)
    ratio = 1.0 - (h_cur - ref) / torch.clamp(
        ref.abs(), min=dense_tracker._ENTROPY_DENOM_FLOOR)
    ok = torch.isfinite(h_cur) & torch.isfinite(ref)
    return torch.where(has_ref, torch.where(ok, ratio, -torch.inf), 1.0)


def fuse_relative_poses(T_a, info_a, T_b, info_b):
    """Information-weighted SE(3) fusion (keyframe_tracker.
    fuse_relative_poses in f32 on the device): one Gauss-Newton step from
    T_a. ``solve_ex`` does not check for errors (``solve`` would, with a
    sync); a singular system gives a non-finite step, dropped below."""
    xi = se3.log(T_b @ se3.inverse(T_a))
    L = info_a + info_b
    delta = torch.linalg.solve_ex(L, (info_b @ xi)[:, None])[0][:, 0]
    good = torch.isfinite(delta).all()
    delta = torch.where(good, delta, torch.zeros_like(delta))
    return se3.exp(delta) @ T_a


def scan_step_reference(res, carry, force, cur, scan_cfg):
    """One frame's decisions after its dual alignment, in plain PyTorch:
    (track result of the two rows (keyframe, previous frame), carry,
    force, the frame's pyramid) -> (new carry, outputs), all on the
    device, no host sync. ``scan_cfg``: min_constraint_ratio,
    min_entropy_ratio, fuse_odometry (keyframe_scan.ScanConfig). The
    keyframe swap selects between ``cur`` and ``carry["kf"]`` level by
    level, whatever they hold (slabs, or their pointers)."""
    dev = carry["T_kf_prev"].device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    r_kf_T = res.transformation[0]
    r_odo_T = res.transformation[1]
    nan = res.is_nan()
    kf_nan, odo_nan = nan[0], nan[1]
    last_odo = torch.where(odo_nan, carry["last_odo"], r_odo_T)

    accept = (~kf_nan) & (res.valid_ratio[0] >= scan_cfg.min_constraint_ratio)
    h = res.entropy[0]
    ratio = torch.where(
        accept, entropy_ratio(h, carry["H_first"], carry["has_first"]), 1.0)
    switch = force | (~accept) | (ratio < scan_cfg.min_entropy_ratio)

    # Non-switch pose: keyframe measurement fused with chained odometry
    # (LocalMap keyframe+odometry measurements, closed form).
    T_alt = r_odo_T @ carry["T_kf_prev"]
    if scan_cfg.fuse_odometry:
        fused = fuse_relative_poses(r_kf_T, res.information[0], T_alt,
                                    res.information[1])
        T_kf_cur = torch.where(odo_nan, r_kf_T, fused)
    else:
        T_kf_cur = r_kf_T

    # Switch measurement old-kf -> new-kf (KeyframeSlam switch branch).
    Z_new = torch.where(accept, r_kf_T,
                        torch.where(odo_nan, carry["T_kf_prev"], T_alt))
    info_new = torch.where(
        accept, res.information[0],
        torch.where(odo_nan,
                    1e2 * torch.eye(6, dtype=torch.float32, device=dev),
                    res.information[1]))

    # First-frame entropy of the active keyframe (ratioWithFirst); after a
    # switch the new keyframe starts with no history.
    set_first = accept & (~carry["has_first"]) & torch.isfinite(h)
    H_first = torch.where(set_first, h, carry["H_first"])
    has_first = carry["has_first"] | set_first
    H_first = torch.where(switch, 0.0, H_first)
    has_first = has_first & ~switch

    new_carry = {
        "kf": tuple(torch.where(switch, c, k)
                    for c, k in zip(cur, carry["kf"])),
        "prev": cur,
        "T_kf_prev": torch.where(switch, eye, T_kf_cur),
        "last_odo": last_odo,
        "H_first": H_first,
        "has_first": has_first,
    }
    out = {
        "rel_pose": torch.where(switch, eye, T_kf_cur),
        "switch": switch,
        "Z_switch": Z_new,
        "info_switch": info_new,
        "entropy": h,
        "entropy_ratio": ratio,
        "valid_ratio": res.valid_ratio[0],
        "accept": accept,
        "iterations": res.iterations,
        "is_nan": nan,
        # Raw (pre-fusion) dual measurements + informations: the chunked
        # walk replays the windowed LocalMap solve from these.
        "T_kf_meas": r_kf_T,
        "T_odo_meas": r_odo_T,
        "info_pair": res.information,
    }
    return new_carry, out


def _with_stats(cfg, scan_cfg) -> bool:
    return bool(cfg.collect_stats and scan_cfg.with_stats)


def _check(lev, lev_i, state_in, table_in, force, cur, out_row, state_out,
           table_out, cfg, scan_cfg):
    """Raise on buffers the step does not take; returns levels."""
    L, M = len(cfg.tracked_levels), cfg.max_iterations
    S = lin_ops.level_row_size(M)
    dev = lev.device
    width = row_width(output_layout(L, M, _with_stats(cfg, scan_cfg)))
    for name, t, shape, dtype in (
            ("lev", lev, (2, L, S), torch.float32),
            ("lev_i", lev_i, (2, L, 2), torch.int32),
            ("state_in", state_in, (STATE_SIZE,), torch.float32),
            ("table_in", table_in, (L, 2), torch.int64),
            ("force", force, (), torch.bool),
            ("out_row", out_row, (width,), torch.float32),
            ("state_out", state_out, (STATE_SIZE,), torch.float32),
            ("table_out", table_out, (L, 2), torch.int64)):
        if (t.shape != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"want {name} a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len(cur) != L or any(c.device != dev or not c.is_contiguous()
                            or c.dtype != torch.float32 for c in cur):
        raise ValueError(f"want the frame's {L} tracked slabs, contiguous "
                         f"float32 on {dev}")
    return L


def scan_step(lev, lev_i, state_in, table_in, force, cur, out_row,
              state_out, table_out, cfg, scan_cfg):
    """Frame k's decisions on the chunked scan's buffers (module
    docstring): csrc/keyframe_scan.cu on a CUDA tensor, the plain version
    on a CPU tensor. ``cur``: the frame's slabs of the tracked levels,
    coarse to fine as ``cfg.tracked_levels``."""
    if lev.device.type == "cuda":
        return scan_step_kernel(lev, lev_i, state_in, table_in, force, cur,
                                out_row, state_out, table_out, cfg, scan_cfg)
    return scan_step_plain(lev, lev_i, state_in, table_in, force, cur,
                           out_row, state_out, table_out, cfg, scan_cfg)


def scan_step_plain(lev, lev_i, state_in, table_in, force, cur, out_row,
                    state_out, table_out, cfg, scan_cfg):
    """``scan_step``'s plain version, on any device: the buffers read into
    a TrackResult and a carry, ``scan_step_reference`` (its keyframe swap
    over the table's pointer values), the results written back (eager
    ops, no host sync)."""
    _check(lev, lev_i, state_in, table_in, force, cur, out_row, state_out,
           table_out, cfg, scan_cfg)
    dev = lev.device
    res = dense_tracker.level_result(lev, lev_i, cfg)
    carry = carry_of(state_in)
    carry["kf"] = tuple(table_in[:, 0])
    cur_ptrs = tuple(torch.full((), c.data_ptr(), dtype=torch.int64,
                                device=dev) for c in cur)
    new, out = scan_step_reference(res, carry, force, cur_ptrs, scan_cfg)
    with_stats = _with_stats(cfg, scan_cfg)
    if with_stats:
        out["stats"] = tuple(res.stats[:5])
    layout = output_layout(len(cur), cfg.max_iterations, with_stats)
    outs = {k: v[None] for k, v in out.items() if k != "stats"}
    if with_stats:
        outs["stats"] = tuple(x[None] for x in out["stats"])
    out_row.copy_(pack(outs, layout)[0])
    state_out.copy_(state_of(new, cfg.use_initial_estimate))
    table_out.copy_(torch.stack([torch.stack(new["kf"]),
                                 torch.stack(cur_ptrs)], dim=1))
    return out_row, state_out, table_out


def timing_buffer(device):
    """A zeroed phase-timing buffer for ``scan_step_kernel(...,
    timing=)``: (_TIMING_SLOTS,) int64."""
    return torch.zeros((_TIMING_SLOTS,), dtype=torch.int64, device=device)


def phase_times(timing):
    """The step kernel's phase split from a filled timing buffer (host
    numpy int64, (_TIMING_SLOTS,)): ({phase: device us}, the launch's
    device us from its start to its end). clock64 spans are converted by
    the launch's %globaltimer span over its clock64 span. The phases
    from "before the wait" to "decided writes" are warp 0's; "copies" is
    warp 1's (the statistics among them, its wait included), from the
    start, beside them."""
    t = np.asarray(timing, np.int64)
    ns = float(t[1] - t[0])
    ns_per_clock = ns / max(float(t[_CLOCK_END] - t[_CLOCK_START]), 1.0)
    return ({name: float(t[b] - t[a]) * ns_per_clock / 1e3
             for name, (a, b) in _PHASE_SLOTS.items()}, ns / 1e3)


def scan_step_kernel(lev, lev_i, state_in, table_in, force, cur, out_row,
                     state_out, table_out, cfg, scan_cfg, timing=None):
    """``scan_step`` on the card: one launch of csrc/keyframe_scan.cu (one
    CTA) on the current stream of the buffers' device, no host sync.
    ``timing``: None (the main path), or a ``timing_buffer`` the kernel
    fills with its phase stamps (``phase_times``)."""
    global LAUNCHES_SCAN_STEP
    L = _check(lev, lev_i, state_in, table_in, force, cur, out_row,
               state_out, table_out, cfg, scan_cfg)
    if timing is not None and (timing.shape != (_TIMING_SLOTS,)
                               or timing.dtype != torch.int64
                               or timing.device != lev.device):
        raise ValueError(f"want timing a ({_TIMING_SLOTS},) int64 tensor "
                         f"on {lev.device}")
    slabs = (ctypes.c_void_p * L)(*(c.data_ptr() for c in cur))
    _build.launch("dvo_scan_step", lev.device, (
        lev.data_ptr(), lev_i.data_ptr(), L, cfg.max_iterations,
        state_in.data_ptr(), table_in.data_ptr(), force.data_ptr(), slabs,
        scan_cfg.min_constraint_ratio, scan_cfg.min_entropy_ratio,
        int(scan_cfg.fuse_odometry), int(cfg.use_initial_estimate),
        int(_with_stats(cfg, scan_cfg)), out_row.data_ptr(),
        state_out.data_ptr(), table_out.data_ptr(),
        None if timing is None else timing.data_ptr()))
    LAUNCHES_SCAN_STEP += 1
    return out_row, state_out, table_out

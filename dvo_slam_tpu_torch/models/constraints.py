"""Loop-closure constraint proposal and batched two-stage validation
(counterpart of ``dvo_slam_tpu/models/constraints.py``; the reference's
constraint machinery
(dvo_slam/include/dvo_slam/constraints/constraint_proposal.h,
constraint_proposal_validator.h, constraint_proposal_voter.h; SURVEY.md S7
and §3.4): candidate keyframes within a metric search radius are tracked at
COARSE pyramid levels in both directions, filtered by voters (NaN result,
cross-validation T_fwd o T_bwd ~ I, entropy ratio vs the keyframe's own
tracking history, constraint ratio), then survivors are re-tracked at FINE
levels and re-voted.

The reference validates proposals serially with a dedicated DenseTracker;
here every stage is ONE batched tracker call over a padded candidate batch
(on the card one launch of the level kernel per level), the
forward stage against the new keyframe shared by every row, the backward
stage pairing the new keyframe with each candidate.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.models.pose_graph import bucket
from dvo_slam_tpu_torch.utils import se3_np
from dvo_slam_tpu_torch.utils.transfer import to_host


class ValidationCache(collections.OrderedDict):
    """LRU device cache of re-uploaded EVICTED candidate pyramids, with
    observability counters (past the residency budget a switch can be
    bound by re-uploads; the counters show whether the cache serves them).

    hits / misses count HOST-RESIDENT candidates per dispatch (resident
    device pyramids never touch the cache); uploaded_bytes counts actual
    host->device bytes shipped for candidates — cache fills when caching is
    on, every host candidate when slots == 0; lru_evictions counts entries
    dropped at capacity."""

    def __init__(self):
        super().__init__()
        self.hits = 0
        self.misses = 0
        self.uploaded_bytes = 0
        self.lru_evictions = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "uploaded_bytes": self.uploaded_bytes,
            "lru_evictions": self.lru_evictions,
            "entries": len(self),
        }


@dataclasses.dataclass
class ConstraintCandidate:
    """A proposed loop-closure edge (reference ConstraintProposal)."""

    keyframe_idx: int  # existing keyframe (vertex i)
    new_idx: int  # the newly added keyframe (vertex j)
    T_init: np.ndarray  # (4, 4) initial estimate: candidate-cam -> new-cam


@dataclasses.dataclass
class AcceptedConstraint:
    keyframe_idx: int
    new_idx: int
    measurement: np.ndarray  # (4, 4) Z = T_i^{-1} T_j convention of the graph
    information: np.ndarray  # (6, 6)


def propose_candidates(positions, new_idx, slam_cfg: SlamConfig) -> List[int]:
    """Radius search over keyframe translations (reference candidate search
    in KeyframeGraph; SURVEY.md §3.4). Excludes keyframes closer than
    min_constraint_distance in graph index (those are covered by odometry
    edges)."""
    new_pos = positions[new_idx]
    out = []
    dists = []
    for k in range(new_idx):
        if new_idx - k < slam_cfg.min_constraint_distance:
            continue
        d = np.linalg.norm(positions[k] - new_pos)
        if d <= slam_cfg.new_constraint_search_radius:
            out.append(k)
            dists.append(d)
    cap = slam_cfg.max_loop_candidates
    if cap > 0 and len(out) > cap:
        # Nearest-N cap: on revisit-heavy trajectories the radius census
        # grows with the map (every cycle adds another ring of in-radius
        # keyframes), and each candidate costs a coarse+fine validation
        # track plus a pyramid re-upload if evicted. Keep the nearest by
        # metric distance — the same candidates the radius criterion
        # ranks as most promising. 0 = unbounded (reference semantics).
        order = np.argsort(np.asarray(dists), kind="stable")[:cap]
        out = [out[int(i)] for i in sorted(order)]
    return out


def _odometry_vote(T_measured, T_init, slam_cfg: SlamConfig) -> bool:
    """OdometryConstraintVoter: a validated constraint must not wildly
    contradict the current graph estimate it was seeded from. The initial
    T comes from composing the (odometry-chained, partially optimized)
    keyframe poses; a measured pose further than the plausible accumulated
    drift from that prediction is more likely a self-similarity false
    positive than a real loop (reference dvo_slam/src/constraints/*)."""
    delta = np.linalg.norm(
        se3_np.log(np.asarray(T_measured, np.float64) @ se3_np.inverse(T_init))
    )
    return delta <= slam_cfg.odometry_constraint_threshold


def _entropy_ratio(entropy, denominator):
    """Sign-safe entropy ratio (SURVEY.md §4.5; dense_tracker.entropy_ratio).

    A keyframe with no usable tracking history (None / non-finite
    denominator) CANNOT vouch for the candidate's quality — the voter
    rejects conservatively instead of auto-passing (a silently-passed
    false loop closure corrupts the whole graph; a missed true one only
    costs a little drift)."""
    if denominator is None:
        return -np.inf
    return dense_tracker.entropy_ratio(entropy, denominator)


def _validate_batch(refs_list, new_pyramid, Ks, Tf, Tb,
                    coarse_cfg: TrackerConfig, fine_cfg: TrackerConfig):
    """The whole two-stage validation of one padded candidate batch:
    coarse forward + coarse backward + fine re-track (seeded by the coarse
    forward pose), each one batched tracker call (the JAX package's
    ``_validate_batch_jit``). The fine stage runs on every padded row;
    rows that fail the stage-1 voters are discarded on the host, so the
    accepted set is the staged pipeline's. Returns a dict of (B, ...)
    tensors on the new keyframe's device, without a host sync."""
    B = Tf.shape[0]
    device = new_pyramid[-1].device
    levels = set(coarse_cfg.tracked_levels) | set(fine_cfg.tracked_levels)
    # Only tracked levels are stacked; host (evicted) levels upload here.
    refs = tuple(
        torch.stack([torch.as_tensor(p[lvl], device=device)
                     for p in refs_list]) if lvl in levels else None
        for lvl in range(len(refs_list[0]))
    )
    # The new keyframe as the backward stage's reference, one view per row.
    news = tuple(lvl.expand((B,) + lvl.shape) for lvl in new_pyramid)
    fwd = dense_tracker.track_batched(refs, new_pyramid, Ks, Tf, coarse_cfg)
    bwd = dense_tracker.track_pairs_batched(news, refs, Ks, Tb, coarse_cfg)
    # Fine stage seeded by the coarse forward pose; a NaN coarse row yields
    # a NaN fine row, rejected by the host NaN voter.
    eye = torch.eye(4, dtype=Tf.dtype, device=device).expand(Tf.shape)
    seed = torch.where(
        torch.isfinite(fwd.transformation).all(-1).all(-1)[:, None, None],
        fwd.transformation, eye)
    fine = dense_tracker.track_batched(refs, new_pyramid, Ks, seed, fine_cfg)
    return {
        "fwd_T": fwd.transformation, "fwd_nan": fwd.is_nan(),
        "fwd_H": fwd.entropy, "fwd_vr": fwd.valid_ratio,
        "bwd_T": bwd.transformation, "bwd_nan": bwd.is_nan(),
        "fine_T": fine.transformation, "fine_nan": fine.is_nan(),
        "fine_H": fine.entropy, "fine_vr": fine.valid_ratio,
        "fine_info": fine.information,
        # The TPU sampler's window loss of the fine measurement: always 0
        # here (the gather has no window).
        "fine_wmiss": fine.window_miss_frac,
    }


@dataclasses.dataclass
class PendingValidation:
    """In-flight validation batches: device results + candidate metadata.

    The reference validates constraints on the background graph thread
    (dvo_slam/src/keyframe_graph.cpp); here the batches' device work is
    queued without a host sync, and the results are read at a later fixed
    point (collect_validation, or the orchestrator's combined fetch)."""

    chunks: List[List[ConstraintCandidate]]
    handles: List[dict]

    def tensors(self) -> list:
        """Every result tensor, in a fixed order (for one combined fetch)."""
        return [t for h in self.handles for t in h.values()]

    def results_from(self, host: list) -> List[dict]:
        """The per-batch result dicts from ``to_host(self.tensors())``."""
        it = iter(host)
        return [{k: next(it) for k in h} for h in self.handles]


def dispatch_validation(
    candidates: List[ConstraintCandidate],
    keyframe_pyramids,
    new_pyramid,
    Ks,
    coarse_cfg: TrackerConfig,
    fine_cfg: TrackerConfig,
    slam_cfg: SlamConfig,
    pyramid_keys=None,
    device_cache=None,
) -> Optional[PendingValidation]:
    """Dispatch every validation batch WITHOUT fetching results.

    pyramid_keys / device_cache: optional ValidationCache of re-uploaded
    EVICTED candidate pyramids (level-trimmed device tuples). Keyframe
    pyramids are immutable after creation, so entries never go stale;
    the caller provides stable identity keys (one per keyframe — e.g.
    (idx, timestamp), which survives index reuse across reset()). Bounded
    at slam_cfg.validation_cache_slots entries (~2.4 MB each at 640x480
    defaults). Without it, on revisit-heavy trajectories every switch
    re-uploads nearly the same spilled candidate set."""
    if not candidates:
        return None
    device = new_pyramid[-1].device

    # Trim pyramid levels below everything validation tracks: with the
    # default schedules level 0 is never touched, yet it is ~75% of a
    # pyramid's bytes, and EVICTED candidates re-upload from host RAM.
    lvl0 = min(coarse_cfg.last_level, fine_cfg.last_level)
    if lvl0 > 0:
        keyframe_pyramids = [
            None if pyr is None else tuple(pyr[lvl0:])
            for pyr in keyframe_pyramids
        ]
        new_pyramid = tuple(new_pyramid[lvl0:])
        Ks = tuple(Ks[lvl0:])
        shift = dict(
            num_levels=coarse_cfg.num_levels - lvl0,
            first_level=coarse_cfg.first_level - lvl0,
            last_level=coarse_cfg.last_level - lvl0,
        )
        coarse_cfg = dataclasses.replace(coarse_cfg, **shift)
        fine_cfg = dataclasses.replace(
            fine_cfg,
            num_levels=fine_cfg.num_levels - lvl0,
            first_level=fine_cfg.first_level - lvl0,
            last_level=fine_cfg.last_level - lvl0,
        )

    # Candidate pyramids living on HOST (evicted, numpy): serve from /
    # fill the LRU device cache so consecutive switches don't re-upload
    # the same spilled pyramids. Cache entries are the TRIMMED level
    # tuples (the upload the dispatch would otherwise do itself).
    slots = slam_cfg.validation_cache_slots
    if device_cache is not None and pyramid_keys is not None:
        keyframe_pyramids = list(keyframe_pyramids)
        for k in {c.keyframe_idx for c in candidates}:
            pyr = keyframe_pyramids[k]
            if pyr is None or not isinstance(pyr[0], np.ndarray):
                continue  # resident (device) — no upload to cache
            key = (pyramid_keys[k], lvl0)
            if slots > 0 and key in device_cache:
                device_cache.move_to_end(key)
                device_cache.hits += 1
            else:
                device_cache.misses += 1
                device_cache.uploaded_bytes += sum(
                    np.asarray(a).nbytes for a in pyr)
                if slots <= 0:
                    continue  # uncached: the upload happens in the dispatch
                device_cache[key] = tuple(
                    torch.as_tensor(a, device=device) for a in pyr)
                while len(device_cache) > slots:
                    device_cache.popitem(last=False)
                    device_cache.lru_evictions += 1
            keyframe_pyramids[k] = device_cache[key]

    # Power-of-two bucketed batch: one batched validation for up to
    # validation_batch_max candidates, split beyond the cap. Padded rows
    # repeat candidate 0 and are discarded by the voters' loop.
    B_max = max(slam_cfg.validation_batch_max, slam_cfg.validation_batch)
    chunks, handles = [], []
    for start in range(0, len(candidates), B_max):
        chunk = candidates[start : start + B_max]
        B = min(bucket(len(chunk), slam_cfg.validation_batch), B_max)
        idx = list(range(len(chunk))) + [0] * (B - len(chunk))
        refs_list = tuple(
            keyframe_pyramids[chunk[i].keyframe_idx] for i in idx
        )
        Tf = torch.as_tensor(
            np.stack([chunk[i].T_init for i in idx]), dtype=torch.float32,
            device=device)
        Tb = torch.as_tensor(
            np.stack([se3_np.inverse(chunk[i].T_init) for i in idx]),
            dtype=torch.float32, device=device)
        handles.append(
            _validate_batch(refs_list, new_pyramid, Ks, Tf, Tb,
                            coarse_cfg, fine_cfg)
        )
        chunks.append(chunk)
    return PendingValidation(chunks=chunks, handles=handles)


def collect_validation(
    pending: Optional[PendingValidation],
    keyframe_entropies,
    slam_cfg: SlamConfig,
    wmiss_threshold: float = 0.02,
) -> List[AcceptedConstraint]:
    """Fetch dispatched validation batches (one transfer) and apply the
    voters on host. keyframe_entropies is read at COLLECT time, matching
    the synchronous pipeline (history up to the proposing switch)."""
    if pending is None:
        return []
    return vote_validation(
        pending.chunks, pending.results_from(to_host(pending.tensors())),
        keyframe_entropies, slam_cfg, wmiss_threshold,
    )


def vote_validation(
    chunks: List[List[ConstraintCandidate]],
    host_results: List[dict],
    keyframe_entropies,
    slam_cfg: SlamConfig,
    wmiss_threshold: float = 0.02,
) -> List[AcceptedConstraint]:
    """Voter logic on ALREADY-FETCHED batch results (callers that combine
    the validation fetch with other per-switch transfers).

    wmiss_threshold: reject a candidate whose fine re-track lost more
    than this fraction of points to the TPU sampler's row window (<= 0
    disables the vote). The port's window-miss fraction is always 0, so
    this voter always passes; it is kept so the voters stay the JAX
    package's, in its order."""
    accepted: List[AcceptedConstraint] = []
    for chunk, r in zip(chunks, host_results):
        for k, c in enumerate(chunk):
            # --- stage 1 voters (coarse results) ---
            if bool(r["fwd_nan"][k]) or bool(r["bwd_nan"][k]):
                continue  # NaNResultVoter
            T_f = np.asarray(r["fwd_T"][k], np.float64)
            T_b = np.asarray(r["bwd_T"][k], np.float64)
            # CrossValidationVoter: forward o backward ~ identity.
            consistency = np.linalg.norm(se3_np.log(T_f @ T_b))
            if consistency > slam_cfg.cross_validation_threshold:
                continue
            # TrackingResultEvaluationVoter (coarse threshold).
            ratio = _entropy_ratio(
                float(r["fwd_H"][k]), keyframe_entropies[c.keyframe_idx]
            )
            if ratio < slam_cfg.min_entropy_ratio_coarse:
                continue
            if float(r["fwd_vr"][k]) < slam_cfg.min_constraint_ratio:
                continue  # ConstraintRatioVoter
            if not _odometry_vote(T_f, c.T_init, slam_cfg):
                continue  # OdometryConstraintVoter

            # --- stage 2 voters (fine re-track seeded by the coarse pose) ---
            if bool(r["fine_nan"][k]):
                continue
            if wmiss_threshold > 0 and float(r["fine_wmiss"][k]) > wmiss_threshold:
                continue  # window-masked fine measurement: reject, not trust
            ratio = _entropy_ratio(
                float(r["fine_H"][k]), keyframe_entropies[c.keyframe_idx]
            )
            if ratio < slam_cfg.min_entropy_ratio_fine:
                continue
            if float(r["fine_vr"][k]) < slam_cfg.min_constraint_ratio:
                continue
            # OdometryConstraintVoter on the FINE result too: a fine
            # re-track can converge into a different (self-similarity)
            # basin than the cross-validated coarse pose; a fine pose far
            # from both the graph prediction and the coarse estimate is a
            # false positive, not refinement.
            T_fine = np.asarray(r["fine_T"][k], np.float64)
            if not _odometry_vote(T_fine, c.T_init, slam_cfg):
                continue
            fine_step = np.linalg.norm(se3_np.log(T_fine @ se3_np.inverse(T_f)))
            if fine_step > slam_cfg.cross_validation_threshold:
                continue
            # Tracker returns T: candidate-cam -> new-cam, i.e.
            # p_new = T p_cand. Graph edge convention: Z = T_i^{-1} T_j with
            # i = candidate, j = new, poses world<-cam: Z = inv(T).
            accepted.append(
                AcceptedConstraint(
                    keyframe_idx=c.keyframe_idx,
                    new_idx=c.new_idx,
                    measurement=se3_np.inverse(T_fine),
                    information=np.asarray(r["fine_info"][k], np.float64),
                )
            )
    return accepted


def validate_candidates(
    candidates: List[ConstraintCandidate],
    keyframe_pyramids,
    keyframe_entropies,
    new_pyramid,
    Ks,
    coarse_cfg: TrackerConfig,
    fine_cfg: TrackerConfig,
    slam_cfg: SlamConfig,
) -> List[AcceptedConstraint]:
    """Two-stage batched validation (reference ConstraintProposalValidator).

    Args:
      candidates: proposals from propose_candidates.
      keyframe_pyramids: list of per-keyframe slab-pyramid tuples.
      keyframe_entropies: per-keyframe reference entropy (tracking-history
        average; the TrackingResultEvaluationVoter denominator).
      new_pyramid: the new keyframe's pyramid.
      Ks: per-level intrinsics.

    Voters applied (reference dvo_slam/src/constraints/*): NaN result,
    cross-validation (T_fwd o T_bwd ~ I), entropy ratio (coarse + fine),
    constraint ratio, and the odometry-constraint voter (_odometry_vote).

    Synchronous form: dispatch_validation + collect_validation back to
    back, with the JAX default window-miss threshold (0.02; the port's
    TrackerConfig has no pallas_miss_escalate, and its miss fraction is 0).
    """
    pending = dispatch_validation(
        candidates, keyframe_pyramids, new_pyramid, Ks,
        coarse_cfg, fine_cfg, slam_cfg,
    )
    return collect_validation(pending, keyframe_entropies, slam_cfg)

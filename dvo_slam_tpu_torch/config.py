"""Tracker and SLAM configuration (counterpart of ``dvo_slam_tpu/config.py``).

``SlamConfig`` keeps the JAX package's fields, defaults and meanings
(reference: ``dvo_slam::Config``).

``TrackerConfig`` keeps the JAX package's field names, defaults and
meanings (reference: ``DenseTracker::Config``), minus the knobs that only
shaped the TPU's windowed Pallas sampler: ``sampler_backend``,
``pallas_rows_per_tile``, ``pallas_cols_per_tile``, ``pallas_margin``,
``pallas_miss_escalate``, ``pallas_precision`` and
``pallas_compact_window_rows``. The port samples with a direct 4-corner
gather in f32, which has no window to size, miss or escalate from.
"""

from __future__ import annotations

import dataclasses

SCALE_ESTIMATORS = ("unit", "normal", "mad", "tdist")
INFLUENCE_FUNCTIONS = ("unit", "huber", "tukey", "tdist")


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Dense-tracker knobs; see ``dvo_slam_tpu.config.TrackerConfig`` for
    the full rationale of each default.

    Level 0 is full resolution, higher is coarser; levels
    ``first_level`` down to ``last_level`` are tracked (reference default
    3 -> 1).
    """

    num_levels: int = 4
    first_level: int = 3
    last_level: int = 1

    max_iterations: int = 50
    # Stop when ||delta_xi||_2 < precision (f32-achievable tolerance).
    precision: float = 1e-6

    # Pose prior weight (reference Config::Mu). 0 = disabled.
    mu: float = 0.0

    # Constant-velocity warm start; consumed by the odometry layer.
    use_initial_estimate: bool = True

    use_weighting: bool = True
    scale_estimator: str = "tdist"
    influence: str = "tdist"
    tdist_dof: float = 5.0
    tdist_scale_iters: int = 5
    # >0: seed the Sigma fixed point from the previous iteration's estimate
    # and run only this many steps after a level's first iteration.
    tdist_scale_warm_iters: int = 0
    huber_k: float = 1.345
    tukey_b: float = 4.6851
    # Sensor-noise floor on the residual scale (keeps Sigma from
    # collapsing on noise-free data).
    min_intensity_sigma: float = 0.5
    min_depth_sigma: float = 1e-3

    intensity_grad_threshold: float = 0.0
    depth_grad_threshold: float = 0.0

    collect_stats: bool = True

    # Bivariate photometric + geometric residual; False = photometric only.
    use_depth: bool = True

    # "current": sample the current frame's gradients at the warped points
    # every iteration (reference formulation); "reference": use the
    # reference frame's gradients at the selected pixels.
    gradient_source: str = "current"

    # >0: compact each tracked level's selected points to this fraction of
    # the grid, rounded up to 128 slots (ops/linearize.compact_reference:
    # row-major order, uniform decimation past the budget). 0 = the full
    # grid with a selection mask.
    point_budget_fraction: float = 0.0

    # Levenberg-Marquardt damping; 0 = Gauss-Newton with rollback.
    lm_lambda_init: float = 0.0
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    lm_lambda_max: float = 1e4

    def __post_init__(self):
        if self.scale_estimator not in SCALE_ESTIMATORS:
            raise ValueError(f"unknown scale estimator {self.scale_estimator}")
        if self.influence not in INFLUENCE_FUNCTIONS:
            raise ValueError(f"unknown influence function {self.influence}")
        if self.gradient_source not in ("current", "reference"):
            raise ValueError(
                f"unknown gradient source {self.gradient_source!r} "
                "(expected 'current' or 'reference')"
            )
        if not (0.0 <= self.point_budget_fraction <= 1.0):
            raise ValueError(
                "point_budget_fraction must be in [0, 1], got "
                f"{self.point_budget_fraction}"
            )
        if not (0 <= self.last_level <= self.first_level < self.num_levels):
            raise ValueError(
                "require 0 <= last_level <= first_level < num_levels, got "
                f"{self.last_level} <= {self.first_level} < {self.num_levels}"
            )

    @property
    def tracked_levels(self) -> tuple:
        """Level indices tracked, coarse to fine."""
        return tuple(range(self.first_level, self.last_level - 1, -1))


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """SLAM backend knobs (reference: dvo_slam::Config); see
    ``dvo_slam_tpu.config.SlamConfig`` for the full rationale of each
    default. The padded capacities are initial sizes: the graph doubles
    when full."""

    # --- keyframe selection (entropy ratio, IROS13 IV) ---
    min_entropy_ratio: float = 0.9
    # Fraction of selected points that produced valid constraints.
    min_constraint_ratio: float = 0.2

    # --- loop closure (reference KeyframeGraph + constraints/*) ---
    new_constraint_search_radius: float = 5.0
    # Skip candidates closer than this many keyframes in graph distance.
    min_constraint_distance: int = 5
    min_entropy_ratio_coarse: float = 0.6
    min_entropy_ratio_fine: float = 0.75
    # Forward-backward consistency: || log(T_fwd * T_bwd) || below this.
    cross_validation_threshold: float = 0.10
    # Reject a constraint further than this twist norm from its graph
    # prediction (OdometryConstraintVoter).
    odometry_constraint_threshold: float = 1.0
    # Validation batches: padded to the power-of-two bucket of their count,
    # floored at validation_batch and split above validation_batch_max.
    validation_batch: int = 8
    validation_batch_max: int = 32
    # Cap on candidates per keyframe insertion (nearest first); 0 = all.
    max_loop_candidates: int = 0

    # Fuse the keyframe-relative estimate with the chained odometry
    # estimate by information weighting.
    fuse_odometry: bool = True

    # --- windowed local-map optimization (reference LocalMap::optimize) ---
    local_map_optimize: bool = True
    local_map_iterations: int = 10
    local_map_capacity: int = 64

    # --- pose graph optimization (g2o replacement) ---
    optimization_iterations: int = 20
    final_optimization_iterations: int = 100
    use_robust_kernel: bool = True
    cauchy_c: float = 1.0
    # Vertex count from which the block-Jacobi CG solver replaces the
    # dense Cholesky.
    graph_cg_threshold: int = 2048
    # Past this many active vertices, plain switches solve every
    # ceil(M / this)-th time (new loop edges always solve); 0 disables.
    optimization_backoff_vertices: int = 128
    remove_outliers: bool = True
    outlier_weight_threshold: float = 0.1

    # --- padded capacities (initial; doubled when full) ---
    max_keyframes: int = 256
    max_edges: int = 1024
    # Keyframe pyramids kept on the device; older ones spill to host RAM
    # and re-upload inside validation batches on candidacy.
    resident_keyframes: int = 64
    # LRU device cache of re-uploaded evicted validation candidates; 0
    # disables.
    validation_cache_slots: int = 48

    # --- tracker configs used by the SLAM layer ---
    coarse_first_level: int = 3
    coarse_last_level: int = 3
    coarse_max_iterations: int = 25

"""dvo_slam_tpu_torch — dense RGB-D odometry and keyframe SLAM in PyTorch + CUDA.

A port of ``dvo_slam_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch on an
NVIDIA Hopper GPU. The JAX package stays the reference: every module here
keeps its counterpart's name and public functions, and the tests feed the
same numpy inputs to both and compare within stated tolerances.

This package imports torch and numpy only, never jax and never
``dvo_slam_tpu``, so it runs where JAX is not installed (the numpy-only
utilities it needs are copied into ``utils/``).

Layering (same as the JAX package):
  ops/     — SE(3), camera, robust weighting, pyramids, the 6x6 solve,
             the IRLS linearization and a level's IRLS loop (batched;
             the cluster kernel of csrc/linearize.cu) and the bilinear
             slab sampler
             (csrc/sampler.cu), built at first use by _build.py.
  models/  — the dense tracker (coarse-to-fine IRLS, one pair or a
             batch), frame-to-frame odometry, and keyframe SLAM:
             the pose graph, the local map, loop-closure validation and
             the KeyframeSlam facade.
  utils/   — host helpers: f64 SE(3), synthetic scenes, ATE/RPE, TUM
             dataset IO with a numpy PNG codec, checkpoints, .g2o IO,
             stopwatch / profiler trace / frame logger.
  native/  — the C++ PNG decoder and prefetch thread (built with g++ at
             first use, ctypes).
  benchmark, cli — the offline harness and the command line
             (``python -m dvo_slam_tpu_torch.cli``).
  convert  — carries configs, pyramids and results across the two packages.

The tracker has no learnable parameters and takes no gradient: its
Jacobian is analytic (ops/linearize.py). So there is no ``nn.Module`` and
no ``torch.autograd.Function``; everything is plain functions on tensors
returning ``NamedTuple`` results that mirror the JAX ones.
"""

import torch as _torch

# Full-f32 products everywhere. TF32 keeps ~3 decimal digits, which is the
# 3.5e-3 relative error the JAX package measured for reduced-precision
# matmuls — fatal for SE(3) composition and the 6x6 normal equations.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from dvo_slam_tpu_torch.config import SlamConfig, TrackerConfig  # noqa: E402

__version__ = "0.1.0"

__all__ = ["TrackerConfig", "SlamConfig", "OdometryTracker", "KeyframeSlam",
           "__version__"]


def __getattr__(name):
    if name == "OdometryTracker":
        from dvo_slam_tpu_torch.models.odometry import OdometryTracker

        return OdometryTracker
    if name == "KeyframeSlam":
        from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeSlam

        return KeyframeSlam
    raise AttributeError(name)

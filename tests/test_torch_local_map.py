"""The port's windowed local map against the JAX package's.

The same windows (numpy measurements from a seed) go through both
``LocalMap``s. Tolerances: refined poses within 1e-4 of the JAX
package's (f32 LM on both sides, sums in another order), and within
1e-5 of the estimates for exact measurements (the JAX test's bound);
``refined_from`` is host numpy on both sides and equal to 1e-12.
"""

import numpy as np

from dvo_slam_tpu.models.keyframe_tracker import fuse_relative_poses
from dvo_slam_tpu.models.local_map import LocalMap
from dvo_slam_tpu.utils import se3_np
from dvo_slam_tpu_torch.models import keyframe_tracker as t_keyframe_tracker
from dvo_slam_tpu_torch.models.local_map import LocalMap as TLocalMap


def _window(seed, n=8, exact=False):
    rng = np.random.default_rng(seed)
    kf_info = np.eye(6) / 0.02**2
    odo_info = np.eye(6) / 0.008**2
    maps = (LocalMap(capacity=16), TLocalMap(capacity=16, device="cpu"))
    T_prev = np.eye(4)
    T = np.eye(4)
    for i in range(n):
        step = se3_np.exp(np.concatenate([rng.normal(scale=0.03, size=3),
                                          rng.normal(scale=0.02, size=3)]))
        T = step @ T
        if exact:
            kf_m, odo_m = T.copy(), step.copy()
        else:
            kf_m = se3_np.exp(rng.normal(scale=0.02, size=6)) @ T
            odo_m = se3_np.exp(rng.normal(scale=0.008, size=6)) @ step
        fused = fuse_relative_poses(kf_m, kf_info, odo_m @ T_prev, odo_info)
        # The odometry measurement is missing for one frame, as after a
        # NaN frame-to-frame result.
        odo = None if i == 3 else (odo_m, odo_info)
        for m in maps:
            m.add_frame(i, fused, (kf_m, kf_info), odo)
        T_prev = fused
    return maps


def _err(a, b):
    return np.linalg.norm(se3_np.log(a @ se3_np.inverse(b)))


def test_window_solve_like_jax():
    for seed in range(3):
        jax_map, port_map = _window(seed)
        want = jax_map.optimize(iterations=10)
        got = port_map.optimize(iterations=10)
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-4)
        # The solve moved the frames off their forward-fused estimates.
        assert max(_err(a, e) for a, e in zip(got, port_map.estimates)) > 1e-4


def test_exact_measurements_are_a_fixed_point():
    _, port_map = _window(5, exact=True)
    for est, ref in zip(port_map.estimates, port_map.optimize(iterations=10)):
        assert _err(est, ref) < 1e-5


def test_refined_from_and_trivial_windows_like_jax():
    jax_map, port_map = _window(1, n=5)
    rng = np.random.default_rng(2)
    poses = np.stack([se3_np.exp(rng.normal(scale=0.05, size=6))
                      for _ in range(16)]).astype(np.float32)
    poses[3, 0, 0] = np.nan  # a non-finite row falls back to its estimate
    for a, b in zip(port_map.refined_from(poses), jax_map.refined_from(poses)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    one_j, one_t = LocalMap(16), TLocalMap(16, device="cpu")
    for m in (one_j, one_t):
        m.add_frame(0, np.eye(4), None, None)
    assert one_t.optimize_async() is None and one_j.optimize_async() is None
    np.testing.assert_array_equal(one_t.optimize()[0], np.eye(4))
    # Capacity: frames past it keep their fused estimates out of the solve.
    full = TLocalMap(capacity=3, device="cpu")
    for i in range(5):
        full.add_frame(i, np.eye(4), None, None)
    assert len(full) == 2 and full.full


def test_fusion_is_the_jax_packages():
    rng = np.random.default_rng(4)
    T_a = se3_np.exp(rng.normal(scale=0.1, size=6))
    T_b = se3_np.exp(rng.normal(scale=0.01, size=6)) @ T_a
    L_a, L_b = np.eye(6) * 3e3, np.diag(rng.uniform(1e3, 1e4, 6))
    np.testing.assert_array_equal(
        t_keyframe_tracker.fuse_relative_poses(T_a, L_a, T_b, L_b),
        fuse_relative_poses(T_a, L_a, T_b, L_b))
    singular = np.zeros((6, 6))
    np.testing.assert_array_equal(
        t_keyframe_tracker.fuse_relative_poses(T_a, singular, T_b, singular),
        T_a)

"""Leaf operators of the port against the JAX package on the same inputs.

Inputs come from numpy seeds. Tolerances: SE(3) atol 1e-6 (f32 on both
sides, O(1) entries, different op order); everything else rtol 1e-5
(f32 rounding in another order); NaN patterns equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops import camera, least_squares, pyramid, robust, se3
from dvo_slam_tpu.utils import synthetic
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import least_squares as t_least_squares
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid
from dvo_slam_tpu_torch.ops import robust as t_robust
from dvo_slam_tpu_torch.ops import se3 as t_se3

K_TUPLE = (40.0, 41.0, 39.5, 29.5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=1e-5, atol=0.0):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def test_camera_pyramid_intrinsics():
    Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_TUPLE), 4)
    t_Ks = t_camera.pyramid_intrinsics(
        t_camera.intrinsics(*K_TUPLE, device="cpu"), 4)
    for a, b in zip(Ks, t_Ks):
        assert b.dtype == torch.float32
        _close(b, a)


def _twists():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.3, size=(64, 6)).astype(np.float32)
    xi[0] = 0.0  # identity
    xi[1, 3:] = 1e-5  # small-angle branches
    xi[2, 3:] = 0.0  # pure translation
    return xi


@pytest.mark.parametrize("fn", ["hat", "exp", "log", "inverse", "adjoint"])
def test_se3(fn):
    xi = _twists()
    if fn == "hat":
        a = se3.hat(jnp.asarray(xi[:, 3:]))
        b = t_se3.hat(torch.from_numpy(xi[:, 3:]))
        _close(b, a, atol=1e-6)
        _close(t_se3.vee(b), se3.vee(a), atol=1e-6)
        return
    T = np.array(se3.exp(jnp.asarray(xi)))
    T_t = torch.from_numpy(T)
    if fn == "exp":
        got, want = t_se3.exp(torch.from_numpy(xi)), T
    else:
        got = getattr(t_se3, fn)(T_t)
        want = getattr(se3, fn)(jnp.asarray(T))
    _close(got, want, rtol=0.0, atol=1e-6)


def _spd(rng, cond):
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    A = (Q * np.logspace(0, np.log10(cond), 6)) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32)


@pytest.mark.parametrize("cond", [1e1, 1e4])
@pytest.mark.parametrize("lm_lambda", [0.0, 1e-3])
def test_least_squares_solve(lm_lambda, cond):
    """The two f32 Cholesky solves (LAPACK in torch, XLA's in JAX) round
    differently, and a system of condition number c amplifies that to a
    forward error of ~c * eps_f32. So: rtol 1e-5 between the two at
    cond 10; at cond 1e4 each must have a backward error (relative
    residual) below 1e-5, and the two may differ by 4 * c * eps_f32
    relative to max|x|, the size of either one's error against f64."""
    rng = np.random.default_rng(1)
    A = _spd(rng, cond) * 1e3
    b = rng.normal(size=6).astype(np.float32)
    want = np.asarray(least_squares.solve(jnp.asarray(A), jnp.asarray(b),
                                          lm_lambda))
    got = t_least_squares.solve(torch.from_numpy(A), torch.from_numpy(b),
                                lm_lambda).numpy()
    if cond < 100:
        _close(got, want)
        return
    damped = A.astype(np.float64) + lm_lambda * np.diag(np.diag(A)) \
        + 1e-8 * np.eye(6)
    for x in (got, want):
        resid = damped @ x.astype(np.float64) + b
        rel = np.linalg.norm(resid) / (np.linalg.norm(damped, 2)
                                       * np.linalg.norm(x))
        assert rel < 1e-5, rel
    tol = 4 * cond * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_least_squares_indefinite_is_nonfinite():
    A = np.diag([1.0, 2.0, -3.0, 4.0, 5.0, 6.0]).astype(np.float32)
    b = np.ones(6, np.float32)
    want = np.asarray(least_squares.solve(jnp.asarray(A), jnp.asarray(b)))
    got = t_least_squares.solve(torch.from_numpy(A), torch.from_numpy(b))
    assert not np.isfinite(want).all()
    assert not torch.isfinite(got).all()


def _residuals():
    rng = np.random.default_rng(2)
    r = (rng.standard_t(5, size=997) * 3.0).astype(np.float32)
    mask = rng.random(997) > 0.2
    return r, mask


@pytest.mark.parametrize("name", sorted(robust.SCALE_FNS))
def test_robust_scale(name):
    r, mask = _residuals()
    want = robust.SCALE_FNS[name](jnp.asarray(r), jnp.asarray(mask))
    got = t_robust.SCALE_FNS[name](torch.from_numpy(r), torch.from_numpy(mask))
    _close(got, want)
    # An even valid count reads the upper median (nth_element(n/2)).
    mask2 = mask.copy()
    mask2[np.flatnonzero(mask2)[0]] = mask2.sum() % 2 == 0
    _close(t_robust.SCALE_FNS[name](torch.from_numpy(r),
                                    torch.from_numpy(mask2)),
           robust.SCALE_FNS[name](jnp.asarray(r), jnp.asarray(mask2)))


@pytest.mark.parametrize("name", sorted(robust.INFLUENCE_FNS))
def test_robust_influence(name):
    x = np.linspace(-8.0, 8.0, 321).astype(np.float32)
    want = robust.INFLUENCE_FNS[name](jnp.asarray(x))
    got = t_robust.INFLUENCE_FNS[name](torch.from_numpy(x))
    _close(got, want)


def _frame(W, H, seed):
    K = np.asarray((40.0, 40.0, (W - 1) / 2, (H - 1) / 2))
    i, z = synthetic.two_plane_scene(sharpness=2.0).render(K, W, H)
    return synthetic.add_sensor_noise(i, z, np.random.default_rng(seed),
                                      dropout=0.05)


def _compare_pyramids(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        _close(b, a)


@pytest.mark.parametrize("size", [(80, 60), (81, 61)])
def test_build_pyramid_f32(size):
    i, z = _frame(*size, seed=3)
    want = pyramid.build_pyramid(jnp.asarray(i), jnp.asarray(z), 4)
    got = t_pyramid.build_pyramid(torch.from_numpy(i), torch.from_numpy(z), 4)
    _compare_pyramids(want, got)
    # Odd sizes drop the trailing row/column at every downsample.
    assert got[1].shape[1:] == (size[1] // 2, size[0] // 2)


def _raw(W=80, H=60):
    i, z = _frame(W, H, seed=4)
    i8 = np.round(i).astype(np.uint8)
    z16 = np.where(np.isfinite(z), np.round(z * 5000.0), 0).astype(np.uint16)
    return i8, z16


def test_build_pyramid_raw_u8_u16():
    i8, z16 = _raw()
    want = pyramid.build_pyramid(jnp.asarray(i8), jnp.asarray(z16), 3)
    got = t_pyramid.build_pyramid(torch.from_numpy(i8),
                                  torch.from_numpy(z16), 3)
    _compare_pyramids(want, got)


@pytest.mark.parametrize("encoding", ["u8+u16", "u8+packed12"])
def test_build_pyramid_raw_odd_size(encoding):
    """Four levels of raw inputs at an odd height (a trailing row dropped
    at each downsample), as the pyramid kernel's plain version takes
    them."""
    i8, z16 = _raw(W=82, H=61)
    z = pyramid.pack_depth12(z16) if encoding == "u8+packed12" else z16
    want = pyramid.build_pyramid(jnp.asarray(i8), jnp.asarray(z), 4)
    got = t_pyramid.build_pyramid(torch.from_numpy(i8), torch.from_numpy(z),
                                  4)
    _compare_pyramids(want, got)
    assert got[3].shape[1:] == (61 // 8, 82 // 8)


def test_build_pyramid_packed12():
    i8, z16 = _raw()
    packed = pyramid.pack_depth12(z16)
    np.testing.assert_array_equal(t_pyramid.pack_depth12(z16), packed)
    want = pyramid.build_pyramid(jnp.asarray(i8), jnp.asarray(packed), 3)
    got = t_pyramid.build_pyramid(torch.from_numpy(i8),
                                  torch.from_numpy(packed), 3)
    _compare_pyramids(want, got)
    _close(t_pyramid.unpack_depth12(torch.from_numpy(packed), 80),
           pyramid.unpack_depth12(jnp.asarray(packed), 80))

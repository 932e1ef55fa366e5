"""One IRLS linearization: the port against the JAX package.

``prepare_reference`` + ``linearize`` at one 80x60 level of a noisy
synthetic pair with depth holes, at a perturbed pose, over the robust
branches and gradient modes. Tolerances: ``n_raw`` exact (same validity
predicate); A and b within 1e-4 * max|.| and sigma, err_mean, log1p_sum
and the t log-likelihood rtol 1e-4 (f32 sums over ~4 800 points taken in
another order differ by ~1e-6 relative; a port bug shows as O(1e-1)).

On CPU tensors ``linearize`` is ``linearize_reference`` (checked exactly);
a CUDA tensor runs mode (a) for every config, whose launch arguments (the
estimator and influence codes) are checked without a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.ops import camera, linearize, pyramid
from dvo_slam_tpu.utils import se3_np, synthetic
from dvo_slam_tpu_torch import config as t_config
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.ops import camera as t_camera
from dvo_slam_tpu_torch.ops import linearize as t_linearize
from dvo_slam_tpu_torch.ops import pyramid as t_pyramid

W, H = 80, 60
K_TUPLE = (40.0, 40.0, (W - 1) / 2, (H - 1) / 2)

CONFIGS = {
    "tdist": {},
    "photometric": {"use_depth": False},
    "reference_gradients": {"gradient_source": "reference"},
    "mad_huber": {"scale_estimator": "mad", "influence": "huber"},
    "tdist_warm": {"tdist_scale_warm_iters": 2},
}


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.two_plane_scene(sharpness=2.0)
    xi = np.array([0.01, -0.008, 0.006, 0.004, -0.003, 0.005])
    T_rel = se3_np.exp(xi)
    K = np.asarray(K_TUPLE)
    rng = np.random.default_rng(0)
    ref = synthetic.add_sensor_noise(*scene.render(K, W, H, np.eye(4)), rng,
                                     dropout=0.03)
    cur = synthetic.add_sensor_noise(
        *scene.render(K, W, H, se3_np.inverse(T_rel)), rng, dropout=0.03)
    # Linearize away from the optimum, as an IRLS iteration does.
    T = (T_rel @ se3_np.exp(0.3 * xi)).astype(np.float32)
    return ref, cur, T


def _jax_side(frames, cfg):
    ref, cur, T = frames
    K = camera.intrinsics(*K_TUPLE)
    ref_slab = pyramid.build_pyramid(jnp.asarray(ref[0]),
                                     jnp.asarray(ref[1]), 1)[0]
    cur_slab = pyramid.build_pyramid(jnp.asarray(cur[0]),
                                     jnp.asarray(cur[1]), 1)[0]
    rd = linearize.prepare_reference(ref_slab, K, cfg)
    sigma0 = jnp.asarray([[40.0, 0.01], [0.01, 1e-3]], jnp.float32)
    lin = linearize.linearize(rd, cur_slab, K, jnp.asarray(T), cfg,
                              sigma_init=sigma0, sigma_warm=jnp.asarray(True))
    return lin, linearize.tdist_loglik(lin, cfg), rd


def _port_inputs(frames, cfg):
    ref, cur, T = frames
    K = t_camera.intrinsics(*K_TUPLE, device="cpu")
    ref_slab = t_pyramid.build_pyramid(torch.from_numpy(ref[0]),
                                       torch.from_numpy(ref[1]), 1)[0]
    cur_slab = t_pyramid.build_pyramid(torch.from_numpy(cur[0]),
                                       torch.from_numpy(cur[1]), 1)[0]
    rd = t_linearize.prepare_reference(ref_slab, K, cfg)
    return rd, cur_slab, K, torch.from_numpy(T)


def _port_side(frames, cfg):
    rd, cur_slab, K, T = _port_inputs(frames, cfg)
    sigma0 = torch.tensor([[40.0, 0.01], [0.01, 1e-3]])
    lin = t_linearize.linearize(rd, cur_slab, K, T, cfg,
                                sigma_init=sigma0, sigma_warm=True)
    return lin, t_linearize.tdist_loglik(lin, cfg), rd


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_linearize_matches_jax(frames, name):
    cfg = TrackerConfig(num_levels=1, first_level=0, last_level=0,
                        **CONFIGS[name])
    t_cfg = convert.tracker_config_from_fields(dataclasses.asdict(cfg))
    want, want_ll, want_rd = _jax_side(frames, cfg)
    got, got_ll, got_rd = _port_side(frames, t_cfg)

    np.testing.assert_array_equal(got_rd.selected.numpy(),
                                  np.asarray(want_rd.selected))
    assert float(got.n_raw) == float(want.n_raw)
    assert 0.5 * H * W < float(got.n_raw) < H * W  # holes really bite
    for field in ("A", "b"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), field
    for field in ("sigma", "err_mean", "log1p_sum", "err_raw"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-4, err_msg=field)
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll), rtol=1e-4)
    assert float(got.n_window_miss) == 0.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_linearize_on_cpu_is_the_plain_version(frames, name):
    t_cfg = t_config.TrackerConfig(num_levels=1, first_level=0, last_level=0,
                                   **CONFIGS[name])
    rd, cur_slab, K, T = _port_inputs(frames, t_cfg)
    sigma0 = torch.tensor([[40.0, 0.01], [0.01, 1e-3]])
    got = t_linearize.linearize(rd, cur_slab, K, T, t_cfg,
                                sigma_init=sigma0, sigma_warm=True)
    want = t_linearize.linearize_reference(rd, cur_slab, K, T, t_cfg,
                                           sigma_init=sigma0, sigma_warm=True)
    for field, a, b in zip(got._fields, got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), field


# The kernel's codes per config (csrc/linearize.cu kEst*, kInf*): every
# config takes mode (a) on a CUDA slab.
KERNEL_ROUTE = {
    "tdist": ("tdist", "tdist"),
    "photometric": ("tdist", "tdist"),
    "reference_gradients": ("tdist", "tdist"),
    "tdist_warm": ("tdist", "tdist"),
    "mad_huber": ("mad", "huber"),
    "normal": ("normal", "tdist"),
    "unit": ("unit", "tdist"),
    "unweighted": ("none", "tdist"),
}
ROUTE_CONFIGS = {
    **CONFIGS,
    "normal": {"scale_estimator": "normal"},
    "unit": {"scale_estimator": "unit"},
    "unweighted": {"use_weighting": False},
}


@pytest.mark.parametrize("name", sorted(ROUTE_CONFIGS))
def test_kernel_route(frames, name):
    """Mode (a)'s launch arguments for the config (built without a
    launch): the kernel's estimator and influence codes, huber_k, tukey_b
    and the scale floors."""
    cfg = t_config.TrackerConfig(num_levels=1, first_level=0, last_level=0,
                                 **ROUTE_CONFIGS[name])
    rd, cur_slab, K, T = _port_inputs(frames, cfg)
    scale = t_linearize._kernel_args(
        t_linearize.RefData(*(None if f is None else f[None] for f in rd)),
        cur_slab, K, T[None], cfg)[3]
    est, inf = KERNEL_ROUTE[name]
    assert scale[7:] == (t_linearize._ESTIMATORS[est],
                         t_linearize._INFLUENCES[inf], cfg.huber_k,
                         cfg.tukey_b, cfg.min_intensity_sigma,
                         cfg.min_depth_sigma)


@pytest.mark.parametrize("name", ["mad_huber", "tdist"])
def test_plain_route_gathers_through_the_sampler_wrapper(frames, monkeypatch,
                                                         name):
    """``linearize``'s plain route samples through ``sampler.sample_slab``
    (which launches the sampler kernel on a CUDA slab), once per call;
    ``linearize_reference`` alone uses the plain sampler."""
    t_cfg = t_config.TrackerConfig(num_levels=1, first_level=0, last_level=0,
                                   **CONFIGS[name])
    rd, cur_slab, K, T = _port_inputs(frames, t_cfg)
    calls = []
    wrapped = t_linearize.sampler.sample_slab

    def counting(slab, u, v):
        calls.append(slab.shape)
        return wrapped(slab, u, v)

    monkeypatch.setattr(t_linearize.sampler, "sample_slab", counting)
    got = t_linearize.linearize(rd, cur_slab, K, T, t_cfg)
    assert calls == [(6, H, W)]
    want = t_linearize.linearize_reference(rd, cur_slab, K, T, t_cfg)
    assert len(calls) == 1
    for field, a, b in zip(got._fields, got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), field


def test_kernels_refuse_plain_only_configs(frames):
    """The kernel wrapper raises for a config it has no code for (a scale
    estimator past the config's own check), before any build or launch
    (so this runs without a card): nothing runs the plain version in its
    place."""
    t_cfg = t_config.TrackerConfig(num_levels=1, first_level=0, last_level=0,
                                   **CONFIGS["mad_huber"])
    rd, cur_slab, K, T = _port_inputs(frames, t_cfg)
    object.__setattr__(t_cfg, "scale_estimator", "trimmed")
    with pytest.raises(ValueError, match="no scale estimator"):
        t_linearize.linearize_kernels_batched(
            t_linearize.RefData(*(None if f is None else f[None]
                                  for f in rd)), cur_slab, K, T[None], t_cfg)


def test_linearize_rejects_other_devices(frames):
    t_cfg = t_config.TrackerConfig(num_levels=1, first_level=0, last_level=0)
    rd, cur_slab, K, T = _port_inputs(frames, t_cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_linearize.linearize(rd, cur_slab.to("meta"), K, T, t_cfg)

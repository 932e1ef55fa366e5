"""The port's CUDA kernel and main path on a CUDA card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one:
a CUDA kernel has no CPU mode. This file imports no JAX, so it also runs
where JAX is not installed; there, skip tests/conftest.py (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the kernel is bit-identical to its plain version by
construction (no FMA contraction) and is held to 1e-5 * max|slab|; the
tracker on the card is held to the same tracker on the CPU at 1e-4 on
the transformation (f32 reductions in another order).
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.ops import camera, pyramid, sampler
from dvo_slam_tpu_torch.utils import se3_np, synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _slab(seed, shape, n_nan):
    rng = np.random.default_rng(seed)
    slab = (rng.normal(size=shape) * 50.0).astype(np.float32)
    c, h, w = shape
    for _ in range(n_nan):
        slab[rng.integers(c), rng.integers(h), rng.integers(w)] = np.nan
    return slab


def _points(h, w, max_shift=6.0):
    """Warped grid plus NaN, +-1e9, infinities and exact-edge points."""
    vg, ug = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    k = np.arange(h * w)
    u = ug.reshape(-1) + max_shift * np.sin(k / 300.0)
    v = vg.reshape(-1) + max_shift * np.cos(k / 400.0)
    su = [np.nan, 5.5, 1e9, -1e9, 5.5, 5.5, np.inf, -np.inf,
          w - 2, w - 2 + 0.75, w - 1, 0.0, -0.25, -1.0, 3.25, np.nan]
    sv = [3.5, np.nan, 3.5, 3.5, 1e9, -1e9, 3.5, 3.5,
          h - 2, h - 2 + 0.5, 2.0, h - 2, 4.0, 4.0, h - 1, np.nan]
    return (np.concatenate([u, su]).astype(np.float32),
            np.concatenate([v, sv]).astype(np.float32))


@pytest.mark.parametrize("level_hw", [(60, 80), (120, 160), (240, 320)])
def test_kernel_matches_plain(cuda, level_hw):
    """At the 640x480 tracked-level shapes, for 6, 2 and 1 channels."""
    h, w = level_hw
    slab = torch.from_numpy(_slab(4, (6, h, w), n_nan=50)).to(cuda)
    u, v = (torch.from_numpy(a).to(cuda) for a in _points(h, w))
    scale = slab.nan_to_num().abs().max().item()
    for channels in (6, 2, 1):
        before = sampler.LAUNCHES
        out, inb = sampler.sample_slab(slab[:channels], u, v)
        torch.cuda.synchronize()
        assert sampler.LAUNCHES == before + 1
        want, want_inb = sampler.sample_slab_reference(slab[:channels], u, v)
        assert out.shape == (channels, u.numel()) and inb.dtype == torch.bool
        assert torch.equal(inb, want_inb)
        assert torch.equal(torch.isnan(out), torch.isnan(want))
        fin = torch.isfinite(want)
        assert (out[fin] - want[fin]).abs().max().item() <= 1e-5 * scale


def test_kernel_on_a_card_that_is_not_current(cuda):
    """Tensors on card 1 while card 0 is current: the wrapper launches on
    the tensors' card and leaves the current card as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    h, w = 120, 160
    slab = torch.from_numpy(_slab(5, (6, h, w), n_nan=20)).to(second)
    u, v = (torch.from_numpy(a).to(second) for a in _points(h, w))
    scale = slab.nan_to_num().abs().max().item()
    with torch.cuda.device(cuda):
        out, inb = sampler.sample_slab(slab, u, v)
        assert torch.cuda.current_device() == cuda.index
    torch.cuda.synchronize(second)
    want, want_inb = sampler.sample_slab_reference(slab, u, v)
    assert out.device == second and torch.equal(inb, want_inb)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    fin = torch.isfinite(want)
    assert (out[fin] - want[fin]).abs().max().item() <= 1e-5 * scale


def test_track_on_card_matches_cpu(cuda):
    """The whole tracker on the card (kernel sampler) against the same
    code on the CPU (plain sampler), at 80x60 with three levels."""
    W, H = 80, 60
    K_t = (40.0, 40.0, (W - 1) / 2.0, (H - 1) / 2.0)
    cfg = TrackerConfig(num_levels=3, first_level=2, last_level=0)
    T_rel = se3_np.exp(np.array([0.02, -0.015, 0.01, 0.01, -0.008, 0.012]))
    scene = synthetic.two_plane_scene()
    ref = scene.render(np.asarray(K_t), W, H, np.eye(4))
    cur = scene.render(np.asarray(K_t), W, H, se3_np.inverse(T_rel))
    results = {}
    for dev in (torch.device("cpu"), cuda):
        Ks = camera.pyramid_intrinsics(camera.intrinsics(*K_t, device=dev), 3)
        pyrs = [pyramid.build_pyramid(torch.as_tensor(i, device=dev),
                                      torch.as_tensor(z, device=dev), 3)
                for i, z in (ref, cur)]
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        before = sampler.LAUNCHES
        res = dense_tracker.track(pyrs[0], pyrs[1], Ks, T0, cfg)
        launched = sampler.LAUNCHES - before
        assert launched == (int(res.iterations.sum()) if dev.type == "cuda"
                            else 0)
        results[dev.type] = res
    got, want = results["cuda"], results["cpu"]
    np.testing.assert_allclose(got.transformation.cpu().numpy(),
                               want.transformation.numpy(), atol=1e-4)
    assert (got.iterations.cpu() - want.iterations).abs().max() <= 1
    assert not bool(got.is_nan().item())
    err = np.linalg.norm(se3_np.log(
        se3_np.inverse(got.transformation.cpu().double().numpy()) @ T_rel))
    assert err < 2e-3

"""The port's histogram helpers (dvo_slam_tpu_torch/utils/histogram.py)
against the JAX package's, on tests/test_histogram.py's inputs."""

import jax.numpy as jnp
import numpy as np
import torch

from dvo_slam_tpu.utils import histogram as hg
from dvo_slam_tpu_torch.utils import histogram as t_hg


def test_histogram_counts():
    vals = [0.1, 0.1, 0.5, 0.9, 2.0, -1.0]
    mask = [True, True, True, True, True, False]
    got = t_hg.histogram(torch.tensor(vals), torch.tensor(mask), 0.0, 1.0, 4)
    want = np.asarray(hg.histogram(jnp.asarray(vals), jnp.asarray(mask),
                                   0.0, 1.0, 4))
    # 0.1, 0.1 -> bin 0; 0.5 -> bin 2; 0.9 -> bin 3; 2.0 clamps to bin 3;
    # -1.0 masked out.
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [2, 0, 1, 2])
    assert got.dtype == torch.float32


def test_entropy_extremes():
    flat = np.ones(16, np.float32)
    peaked = np.zeros(16, np.float32)
    peaked[3] = 100.0
    for h in (flat, peaked):
        np.testing.assert_allclose(float(t_hg.entropy(torch.as_tensor(h))),
                                   float(hg.entropy(jnp.asarray(h))),
                                   atol=1e-6)
    assert abs(float(t_hg.entropy(torch.as_tensor(flat))) - 4.0) < 1e-5
    assert float(t_hg.entropy(torch.as_tensor(peaked))) < 1e-5


def test_median_from_histogram():
    rng = np.random.default_rng(0)
    vals = rng.normal(loc=2.0, scale=0.5, size=4096).astype(np.float32)
    mask = np.ones(4096, bool)
    got_h = t_hg.histogram(torch.as_tensor(vals), torch.as_tensor(mask),
                           0.0, 4.0, 64)
    want_h = hg.histogram(jnp.asarray(vals), jnp.asarray(mask), 0.0, 4.0, 64)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    med = float(t_hg.median_from_histogram(got_h, 0.0, 4.0))
    assert med == float(hg.median_from_histogram(want_h, 0.0, 4.0))
    assert abs(med - 2.0) < 0.1

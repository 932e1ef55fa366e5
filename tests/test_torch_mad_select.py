"""The MAD scale's radix select as csrc/linearize.cu runs it, modelled in
numpy, against the JAX package's ``robust.scale_mad`` (a sort).

The kernel reads robust.scale_mad's element, index min(n // 2, n - 1) of
the sorted |r| over the n valid points, without a sort: 4 passes of 8-bit
digits over the f32 bit patterns of |r| (non-negative floats order as
unsigned integers), high digit first. In each pass every CTA of the
cluster counts its points that match the digits chosen so far into a
256-bin histogram of the next digit, the cluster sums the histograms bin
by bin, and every CTA picks the digit whose bin holds the wanted rank.
``_radix_select`` is that model, the points split over ``ranks`` CTAs as
the kernel splits them. The selected element must equal the sort's bit for
bit, and 1.4826 x it (1 where there is no valid point) the port's plain
``robust.scale_mad`` and JAX's scale bit for bit. XLA on the CPU flushes a
subnormal product to zero (the port's PyTorch and the card keep it), so
JAX's scale is held to the model's flushed there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops import robust
from dvo_slam_tpu_torch.ops import robust as t_robust

DIGIT_BITS, PASSES = 8, 4
BINS = 1 << DIGIT_BITS


def _radix_select(bits, k, ranks):
    """The k-th smallest of the uint32 patterns ``bits`` (0-based), by the
    kernel's digit passes over ``ranks`` CTAs' slices."""
    prefix, mask = 0, 0
    slices = np.array_split(bits, ranks)
    for p in range(PASSES):
        shift = DIGIT_BITS * (PASSES - 1 - p)
        hist = np.zeros(BINS, np.int64)
        for part in slices:  # each CTA's histogram, summed in rank order
            mine = part[(part & mask) == prefix]
            hist += np.bincount((mine >> shift) & (BINS - 1), minlength=BINS)
        incl = np.cumsum(hist)
        excl = incl - hist
        (digit,) = np.nonzero((excl <= k) & (k < incl))[0]
        prefix |= int(digit) << shift
        k -= int(excl[digit])
        mask |= (BINS - 1) << shift
    return np.uint32(prefix)


def _mad_model(r, valid, ranks):
    """(the selected element, 1.4826 x it or 1.4826 without a valid point)
    as the kernel computes them, in f32."""
    n = int(valid.sum())
    if n == 0:
        element = np.float32(np.inf)
    else:
        bits = np.abs(r[valid]).astype(np.float32).view(np.uint32)
        element = _radix_select(bits, min(n // 2, n - 1), ranks).view(
            np.float32)
    scale = np.float32(1.4826) * (element if np.isfinite(element)
                                  else np.float32(1.0))
    return element, np.float32(scale)


def _case(name, rng):
    """(r, valid) of a named case: f32 residuals with a validity mask
    (invalid entries hold values the selection must ignore)."""
    if name == "odd":
        r = rng.normal(size=1001)
    elif name == "even":
        r = rng.normal(size=1000)
    elif name == "none_valid":
        r = rng.normal(size=64)
        return r.astype(np.float32), np.zeros(64, bool)
    elif name == "one_valid":
        r = rng.normal(size=64)
        valid = np.zeros(64, bool)
        valid[17] = True
        return r.astype(np.float32), valid
    elif name == "all_equal":
        r = np.full(777, -3.25)
    elif name == "ties_across_the_median":
        r = np.concatenate([np.full(300, 0.5), np.full(301, -0.5),
                            rng.normal(size=200)])
        rng.shuffle(r)
    elif name == "zeros":
        r = np.concatenate([np.zeros(500), -np.zeros(200),
                            rng.normal(size=299)])
    elif name == "subnormals":
        r = rng.integers(1, 1 << 23, size=513).astype(np.uint32).view(
            np.float32).astype(np.float64) * rng.choice([-1.0, 1.0], 513)
    elif name == "huge":
        r = np.concatenate([np.full(400, 1e30), -np.full(101, 1e30),
                            rng.normal(size=500)])
    else:
        raise ValueError(name)
    r = r.astype(np.float32)
    valid = rng.random(r.size) < 0.8
    if name in ("odd", "even"):
        valid[:] = True  # the count's parity is the case
    r[~valid] = np.float32(7.0)  # ignored: never selected
    return r, valid


CASES = ("odd", "even", "none_valid", "one_valid", "all_equal",
         "ties_across_the_median", "zeros", "subnormals", "huge")


@pytest.mark.parametrize("ranks", [1, 4, 16])
@pytest.mark.parametrize("name", CASES)
def test_digit_passes_select_the_sorts_element(name, ranks):
    rng = np.random.default_rng(CASES.index(name))
    r, valid = _case(name, rng)
    element, scale = _mad_model(r, valid, ranks)
    n = int(valid.sum())
    absr = np.where(valid, np.abs(r), np.float32(np.inf))
    want = np.sort(absr)[min(n // 2, max(n - 1, 0))]
    assert element.view(np.uint32) == np.float32(want).view(np.uint32)
    port = t_robust.scale_mad(torch.from_numpy(r), torch.from_numpy(valid))
    assert scale.view(np.uint32) == np.float32(port.item()).view(np.uint32)
    jax_scale = np.float32(np.asarray(robust.scale_mad(jnp.asarray(r),
                                                       jnp.asarray(valid))))
    flushed = (np.float32(0.0) if abs(scale) < np.finfo(np.float32).tiny
               else scale)
    assert flushed.view(np.uint32) == jax_scale.view(np.uint32)

"""The reference's precision, and the control's one step below it.

The reference runs its float32 products in full float32 and its sums over
points in float64, as the configurations state. The control (``control``)
computes the products as TF32 does, each factor rounded to TF32's 10-bit
mantissa before an exact float32 product (what a tensor-core matrix
multiply does with float32 inputs), and its sums in float32. The rounding
is written out here rather than left to PyTorch's TF32 switch: for the
reference's small matrices the library takes kernels that ignore it.
"""

from __future__ import annotations

import contextlib

import torch

_TF32 = False


def tf32(x):
    """x (float32) rounded to the nearest TF32 value while the control is
    on; x itself otherwise."""
    if not _TF32 or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    keep = ~torch.isfinite(x)
    return torch.where(keep, x, rounded.view(torch.float32))


def mm(a, b):
    """a @ b, of TF32-rounded factors under the control."""
    return tf32(a) @ tf32(b)


@contextlib.contextmanager
def control():
    """The control's precision for products inside the block."""
    global _TF32
    saved, _TF32 = _TF32, True
    try:
        yield
    finally:
        _TF32 = saved

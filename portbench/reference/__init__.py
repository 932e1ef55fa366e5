"""The plain reference that decides whether a run is correct.

Plain PyTorch and numpy. It imports neither JAX, the JAX package nor the
port, and takes nothing that the system under test made: it builds
its own pyramids from the raw frames the benchmark rendered, tracks with
its own iteratively re-weighted Gauss-Newton loop and solves pose graphs
with its own Levenberg-Marquardt loop. Where a check follows the system's
state (the warm start of each checked frame, a keyframe decision at a
tie, a final graph's edges), the traffic module that does it says so.
"""

import contextlib


@contextlib.contextmanager
def full_float32():
    """The library's float32 matrix products in full float32 (never
    TF32) inside the block, whatever the process had set."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])

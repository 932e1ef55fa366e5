"""Peaks of the card and the least bytes a kernel launch must move.

Peaks: NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W
power limit. A roofline share is stated against them, with the card's
power limit printed beside it.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12  # HBM3

F32 = 4
SLAB_CHANNELS = 6  # [I, Z, dI/dx, dI/dy, dZ/dx, dZ/dy]
POSE_FLOATS = 16


def cluster_ctas(points: int) -> int:
    """The level kernel's CTAs a cluster for a level of ``points`` pixels
    (one cluster a batch row, its grid's x): the smallest power of two
    C <= 16 with 300 C^2 >= points."""
    c = 1
    while c < 16 and 300 * c * c < points:
        c *= 2
    return c


def level_shapes(width, height, levels):
    """(H, W) of each pyramid level, finest first."""
    return [(height >> lvl, width >> lvl) for lvl in range(levels)]


def level_of_cluster(width, height, tracked):
    """{CTAs a cluster: tracked level} for a camera; a size shared by two
    tracked levels is left out (it cannot tell them apart)."""
    shapes = level_shapes(width, height, max(tracked) + 1)
    by_c = {}
    for lvl in tracked:
        h, w = shapes[lvl]
        by_c.setdefault(cluster_ctas(h * w), []).append(lvl)
    return {c: lv[0] for c, lv in by_c.items() if len(lv) == 1}


def track_level_bytes(rows, height, width, distinct_slabs):
    """The least bytes one launch of the level kernel moves for ``rows``
    batch rows at a level of height x width: each distinct reference and
    current slab read once (``distinct_slabs(rows)`` of them), each row's
    initial pose read and final pose written once."""
    slab = SLAB_CHANNELS * height * width * F32
    return distinct_slabs(rows) * slab + rows * 2 * POSE_FLOATS * F32


# How many distinct slabs a launch of B rows reads, by how a cell's
# traffic feeds the level kernel.
SLAB_MODELS = {
    # every row its own reference and its own current frame
    "own_pairs": lambda b: 2 * b,
    # B references against one shared current frame, or one reference
    # against B current frames (keyframe scan, loop-closure validation)
    "shared_side": lambda b: b + 1,
}

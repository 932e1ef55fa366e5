"""The level kernel's share of its roofline: the least time of all its
launches in the traced sub-window over their device time. The least time
is by bytes at the card's peak bandwidth (``portbench/roofline.py``):
each distinct slab a launch reads once and each row's pose in and out,
from the launch's own grid (one cluster a batch row; its CTAs name the
level). Operations are not counted: they need each launch's iterations,
which the program does not expose. A launch whose grid names no tracked
level fails the run: the kernel's launch geometry has changed, and the
level's count above must follow it."""

from portbench import roofline
from portbench.harness import RunError

UNIT = "%"
KERNEL = "track_level_kernel"


def read(trace):
    cam = trace.info.get("camera")
    model = roofline.SLAB_MODELS.get(trace.info.get("slab_model"))
    if cam is None or model is None:
        return None
    levels = roofline.level_of_cluster(cam["width"], cam["height"],
                                       trace.info["tracked_levels"])
    shapes = roofline.level_shapes(cam["width"], cam["height"],
                                   max(trace.info["tracked_levels"]) + 1)
    least_s = device_s = 0.0
    for r in trace.device:
        if KERNEL not in r.name:
            continue
        grid = r.meta.get("grid")
        if not grid or grid[0] not in levels:
            raise RunError(f"{r.name}: grid {grid} names no tracked level "
                           f"(CTAs a cluster by level: {levels})")
        h, w = shapes[levels[grid[0]]]
        least_s += roofline.track_level_bytes(grid[1], h, w, model) \
            / roofline.PEAK_BYTES_S
        device_s += (r.end - r.start) * 1e-6
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s

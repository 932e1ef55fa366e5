"""Cells cut to a size the CPU runs in seconds, for the benchmark's own
tests: 80x60 frames (the fr1 intrinsics scaled), levels 2 to 0, the
traffic's lengths shortened; the program runs its plain CPU versions."""

from portbench import harness

WIDTH, HEIGHT = 80, 60


def cell(name, mild=False, **params):
    c = harness.load_cell(name)
    cam = c["config"]["camera"]
    s = WIDTH / cam["width"]
    fx, fy, cx, cy = cam["intrinsics"]
    cam.update(width=WIDTH, height=HEIGHT,
               intrinsics=[fx * s, fy * s, (cx + 0.5) * s - 0.5,
                           (cy + 0.5) * s - 0.5])
    c["config"]["tracker"].update(num_levels=3, first_level=2, last_level=0)
    if mild:
        # Light noise: at 80x60 the protocol's corruption switches
        # keyframes at almost every frame.
        c["config"]["protocol"]["noise"].update(
            intensity_std=2.0, depth_rel_std=0.01, dropout=0.0)
    c["params"].update(params)
    return c


def fleet(**params):
    return cell("vo.fleet8", **{"streams": 2, "ring_frames": 9, "check_rows": 4,
                                "frames_per_call": 5, "check_calls": 2,
                                **params})


def slam(frames=130, **params):
    """A sequence just past one lap of the orbit: loop edges close."""
    return cell("slam.desk16", mild=True, **{"frames": frames, "chunk": 4,
                                             "check_frames": frames,
                                             **params})

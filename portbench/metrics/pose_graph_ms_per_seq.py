"""Device time of the pose-graph solves a whole sequence: the records of
the graph kernels (the cluster kernel's ``pose_graph_kernel`` and the grid
kernel's ``pose_graph_grid_kernel``) in the traced sub-window, over the
whole sequences it holds."""

UNIT = "ms"
KERNELS = ("pose_graph_kernel", "pose_graph_grid_kernel")


def read(trace):
    sequences = trace.info.get("sequences")
    if not sequences:
        return None
    us = sum(r.end - r.start for r in trace.device
             if any(k in r.name for k in KERNELS))
    return us * 1e-3 / sequences

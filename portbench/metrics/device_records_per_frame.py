"""Device records (kernels, copies and fills) a camera frame in the traced
sub-window: the work the host issues to the card a frame, which sets the
pace where the host bounds the rate."""

UNIT = "records/frame"


def read(trace):
    frames = trace.info.get("frames")
    if not frames:
        return None
    return len(trace.device) / frames

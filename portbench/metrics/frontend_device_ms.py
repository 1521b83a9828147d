"""Device milliseconds a frame of the front end: the summed time of every
device operation (kernels, copies, sets) in the traced frames, over the
traced frames (torch.profiler)."""

UNIT = "ms"


def read(trace):
    if not trace["kernels"] or not trace["frames"]:
        return None
    return sum(e - s for _, s, e in trace["kernels"]) / trace["frames"] * 1e3

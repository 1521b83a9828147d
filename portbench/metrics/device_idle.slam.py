"""The device's idle share over the traced batches of a SLAM cell: one less
the union of the device operations' intervals over the traced slice's wall
time, in percent (torch.profiler)."""

UNIT = "%"


def read(trace):
    if not trace["kernels"] or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

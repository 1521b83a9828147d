"""Device milliseconds of a SLAM batch's chain: the mean of the program's
`dev.chain` device timers (a CUDA event pair around each batch's chain
and BoW scoring in `VisualOdometer.dispatch_batch`, read when the batch
is collected) over the window's batches outside the profiler slice. Each
is the stream's interval between the two events, not the device's busy
time: a wait of the stream inside it, such as on the host's launches of
the chain's replays, counts too."""

UNIT = "ms"


def read(trace):
    times = trace.get("device_ms", {}).get("dev.chain")
    return sum(times) / len(times) if times else None

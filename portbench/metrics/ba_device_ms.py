"""Device milliseconds of a window bundle adjustment: the mean of the
program's `dev.ba` device timers (a CUDA event pair around the captured
LM program of each window solve, which has no wall cap, that
`BundleAdjuster.optimize_async` launches, read when it is finished; a
capped solve, such as a closure's polish, is timed apart, as
`dev.ba.capped`) over the window outside the profiler slice. Each is the stream's interval between the two events."""

UNIT = "ms"


def read(trace):
    times = trace.get("device_ms", {}).get("dev.ba")
    return sum(times) / len(times) if times else None

"""The mean stall of a live loop closure: the host milliseconds of the
program's `pg.optimize` spans (`PoseGraphOptimizer.optimize(live=True)`:
the loop-edge batch, the pose graph's solve and the writeback) in the
window outside the profiler slice."""

UNIT = "ms"


def read(trace):
    times = trace.get("spans", {}).get("pg.optimize")
    return sum(times) / len(times) if times else None

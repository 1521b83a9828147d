"""The mean host milliseconds of a live closure's loop-edge batch: the
program's `pg.edges` spans (load, replay and readback of the edges'
program) in the window outside the profiler slice."""

UNIT = "ms"


def read(trace):
    times = trace.get("spans", {}).get("pg.edges")
    return sum(times) / len(times) if times else None

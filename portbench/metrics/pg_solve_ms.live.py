"""The mean host milliseconds of a live pose-graph solve: the program's
`pg.solve` spans (the Gauss-Newton program's replays and the readback of
the poses) in the window outside the profiler slice."""

UNIT = "ms"


def read(trace):
    times = trace.get("spans", {}).get("pg.solve")
    return sum(times) / len(times) if times else None

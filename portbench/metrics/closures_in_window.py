"""Live loop closures in the window, the profiler slice's included: a count
of the pose-graph optimizer's live solves in the window's stats
(`PoseGraphOptimizer.history`). It guards the cell's coverage and is no
cost: it has to stay at 1 or more, and each closure stalls the loop."""

UNIT = "closures"


def read(trace):
    closures = trace.get("closures")
    return None if closures is None else len(closures)

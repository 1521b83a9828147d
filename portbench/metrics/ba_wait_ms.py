"""Host milliseconds a batch waits on bundle adjustment: the program's
`ba.finish` spans (the readback and writeback of the window BA launched a
batch before, and of a closure's deferred polish) summed over the window
outside the profiler slice, over its `slam.batch` spans."""

UNIT = "ms"


def read(trace):
    spans = trace.get("spans", {})
    batches = spans.get("slam.batch")
    if not batches:
        return None
    return sum(spans.get("ba.finish", [])) / len(batches)

"""`triangulate_dlt`'s share of its roofline at the loop-edge batch's
shape: the mean bound of `portbench/roofline/triangulate_dlt.py` on the
systems of the profiler slice's loop-edge batches (E_pad x N pixel pairs a
launch, counted from the reference Jacobi's sweeps and rotations) over
the mean traced time of those batches' launches only, in percent.

The slice's `triangulate_dlt_kernel` launches also hold the front end's,
one a frame at N = 1024. The loop-edge batch's are told apart by what
launched them: every launch runs on the one stream in the order the host
issued it, and the program counts its launches (`dlt.LAUNCHES`, replays
included); the entry notes, for each loop-edge batch the slice holds, how
many launches it made and how many the program issued after it until the
slice ended, so they are those places, counted back from the slice's last
launch, of its launches ordered by start."""

from portbench.roofline import triangulate_dlt

UNIT = "%"


def read(trace):
    batches = trace.get("edge_dlt")
    starts = sorted((s, e) for n, s, e in trace.get("kernels", [])
                    if "triangulate_dlt_kernel" in n)
    if not batches or not starts:
        return None
    times, bounds = [], []
    for b in batches:
        hi = len(starts) - b["after"]
        lo = hi - b["launches"]
        if lo < 0 or b["launches"] != len(b["calls"]):
            return None
        times += [e - s for s, e in starts[lo:hi]]
        bounds += [triangulate_dlt.bound_s(**c)[0] for c in b["calls"]]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))

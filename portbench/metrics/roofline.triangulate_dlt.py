"""`triangulate_dlt`'s share of its roofline: the mean bound of
`portbench/roofline/triangulate_dlt.py` on the traced frames' own systems
(the reference Jacobi's sweeps and rotations, never the kernel's) over the
kernel's mean traced time a launch, in percent."""

from portbench import harness
from portbench.roofline import triangulate_dlt

UNIT = "%"


def read(trace):
    times = harness.kernel_times(trace, "triangulate_dlt_kernel")
    calls = trace.get("shapes", {}).get("triangulate_dlt")
    if not times or not calls:
        return None
    bound = sum(triangulate_dlt.bound_s(**c)[0] for c in calls) / len(calls)
    return 100.0 * bound / (sum(times) / len(times))

"""`orb_describe`'s share of its roofline: the bound of
`portbench/roofline/orb_describe.py` at the traced frames' shape over the
kernel's mean traced time a launch, in percent."""

from portbench import harness
from portbench.roofline import orb_describe

UNIT = "%"


def read(trace):
    times = harness.kernel_times(trace, "orb_describe_kernel")
    shape = trace.get("shapes", {}).get("orb_describe")
    if not times or shape is None:
        return None
    return 100.0 * orb_describe.bound_s(**shape)[0] / (sum(times) / len(times))

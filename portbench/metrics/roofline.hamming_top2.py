"""`hamming_top2`'s share of its roofline: the bound of
`portbench/roofline/hamming_top2.py` at the traced frames' shape over the
kernel's mean traced time a launch, in percent."""

from portbench import harness
from portbench.roofline import hamming_top2

UNIT = "%"


def read(trace):
    times = harness.kernel_times(trace, "hamming_top2_kernel")
    shape = trace.get("shapes", {}).get("hamming_top2")
    if not times or shape is None:
        return None
    return 100.0 * hamming_top2.bound_s(**shape)[0] / (sum(times) / len(times))

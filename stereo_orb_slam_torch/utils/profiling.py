"""Per-stage wall-clock timers and optional profiler regions.

The PyTorch counterpart of the JAX package's `utils/profiling.py`. The
reference's only instrumentation is a per-frame elapsed-ms print (ref
src/slam.cpp:136-138); here every pipeline stage accumulates into a
registry that the apps print at exit, and `trace()` names a region in a
torch.profiler trace (`torch.profiler.record_function`).

The timers read the host clock and add no device sync: device work is
asynchronous, so a stage that ends in a readback (`vo.collect`,
`ba.finish`, a loop closure) includes the device time it waited for, as
the JAX package's stages that block do, and a stage that only launches
work (`vo.dispatch`, `ba.window`) does not.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self):
        """Zero all accumulators (a harness calls this between its warm-up
        and its timed frames)."""
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(
                f"{name:<24s} {s['count']:>6d} calls  "
                f"{s['mean_ms']:>9.2f} ms/call  {s['total_s']:>8.2f} s total"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(name: str, enabled: bool = False):
    """A named torch.profiler region (`record_function`); no-op unless
    enabled."""
    if not enabled:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield

"""Spans on the host clock, and the per-stage timers built on them.

The PyTorch counterpart of the JAX package's `utils/profiling.py`. The
reference's only instrumentation is a per-frame elapsed-ms print (ref
src/slam.cpp:136-138); here the program opens a span at each layer
boundary of its hot path (`VisualOdometer.track`'s upload, launch,
readback and host map, a program's capture and replay) and at each
pipeline stage (`StageTimers`). The batch path (`dispatch_batch`,
`collect_batch`) is timed by `SlamSystem`'s stages alone.

`TRACER` is the process's tracer, off by default. Off, `span()` is one
flag check that returns a shared no-op context: it reads no clock, opens
no profiler region and touches no device. On, a span records its name, its
start and end on the host clock (`time.perf_counter_ns`), the span it was
opened in, and the frame id of the root span that carries one (`vo.track`
carries the odometer's frame counter; its children inherit it). The
records go into one flat buffer that grows by doubling and are read out
with `spans()` when the run ends.

While tracing is on and a torch.profiler records, each span also opens
`torch.profiler.record_function(name)`, so the program's spans sit on the
profiler's timeline beside the device's kernels. A span read under the
profiler is slower on the host than one read without it: the profiler
records every operation, so per-layer host times come from frames traced
with the profiler off.

A timed span (`timed()`) reads the clock whether tracing is on or not,
and records only when it is on: `StageTimers` and a program's capture
time (`programs.Program._capture`) read their durations from one.

A device timer (`device_timer()`) is a pair of CUDA timing events around
work launched on the current stream, made only while tracing is on and the
work's device is a CUDA device (otherwise it is None, after one flag
check). `stop()` records its second event; `read()`, called once the host
knows the work has finished (after a readback that waited on it), adds the
milliseconds between the events to the tracer's device times under its
name, with no sync of its own. That is the stream's interval between the
two events: it counts any wait of the stream inside it, and is not the
device's busy time. The batch path times its chain (`dev.chain`,
`VisualOdometer.dispatch_batch` to `collect_batch`) and each captured
window solve of the BA (`dev.ba`, the batch path's
`BundleAdjuster.optimize_async` to its finish; a capped solve, such as
a live closure's polish, is `dev.ba.capped`) so; `device_times()` reads
them out.

Spans are opened and closed by one thread, the one that runs the
program; the host clock adds no device sync, so a span that ends in a
readback (`vo.readback`, `vo.collect`, `ba.finish`) includes the device
time it waited for, and one that only launches work (`vo.launch`,
`vo.dispatch`) does not.
"""

from __future__ import annotations

import contextlib
from array import array
from collections import defaultdict
from time import perf_counter_ns as _clock
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

# The fields of a recorded span in the buffer.
_NAME, _START, _END, _PARENT, _FRAME = range(5)
_FIELDS = 5


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int      # -1 while the span is open
    parent: int      # index of the span it was opened in, -1 for a root
    frame: int       # frame id of its root span, -1 for none


class _Span:
    """One span: recorded while its tracer is on, timed when asked."""

    __slots__ = ("tracer", "name", "frame", "row", "start_ns", "end_ns", "region")

    def __init__(self, tracer: "Tracer", name: str, frame: Optional[int]):
        self.tracer, self.name, self.frame = tracer, name, frame
        self.row, self.region = -1, None

    def __enter__(self):
        t = self.tracer
        if t.enabled:
            self.row = t._open_row(self.name, self.frame)
            if torch.autograd._profiler_enabled():
                self.region = torch.profiler.record_function(self.name)
                self.region.__enter__()
        self.start_ns = _clock()
        if self.row >= 0:
            t._buf[self.row * _FIELDS + _START] = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self.row >= 0:
            t = self.tracer
            t._buf[self.row * _FIELDS + _END] = self.end_ns
            t._open.pop()
            if self.region is not None:
                self.region.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_OFF = contextlib.nullcontext()


class DeviceTimer:
    """A CUDA event pair on the current stream (see the module's
    docstring): started when made."""

    __slots__ = ("tracer", "name", "start", "end")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def stop(self):
        self.end.record()

    def read(self):
        """Add the device milliseconds between the events (both passed)."""
        self.tracer._device[self.name].append(self.start.elapsed_time(self.end))


class Tracer:
    """The spans of one process (see the module's docstring)."""

    def __init__(self, capacity: int = 4096):
        self.enabled = False
        self._buf = array("q", bytes(8 * _FIELDS * max(capacity, 1)))
        self._n = 0
        self._names: List[str] = []
        self._ids: Dict[str, int] = {}
        self._open: List[int] = []     # rows of the open recorded spans, innermost last
        self._device: Dict[str, List[float]] = defaultdict(list)

    def enable(self, on: bool = True):
        self.enabled = bool(on)

    def span(self, name: str, frame: Optional[int] = None):
        """A context that records the span `name` while tracing is on;
        `frame` marks a root span of that frame id."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, frame)

    def timed(self, name: str) -> _Span:
        """A span that reads the clock whether tracing is on or not: its
        `seconds` after it closes."""
        return _Span(self, name, None)

    def device_timer(self, name: str, device) -> Optional[DeviceTimer]:
        """A started `DeviceTimer` of `name` while tracing is on and
        `device` is a CUDA device; None otherwise."""
        if not self.enabled or torch.device(device).type != "cuda":
            return None
        return DeviceTimer(self, name)

    def device_times(self) -> Dict[str, List[float]]:
        """{name: [device milliseconds of each timer read]}."""
        return {name: list(ms) for name, ms in self._device.items()}

    def _open_row(self, name: str, frame: Optional[int]) -> int:
        row = self._n
        if (row + 1) * _FIELDS > len(self._buf):
            self._buf.extend(array("q", bytes(8 * len(self._buf))))
        self._n = row + 1
        name_id = self._ids.get(name)
        if name_id is None:
            name_id = self._ids[name] = len(self._names)
            self._names.append(name)
        parent = self._open[-1] if self._open else -1
        if frame is None:
            frame = self._buf[parent * _FIELDS + _FRAME] if parent >= 0 else -1
        base = row * _FIELDS
        self._buf[base + _NAME] = name_id
        self._buf[base + _END] = -1
        self._buf[base + _PARENT] = parent
        self._buf[base + _FRAME] = frame
        self._open.append(row)
        return row

    def spans(self) -> List[SpanRecord]:
        """The recorded spans in the order they were opened."""
        b, names = self._buf, self._names
        return [SpanRecord(names[b[i]], b[i + 1], b[i + 2], b[i + 3], b[i + 4])
                for i in range(0, self._n * _FIELDS, _FIELDS)]

    def reset(self):
        """Drop the recorded spans and device times (with no span open)."""
        if self._open:
            raise RuntimeError("a tracer is reset only with no span open")
        self._n = 0
        self._device.clear()


def self_ns(spans: List[SpanRecord]) -> List[int]:
    """Each span's duration less the time its children cover (a thread's
    children follow one another, so they never overlap)."""
    covered = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            covered[s.parent] += s.end_ns - s.start_ns
    return [s.end_ns - s.start_ns - c for s, c in zip(spans, covered)]


def frame_totals(spans: List[SpanRecord], frames: Iterable[int],
                 durations: Optional[List[int]] = None) -> Dict[str, int]:
    """{name: nanoseconds} summed over the spans of the given frame ids,
    the frames' root spans included: their durations, or the given ones
    (`self_ns(spans)` for self times)."""
    keep = set(frames)
    if durations is None:
        durations = [s.end_ns - s.start_ns for s in spans]
    out: Dict[str, int] = defaultdict(int)
    for s, d in zip(spans, durations):
        if s.frame in keep:
            out[s.name] += d
    return dict(out)


# The process's tracer, the one the program's spans use.
TRACER = Tracer()


class StageTimers:
    """Wall time and calls by pipeline stage; each stage is a span of its
    name on `tracer`, timed whether tracing is on or not."""

    def __init__(self, tracer: Tracer = TRACER):
        self.tracer = tracer
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        span = self.tracer.timed(name)
        try:
            with span:
                yield
        finally:
            self.totals[name] += span.seconds
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

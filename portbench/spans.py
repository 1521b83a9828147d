"""The port's own spans in one run of a visual-odometry cell, on the chip.

    python3 -m portbench.spans --workload NAME --seed N --seconds S --tracing 0|1

runs the cell's entry once, as `portbench.run` does: with `--tracing 0` as
its `--trace 0` run, with `--tracing 1` as its `--trace 1` run (the
torch.profiler slice included) with the port's tracer
(`stereo_orb_slam_torch.utils.profiling.TRACER`) on from before set-up.
It prints one JSON line:

- both: the window's frames, `fps`, and the median, mean and p95 of the
  per-frame latency that the entry measures, over the window's frames
  outside the profiler slice (all of them with `--tracing 0`), so that the
  two runs of one seed give the cost of tracing when on;
- `--tracing 1`, over the same frames: each span's host milliseconds a
  frame (`vo.upload`, `vo.launch`, `vo.readback`, `vo.map`, `vo.track`,
  `program.replay`) and its self time, the share of `vo.track` that its
  children (`vo.upload`, `vo.launch`, `vo.readback`, `vo.map`) cover, and
  `vo.track`'s mean over the mean latency; the `program.capture` spans
  before the window (count, milliseconds) and inside it; and, from the
  profiler slice on the profiler's clock, how many frames hold every one
  of their kernels
  between the start of their `vo.launch` and the end of their
  `vo.readback`, and the device's idle time in the slice split by the
  innermost program span open at the time (`none` where none is).

Nothing here is read by `portbench.run`: the benchmark's runs keep the
tracer off. `measure` is a stand-in until the entry hands the readers the
program's spans: it swaps `harness.reduce_profile` for the length of its
one run (`_keep_slice`) to keep the slice's events, and goes, with
`--tracing`, once `reduce_profile` has a hook that keeps them and the
readers of the span metrics exist. `clock_check` and `idle_by_span` are
pure functions of the slice's events, for those readers.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

import numpy as np

from portbench import harness
from portbench import run as bench_run   # sets the host's thread counts before torch loads

FRAME_SPANS = ("vo.upload", "vo.launch", "vo.readback", "vo.map")
REPORTED = FRAME_SPANS + ("vo.track", "program.replay")


def _keep_slice(kept: dict):
    """`harness.reduce_profile`, also keeping the slice's program spans
    (names of the tracer's spans) and its device operations. The device's
    side of each span (the profiler's `gpu_user_annotation`, which bears
    the span's name) is not an operation."""
    from stereo_orb_slam_torch.utils.profiling import TRACER

    reduce = harness.reduce_profile

    def reduce_and_keep(prof, window_s, frames):
        import torch

        names = {s.name for s in TRACER.spans()}
        spans, dev = [], []
        for e in prof.events():
            tr = e.time_range
            if e.name in names:
                if e.device_type == torch.autograd.DeviceType.CPU:
                    spans.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
        kept["spans"], kept["device"] = sorted(spans, key=lambda s: s[1]), dev
        return reduce(prof, window_s, frames)

    return reduce_and_keep


def clock_check(spans: list, device: list) -> dict:
    """Frames of the slice whose kernels (device operations other than
    copies and sets) all start at or after their `vo.launch` span starts
    and end at or before their `vo.readback` span ends. A kernel belongs to
    the frame whose `vo.track` span started last before it. Also the
    furthest a kernel starts before its `vo.launch` and ends after its
    `vo.readback`, in ms (0: none does)."""
    tracks = [s for s in spans if s[0] == "vo.track"]
    starts = [s[1] for s in tracks]
    first = {name: {} for name in ("vo.launch", "vo.readback")}
    for name, s, e in spans:
        if name in first:
            first[name].setdefault(bisect.bisect_right(starts, s) - 1, (s, e))
    holds = [True] * len(tracks)
    kernels = [d for d in device if not d[0].startswith(("Memcpy", "Memset"))]
    early, before, after = 0, 0.0, 0.0
    for _, s, e in kernels:
        k = bisect.bisect_right(starts, s) - 1
        if k < 0:
            early += 1
            continue
        launch, readback = first["vo.launch"].get(k), first["vo.readback"].get(k)
        if launch is None or readback is None:
            holds[k] = False
            continue
        before, after = max(before, launch[0] - s), max(after, e - readback[1])
        if s < launch[0] or e > readback[1]:
            holds[k] = False
    return {"frames": len(tracks), "hold": sum(holds), "kernels": len(kernels),
            "before_first_frame": early, "before_launch_ms": before * 1e3,
            "after_readback_ms": after * 1e3}


def idle_by_span(spans: list, device: list) -> dict:
    """The device's idle seconds between the slice's first `vo.track` start
    and last end, by the innermost program span open (`none`: none is), and
    the slice's wall seconds."""
    tracks = [s for s in spans if s[0] == "vo.track"]
    if not tracks:
        return {"wall_s": 0.0, "idle_s": {}}
    t0, t1 = tracks[0][1], max(s[2] for s in tracks)
    busy = sorted((s, e) for _, s, e in device if e > t0 and s < t1)
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    # Each span by the frame whose `vo.track` started last before it.
    starts = [s[1] for s in tracks]
    by_frame = defaultdict(list)
    for sp in spans:
        by_frame[bisect.bisect_right(starts, sp[1]) - 1].append(sp)
    idle = defaultdict(float)
    for gs, ge in gaps:
        k0, k1 = (bisect.bisect_right(starts, t) - 1 for t in (gs, ge))
        inside = [sp for k in range(k0, k1 + 1) for sp in by_frame[k]
                  if sp[1] < ge and sp[2] > gs]
        cuts = sorted({gs, ge} | {t for sp in inside for t in sp[1:] if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            open_ = [sp for sp in inside if sp[1] <= mid < sp[2]]
            name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "none"
            idle[name] += b - a
    return {"wall_s": t1 - t0, "idle_s": dict(idle)}


def measure(cfg: dict, cell: dict, seed: int, seconds: float, tracing: bool,
            device="cuda") -> dict:
    """One run of the cell's entry (see the module's docstring)."""
    from stereo_orb_slam_torch.utils import profiling
    from portbench.reference.judge import worst

    tracer = profiling.TRACER
    tracer.reset()
    tracer.enable(tracing)
    kept: dict = {}
    entry = harness.entry(cell["entry"])
    reduce = harness.reduce_profile
    if tracing:
        harness.reduce_profile = _keep_slice(kept)
    try:
        out = entry.run(cfg, cell, seed, seconds, tracing, device=device)
    finally:
        harness.reduce_profile = reduce
        tracer.enable(False)

    warm, tr = cell["warmup_frames"], cell["trace"]
    lat = np.asarray(out["latency_ms"])
    pos = np.arange(len(lat))
    outside = ~((pos >= tr["start"]) & (pos < tr["start"] + tr["frames"])) if tracing \
        else np.ones(len(lat), bool)
    checks = bench_run.checks_of(cell, worst(out["readings"]))
    line = {"workload": cell["name"], "seed": seed, "tracing": int(tracing),
            "correct": bench_run.is_correct(checks), "frames": out["frames"],
            "failed": out["failed"], "fps": out["metrics"]["fps"][0],
            "setup_s": out["setup_s"], "timed_frames": int(outside.sum()),
            "latency_median_ms": float(np.median(lat[outside])),
            "latency_mean_ms": float(np.mean(lat[outside])),
            "latency_p95_ms": float(np.percentile(lat[outside], 95))}
    spans = tracer.spans()
    if not tracing:
        line["spans_recorded"] = len(spans)
        return line

    frames = [warm + int(p) for p in pos[outside]]
    totals = profiling.frame_totals(spans, frames)
    n = len(frames)
    own = profiling.frame_totals(spans, frames, profiling.self_ns(spans))
    line["span_ms"] = {k: totals.get(k, 0) * 1e-6 / n for k in REPORTED}
    line["self_ms"] = {k: own.get(k, 0) * 1e-6 / n for k in REPORTED}
    track = totals.get("vo.track", 0)
    line["children_share"] = 1.0 - own.get("vo.track", 0) / track if track else None
    line["track_over_latency"] = (line["span_ms"]["vo.track"] / line["latency_mean_ms"])
    window = [s for s in spans if s.name == "vo.track" and s.frame >= warm]
    w0, w1 = window[0].start_ns, window[-1].end_ns
    caps = [s for s in spans if s.name == "program.capture"]
    before = [s for s in caps if s.start_ns < w0]
    line["captures"] = {
        "setup": len(before), "setup_ms": sum(s.end_ns - s.start_ns for s in before) * 1e-6,
        "window": sum(1 for s in caps if w0 <= s.start_ns <= w1)}
    if kept:
        line["clock"] = clock_check(kept["spans"], kept["device"])
        split = idle_by_span(kept["spans"], kept["device"])
        wall = split["wall_s"]
        line["slice_idle"] = {
            "share": sum(split["idle_s"].values()) / wall if wall else None,
            "ms_per_frame": {k: v * 1e3 / tr["frames"]
                             for k, v in sorted(split["idle_s"].items(), key=lambda kv: -kv[1])}}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracing", choices=("0", "1"), required=True)
    args = ap.parse_args(argv)
    cell, cfg = harness.cell_files(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans measures on a CUDA device; none is available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    line = measure(cfg, cell, args.seed, args.seconds, args.tracing == "1")
    line["device"] = {"kind": torch.cuda.get_device_name(0),
                      "power_limit_w": harness.power_limit_w()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's files are found by its name (see
portbench/harness.py). With `--trace 0` the result's metrics are the cell's
end-to-end metrics of BENCHMARK.json, with `--trace 1` its per-layer
metrics, read from a torch.profiler slice of the window. The last lines on
standard error, and the result line's last key, give each number that
decides `correct` beside its limit.

Exits with 2, printing no result, without as many CUDA devices as the cell
asks for; with 3 when the process holds JAX or the JAX package after the
window.
"""

from __future__ import annotations

import os

# Few host threads: the port's host work is small NumPy and torch calls.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def checks_of(cell: dict, readings: dict) -> dict:
    """{number: (worst reading, limit)} of the cell's limits."""
    return {k: (readings.get(k), lim) for k, lim in cell["limits"].items()}


def is_correct(checks: dict) -> bool:
    return all(v is not None and not math.isnan(v) and v <= lim for v, lim in checks.values())


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark()
    spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell, cfg = harness.cell_files(args.workload)
    if cell["config"] != spec["config"] or cell["traffic"]["name"] != spec["traffic"]:
        log(f"workloads/{args.workload}.json does not match BENCHMARK.json's entry")
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        log(f"{args.workload} needs {spec['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.cuda.set_device(0)
    power_w = harness.power_limit_w()
    out = harness.entry(cell["entry"]).run(cfg, cell, args.seed, args.seconds,
                                           bool(args.trace))
    from portbench.reference.judge import worst

    checks = checks_of(cell, worst(out["readings"]))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"]), "power_limit_w": power_w}
    breakdown = None
    if args.trace:
        tr = out["trace"]
        metrics = {}
        if tr is not None:
            device["busy_s"] = tr["busy_s"]
            device["window_s"] = tr["window_s"]
            breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
            for m in harness.per_layer_for(bench, args.workload):
                mod = harness.reader(m["name"])
                value = mod.read(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": mod.UNIT}
                    log(f"{m['name']}: {value} {mod.UNIT}"
                        + (f" (power limit {power_w} W)" if m["name"].startswith("roofline")
                           else ""))
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]][0],
                               "unit": out["metrics"][m["name"]][1]}
                   for m in harness.end_to_end_for(bench, args.workload)}
        lat = out["latency_ms"]
        if len(lat):
            import numpy as np

            log(f"frames {out['frames']} in {out['window_s']:.3f} s; per-frame latency median "
                f"{float(np.median(lat))} ms, p95 {float(np.percentile(lat, 95))} ms over "
                f"{len(lat)} frames ({int(len(lat) * 0.05)} beyond the p95)")
            log("median latency by quarter of the window: " + ", ".join(
                f"{float(np.median(q)):.4f}" for q in np.array_split(lat, 4)) + " ms")
    log(f"set-up {out['setup_s']} s (render {out['render_s']} s); memory peak "
        f"{out['memory_peak_bytes']} bytes; {device['kind']}, power limit {power_w} W")
    bad = harness.forbidden_modules()
    if bad:
        log(f"the process holds modules it may not load: {bad}")
        return 3
    correct = is_correct(checks)
    log(f"judged {len(out['readings'])} frames of the window against the plain reference")
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    print(harness.result_line(correct, out["frames"], out["failed"], metrics, device, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

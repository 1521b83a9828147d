"""What every cell of the benchmark shares: finding its files by name, the
device's description, reducing a profiler trace, the per-layer readers and
the result line.

A cell `<name>` is `workloads/<name>.json` (its configuration, its entry
and its traffic), a configuration `<config>` is `configs/<config>.json`, an
entry `<entry>` is the module `portbench.entries.<entry>` (set-up, window
and the comparison that decides `correct`), and a per-layer metric `<m>` is
read by `metrics/<m>.py`, which defines `UNIT` and `read(trace)`, returning
a number or None when the trace holds nothing for it. Nothing here names a
cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_orb_slam_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def cell_files(name: str, root: Path = ROOT):
    """(cell, configuration) of the cell `name`, read from its files."""
    cell = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{cell['config']}.json")
    return cell, cfg


def entry(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def reader(metric: str, root: Path = ROOT):
    """The module of `metrics/<metric>.py` (a name may hold dots)."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_for(bench: dict, workload: str) -> list:
    """The per-layer metrics of BENCHMARK.json that this cell reports."""
    return [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]


def end_to_end_for(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split("\n")[0])
    except ValueError:
        return None


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


# ------------------------------------------------------------------ traces
def reduce_profile(prof, window_s: float, frames: int) -> dict:
    """The device's kernels and the host's operations of a torch.profiler
    run over `frames` frames and `window_s` wall seconds: device intervals
    (name, start, end in seconds), their busy union, the top operations
    and the longest idle gaps labelled by the innermost host operation
    running at the gap's start."""
    import torch

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    dev.sort(key=lambda x: x[1])
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, e in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    totals = {}
    for name, s, e in dev:
        totals[name] = totals.get(name, 0.0) + (e - s)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for gs, ge in gaps[:10]:
        inner = [h for h in host if h[1] <= gs < h[2]]
        label = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host"
        labelled.append([label, ge - gs])
    return {"frames": frames, "window_s": window_s, "busy_s": busy, "kernels": dev,
            "device_ops": [[n, t] for n, t in top], "idle_gaps": labelled}


def kernel_times(trace: dict, fragment: str) -> list:
    """Durations in seconds of the traced kernels whose name holds
    `fragment`."""
    return [e - s for n, s, e in trace["kernels"] if fragment in n]


# ------------------------------------------------------------------ result
def result_line(correct, attempted, failed, metrics: dict, device: dict, checks: dict,
                breakdown=None) -> str:
    """The run's one JSON line; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)

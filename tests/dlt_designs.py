"""Builds of the batched DLT kernel timed side by side, on the card.

Each `--source NAME=PATH` is a source with the C interface of
stereo_orb_slam_torch/csrc/triangulate_dlt.cu (`triangulate_dlt_launch`),
for example an earlier design of the kernel; `NAME=` with no path is the
repository's kernel. Each is built and launched through the kernel's own
wrapper (`ops.kernels.dlt.triangulate_dlt_work` with `source`). On the
smoke's synthetic inputs (`chip_smoke._dlt_case`: EuRoC cam0's rig, half
the points 1.5-5 m deep, half 45-100 m, a quarter of the slots zero) at

- N = 1024 (S = 1),
- S = 2 (two such problems, one projection pair each), and
- B = E x 1024 for each E of `--edges` (the loop edges' column slices of
  [B, N, 4] banks, E the batch's padded edge count),

every build is held against a float64 DLT within `chip_smoke.DLT_F64_RTOL`
of each valid point's depth and must be finite everywhere (the script
exits non-zero at its end if one is not); then it is timed as the smoke
times a kernel (device µs a launch, CUDA graphs of 50 launches,
`chip_smoke.time_device`), the builds in turns A B B A, `--rounds` times,
so that both see the same card and clocks. Its Jacobi sweeps per point
(the `work` output) are recorded beside.

    python tests/dlt_designs.py --source before=OLD.cu --source after=

Without `--source` it times the repository's kernel alone. Needs a CUDA
device and nvcc; prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def cases(rng, dev, edges):
    """(name, (P1, P2, uv1, uv2), valid [B, N]) at each shape."""
    import torch

    import chip_smoke

    P1, P2, uv1, uv2, valid, _ = chip_smoke._dlt_case(rng, 1024)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    yield "N=1024", (t(P1), t(P2), t(uv1), t(uv2)), valid
    Q1, Q2, w1, w2, wv, _ = chip_smoke._dlt_case(rng, 1024)
    yield ("S=2", (t(np.stack([P1, P2]))[:, None], t(np.stack([P2, P1]))[:, None],
                   t(np.concatenate([uv1, w2])), t(np.concatenate([uv2, w1]))),
           np.concatenate([valid, wv]))
    for E in edges:
        parts = [chip_smoke._dlt_case(rng, 1024) for _ in range(E)]
        bank = t(np.concatenate([np.concatenate([p[2], p[3]], -1) for p in parts]))
        yield (f"B={E}x1024", (t(P1), t(P2), bank[..., :2], bank[..., 2:]),
               np.concatenate([p[4] for p in parts]))


def main(argv=None):
    import torch

    import chip_smoke
    from stereo_orb_slam_torch.ops.kernels import dlt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--edges", default="64", help="comma-separated E of the B = E x 1024 shapes")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    sources = {name: path or None for name, path in
               (s.split("=", 1) for s in args.source or ["current="])}
    edges = [int(e) for e in args.edges.split(",") if e]
    dev = torch.device("cuda")
    failed = []
    result = {"device": torch.cuda.get_device_name(0), "power_limit": smi.stdout.strip(),
              "sources": sources, "shapes": {}}
    for shape, args_, valid in cases(np.random.default_rng(0), dev, edges):
        calls, row = {}, {}
        for name, src in sources.items():
            got, work = dlt.triangulate_dlt_work(*args_, source=src)
            torch.cuda.synchronize()
            got, w = got.cpu().numpy(), work.cpu().numpy().reshape(-1, 2)
            rel = chip_smoke._dlt_f64_rel(got, *args_, valid)
            ok = bool(np.isfinite(got).all()) and rel <= chip_smoke.DLT_F64_RTOL
            if not ok:
                failed.append(f"{name} at {shape}: {rel} of the depth from float64, "
                              f"finite {bool(np.isfinite(got).all())}")
            calls[name] = (lambda src=src: dlt.triangulate_dlt_work(*args_, work=False,
                                                                    source=src))
            row[name] = {"ok": ok, "float64_rel_err": rel,
                         "sweeps_mean": float(w[:, 0].mean()), "sweeps_max": int(w[:, 0].max()),
                         "rotations_mean": float(w[:, 1].mean()), "us": []}
        order = list(calls)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                row[name]["us"].append(chip_smoke.time_device(calls[name]) * 1e3)
        for name in order:
            row[name]["us_median"] = statistics.median(row[name]["us"])
        result["shapes"][shape] = row
        print(f"{shape}: " + ", ".join(f"{k} {v['us_median']:.2f} us (sweeps mean "
                                       f"{v['sweeps_mean']:.2f}, max {v['sweeps_max']}; "
                                       f"{v['float64_rel_err']:.3g} of the depth)"
                                       for k, v in row.items()), flush=True)
    print(json.dumps(result))
    if failed:
        raise SystemExit("off the float64 DLT or non-finite: " + "; ".join(failed))


if __name__ == "__main__":
    main()

"""The readings that the limits of `correct` are set from, on the chip.

    python3 -m portbench.control --workload NAME --seeds 1,2,3 --seconds S [--control]

runs the cell's entry once per seed in this one process (the set-up's
captures are reused from the second seed on) and prints one JSON line per
seed: the worst reading of each compared number over the judged frames for
the port and, with `--control`, for the control (the plain reference one
precision step below the configuration's, put in the port's place). The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness
from portbench.reference.judge import worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell, cfg = harness.cell_files(args.workload)
    entry = harness.entry(cell["entry"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = entry.run(cfg, cell, seed, args.seconds, False, control=args.control)
        line = {"workload": args.workload, "seed": seed, "frames": out["frames"],
                "judged": len(out["readings"]), "program": worst(out["readings"]),
                "fps": out["metrics"]["fps"][0], "setup_s": out["setup_s"]}
        if args.control:
            line["control"] = worst(out["control_readings"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

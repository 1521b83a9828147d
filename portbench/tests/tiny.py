"""Small copies of the benchmark's cells for CPU tests: the same files, the
image cut to a few hundred pixels a side, 256 features, one judged run of
a few frames in a window of a few seconds, the traced slice at its start."""

import copy

from portbench import harness


def tiny(name: str):
    """(cell, configuration) of the cell `name`, cut to run on the CPU."""
    cell, cfg = harness.cell_files(name)
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    s = 400.0 / cfg["w"]
    h = int(round(cfg["h"] * s / 4)) * 4
    cfg.update(h=h, w=400, fx=cfg["fx"] * s, fy=cfg["fy"] * s, cx=cfg["cx"] * s,
               cy=cfg["cy"] * s)
    cfg["scene"]["depth_m"] = cfg["fx"] * cfg["baseline_m"] / 20.0
    cfg["frontend"]["num_features"] = 256
    cell.update(judge={"runs": 1, "frames": 3}, trace={"start": 1, "frames": 2})
    return cell, cfg

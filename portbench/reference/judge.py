"""The numbers that decide `correct` for one stereo frame, and the frames'
worst readings.

Each number compares a side (the port's frame, or the control's) with the
plain reference's frame (`reference.frontend.frame`) on the same inputs:

- `corners`: share of the left image's slots whose corner lies more than
  1e-3 px from the reference's (ideal coordinates on the general rig);
- `descriptors`: share of the left descriptors' bits that differ;
- `stereo`: share of slots whose stereo validity differs, or whose right
  match lies more than 1e-3 px from the reference's where both are valid;
- `points`: the largest gap of a triangulated point from the reference's,
  over the slots valid on both sides, as a share of its depth;
- `temporal`: share of slots whose match into the previous frame (where
  the reference's passes its gates) or whose RANSAC inlier flag differs;
- `pose`: the largest distance, in metres, between the frame's valid
  reference points moved by the side's returned pose and by the
  reference's;
- `trajectory`: the same distance for a run of consecutive frames, the
  last frame's valid reference points moved by the side's trajectory over
  the run and by the reference's own chained poses.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("corners", "descriptors", "stereo", "points", "temporal", "pose",
           "trajectory")
PX = 1e-3


def _share(mask) -> float:
    return float(mask.float().mean())


def slots(s) -> dict:
    """The port's slots of a frame as a dict."""
    return {k: getattr(s, k) for k in ("kp_l", "kp_r", "desc", "pts", "valid")}


def _moved_gap(Ts, Tr, ref: dict) -> float:
    """The largest distance between the frame's valid reference points moved
    by Ts and by Tr (metres)."""
    X = ref["pts"][ref["valid"]].double()
    if X.shape[0] == 0:
        X = torch.eye(3, dtype=torch.float64, device=X.device)
    Ts = torch.as_tensor(Ts).to(X.device).double()
    Tr = torch.as_tensor(Tr).to(X.device).double()

    def moved(T):
        return X @ T[:3, :3].T + T[:3, 3]

    return float((moved(Ts) - moved(Tr)).norm(dim=-1).max())


def numbers(side: dict, ref: dict) -> dict:
    """The numbers of one frame but `trajectory` (see the module's
    docstring)."""
    from portbench.reference.frontend import unpack_bits

    dev = ref["kp_l"].device
    s = {k: (torch.as_tensor(v).to(dev) if not isinstance(v, bool) else v)
         for k, v in side.items()}
    corners = (s["kp_l"] - ref["kp_l"]).abs().amax(-1) > PX
    bits = unpack_bits(s["desc"].to(torch.int32)) != unpack_bits(ref["desc"])
    both = s["valid"] & ref["valid"]
    right_off = ((s["kp_r"] - ref["kp_r"]).abs().amax(-1) > PX) & both
    stereo = (s["valid"] != ref["valid"]) | right_off
    if bool(both.any()):
        gap = (s["pts"][both].double() - ref["pts"][both].double()).abs().amax(-1)
        points = float((gap / ref["pts"][both, 2].double().abs().clamp(min=1e-9)).max())
    else:
        points = 0.0
    temporal = ((ref["t_ok"] & (s["prev_idx"].long() != ref["prev_idx"].long()))
                | (s["tracked"] != ref["tracked"]))
    pose = _moved_gap(s["T"], ref["T"], ref)
    return {"corners": _share(corners), "descriptors": _share(bits), "stereo": _share(stereo),
            "points": points, "temporal": _share(temporal), "pose": pose}


def run_numbers(side: list, side_chain, ref: list, ref_chain) -> list:
    """The numbers of each frame of a run (dicts as `numbers` takes them),
    `trajectory` on the last: the side's pose over the run `side_chain`
    against the reference's `ref_chain` (each [4, 4], the last frame's
    points into the frame before the run's)."""
    out = [numbers(s, r) for s, r in zip(side, ref)]
    out[-1]["trajectory"] = _moved_gap(side_chain, ref_chain, ref[-1])
    return out


def worst(readings: list) -> dict:
    """The largest reading of each number over the frames that have it (NaN
    if any read NaN; None when none did)."""
    out = {}
    for k in NUMBERS:
        vals = np.array([r[k] for r in readings if k in r], np.float64)
        if not len(vals):
            out[k] = None
        else:
            out[k] = float("nan") if np.isnan(vals).any() else float(vals.max())
    return out

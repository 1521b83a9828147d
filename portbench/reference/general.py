"""The plain reference of the SLAM path's front-end pieces on the general
(distorted, unrectified) rig: a stereo frame with RANSAC's refit, a batch
of loop edges, and the camera-frame points of stored observations.

The general-rig counterpart of `reference/loop_edges.py`, with its
interface (`frame`, `edges`, `edge_keys`), built from
`reference/frontend.py`'s stages:

- `frame`: `reference.frontend.frame` on the general branch (corners,
  descriptors and matching on the raw images, both sides' pixels
  undistorted by the fixed-point inversion in float32, the DLT in float64
  rounded once, valid where 0 < z < fx * baseline), then, where the
  configuration's `ransac` asks for it (`final_model_fitting`), RANSAC
  again with `loop_edges.ransac`'s refit (Horn over the winner's inliers,
  kept where it loses no inlier) on the same keys;
- `edges`: a loop edge (src, dst) as `loop_edges.edges` measures it (dst's
  stored descriptors matched against src's, RANSAC fitting
  X_dst = T X_src with no refit, every answer under rounding kept by
  `loop_edges.tied`), both frames' stored ideal observations triangulated
  again by the DLT in float64 (z < 100 m), as the program's loop-edge
  batch triangulates them on this rig;
- `stereo_points`: the camera-frame points of stored ideal observations by
  the closed form these coordinates admit: both cameras have the same
  intrinsics and the right one sits `baseline` along x, so after
  undistortion z = fx b / (u_l - u_r), x = (u_l - cx) z / fx and
  y = (v_l - cy) z / fy.

Imports nothing of the program. `low` computes the control, one precision
step below (a bfloat16 front end, the DLT in float32, Horn's products in
TF32).
"""

from __future__ import annotations

import torch

from portbench.reference import frontend as ref_fe
from portbench.reference import loop_edges as ref_le
from portbench.reference.loop_edges import EDGE_MAX_DEPTH, edge_keys  # noqa: F401


def frame(img_l, img_r, prev, keys, rig: ref_fe.Rig, fe: dict, rc: dict, table, low=False):
    """`reference.frontend.frame` with RANSAC's refit when the
    configuration's `ransac` asks for it; the same dict out. TF32 is off
    but in the control's RANSAC."""
    with ref_le._tf32(False):
        out = ref_fe.frame(img_l, img_r, prev, keys, rig, fe, rc, table, low)
    if not rc.get("final_model_fitting", False):
        return out
    pi = out["prev_idx"].long()
    obs_prev = torch.cat([prev["kp_l"], prev["kp_r"]], dim=-1)[pi]
    with ref_le._tf32(low):
        T, inl, success = ref_le.ransac(keys, out["pts"], prev["pts"][pi], obs_prev,
                                        out["t_ok"], rig.P_l, rig.P_r,
                                        rc["inlier_threshold_px"], rc["min_pairs"],
                                        rc["min_inliers"], refit=True)
    if out["num_stereo"] < fe["min_stereo_matches"]:
        T, success = torch.eye(4, device=T.device), False
    return dict(out, tracked=inl & out["t_ok"], T=T, success=success)


def _triangulate(uv, rig: ref_fe.Rig, low: bool):
    """Points [N, 3] and validity of ideal stereo observations [N, 4] by
    the reference's DLT, gated at the loop edges' depth."""
    return ref_fe.triangulate_dlt(rig.P_l, rig.P_r, uv[:, :2], uv[:, 2:], EDGE_MAX_DEPTH, low)


def edges(src_banks, dst_banks, keys, rig: ref_fe.Rig, fe: dict, rc: dict, low=False):
    """`loop_edges.edges` on the general rig: the same dicts out. TF32 is
    off but in the control's RANSAC."""
    with ref_le._tf32(False):
        return [_edge(e, src_banks, dst_banks, keys, rig, fe, rc, low)
                for e in range(len(keys))]


def _edge(e, src_banks, dst_banks, keys, rig, fe, rc, low):
    d_s, v_s, uv_s = (b[e] for b in src_banks)
    d_d, v_d, uv_d = (b[e] for b in dst_banks)
    idx, ok = ref_fe.gate(ref_fe.top2(d_d, d_s, v_s), v_d, fe["match_max_distance"],
                          fe["match_ratio"])
    pts_d, tv_d = _triangulate(uv_d, rig, low)
    pts_s, tv_s = _triangulate(uv_s[idx], rig, low)
    args = (keys[e], pts_s, pts_d, uv_d, ok & tv_d & tv_s, rig.P_l, rig.P_r,
            rc["inlier_threshold_px"], rc["min_pairs"], rc["min_inliers"])
    with ref_le._tf32(low):
        T, inl, success = ref_le.ransac(*args)
        answers = [(T, inl, success)] + ref_le.tied(*args)
    own, own_ok = _triangulate(uv_s, rig, low)
    return {"idx": idx, "ok": ok, "inliers": inl, "T": T, "success": success,
            "answers": answers, "pts": own, "valid": own_ok & v_s}


def stereo_points(uv, valid, rig: ref_fe.Rig):
    """Camera-frame points [..., N, 3] float64 of ideal stereo observations
    [..., N, 4] (see the module's docstring), and their validity."""
    uv = uv.double()
    d = uv[..., 0] - uv[..., 2]
    z = rig.fx * rig.baseline / torch.where(d.abs() < 1e-6, 1e-6, d)
    pts = torch.stack([(uv[..., 0] - rig.cx) * z / rig.fx, (uv[..., 1] - rig.cy) * z / rig.fy,
                       z], -1)
    return pts, valid & (z > 0)

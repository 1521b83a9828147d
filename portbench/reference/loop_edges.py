"""The plain reference of the SLAM path's front-end pieces: a stereo frame
with RANSAC's refit, and a batch of loop edges.

Built from `reference/frontend.py`'s stages (corners, descriptors, Hamming
top-2 and its gates, the rectified closed form, Horn's alignment), with two
additions the SLAM path needs:

- `ransac(..., refit=True)`: after the winning hypothesis, Horn's alignment
  again over all of its inliers, kept only where it loses no inlier (the
  reference C++ ships the refit off, ref src/params.h:18; the SLAM drive's
  settings turn it on);
- `edges`: a loop edge (src, dst) as the reference C++ measures it
  (MatchPoints + CalcTransformation, ref pose_graph_optimizer.cpp:189,229):
  dst's stored descriptors matched against src's, both frames' stored ideal
  observations triangulated again by the closed form (z < 100 m), and RANSAC
  fitting X_dst = T X_src over the pairs valid on both sides, with no refit.
  The reference C++ measures the edges one by one; here the edges come one
  by one too, each from its own keys. Without the refit the winner's pose
  jumps where rounding moves an error across the inlier threshold or two
  order keys into one float32 value, so an edge also carries every answer
  the rule gives under errors moved by 1e-3 px (`tied`).

Imports nothing of the program. `low` computes the control, one precision
step below (bfloat16 triangulation, Horn's products in TF32), as
`reference/frontend.py` does.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference import frontend as ref_fe

# The loop edges' triangulation gate (the program's default max_depth).
EDGE_MAX_DEPTH = 100.0
# How far (px) a reprojection error may move by rounding: the judge's
# pixel tolerance (`reference.judge.PX`).
BAND_PX = 1e-3


def _hypotheses(keys, pts_curr, pts_prev, valid):
    """The K hypotheses of the keys [K, N]: Horn on each Gumbel top-3
    minimal set of the valid pairs ([K, 4, 4]), and whether the set spans a
    triangle (the degeneracy guard)."""
    g = torch.where(valid[None, :], keys, -torch.inf)
    sets = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :3]
    src, dst = pts_curr[sets], pts_prev[sets]
    areas = torch.linalg.vector_norm(
        torch.linalg.cross(src[:, 1] - src[:, 0], src[:, 2] - src[:, 0]), dim=-1)
    return ref_fe.horn(src, dst), areas > 1e-6


def _errors(T, pts_curr, obs_prev, P_l, P_r):
    """The max-abs stereo reprojection error [..., N] of each pair under T
    [..., 4, 4]."""
    Xp = ref_fe._transform(T, pts_curr)
    ph = torch.cat([Xp, torch.ones_like(Xp[..., :1])], dim=-1)
    uvw_l, uvw_r = ph @ P_l.T, ph @ P_r.T
    wl = torch.where(torch.abs(uvw_l[..., 2:3]) < 1e-9, 1e-9, uvw_l[..., 2:3])
    wr = torch.where(torch.abs(uvw_r[..., 2:3]) < 1e-9, 1e-9, uvw_r[..., 2:3])
    res = torch.cat([uvw_l[..., :2] / wl, uvw_r[..., :2] / wr], dim=-1) - obs_prev
    return torch.amax(torch.abs(res), dim=-1)


def _rank(err, valid, threshold):
    """Inlier counts, truncated losses and inlier masks of errors [..., N]."""
    inl = (err < threshold) & valid
    loss = torch.where(valid, torch.clamp(err, max=threshold), 0.0)
    return torch.sum(inl.to(torch.int32), dim=-1), torch.sum(loss, dim=-1), inl


def ransac(keys, pts_curr, pts_prev, obs_prev, valid, P_l, P_r, threshold, min_pairs,
           min_inliers, refit=False):
    """RANSAC as `reference.frontend.ransac` (Gumbel top-3 minimal sets,
    Horn, the most inliers by max-abs stereo reprojection error, ties to the
    smaller truncated loss), and with `refit` Horn again on the winner's
    inliers, kept where it counts at least as many. Returns (T [4, 4] with
    X_prev = T X_curr, the inlier mask [N], success)."""
    Ts, nondegenerate = _hypotheses(keys, pts_curr, pts_prev, valid)
    counts, losses, inls = _rank(_errors(Ts, pts_curr, obs_prev, P_l, P_r), valid, threshold)
    counts = torch.where(nondegenerate, counts, -1)
    best = int(torch.argmax(counts.to(torch.float32) - 1e-6 * losses))
    T, mask, num = Ts[best], inls[best], int(counts[best])
    if refit:
        T_r = ref_fe.horn(pts_curr, pts_prev, mask.to(torch.float32))
        cnt_r, _, inl_r = _rank(_errors(T_r, pts_curr, obs_prev, P_l, P_r), valid, threshold)
        if int(cnt_r) >= num:
            T, mask, num = T_r, inl_r, int(cnt_r)
    success = int(valid.sum()) >= min_pairs and num >= min_inliers
    if not success:
        return torch.eye(4, dtype=T.dtype, device=T.device), torch.zeros_like(mask), False
    return T, mask, True


def tied(keys, pts_curr, pts_prev, obs_prev, valid, P_l, P_r, threshold, min_pairs,
         min_inliers, band=BAND_PX):
    """Every answer (T, inlier mask, success) that `ransac` without refit
    gives when each pair's error may move by up to `band` px, the rounding
    by which two float32 solves of the same hypothesis differ.

    The rule's winner is not continuous in its inputs: an error within
    `band` of the threshold is an inlier on one side and not on the other,
    and the order key (count - 1e-6 loss, in float32) cannot tell losses
    apart that differ by less than its spacing, where the first hypothesis
    wins. A hypothesis is kept where its key, with the errors within `band`
    of the threshold counted in and its loss lowered by `band` a valid pair,
    reaches the largest key of any hypothesis with them counted out and its
    loss raised as much; rounding is monotone, so `ransac`'s own winner is
    always kept. A kept hypothesis whose count can fall either side of
    `min_inliers` admits the failure (identity, no inliers) too."""
    Ts, nondegenerate = _hypotheses(keys, pts_curr, pts_prev, valid)
    err = _errors(Ts, pts_curr, obs_prev, P_l, P_r)
    _, loss, inls = _rank(err, valid, threshold)
    hi = torch.where(nondegenerate, _rank(err, valid, threshold + band)[0], -1)
    lo = torch.where(nondegenerate, _rank(err, valid, threshold - band)[0], -1)
    slack = band * valid.sum()
    key_hi = hi.to(torch.float32) - 1e-6 * (loss - slack)
    key_lo = lo.to(torch.float32) - 1e-6 * (loss + slack)
    enough = int(valid.sum()) >= min_pairs
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    out = []
    for h in torch.nonzero(key_hi >= key_lo.max())[:, 0].tolist():
        if enough and int(hi[h]) >= min_inliers:
            out.append((Ts[h], inls[h], True))
        if not (enough and int(lo[h]) >= min_inliers):
            out.append((eye, torch.zeros_like(inls[h]), False))
    return out


def frame(img_l, img_r, prev, keys, rig: ref_fe.Rig, fe: dict, rc: dict, table, low=False):
    """`reference.frontend.frame` with RANSAC's refit when the
    configuration's `ransac` asks for it (`final_model_fitting`); the same
    dict out. The rectified rig only (the SLAM path's)."""
    dt = torch.bfloat16 if low else torch.float32
    sides = []
    for img in (img_l, img_r):
        xy, v = ref_fe.detect(img.to(dt), fe["num_features"], fe["quality_level"],
                              fe["block_size"], fe["min_distance"])
        sides.append((xy, v, ref_fe.describe(img.to(dt), xy, v, table, fe["smoothing_ksize"],
                                             low)))
    (kp_l, v_l, d_l), (xy_r, v_r, d_r) = sides
    r_idx, s_ok = ref_fe.gate(ref_fe.top2(d_l, d_r, v_r), v_l, fe["match_max_distance"],
                              fe["match_ratio"])
    kp_r = xy_r[r_idx]
    pts, tri_ok = ref_fe.triangulate_rectified(kp_l, kp_r, rig.fx, rig.cx, rig.cy, rig.cx,
                                               rig.baseline, rig.max_depth, low)
    valid = v_l & s_ok & tri_ok & (torch.abs(pts[:, 2]) < rig.max_depth)
    pts = torch.where(valid[:, None], pts, 0.0)
    num_stereo = int(valid.sum())
    prev_idx, t_ok = ref_fe.gate(ref_fe.top2(d_l, prev["desc"], prev["valid"]), valid,
                                 fe["match_max_distance"], fe["match_ratio"])
    pi = prev_idx.long()
    obs_prev = torch.cat([prev["kp_l"], prev["kp_r"]], dim=-1)[pi]
    with _tf32(low):
        T, inl, success = ransac(keys, pts, prev["pts"][pi], obs_prev, t_ok, rig.P_l, rig.P_r,
                                 rc["inlier_threshold_px"], rc["min_pairs"],
                                 rc["min_inliers"], rc.get("final_model_fitting", False))
    if num_stereo < fe["min_stereo_matches"]:
        T, success = torch.eye(4, device=T.device), False
    return {"kp_l": kp_l, "kp_r": kp_r, "desc": d_l, "pts": pts, "valid": valid,
            "prev_idx": prev_idx, "t_ok": t_ok, "tracked": inl & t_ok, "T": T,
            "success": success, "num_stereo": num_stereo}


def edge_keys(edge: int, num_hypotheses: int, n: int, device):
    """[K, n] Gumbel keys of the loop matcher's edge `edge` (edges counted in
    measurement order over a drive): the stream that
    `reference.frontend.frame_seed` gives the matcher's seed (1234) and an
    offset of 0x5851F42D before the edge's count."""
    return ref_fe.gumbel_keys(1234, 0x5851F42D + edge, num_hypotheses, n, device)


def edges(src_banks, dst_banks, keys, rig: ref_fe.Rig, fe: dict, rc: dict, low=False):
    """The loop edges e = 0.. of the banks (desc [E, N, 8] int32, validity
    [E, N], ideal observations [E, N, 4]) of their src and dst frames, each
    with its keys [E][K, N]. Returns a list of dicts: idx (dst slot -> src
    slot), ok (the match passes its gates), inliers, T (X_dst = T X_src),
    success, answers (every (T, inliers, success) the rule gives under
    rounding, `tied`; the first is the edge's own), and the src frame's
    triangulated points and their validity."""
    out = []
    for e in range(len(keys)):
        d_s, v_s, uv_s = (b[e] for b in src_banks)
        d_d, v_d, uv_d = (b[e] for b in dst_banks)
        idx, ok = ref_fe.gate(ref_fe.top2(d_d, d_s, v_s), v_d, fe["match_max_distance"],
                              fe["match_ratio"])
        uv_s_m = uv_s[idx]
        pts_d, tv_d = ref_fe.triangulate_rectified(uv_d[:, :2], uv_d[:, 2:], rig.fx, rig.cx,
                                                   rig.cy, rig.cx, rig.baseline,
                                                   EDGE_MAX_DEPTH, low)
        pts_s, tv_s = ref_fe.triangulate_rectified(uv_s_m[:, :2], uv_s_m[:, 2:], rig.fx,
                                                   rig.cx, rig.cy, rig.cx, rig.baseline,
                                                   EDGE_MAX_DEPTH, low)
        args = (keys[e], pts_s, pts_d, uv_d, ok & tv_d & tv_s, rig.P_l, rig.P_r,
                rc["inlier_threshold_px"], rc["min_pairs"], rc["min_inliers"])
        with _tf32(low):
            T, inl, success = ransac(*args)
            answers = [(T, inl, success)] + tied(*args)
        own, own_ok = ref_fe.triangulate_rectified(uv_s[:, :2], uv_s[:, 2:], rig.fx, rig.cx,
                                                   rig.cy, rig.cx, rig.baseline,
                                                   EDGE_MAX_DEPTH, low)
        out.append({"idx": idx, "ok": ok, "inliers": inl, "T": T, "success": success,
                    "answers": answers, "pts": own, "valid": own_ok & v_s})
    return out


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old

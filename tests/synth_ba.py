"""A seeded bundle-adjustment problem for the PyTorch port, and a probe of
its first LM step, without JAX.

`tests/test_torch_ba_oracles.py` and `chip_smoke.py` both use them, on the
CPU and on the card.
"""

import numpy as np
import torch

from stereo_orb_slam_torch.backend import ba, schur_dense


def banded_problem(rng, C=64, P=8192, device="cpu"):
    """tests/test_ba.py::test_banded_schur_matches_dense's problem: C
    cameras, P points on tracks of 1-6 consecutive cameras (point ids in
    camera order, so the band plan is feasible), 0.5 px noise, drawn from
    `rng`. Returns the BAProblem, its host slot maps and its band plan."""
    fx, cx, cy, b = 240.0, 160.0, 120.0, 0.6
    P_l = np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0]], np.float32)
    P_r = P_l.copy()
    P_r[0, 3] = -fx * b
    pts = np.stack([rng.uniform(-10, 10, P), rng.uniform(-4, 4, P),
                    rng.uniform(4, 30, P)], 1).astype(np.float32)
    pose6 = rng.normal(0, 0.005, (C, 6)).astype(np.float32)
    c0 = (np.arange(P, dtype=np.int64) * C // P).astype(np.int32)
    tlen = np.minimum(rng.integers(1, 7, P), C - c0)
    obs_point = np.repeat(np.arange(P, dtype=np.int32), tlen)
    offs = np.concatenate([np.arange(t) for t in tlen]).astype(np.int32)
    obs_cam = (np.repeat(c0, tlen) + offs).astype(np.int32)
    O = len(obs_point)
    Xh = np.concatenate([pts[obs_point], np.ones((O, 1), np.float32)], 1)

    def proj(Pm):
        uvw = Xh @ Pm.T
        return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)

    obs_uv = np.concatenate([proj(P_l), proj(P_r)], 1).astype(np.float32)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape).astype(np.float32)
    cam_mask = np.ones(C, np.float32)
    cam_mask[0] = 0.0

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    prob = ba.BAProblem(t(pose6), t(pts), t(obs_cam, torch.long), t(obs_point, torch.long),
                        t(obs_uv), torch.ones(O, device=device), t(cam_mask),
                        torch.ones(P, device=device), t(P_l), t(P_r))
    sto, scam, smask, K = schur_dense.group_slots(obs_point, obs_cam, P, O)
    slots = (t(sto, torch.long), t(scam, torch.long), t(smask))
    return prob, slots, schur_dense.band_plan(obs_point, obs_cam, P, O, C, K)


def first_step(prob, cfg, dense_K=None, cam_K=None, band_bases=None, band_B=None,
               band_Pc=None):
    """The camera blocks and gradient of the normal equations at the start
    (H_cc, b_c) and the first proposed LM step (the pose6 change at the
    initial lambda, accepted or not), on the path `ba.ba_solve` takes with
    the same arguments."""
    slots = None if dense_K is None else ba.build_slots_device(
        prob.obs_point, prob.obs_cam, prob.obs_weight, prob.points.shape[0], dense_K)
    cam_red = ba._cam_reduction(prob, slots, cam_K)
    c = ba.lm_init(prob, cfg, slots, cam_red)
    pose6, _ = ba.full_f32(ba._solve_lm)(
        prob, c.H_cc, c.H_pp, c.W, c.b_c, c.b_p, c.lam, cfg, slots, cam_red, c.Wg,
        ba._band(band_bases, band_B, band_Pc))
    return {"H_cc": c.H_cc, "b_c": c.b_c, "step": pose6 - prob.pose6}

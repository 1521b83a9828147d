"""The plain reference of a window bundle adjustment, in float64.

The problem of the reference C++ (ref src/bundle_adjuster.cpp:39-133): a
camera per frame of the window as a world-to-camera pose6 [w, t] (angle-axis
and translation, ref src/math_utils.h:13-25), the first camera held
constant (ref :113), a 3-vector per landmark, and per observation the stereo
reprojection residual of ref src/reprojection_error.h:12-41,

    r = [P_l X_c, P_r X_c] (dehomogenised) - [u_l, v_l, u_r, v_r],
    X_c = exp(w) X + t,

robustified by Huber's loss of width 1 (ref :100): the cost is
0.5 sum rho(|r|^2), rho(s) = s below 1 and 2 sqrt(s) - 1 above, and a step
weighs an observation's residual and Jacobian by sqrt(min(1, 1 / |r|))
(iteratively reweighted least squares). Landmarks stay in a box of
+-10,000 m (ref src/params.h:44-47).

Levenberg-Marquardt with Marquardt's scaling: the step solves (H + lambda
diag(H) + 1e-8 I) d = -g, with the landmarks eliminated (Schur complement
on the cameras, assembled densely, each 3 x 3 landmark block inverted) and
the cameras' system factored by Cholesky; lambda starts at 1e-4, halves on a
step that lowers the cost, quadruples on one that does not (kept within
[1e-10, 1e8]); the solve stops after a step that lowers the cost by less
than 1e-9 of it, or after the iteration budget. Jacobians come from
forward-mode differentiation of the residual, one observation at a time.

Departures from the reference C++, and why: Ceres's trust region (its own
radius rule, its iterative Schur solver and its 1 s budget) is replaced by
the plain schedule above, the one the program runs, so that a solve of the
same problem for the same number of iterations is comparable.

`dtype=torch.float32` computes the control: the same solve in float32.
Imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def rotation(w):
    """Rodrigues' formula of angle-axis vectors [..., 3] (Taylor near 0)."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    small = theta2 < 1e-8
    t = torch.sqrt(torch.where(small, 1.0, theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / torch.where(small, 1.0,
                                                                                   theta2))
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                     torch.stack([w[..., 2], z, -w[..., 0]], -1),
                     torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def residual(pose6, point, uv, P_l, P_r):
    """The 4 stereo reprojection residuals of one observation."""
    Xc = rotation(pose6[:3]) @ point + pose6[3:]
    Xh = torch.cat([Xc, torch.ones_like(Xc[:1])])
    pl, pr = P_l @ Xh, P_r @ Xh
    return torch.cat([pl[:2] / pl[2:], pr[:2] / pr[2:]]) - uv


def _linearise(pose6, points, cam, pt, uv, P_l, P_r, huber):
    """Weighted residuals [O, 4], Jacobians [O, 4, 6] and [O, 4, 3], and
    the robust cost."""
    args = (pose6[cam], points[pt], uv)
    r = vmap(residual, in_dims=(0, 0, 0, None, None))(*args, P_l, P_r)
    Jc, Jp = vmap(jacfwd(residual, argnums=(0, 1)), in_dims=(0, 0, 0, None, None))(
        *args, P_l, P_r)
    s = (r * r).sum(-1)
    root = torch.sqrt(torch.clamp(s, min=1e-30))
    cost = 0.5 * torch.where(s <= huber * huber, s, 2.0 * huber * root - huber * huber).sum()
    w = torch.sqrt(torch.where(s <= huber * huber, 1.0, huber / root))[:, None]
    return r * w, Jc * w[..., None], Jp * w[..., None], cost


def cost_of(pose6, points, cam, pt, uv, P_l, P_r, huber):
    r = vmap(residual, in_dims=(0, 0, 0, None, None))(pose6[cam], points[pt], uv, P_l, P_r)
    s = (r * r).sum(-1)
    root = torch.sqrt(torch.clamp(s, min=1e-30))
    return 0.5 * torch.where(s <= huber * huber, s, 2.0 * huber * root - huber * huber).sum()


def _step(pose6, points, cam, pt, uv, P_l, P_r, free, lam, cfg):
    """The damped step (d_cam [C, 6], d_point [P, 3]) at lambda, and the
    cost at the linearisation point. None where the factorisation fails."""
    C, P = pose6.shape[0], points.shape[0]
    r, Jc, Jp, cost = _linearise(pose6, points, cam, pt, uv, P_l, P_r, cfg["huber_delta"])
    dt, dev = pose6.dtype, pose6.device
    Hcc = torch.zeros((C, 6, 6), dtype=dt, device=dev).index_add_(
        0, cam, Jc.transpose(1, 2) @ Jc)
    Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
        0, pt, Jp.transpose(1, 2) @ Jp)
    gc = torch.zeros((C, 6), dtype=dt, device=dev).index_add_(
        0, cam, (Jc.transpose(1, 2) @ r[..., None])[..., 0])
    gp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
        0, pt, (Jp.transpose(1, 2) @ r[..., None])[..., 0])

    def damp(H):
        return H + torch.diag_embed(lam * torch.diagonal(H, dim1=-2, dim2=-1) + 1e-8)

    Hcc, Hpp_inv = damp(Hcc), torch.linalg.inv(damp(Hpp))
    # The camera-landmark block W [6C, 3P] dense, and the Schur complement
    # on the cameras S = Hcc - W Hpp^-1 W^T.
    rows = (cam[:, None] * 6 + torch.arange(6, device=dev))[:, :, None].expand(-1, -1, 3)
    cols = (pt[:, None] * 3 + torch.arange(3, device=dev))[:, None, :].expand(-1, 6, -1)
    W = torch.zeros((6 * C, 3 * P), dtype=dt, device=dev).index_put_(
        (rows, cols), Jc.transpose(1, 2) @ Jp, accumulate=True)
    WHi = (W.view(6 * C, P, 3)[:, :, None, :] @ Hpp_inv[None]).view(6 * C, 3 * P)
    S = torch.block_diag(*Hcc) - WHi @ W.T
    rhs = (-gc).reshape(-1) - WHi @ (-gp).reshape(-1)
    held = torch.nonzero(~free)[:, 0]
    rows = (held[:, None] * 6 + torch.arange(6, device=dev)).reshape(-1)
    S[rows] = 0.0
    S[:, rows] = 0.0
    S[rows, rows] = 1.0
    rhs[rows] = 0.0
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        return None, None, cost
    dc = torch.cholesky_solve(rhs[:, None], L).view(C, 6) * free[:, None]
    z = (W.T @ dc.reshape(-1)).view(P, 3)
    dp = (Hpp_inv @ (-gp - z)[..., None])[..., 0]
    return dc, dp, cost


def solve(pose6, points, obs_cam, obs_point, obs_uv, P_l, P_r, iterations, cfg: dict,
          free=None, dtype=torch.float64):
    """Up to `iterations` LM iterations of the window (see the module's
    docstring); `cfg` holds huber_delta, lm_lambda_init, lm_lambda_up,
    lm_lambda_down, lm_lambda_min, lm_lambda_max, function_tolerance and
    point_bound; `free` [C] marks the cameras that move (default: all but
    the first). Returns (pose6, points, iterations run, initial cost, final
    cost)."""
    def f(x):
        return torch.as_tensor(x).to(dtype)

    pose6, points, uv, P_l, P_r = f(pose6), f(points), f(obs_uv), f(P_l), f(P_r)
    dev = pose6.device
    cam = torch.as_tensor(obs_cam, device=dev).long()
    pt = torch.as_tensor(obs_point, device=dev).long()
    if free is None:
        free = torch.ones(pose6.shape[0], dtype=torch.bool, device=dev)
        free[0] = False
    free = torch.as_tensor(free, device=dev).bool()
    lam = cfg["lm_lambda_init"]
    cost = cost0 = float(cost_of(pose6, points, cam, pt, uv, P_l, P_r, cfg["huber_delta"]))
    ran = 0
    for _ in range(iterations):
        ran += 1
        dc, dp, _ = _step(pose6, points, cam, pt, uv, P_l, P_r, free, lam, cfg)
        accepted = False
        if dc is not None:
            pose_t = pose6 + dc
            pts_t = torch.clamp(points + dp, -cfg["point_bound"], cfg["point_bound"])
            cost_t = float(cost_of(pose_t, pts_t, cam, pt, uv, P_l, P_r, cfg["huber_delta"]))
            accepted = cost_t < cost
        if accepted:
            done = cost > 0 and (cost - cost_t) < cfg["function_tolerance"] * cost
            pose6, points, cost = pose_t, pts_t, cost_t
            lam = max(lam * cfg["lm_lambda_down"], cfg["lm_lambda_min"])
            if done:
                break
        else:
            lam = min(lam * cfg["lm_lambda_up"], cfg["lm_lambda_max"])
    return pose6, points, ran, cost0, cost

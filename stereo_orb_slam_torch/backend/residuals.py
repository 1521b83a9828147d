"""Stereo reprojection residual + Jacobians for bundle adjustment.

PyTorch counterpart of the JAX package's `backend/residuals.py`. The cost is
the reference's Ceres functor (ref `src/reprojection_error.h:12-41`): a
6-dof camera (world->camera as angle-axis + translation, the `MatrixToPose`
parameterization of ref `src/math_utils.h:13-25`) and a 3-dof world point
produce a 4-vector residual

    [u_l_hat - u_l, v_l_hat - v_l, u_r_hat - u_r, v_r_hat - v_r]

by rotating the point into the rig frame and projecting through the static
3x4 left/right projection matrices (explicit arguments here).

Every function is batched over leading dimensions: where the JAX package
vmaps `residual_one`, the port calls it on the whole batch. The small
per-observation matrix products are broadcast multiplies summed over the
inner axis (`bmm`, `bmv`), not `@`: on CUDA, `@` over [O] tiny matrices
becomes a cuBLAS batched GEMM, slow at this shape and rounded by TF32
when that is on. Robustification is IRLS-style Huber whitening (sqrt of
the Ceres Huber rho'), matching HuberLoss(1.0) at ref
`src/bundle_adjuster.cpp:100`.
"""

from __future__ import annotations

import torch

from stereo_orb_slam_torch.geometry import se3


def bmm(A, B):
    """Batched small-matrix product [..., i, k] x [..., k, j] -> [..., i, j]
    as a broadcast multiply and a sum over k."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def bmv(A, x):
    """Batched small matrix-vector product [..., i, k] x [..., k] -> [..., i]
    as a broadcast multiply and a sum over k. (As an einsum it becomes a
    batched cuBLAS GEMV of [O] tiny matrices, which took 19 of the 25 ms of
    device time of a matrix-free LM iteration at map size on the H100.)"""
    return (A * x[..., None, :]).sum(dim=-1)


def _so3_exp(w):
    """se3.so3_exp (Rodrigues, Taylor-guarded near 0) with K^2 by `bmm`."""
    _, _, a, b = se3._sin_cos_terms(w)
    K = se3.hat(w)
    return se3._eye3_like(K) + a * K + b * bmm(K, K)


def project_rig(P, X_rig):
    """[3,4] @ homogeneous point -> pixel (u, v). X_rig: [..., 3]."""
    Xh = torch.cat([X_rig, torch.ones_like(X_rig[..., :1])], dim=-1)
    uvw = bmv(P, Xh)
    w = uvw[..., 2:3]
    safe_w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    return uvw[..., :2] / safe_w


def residual_one(pose6, point, uv4, P_l, P_r):
    """4-vector stereo reprojection residual, batched over leading dims of
    pose6 [...,6], point [...,3] and uv4 [...,4]."""
    R = _so3_exp(pose6[..., :3])
    X_rig = bmv(R, point) + pose6[..., 3:]
    pred_l = project_rig(P_l, X_rig)
    pred_r = project_rig(P_r, X_rig)
    return torch.cat([pred_l, pred_r], dim=-1) - uv4


def right_jacobian_so3(w):
    """Right Jacobian Jr(w) of SO(3): exp(w + d) ~ exp(w) exp(Jr(w) d).

    Batched over leading dims; Taylor-guarded at theta -> 0.
    """
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-16))
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = se3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye - a * K + b * bmm(K, K)


def jacobians_closed(pose6, point, P_l, P_r):
    """Closed-form (J_c [...,4,6], J_p [...,4,3]).

    Derivation: r = proj(Y) - uv with Y = R(w) X + t.
      dY/dt = I;  dY/dX = R;
      dY/dw = -R [X]x Jr(w)      (global angle-axis parameterization)
      dproj/dY rows: (P_row0[:3] - u * P_row2[:3]) / s  etc.
    Batched over leading dims of pose6/point.
    """
    w = pose6[..., :3]
    t = pose6[..., 3:]
    R = _so3_exp(w)
    Y = bmv(R, point) + t

    def proj_jac(P):
        Yh = torch.cat([Y, torch.ones_like(Y[..., :1])], dim=-1)
        uvw = bmv(P, Yh)
        s = uvw[..., 2]
        safe_s = torch.where(torch.abs(s) < 1e-9, 1e-9, s)
        u = uvw[..., 0] / safe_s
        v = uvw[..., 1] / safe_s
        du = (P[0, :3] - u[..., None] * P[2, :3]) / safe_s[..., None]
        dv = (P[1, :3] - v[..., None] * P[2, :3]) / safe_s[..., None]
        return torch.stack([du, dv], dim=-2)  # [...,2,3]

    J_proj = torch.cat([proj_jac(P_l), proj_jac(P_r)], dim=-2)  # [...,4,3]

    Jr = right_jacobian_so3(w)
    dY_dw = -bmm(bmm(R, se3.hat(point)), Jr)    # [...,3,3]
    J_w = bmm(J_proj, dY_dw)                    # [...,4,3]
    J_c = torch.cat([J_w, J_proj], dim=-1)      # [...,4,6]; dY/dt = I
    J_p = bmm(J_proj, R)                        # [...,4,3]
    return J_c, J_p


def _huber(r, obs_weight, huber_delta: float):
    """(Huber weights hw, Ceres robust cost 0.5 * sum(rho(|r|^2) * w))."""
    s = torch.sum(r * r, dim=-1)
    d2 = huber_delta * huber_delta
    # Ceres Huber: rho(s) = s (s<=d2) else 2*d*sqrt(s) - d2; rho' = min(1, d/sqrt(s))
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-18))
    hw = torch.where(s <= d2, 1.0, huber_delta / sqrt_s)
    rho = torch.where(s <= d2, s, 2.0 * huber_delta * sqrt_s - d2)
    return hw, 0.5 * torch.sum(rho * obs_weight)


def residuals_and_jacobians_gathered(p6, pt, obs_uv, obs_weight, P_l, P_r,
                                     huber_delta: float):
    """Whitened (r [...,4], J_c [...,4,6], J_p [...,4,3], cost) on
    PRE-GATHERED per-observation poses and points (any leading shape)."""
    r = residual_one(p6, pt, obs_uv, P_l, P_r)
    J_c, J_p = jacobians_closed(p6, pt, P_l, P_r)
    hw, cost = _huber(r, obs_weight, huber_delta)
    wscale = (torch.sqrt(hw) * obs_weight)[..., None]
    return r * wscale, J_c * wscale[..., None], J_p * wscale[..., None], cost


def residuals_and_jacobians(pose6_all, points_all, obs_cam, obs_point, obs_uv,
                            obs_weight, P_l, P_r, huber_delta: float):
    """Whitened residuals + Jacobians for a batch of observations.

    Args: pose6_all [C,6] world->camera poses, points_all [P,3], obs_cam /
    obs_point [O] indices, obs_uv [O,4], obs_weight [O] (0 for padding).
    Returns (r [O,4], J_c [O,4,6], J_p [O,4,3], cost) where r/J are scaled
    by sqrt(huber_weight) * obs_weight and cost is the Ceres-style robust
    total 0.5 * sum(rho(||r||^2)).
    """
    return residuals_and_jacobians_gathered(
        pose6_all[obs_cam], points_all[obs_point], obs_uv, obs_weight, P_l,
        P_r, huber_delta,
    )


def build_rows_soa(p6, pt, obs_uv, obs_weight, P_l, P_r, huber_delta: float):
    """Whitened normal-equation rows of every observation.

    The JAX package's function of this name unrolls the same math over
    scalar components (which keeps XLA's fusion whole). In eager PyTorch
    every such term would be its own launch, so here the rows come from
    the batched residuals and Jacobians (residuals_and_jacobians_gathered)
    and one broadcast product: with A = [J_c | J_p | r] per observation
    ([O,4,10]), M = A^T A ([O,10,10]) holds every block at once.

    Args are PRE-GATHERED per observation: p6 [O,6], pt [O,3], obs_uv
    [O,4], obs_weight [O]. P_l/P_r are [3,4].

    Returns (cam_rows [O,42], pt_rows [O,12], W [O,6,3], cost):
      cam_rows = [JcT_Jc (36, row-major), JcT_r (6)]
      pt_rows  = [JpT_Jp (9, row-major), -JpT_r (3)]
    all scaled by the Huber IRLS weights exactly like the reference's
    Ceres setup (ref src/bundle_adjuster.cpp:100, HuberLoss(1.0)).
    """
    r, J_c, J_p, cost = residuals_and_jacobians_gathered(p6, pt, obs_uv, obs_weight,
                                                         P_l, P_r, huber_delta)
    A = torch.cat([J_c, J_p, r[..., None]], dim=-1)                # [O,4,10]
    M = (A[..., :, None] * A[..., None, :]).sum(dim=-3)            # [O,10,10]
    O = p6.shape[0]
    cam_rows = torch.cat([M[:, :6, :6].reshape(O, 36), M[:, :6, 9]], dim=1)
    pt_rows = torch.cat([M[:, 6:9, 6:9].reshape(O, 9), -M[:, 6:9, 9]], dim=1)
    return cam_rows, pt_rows, M[:, :6, 6:9].contiguous(), cost


def robust_cost_gathered(p6, pt, obs_uv, obs_weight, P_l, P_r, huber_delta: float):
    """Cost only, on pre-gathered per-observation poses/points."""
    r = residual_one(p6, pt, obs_uv, P_l, P_r)
    return _huber(r, obs_weight, huber_delta)[1]


def robust_cost(pose6_all, points_all, obs_cam, obs_point, obs_uv, obs_weight,
                P_l, P_r, huber_delta: float):
    """Cost only (no Jacobians) for LM accept/reject evaluation."""
    return robust_cost_gathered(pose6_all[obs_cam], points_all[obs_point], obs_uv,
                                obs_weight, P_l, P_r, huber_delta)

"""Trajectory evaluation: ATE and RPE against ground truth.

A copy of the JAX package's `utils/evaluate.py`.

The benchmark harness for BASELINE.json's KITTI metrics. The reference ships
no evaluator (validation was visual, SURVEY.md §4); this implements the
standard definitions:

- ATE: RMSE of translational error after SE(3) (optionally Sim(3)) Umeyama
  alignment of the estimated trajectory to ground truth.
- RPE: relative pose error over a fixed frame delta.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=False):
    """Least-squares rigid (or similarity) transform aligning src to dst.

    src, dst: [N,3]. Returns (R, t, s) with dst ≈ s R src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (sc ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align=True) -> float:
    """Absolute trajectory error (RMSE, meters). Poses: [N,4,4] or [N,3,4]."""
    p_est = np.asarray(est_poses)[:, :3, 3]
    p_gt = np.asarray(gt_poses)[:, :3, 3]
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over `delta` frames.

    Returns (trans_rmse [m], rot_rmse [rad]).
    """
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = min(len(est), len(gt))
    t_errs, r_errs = [], []
    for i in range(n - delta):
        d_est = np.linalg.inv(_to44(est[i])) @ _to44(est[i + delta])
        d_gt = np.linalg.inv(_to44(gt[i])) @ _to44(gt[i + delta])
        e = np.linalg.inv(d_gt) @ d_est
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )


def _to44(T):
    if T.shape == (4, 4):
        return T
    out = np.eye(4, dtype=T.dtype)
    out[:3, :4] = T
    return out


def load_kitti_gt(path: str) -> np.ndarray:
    """KITTI ground-truth poses file: 12 floats per line (3x4)."""
    rows = np.loadtxt(path, dtype=np.float64)
    return rows.reshape(-1, 3, 4)

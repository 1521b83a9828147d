"""Pure-NumPy mirrors of the host-facing SE(3) conversions.

A copy of the JAX package's `geometry/se3_np.py` (NumPy only), kept in the
port so that the port imports nothing of the JAX package. The world map and
the solvers' host code are NumPy: the pose6 <-> matrix conversions of
`backend.ba.prepare_problem_arrays` and of the BA writeback take
microseconds here and would cost a device round trip as tensor ops. These
mirror geometry/se3.py's conventions exactly (ref src/math_utils.h:13-41:
rotation as angle-axis, translation copied verbatim — NOT the SE(3)
exponential).
"""

from __future__ import annotations

import numpy as np


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """[...,3,3] -> quaternion (w,x,y,z), w >= 0. Batched, Shepperd-style."""
    R = np.asarray(R, np.float64)
    m = R.reshape(-1, 3, 3)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    cand = np.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], 1)
    best = np.argmax(cand, axis=1)
    s = 0.5 * np.sqrt(np.maximum(cand[np.arange(len(m)), best], 1e-12))
    q = np.empty((len(m), 4))
    for i, (b, si) in enumerate(zip(best, s)):
        if b == 0:
            q[i] = (si, (m21[i] - m12[i]) / (4 * si),
                    (m02[i] - m20[i]) / (4 * si),
                    (m10[i] - m01[i]) / (4 * si))
        elif b == 1:
            q[i] = ((m21[i] - m12[i]) / (4 * si), si,
                    (m01[i] + m10[i]) / (4 * si),
                    (m02[i] + m20[i]) / (4 * si))
        elif b == 2:
            q[i] = ((m02[i] - m20[i]) / (4 * si),
                    (m01[i] + m10[i]) / (4 * si), si,
                    (m12[i] + m21[i]) / (4 * si))
        else:
            q[i] = ((m10[i] - m01[i]) / (4 * si),
                    (m02[i] + m20[i]) / (4 * si),
                    (m12[i] + m21[i]) / (4 * si), si)
    q *= np.where(q[:, :1] < 0, -1.0, 1.0)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.reshape(R.shape[:-2] + (4,))


def so3_log_np(R: np.ndarray) -> np.ndarray:
    """[...,3,3] -> angle-axis [...,3] via the quaternion (robust at 0, pi)."""
    q = rotmat_to_quat_np(R).reshape(-1, 4)
    w = np.clip(q[:, 0], -1.0, 1.0)
    v = q[:, 1:]
    vn = np.linalg.norm(v, axis=1)
    theta = 2.0 * np.arctan2(vn, w)
    scale = np.where(vn > 1e-12, theta / np.maximum(vn, 1e-12), 2.0)
    out = v * scale[:, None]
    return out.reshape(np.asarray(R).shape[:-2] + (3,)).astype(np.float32)


def so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Angle-axis [...,3] -> rotation matrix (Rodrigues), batched."""
    w = np.asarray(w, np.float64)
    flat = w.reshape(-1, 3)
    theta = np.linalg.norm(flat, axis=1)
    out = np.empty((len(flat), 3, 3))
    for i, (wi, th) in enumerate(zip(flat, theta)):
        if th < 1e-12:
            K = np.array([[0, -wi[2], wi[1]], [wi[2], 0, -wi[0]],
                          [-wi[1], wi[0], 0]])
            out[i] = np.eye(3) + K  # first-order
            continue
        a = wi / th
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        out[i] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    return out.reshape(w.shape[:-1] + (3, 3)).astype(np.float32)


def matrix_to_pose6_np(T: np.ndarray) -> np.ndarray:
    """[...,4,4] -> [w, t] with t copied verbatim (ref src/math_utils.h:13-25)."""
    T = np.asarray(T, np.float32)
    return np.concatenate(
        [so3_log_np(T[..., :3, :3]), T[..., :3, 3]], axis=-1
    ).astype(np.float32)


def pose6_to_matrix_np(pose: np.ndarray) -> np.ndarray:
    """[w, t] -> [...,4,4] with t copied verbatim (ref src/math_utils.h:28-41)."""
    pose = np.asarray(pose, np.float32)
    R = so3_exp_np(pose[..., :3])
    batch = pose.shape[:-1]
    T = np.zeros(batch + (4, 4), np.float32)
    T[..., :3, :3] = R
    T[..., :3, 3] = pose[..., 3:]
    T[..., 3, 3] = 1.0
    return T


def inverse_np(T: np.ndarray) -> np.ndarray:
    """Closed-form rigid-transform inverse, batched."""
    T = np.asarray(T, np.float32)
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out

"""SE(3) / SO(3) utilities on tensors, batched over leading dimensions.

PyTorch counterpart of the JAX package's `geometry/se3.py` (ref
`src/math_utils.h:6-41`): the same formulas in the same float32 operation
order, with the Taylor branches near theta = 0 selected by `torch.where`.

Convention: a pose matrix T maps homogeneous points from the "child" frame to
the "parent" frame. The 6-dof vector layout is [wx, wy, wz, tx, ty, tz].
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of a 3-vector. Batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _sin_cos_terms(w):
    """theta^2, sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks near 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # [...,1,1]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return theta2, small, a, b


def _eye3_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w):
    """Rodrigues: angle-axis (angle*axis) -> rotation matrix."""
    _, _, a, b = _sin_cos_terms(w)
    K = hat(w)
    return _eye3_like(K) + a * K + b * (K @ K)


def so3_log(R):
    """Rotation matrix -> angle-axis, through the quaternion (robust near pi)."""
    q = rotmat_to_quat(R)  # [..., 4] (w, x, y, z), w >= 0
    qw = torch.clamp(q[..., :1], -1.0, 1.0)[..., 0]  # clamped with its dim (see above)
    qv = q[..., 1:]
    norm_qv = torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(norm_qv[..., 0], qw)[..., None]
    small = norm_qv < _EPS
    scale = torch.where(
        small, 2.0 / torch.clamp(qw[..., None], min=_EPS),
        theta / torch.clamp(norm_qv, min=_EPS),
    )
    return scale * qv


def se3_exp(xi):
    """6-dof [w, t_v] -> 4x4 matrix, where t = V(w) @ t_v (true SE(3) exp)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2, small, a, b = _sin_cos_terms(w)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    K = hat(w)
    eye = _eye3_like(K)
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    t = (V @ v[..., None])[..., 0]
    return rt_to_matrix(R, t)


def se3_log(T):
    """4x4 matrix -> 6-dof [w, t_v] (true SE(3) log)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2, small, a, _ = _sin_cos_terms(w)
    K = hat(w)
    # V^-1 = I - K/2 + (1/theta^2)(1 - a/(2b)) K^2, with b = (1 - cos t)/t^2
    # taken as 2 sin^2(t/2)/t^2: in float32, cos t rounds to 1 for t up to
    # about 3.4e-4 (above the Taylor branch's 1e-4), and 1 - cos t = 0 made
    # the JAX package's coefficient -inf and v NaN there.
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = torch.sin(0.5 * theta)
    b = 2.0 * half * half / theta2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b)) / theta2)
    Vinv = _eye3_like(K) - 0.5 * K + coef * (K @ K)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def pose6_to_matrix(pose):
    """[w (angle*axis), t] -> 4x4 with t copied verbatim (ref math_utils.h:28-41)."""
    return rt_to_matrix(so3_exp(pose[..., :3]), pose[..., 3:])


def matrix_to_pose6(T):
    """4x4 -> [w, t] with t copied verbatim (ref src/math_utils.h:13-25)."""
    return torch.cat([so3_log(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def rt_to_matrix(R, t):
    """(3x3, 3) -> 4x4 homogeneous, batched. Built without writes in place,
    so it runs under torch.func transforms (the pose graph's jacfwd/vmap)."""
    top = torch.cat([R, t[..., None]], dim=-1)  # [..., 3, 4]
    # [0, 0, 0, 1] made on the device (a host tensor would be a copy and a sync).
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def inverse(T):
    """Closed-form inverse of a rigid transform, batched."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_matrix(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T, pts):
    """Apply 4x4 T to [..., N, 3] points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotmat_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0, batched.

    Branch-free Shepperd construction: all four candidates are computed and
    the best-conditioned one is selected (first maximum, as `argmax` picks).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # The clamps run on the stacked [..., 4] candidates: on a 0-d tensor,
    # clamp's forward-mode derivative comes out float64 (torch.func.jacfwd,
    # the pose graph's Jacobians).
    q2 = torch.clamp(torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                                  1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1),
                     min=0.0)
    qw2, qx2, qy2, qz2 = q2.unbind(-1)
    sw, sx, sy, sz = (0.5 * torch.sqrt(torch.clamp(q2, min=_EPS))).unbind(-1)

    qw_w = torch.stack([sw, (m21 - m12) / (4 * sw), (m02 - m20) / (4 * sw), (m10 - m01) / (4 * sw)], -1)
    qx_x = torch.stack([(m21 - m12) / (4 * sx), sx, (m01 + m10) / (4 * sx), (m02 + m20) / (4 * sx)], -1)
    qy_y = torch.stack([(m02 - m20) / (4 * sy), (m01 + m10) / (4 * sy), sy, (m12 + m21) / (4 * sy)], -1)
    qz_z = torch.stack([(m10 - m01) / (4 * sz), (m02 + m20) / (4 * sz), (m12 + m21) / (4 * sz), sz], -1)

    best = torch.argmax(q2, dim=-1)
    q = torch.where((best == 0)[..., None], qw_w,
        torch.where((best == 1)[..., None], qx_x,
        torch.where((best == 2)[..., None], qy_y, qz_z)))
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q):
    """Quaternion (w, x, y, z) -> rotation matrix, batched."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def normalize_pose(T):
    """Re-orthonormalize the rotation through a quaternion round trip
    (ref `src/math_utils.h:6-10`)."""
    R = quat_to_rotmat(rotmat_to_quat(T[..., :3, :3]))
    return rt_to_matrix(R, T[..., :3, 3])

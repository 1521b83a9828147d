"""Camera models: pinhole projection, distortion, stereo triangulation.

PyTorch counterpart of the JAX package's `geometry/camera.py` (ref
`src/camera_model.h:13-84`, `src/camera_model.cpp`). Camera parameters are
float32 tensors on one device, held in NamedTuples. The rectified path is
the closed-form disparity -> depth of ref `src/camera_model.cpp:155-228`,
with a validity mask in place of the reference's dropped points; the general
path is the DLT of ref `src/camera_model.cpp:123-152` through a batched SVD
(on the card the hand kernel of `ops/kernels/dlt.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_orb_slam_torch.geometry import se3
from stereo_orb_slam_torch.ops.kernels import dlt


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class Pinhole(NamedTuple):
    """One pinhole camera. All fields are float32 tensors on one device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor        # [5] = (k1, k2, p1, p2, k3)
    pose: torch.Tensor        # [4,4] camera-to-rig transform
    projection: torch.Tensor  # [3,4] = K @ [I|0] @ pose^-1

    @staticmethod
    def create(fx, fy, cx, cy, dist=None, pose=None, device="cuda") -> "Pinhole":
        dist = np.zeros(5, np.float32) if dist is None else np.asarray(dist, np.float32)
        pose = np.eye(4, dtype=np.float32) if pose is None else np.asarray(pose, np.float32)
        K34 = np.array(
            [[fx, 0.0, cx, 0.0], [0.0, fy, cy, 0.0], [0.0, 0.0, 1.0, 0.0]], np.float32
        )
        proj = K34 @ np.linalg.inv(pose)
        return Pinhole(
            fx=_f32(fx, device), fy=_f32(fy, device),
            cx=_f32(cx, device), cy=_f32(cy, device),
            dist=_f32(dist, device), pose=_f32(pose, device),
            projection=_f32(proj, device),
        )

    @property
    def K(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            -2,
        )


class StereoRig(NamedTuple):
    """A stereo pair; `rectified` (a Python bool) selects the closed-form
    triangulation path. `baseline` is a scalar tensor: the x-offset of the
    right camera in the left frame (the reference reads y at
    camera_model.cpp:175; x is used everywhere here, as in the JAX package)."""

    left: Pinhole
    right: Pinhole
    rectified: bool
    baseline: torch.Tensor

    @staticmethod
    def create(left: Pinhole, right: Pinhole, rectified: bool,
               baseline: float = None) -> "StereoRig":
        if baseline is None:
            pose_lr = se3.inverse(left.pose) @ right.pose
            b = torch.abs(pose_lr[0, 3])
        else:
            b = _f32(abs(float(baseline)), left.fx.device)
        return StereoRig(left=left, right=right, rectified=bool(rectified), baseline=b)

    @property
    def device(self) -> torch.device:
        return self.left.fx.device

    def max_sensible_distance(self):
        """fx * baseline: depth beyond which disparity < 1 px
        (ref `src/camera_model.cpp:111-121`)."""
        return self.left.fx * self.baseline


def stack_rigs(rigs) -> StereoRig:
    """S rigs as one, every tensor field with a leading sequence axis ([S]
    scalars, [S, 3, 4] projections). All must share the triangulation path
    (`rectified`) and one device."""
    rigs = list(rigs)
    flags = {r.rectified for r in rigs}
    if len(flags) != 1:
        raise ValueError("all rigs must share the triangulation path (rectified)")

    def stack(cams):
        return Pinhole(*(torch.stack(fs) for fs in zip(*cams)))

    return StereoRig(left=stack([r.left for r in rigs]), right=stack([r.right for r in rigs]),
                     rectified=flags.pop(), baseline=torch.stack([r.baseline for r in rigs]))


def project(P, pts):
    """Project [..., N, 3] points through a [3,4] projection. -> [..., N, 2]."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    uvw = ph @ P.T
    w = uvw[..., 2:3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return uvw[..., :2] / safe_w


def distort_normalized(cam: Pinhole, xy):
    """Apply the 5-coefficient radial-tangential model to normalized
    coordinates [..., N, 2] (a stacked camera, fields [S], takes [S, N, 2])."""
    k1, k2, p1, p2, k3 = (cam.dist[..., i, None] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Pinhole, uv, iterations: int = 8):
    """Distorted pixel coords [..., N, 2] -> undistorted pixel coords (a
    stacked camera, fields [S], takes [S, N, 2])
    (ref `src/camera_model.cpp:72-90`): fixed-point inversion of the
    distortion in normalized coordinates, then back through K."""
    fx, fy, cx, cy = (f[..., None] for f in (cam.fx, cam.fy, cam.cx, cam.cy))
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    k1, k2, p1, p2, k3 = (cam.dist[..., i, None] for i in range(5))
    x, y = x0, y0
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def triangulate_dlt(P1, P2, uv1, uv2):
    """Batched DLT triangulation (cv::triangulatePoints,
    ref `src/camera_model.cpp:123-152`). [..., N, 2] x 2 -> [..., N, 3], with
    [3, 4] projections or one per problem ([..., 1, 3, 4]).

    The null vector is the right singular vector of the smallest singular
    value; its sign is arbitrary and cancels when dehomogenising. On the
    CPU it comes from `torch.linalg.svd` (the plain version), on the card
    from the hand kernel `csrc/triangulate_dlt.cu` (a float64 Jacobi SVD
    with no host sync, so the front end's program can be captured); see
    `ops/kernels/dlt.py`.
    """
    return dlt.triangulate_dlt(P1, P2, uv1, uv2)


def triangulate_rectified(rig: StereoRig, uv_l, uv_r, max_depth: float = 100.0):
    """Closed-form rectified triangulation with validity mask
    (ref `src/camera_model.cpp:195-228`, 0 < z < max_depth gate). uv_l,
    uv_r [..., N, 2]; a stacked rig (`stack_rigs`, fields [S]) triangulates
    sequence s's [S, N, 2] pixels with rig s."""
    fx = rig.left.fx[..., None]
    cx = rig.left.cx[..., None]
    cy = rig.left.cy[..., None]
    u = uv_l[..., 0]
    v = uv_l[..., 1]
    d = uv_l[..., 0] - uv_r[..., 0]
    # z = fx * b / (d - (cx - cx_r)): accounts for differing principal points.
    dd = d - (cx - rig.right.cx[..., None])
    safe_dd = torch.where(torch.abs(dd) < 1e-6, 1e-6, dd)
    z = fx * rig.baseline[..., None] / safe_dd
    x = (u - cx) * z / fx
    y = (v - cy) * z / fx  # the rectified model assumes fx == fy
    pts = torch.stack([x, y, z], dim=-1)
    valid = (z > 0.0) & (z < max_depth)
    return pts, valid


def triangulate_general(rig: StereoRig, uv_l, uv_r, max_depth: float = 100.0):
    """General stereo path on raw (distorted) pixels: undistort (ref
    `src/camera_model.cpp:128-132`), then DLT; valid where the depth in the
    left camera frame lies in (0, max_depth). A stacked rig takes
    [S, N, 2] pixels, sequence s with rig s."""
    return triangulate_ideal(rig, undistort_points(rig.left, uv_l),
                             undistort_points(rig.right, uv_r), max_depth, rectified=False)


def triangulate(rig: StereoRig, uv_l, uv_r, max_depth: float = 100.0, rectified=None):
    """Rectified or general triangulation of raw pixels; both return
    (pts, valid). `rectified` is a Python bool, or None to take the rig's
    own flag (a host bool, so the branch is taken in Python)."""
    if rectified is None:
        rectified = rig.rectified
    if rectified:
        return triangulate_rectified(rig, uv_l, uv_r, max_depth)
    return triangulate_general(rig, uv_l, uv_r, max_depth)


def triangulate_ideal(rig: StereoRig, uv_l, uv_r, max_depth: float = 100.0,
                      rectified: bool = True):
    """Triangulate already-undistorted (ideal pinhole) pixel observations:
    closed-form disparity when rectified, else DLT without re-undistorting.
    A stacked rig takes [S, N, 2] pixels, sequence s with rig s."""
    if rectified:
        return triangulate_rectified(rig, uv_l, uv_r, max_depth)
    P1, P2 = rig.left.projection, rig.right.projection
    if P1.dim() == 3:  # stacked: one [3, 4] per sequence, for its N points
        P1, P2 = P1[:, None], P2[:, None]
    pts = triangulate_dlt(P1, P2, uv_l, uv_r)
    local = se3.transform_points(se3.inverse(rig.left.pose), pts)
    valid = (local[..., 2] > 0.0) & (local[..., 2] < max_depth)
    return pts, valid


def triangulate_rectified_np(fx, cx, cy, cx_r, baseline, uv_l, uv_r):
    """Host (NumPy) mirror of triangulate_rectified's values, in the same
    float32 operation order with scalar intrinsics. The host map recomputes
    its points with it, so the per-frame and batched paths write identical
    landmarks."""
    fx = np.float32(fx)
    cx = np.float32(cx)
    cy = np.float32(cy)
    cx_r = np.float32(cx_r)
    b = np.float32(baseline)
    u = uv_l[..., 0]
    v = uv_l[..., 1]
    d = uv_l[..., 0] - uv_r[..., 0]
    dd = d - (cx - cx_r)
    safe_dd = np.where(np.abs(dd) < np.float32(1e-6), np.float32(1e-6), dd)
    z = fx * b / safe_dd
    x = (u - cx) * z / fx
    y = (v - cy) * z / fx
    return np.stack([x, y, z], axis=-1)

"""Camera calibration parsing.

Supports two formats:

1. The reference's `key=value` camera file (ref `src/camera_utils.cpp:8-64`):
   keys `type, fx_l, fy_l, cx_l, cy_l, fx_r, ..., b, d_l, d_r, T_l, T_r`,
   where d_* are 5 space-separated distortion coefficients and T_* are
   row-major 4x4 camera-to-rig transforms.

   Reference quirk (ref camera_utils.cpp:56): the rectified check uses the
   chained comparison `fx_l == fy_l == fx_r == fy_r`, which in C++ evaluates
   as `((fx_l == fy_l) == fx_r) == fy_r` — i.e. compares a bool (0/1) to
   fx_r. For real focal lengths (≫1) this makes the chained term true only
   in bizarre cases, so virtually every file parses as general Stereo even
   when rectified. We implement the INTENDED 4-way equality and document
   the fix here.

2. KITTI odometry `calib.txt` (P0/P1 rows) for convenience, since that is
   the benchmark dataset (BASELINE.json).

The PyTorch port of the JAX package's `io/calib.py`: the same parsing, and
the rig's tensors go to `device` (the CUDA device unless the caller asks for
another).
"""

from __future__ import annotations

import numpy as np

from stereo_orb_slam_torch.geometry import camera


def load_camera(path: str, device="cuda") -> camera.StereoRig:
    if path.endswith("calib.txt"):
        return load_kitti_calib(path, device)
    return load_reference_format(path, device)


def load_reference_format(path: str, device="cuda") -> camera.StereoRig:
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            vals[key.strip()] = value.strip()

    def flt(k, default=0.0):
        return float(vals[k]) if k in vals else default

    def vec(k, n, default=0.0):
        if k not in vals:
            return np.full(n, default, np.float32)
        return np.asarray([float(x) for x in vals[k].split()], np.float32)

    d_l = vec("d_l", 5)
    d_r = vec("d_r", 5)
    T_l = vec("T_l", 16, 0.0).reshape(4, 4) if "T_l" in vals else np.eye(4, dtype=np.float32)
    T_r = vec("T_r", 16, 0.0).reshape(4, 4) if "T_r" in vals else np.eye(4, dtype=np.float32)

    fx_l, fy_l = flt("fx_l"), flt("fy_l")
    fx_r, fy_r = flt("fx_r"), flt("fy_r")
    cx_l, cy_l = flt("cx_l"), flt("cy_l")
    cx_r, cy_r = flt("cx_r"), flt("cy_r")

    # Baseline key "b": if T_r is identity but b is given, place the right
    # camera at x = b in the rig frame (common rectified shorthand).
    if "b" in vals and np.allclose(T_r, np.eye(4)):
        T_r = np.eye(4, dtype=np.float32)
        T_r[0, 3] = flt("b")

    left = camera.Pinhole.create(fx_l, fy_l, cx_l, cy_l, dist=d_l, pose=T_l, device=device)
    right = camera.Pinhole.create(fx_r, fy_r, cx_r, cy_r, dist=d_r, pose=T_r, device=device)
    baseline = float(abs((np.linalg.inv(T_l) @ T_r)[0, 3]))

    # Intended 4-way rectified check (fixing the reference's chained
    # comparison quirk, ref camera_utils.cpp:56).
    rectified = (
        vals.get("type") == "StereoRectified"
        and fx_l == fy_l == fx_r == fy_r
        and cy_l == cy_r
        and not np.any(d_l)
        and not np.any(d_r)
    )
    return camera.StereoRig.create(
        left, right, rectified=bool(rectified), baseline=baseline
    )


def load_kitti_calib(path: str, device="cuda") -> camera.StereoRig:
    """KITTI odometry calib.txt: P0 (left gray) and P1 (right gray)."""
    P = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, rest = line.partition(":")
            vals = np.asarray([float(x) for x in rest.split()], np.float32)
            if len(vals) == 12:
                P[key.strip()] = vals.reshape(3, 4)
    P0, P1 = P["P0"], P["P1"]
    fx, fy = P0[0, 0], P0[1, 1]
    cx, cy = P0[0, 2], P0[1, 2]
    # P1 = K [I | -b_x] in the left frame => camera pose x-offset = -P1[0,3]/fx
    baseline = -P1[0, 3] / P1[0, 0]
    left = camera.Pinhole.create(fx, fy, cx, cy, device=device)
    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = baseline
    right = camera.Pinhole.create(P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2], pose=pose_r,
                                   device=device)
    return camera.StereoRig.create(
        left, right, rectified=True, baseline=float(baseline)
    )

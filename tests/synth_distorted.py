"""A distorted, non-rectified stereo scene and its EuRoC layout, free of JAX.

`DistortedPlaneScene` is a copy of the scene of tests/test_general_stereo.py
(a textured plane rendered through cameras with radial distortion), so that
the PyTorch port's tests and `chip_smoke.py` can render it without
importing JAX. `make_rig(device)` builds the port's rig from the scene's
fields; a JAX test builds the JAX package's rig from the same fields.

`write_euroc_tree` and `write_camera_file` lay the frames out as a EuRoC
`mav0` tree and a reference key=value camera file with distortion and
extrinsics (the recipe of tests/test_euroc_e2e.py, written with PIL), and
`write_gt` a KITTI-format ground-truth file for the apps' `--gt`.
`dlt_float64` is the float64 DLT the float32 ones are held against.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.ndimage as ndi

# EuRoC MAV's cam0 (mav0/cam0/sensor.yaml of the EuRoC MAV dataset):
# 752x480, pinhole fx = fy, radial-tangential distortion with p1 = p2 = 0
# here, because the scene renders radial distortion only; baseline 0.110 m.
EUROC = dict(fx=458.654, cx=367.215, cy=248.375, k1=-0.28340811, k2=0.07395907,
             baseline=0.110, h=480, w=752)


class DistortedPlaneScene:
    """Textured plane rendered through cameras WITH radial distortion."""

    def __init__(self, rng, fx=220.0, cx=160.0, cy=120.0, baseline=0.4,
                 depth=10.0, h=240, w=320, k1=-0.15, k2=0.03):
        self.fx, self.cx, self.cy = fx, cx, cy
        self.baseline, self.depth = baseline, depth
        self.h, self.w = h, w
        self.dist = np.array([k1, k2, 0.0, 0.0, 0.0], np.float32)
        tex = rng.uniform(0, 255, (512, 512)).astype(np.float32)
        tex = np.kron(tex, np.ones((8, 8), np.float32))
        self.tex = ndi.gaussian_filter(tex, 1.0)
        self.tex_scale = 0.02

    def render(self, cam_x, right=False):
        """The image of a camera at x = cam_x (+ baseline for the right
        one): each distorted pixel is undistorted by fixed-point iteration
        and its ray sampled on the plane."""
        ox = cam_x + (self.baseline if right else 0.0)
        uu, vv = np.meshgrid(
            np.arange(self.w, dtype=np.float32),
            np.arange(self.h, dtype=np.float32),
        )
        x = (uu - self.cx) / self.fx
        y = (vv - self.cy) / self.fx
        xu, yu = x.copy(), y.copy()
        k1, k2 = self.dist[0], self.dist[1]
        for _ in range(10):
            r2 = xu * xu + yu * yu
            rad = 1.0 + k1 * r2 + k2 * r2 * r2
            xu = x / rad
            yu = y / rad
        wx = xu * self.depth + ox
        wy = yu * self.depth
        tx = wx / self.tex_scale + self.tex.shape[1] / 2
        ty = wy / self.tex_scale + self.tex.shape[0] / 2
        return ndi.map_coordinates(
            self.tex, [ty, tx], order=1, mode="nearest"
        ).astype(np.float32)

    def right_pose(self):
        """The right camera's camera-to-rig transform: x = baseline."""
        pose_r = np.eye(4, dtype=np.float32)
        pose_r[0, 3] = self.baseline
        return pose_r

    def make_rig(self, device="cuda"):
        """The port's rig: both cameras distorted, rectified=False (the
        undistort + DLT path)."""
        from stereo_orb_slam_torch.geometry import camera

        left = camera.Pinhole.create(self.fx, self.fx, self.cx, self.cy, dist=self.dist,
                                     device=device)
        right = camera.Pinhole.create(self.fx, self.fx, self.cx, self.cy, dist=self.dist,
                                      pose=self.right_pose(), device=device)
        return camera.StereoRig.create(left, right, rectified=False,
                                       baseline=self.baseline)


def euroc_scene(rng, disparity_px=20.0):
    """A DistortedPlaneScene through EuRoC MAV's cam0 model, with the plane
    at the depth that gives `disparity_px` of (undistorted) disparity."""
    e = EUROC
    return DistortedPlaneScene(rng, fx=e["fx"], cx=e["cx"], cy=e["cy"],
                               baseline=e["baseline"],
                               depth=e["fx"] * e["baseline"] / disparity_px,
                               h=e["h"], w=e["w"], k1=e["k1"], k2=e["k2"])


def write_euroc_tree(root, scene, xs):
    """Frames at camera x positions `xs` as a EuRoC `mav0` tree under root:
    cam{0,1}/data/<timestamp>.png (uint8) and cam{0,1}/data.csv."""
    from PIL import Image

    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    rows = []
    for i, x in enumerate(xs):
        ts = 1_000_000 + i  # nanosecond timestamps
        name = f"{ts}.png"
        for cam, right in (("cam0", False), ("cam1", True)):
            img = np.clip(scene.render(x, right=right), 0, 255).astype(np.uint8)
            Image.fromarray(img, "L").save(os.path.join(root, "mav0", cam, "data", name))
        rows.append((ts, name))
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ts, name in rows:
                f.write(f"{ts},{name}\n")


def write_euroc_replay(root, src_root, order):
    """A EuRoC `mav0` tree under root whose frame j is frame order[j] of the
    tree at src_root (written by write_euroc_tree): its data/ folders are
    links to src_root's, and only the data.csv files are new."""
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam))
        os.symlink(os.path.join(os.path.abspath(src_root), "mav0", cam, "data"),
                   os.path.join(root, "mav0", cam, "data"))
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for j, i in enumerate(order):
                f.write(f"{2_000_000 + j},{1_000_000 + i}.png\n")


def write_camera_file(path, scene):
    """The reference's key=value camera file (type=Stereo): intrinsics,
    5 distortion coefficients and camera-to-rig transforms for each side."""
    d = " ".join(repr(float(v)) for v in scene.dist)
    with open(path, "w") as f:
        f.write("type=Stereo\n")
        for side in ("l", "r"):
            f.write(f"fx_{side}={scene.fx}\nfy_{side}={scene.fx}\n")
            f.write(f"cx_{side}={scene.cx}\ncy_{side}={scene.cy}\n")
            f.write(f"d_{side}={d}\n")
        f.write("T_l=" + " ".join(str(v) for v in np.eye(4).reshape(-1)) + "\n")
        f.write("T_r=" + " ".join(str(float(v)) for v in scene.right_pose().reshape(-1))
                + "\n")


def dlt_float64(P1, P2, uv1, uv2):
    """The DLT of [N, 2] pixel pairs through [3, 4] projections in float64
    (NumPy): the reference the float32 DLTs are held against."""
    P1, P2 = np.asarray(P1, np.float64), np.asarray(P2, np.float64)
    uv1, uv2 = np.asarray(uv1, np.float64), np.asarray(uv2, np.float64)
    A = np.stack([uv1[:, :1] * P1[2] - P1[0], uv1[:, 1:] * P1[2] - P1[1],
                  uv2[:, :1] * P2[2] - P2[0], uv2[:, 1:] * P2[2] - P2[1]], axis=1)
    X = np.linalg.svd(A)[2][:, -1]
    return X[:, :3] / X[:, 3:]


def write_gt(path, xs):
    """KITTI-format ground truth (a 3x4 pose per line) for x positions xs."""
    rows = []
    for x in xs:
        T = np.eye(4)
        T[0, 3] = x
        rows.append(" ".join(f"{v:.9f}" for v in T[:3, :].reshape(12)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")

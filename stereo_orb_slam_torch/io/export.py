"""Result / checkpoint export and import.

A copy of the JAX package's `io/export.py` (NumPy only).

Byte-compatible with the reference's output formats so downstream tooling
can consume either implementation:

- `poses.txt` / `points.txt` / `constraints.txt` from VisualOdometer::Dump
  (ref `src/visual_odometer.cpp:446-505`): counts on the first line; poses
  as 16 row-major floats; constraint rows
  `frame_id point_id u_l v_l u_r v_r sigma`. The constraints file is a
  complete BA problem dump and doubles as the checkpoint format
  (SURVEY.md §5.4) — `read_constraints`/`read_poses` restore a WorldMap.
- The four ASCII PLY writers (ref `src/ply_utils.h:13-226`): raw points,
  trajectory waypoints, colored map (observation-count palette,
  ref ply_utils.h:144-167), pose graph with edge elements.
"""

from __future__ import annotations

import os

import numpy as np


def _fmt(x: float) -> str:
    """Match C++ `operator<<(float)` default formatting (6 sig digits)."""
    return f"{x:.6g}"


def save_poses_txt(path: str, poses: np.ndarray):
    with open(path, "w") as f:
        f.write(f"{len(poses)}\n")
        for T in poses:
            f.write(" ".join(_fmt(v) for v in np.asarray(T).reshape(16)) + "\n")


def read_poses_txt(path: str) -> np.ndarray:
    with open(path) as f:
        n = int(f.readline())
        out = np.zeros((n, 4, 4), np.float32)
        for i in range(n):
            out[i] = np.asarray(
                [float(x) for x in f.readline().split()], np.float32
            ).reshape(4, 4)
    return out


def save_points_txt(path: str, points: np.ndarray):
    with open(path, "w") as f:
        f.write(f"{len(points)}\n")
        for p in points:
            f.write(f"{_fmt(p[0])} {_fmt(p[1])} {_fmt(p[2])}\n")


def read_points_txt(path: str) -> np.ndarray:
    with open(path) as f:
        n = int(f.readline())
        return np.asarray(
            [[float(x) for x in f.readline().split()] for _ in range(n)],
            np.float32,
        ).reshape(n, 3)


def save_constraints_txt(path: str, obs_frame, obs_point, obs_uv, obs_sigma):
    with open(path, "w") as f:
        f.write(f"{len(obs_frame)}\n")
        for i in range(len(obs_frame)):
            u = obs_uv[i]
            f.write(
                f"{obs_frame[i]} {obs_point[i]} "
                f"{_fmt(u[0])} {_fmt(u[1])} {_fmt(u[2])} {_fmt(u[3])} "
                f"{_fmt(obs_sigma[i])}\n"
            )


def read_constraints_txt(path: str):
    with open(path) as f:
        n = int(f.readline())
        frame = np.zeros(n, np.int32)
        point = np.zeros(n, np.int32)
        uv = np.zeros((n, 4), np.float32)
        sigma = np.zeros(n, np.float32)
        for i in range(n):
            parts = f.readline().split()
            frame[i] = int(parts[0])
            point[i] = int(parts[1])
            uv[i] = [float(x) for x in parts[2:6]]
            sigma[i] = float(parts[6])
    return frame, point, uv, sigma


def dump_world(folder: str, world):
    """VisualOdometer::Dump equivalent (ref visual_odometer.cpp:446-505)."""
    os.makedirs(folder, exist_ok=True)
    save_poses_txt(
        os.path.join(folder, "poses.txt"), world.pose_global[: world.num_frames]
    )
    save_points_txt(
        os.path.join(folder, "points.txt"), world.points[: world.num_points]
    )
    save_constraints_txt(
        os.path.join(folder, "constraints.txt"),
        world.obs_frame[: world.num_obs],
        world.obs_point[: world.num_obs],
        world.obs_uv[: world.num_obs],
        world.obs_sigma[: world.num_obs],
    )


# ------------------------------------------------------------------ PLY
_PLY_XYZ_HEADER = (
    "ply\nformat ascii 1.0\ncomment object: list of points\n"
    "element vertex {n}\nproperty float x\nproperty float y\n"
    "property float z\nend_header\n"
)


def save_points_ply(path: str, points: np.ndarray):
    """Plain xyz point list (ref ply_utils.h:13-43)."""
    with open(path, "w") as f:
        f.write(_PLY_XYZ_HEADER.format(n=len(points)))
        for p in points:
            f.write(f"{_fmt(p[0])} {_fmt(p[1])} {_fmt(p[2])}\n")


def save_poses_ply(path: str, poses: np.ndarray):
    """Trajectory waypoints = translation of each global pose
    (ref ply_utils.h:45-84)."""
    save_points_ply(path, np.asarray(poses)[:, :3, 3])


def _obs_count_color(n: int):
    """Observation-count palette (ref ply_utils.h:144-167)."""
    if n > 10:
        return (204, 85, 0)     # burnt orange
    if n > 5:
        return (255, 172, 28)   # bright orange
    if n > 1:
        return (255, 255, 0)    # yellow
    return (255, 255, 255)      # white


def save_map_ply(path: str, poses: np.ndarray, points: np.ndarray, obs_counts):
    """Green frames + observation-count-colored landmarks
    (ref ply_utils.h:86-171)."""
    nf, npts = len(poses), len(points)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\ncomment object: list of points\n"
            f"element vertex {nf + npts}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for T in poses:
            t = T[:3, 3]
            f.write(f"{_fmt(t[0])} {_fmt(t[1])} {_fmt(t[2])} 0 255 0\n")
        for p, c in zip(points, obs_counts):
            r, g, b = _obs_count_color(int(c))
            f.write(f"{_fmt(p[0])} {_fmt(p[1])} {_fmt(p[2])} {r} {g} {b}\n")


def save_pose_graph_ply(path: str, poses: np.ndarray, edges):
    """Frames + red loop edges as PLY edge elements (ref ply_utils.h:173-226)."""
    nf, ne = len(poses), len(edges)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\ncomment object: list of points\n"
            f"element vertex {nf}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element edge {ne}\n"
            "property int vertex1\nproperty int vertex2\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for T in poses:
            t = T[:3, 3]
            f.write(f"{_fmt(t[0])} {_fmt(t[1])} {_fmt(t[2])} 0 255 0\n")
        for a, b in edges:
            f.write(f"{a} {b} 255 0 0\n")


def save_pose_graph_txt(path: str, poses: np.ndarray, edges, measurements=None):
    """Text pose-graph dump: header `n_vertices n_edges`, vertices as
    `tx ty tz qx qy qz qw`, edges as `src dst tx..qw`.

    Mirrors the reference's (dead-code) SavePoseGraph format
    (ref pose_graph_optimizer.cpp:251-286).
    """
    from scipy.spatial.transform import Rotation

    def pose7(T):
        q = Rotation.from_matrix(np.asarray(T)[:3, :3]).as_quat()  # x,y,z,w
        t = np.asarray(T)[:3, 3]
        return [t[0], t[1], t[2], q[0], q[1], q[2], q[3]]

    with open(path, "w") as f:
        f.write(f"{len(poses)} {len(edges)}\n")
        for T in poses:
            f.write(" ".join(_fmt(v) for v in pose7(T)) + "\n")
        for i, (a, b) in enumerate(edges):
            if measurements is not None:
                z = pose7(measurements[i])
            else:
                z = pose7(np.linalg.inv(np.asarray(poses[a])) @ np.asarray(poses[b]))
            f.write(f"{a} {b} " + " ".join(_fmt(v) for v in z) + "\n")


def save_kitti_trajectory(path: str, poses: np.ndarray):
    """KITTI odometry format: 12 floats (3x4 row-major) per line — used by
    the ATE/RPE evaluator against ground-truth poses."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(_fmt(v) for v in np.asarray(T)[:3, :].reshape(12)) + "\n")

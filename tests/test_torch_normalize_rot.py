"""The port's world map, one frame's writes against the batch writers (no
JAX): `_np_normalize_rot`, the single-matrix renormalisation, bit for bit
`_np_normalize_rot_batch(T[None])[0]` (compared as uint32 views) on
seeded near-rotations, on each Shepperd branch, on exact ties between the
candidates (the 24 rotations of the cube, half turns about the axes and
the face diagonals, the identity) and on a quaternion that comes out with
a negative w; and `add_observations`' counts against an `np.add.at`
oracle, with repeated ids and ids outside the map.
"""

import itertools

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from stereo_orb_slam_torch.worldmap import WorldMap
from stereo_orb_slam_torch.worldmap.world import _np_normalize_rot, _np_normalize_rot_batch


def pose(R, t=(0.0, 0.0, 0.0)):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def candidates(T):
    """The batch kernel's four Shepperd candidates, in float32."""
    m = T[:3, :3]
    one = np.float32(1.0)
    return np.array([one + m[0, 0] + m[1, 1] + m[2, 2], one + m[0, 0] - m[1, 1] - m[2, 2],
                     one - m[0, 0] + m[1, 1] - m[2, 2], one - m[0, 0] - m[1, 1] + m[2, 2]],
                    np.float32)


def assert_bits(T):
    got, want = _np_normalize_rot(T), _np_normalize_rot_batch(T[None])[0]
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_near_rotations_bit_for_bit():
    rng = np.random.default_rng(18)
    rots = Rotation.random(10_000, random_state=rng).as_matrix()
    noise = rng.normal(scale=1e-3, size=(10_000, 3, 3))
    trans = rng.normal(scale=20.0, size=(10_000, 3))
    branches = set()
    for R, e, t in zip(rots, noise, trans):
        T = pose(R + e, t)
        branches.add(int(np.argmax(candidates(T))))
        assert_bits(T)
    assert branches == {0, 1, 2, 3}


def _about(axis, angle):
    axis = np.asarray(axis, np.float64)
    return Rotation.from_rotvec(axis / np.linalg.norm(axis) * angle).as_matrix()


@pytest.mark.parametrize("branch,axis", [(0, None), (1, 0), (2, 1), (3, 2)])
def test_each_shepperd_branch(branch, axis):
    """A small turn keeps the trace largest; about 150 degrees about an axis
    makes that axis's diagonal largest."""
    rng = np.random.default_rng(branch)
    for _ in range(200):
        if axis is None:
            R = _about(rng.normal(size=3), rng.uniform(0.0, 1.0))
        else:
            tilt = np.zeros(3)
            tilt[axis] = 1.0
            tilt += rng.normal(scale=0.1, size=3)
            R = _about(tilt, rng.uniform(2.3, 2.9))
        T = pose(R + rng.normal(scale=1e-3, size=(3, 3)), rng.normal(size=3))
        assert int(np.argmax(candidates(T))) == branch
        assert_bits(T)


def _cube_rotations():
    """The 24 signed permutation matrices of determinant +1: entries 0 and
    +-1, so the candidates tie exactly (the identity, quarter and half turns
    about the axes, half turns about the face diagonals, thirds about the
    body diagonals)."""
    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3), np.float32)
            R[range(3), perm] = signs
            if np.linalg.det(R) > 0:
                out.append(R)
    return out


@pytest.mark.parametrize("R", _cube_rotations(), ids=lambda R: "".join(
    "+-0"[int(v == -1) if v else 2] for v in R.ravel()))
def test_exact_ties(R):
    """The clean matrix, then one with noise off the diagonal alone: the
    candidates still tie exactly, and the tied branches' constructions round
    differently, so only the first largest gives the batch's bits."""
    T = pose(R, (1.5, -2.0, 0.25))
    assert_bits(T)
    np.testing.assert_allclose(_np_normalize_rot(T), T, atol=1e-6)
    rng = np.random.default_rng(7)
    for _ in range(50):
        N = pose(R + rng.normal(scale=1e-3, size=(3, 3)) * (1 - np.eye(3)), (1.5, -2.0, 0.25))
        np.testing.assert_array_equal(candidates(N), candidates(T))
        assert_bits(N)


def test_ties_are_present():
    """The cube set holds ties at the maximum between every pair of
    candidates, and four-way ones."""
    pairs = set()
    for R in _cube_rotations():
        c = candidates(pose(R))
        top = np.flatnonzero(c == c.max())
        pairs.update(itertools.combinations(top.tolist(), 2))
        if len(top) == 4:
            pairs.add("all")
    assert pairs >= set(itertools.combinations(range(4), 2)) | {"all"}


def test_negative_w_flips():
    """About x by -2.5 rad: the x diagonal wins (cos < 0) and the branch's
    w, (m21 - m12) r = 2 sin(theta) r, is negative, so the kernel flips the
    quaternion's sign before it normalises. The matrix is even in q, so the
    flip leaves its bits as they are; the case runs the flipped path."""
    theta = -2.5
    R = _about([1.0, 0.0, 0.0], theta) + np.random.default_rng(5).normal(scale=1e-3, size=(3, 3))
    T = pose(R, (0.5, 0.5, 0.5))
    assert int(np.argmax(candidates(T))) == 1
    assert (T[2, 1] - T[1, 2]) < 0
    assert_bits(T)
    np.testing.assert_allclose(_np_normalize_rot(T)[:3, :3], _about([1.0, 0, 0], theta), atol=2e-3)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, 0.0, 1e30, -1e30])
def test_non_finite_and_extreme_entries(value):
    """One entry replaced at a time, and the zero matrix: NaN, infinity and
    overflow reach the output as the batch kernel lets them."""
    base = pose(np.eye(3) + 0.01 * np.arange(9).reshape(3, 3))
    with np.errstate(all="ignore"):
        for i, j in itertools.product(range(4), range(4)):
            T = base.copy()
            T[i, j] = value
            assert_bits(T)
        assert_bits(np.zeros((4, 4), np.float32))


def test_input_forms():
    """float64 input and a strided view give the batch's float32 result."""
    rng = np.random.default_rng(6)
    T64 = pose(_about(rng.normal(size=3), 0.7), rng.normal(size=3)).astype(np.float64)
    T64[:3, :3] += rng.normal(scale=1e-3, size=(3, 3))
    assert_bits(T64)
    stack = np.stack([T64.astype(np.float32)] * 3)
    view = stack[::2][1]
    np.testing.assert_array_equal(_np_normalize_rot(view).view(np.uint32),
                                  _np_normalize_rot_batch(stack)[2].view(np.uint32))


def _oracle(world, frame_id, ids, uv4):
    """The per-frame writes with np.add.at's count, on copies."""
    count = world.point_obs_count.copy()
    i = np.asarray(ids, np.int64)
    np.add.at(count, i[(i >= 0) & (i < world.num_points)], 1)
    n0 = world.num_obs
    return count, n0 + len(ids), (np.full(len(ids), frame_id, np.int32),
                                  np.asarray(ids, np.int32), uv4)


@pytest.mark.parametrize("case", ["repeats", "outside", "mixed", "empty", "one_id"])
def test_observation_counts_match_add_at(case):
    rng = np.random.default_rng(len(case))
    world = WorldMap(point_capacity=8, obs_capacity=4)
    world.add_frame(np.eye(4, dtype=np.float32))
    world.add_points(rng.normal(size=(40, 3)).astype(np.float32), 0)
    for frame in range(12):
        n = 0 if case == "empty" else int(rng.integers(1, 60))
        if case == "repeats":
            ids = rng.integers(0, 8, n)
        elif case == "one_id":
            ids = np.full(n, frame % 3 + 2)
        elif case == "outside":
            ids = rng.integers(-5, 0, n) if frame % 2 else rng.integers(40, 60, n)
        else:
            ids = rng.integers(-3, 45, n)
            if n:
                ids[: n // 3] = ids[0]  # a run of one id
        ids = ids.astype(np.int32)
        uv4 = rng.normal(size=(n, 4)).astype(np.float32)
        count, num_obs, rows = _oracle(world, frame, ids, uv4)
        world.add_observations(frame, ids, uv4)
        np.testing.assert_array_equal(world.point_obs_count, count)
        assert world.num_obs == num_obs
        sl = slice(num_obs - n, num_obs)
        for got, want in zip((world.obs_frame[sl], world.obs_point[sl], world.obs_uv[sl]), rows):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(world.obs_sigma[: world.num_obs], 1.0)
    np.testing.assert_array_equal(world.point_obs_count[40:], 0)

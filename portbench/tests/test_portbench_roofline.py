"""The frozen roofline counts reproduce the bounds PERF.md gives the port's
kernels at the main path's shapes (NVIDIA H100 SXM peaks)."""

import numpy as np
import pytest

from portbench.roofline import hamming_top2, orb_describe, triangulate_dlt

EUROC = dict(fx=458.654, cx=367.215, cy=248.375, baseline=0.110)


def test_hamming_top2_bound():
    """N = 1024 against two train sets of 1024 (one launch a frame): 0.543
    us, bound by the int8 tensor-core rate; B = 3: 1.628 us."""
    t, by = hamming_top2.bound_s(n=1024, m=1024, sets=2)
    assert by == "operations" and round(t * 1e6, 3) == 0.543
    assert round(hamming_top2.bound_s(1024, 1024, 2, batch=3)[0] * 1e6, 3) == 1.628


@pytest.mark.parametrize("h,w,want", [(376, 1241, 0.629), (480, 752, 0.489)])
def test_orb_describe_bound(h, w, want):
    """N = 1024 on the KITTI frame (0.629 us) and the EuRoC frame (0.489
    us), padded by 15 pixels, bound by bytes."""
    t, by = orb_describe.bound_s(hp=h + 30, wp=w + 30, n=1024)
    assert by == "bytes" and round(t * 1e6, 3) == want


def _dlt_case(rng, n):
    """The DLT's synthetic N = 1024 case (chip_smoke.py's): EuRoC cam0's
    projections, half the points 1.5-5 m deep, half 45-100 m, pixel noise on
    the left, a quarter of the slots zero."""
    K = np.array([[EUROC["fx"], 0, EUROC["cx"]], [0, EUROC["fx"], EUROC["cy"]], [0, 0, 1.0]])
    P1 = (K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32)
    P2 = (K @ np.hstack([np.eye(3), [[-EUROC["baseline"]], [0.0], [0.0]]])).astype(np.float32)
    near = np.arange(n) < n // 2
    z = np.where(near, rng.uniform(1.5, 5.0, n), rng.uniform(45.0, 100.0, n))
    X = np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.5, 0.5, n) * z, z], 1)

    def pix(P):
        x = X @ P[:, :3].T.astype(np.float64) + P[:, 3]
        return (x[:, :2] / x[:, 2:]).astype(np.float32)

    uv1 = pix(P1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2 = pix(P2)
    valid = rng.random(n) >= 0.25
    uv1[~valid] = 0.0
    uv2[~valid] = 0.0
    return P1, P2, uv1, uv2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_dlt_bound(seed):
    """The synthetic N = 1024 systems: 0.0601 us in PERF.md (on its own
    draw; 0.0599 on the general path's first frame), bound by float64
    operations counted from the fixed cyclic Jacobi: within 1% here on
    other draws of the same case."""
    t, by = triangulate_dlt.bound_s(*_dlt_case(np.random.default_rng(seed), 1024))
    assert by == "operations"
    assert abs(t * 1e6 - 0.0601) < 0.0006


def test_dlt_count_is_the_reference_jacobi():
    """The count follows the reference's sweeps and rotations: a diagonal
    system needs one sweep and no rotation (99 + 162 operations)."""
    a = np.tile(np.diag([4.0, 3.0, 2.0, 1.0]), (5, 1, 1))
    sweeps, rotations = triangulate_dlt.jacobi_work(a)
    assert sweeps.tolist() == [1] * 5 and rotations.tolist() == [0] * 5

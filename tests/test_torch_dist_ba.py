"""Distributed bundle adjustment of the port (`parallel/dist_ba.py`) on
gloo ranks, against the port's single-process solve and the JAX package's
sharded solve on its virtual CPU mesh.

- `partition_points_balanced` and `build_point_aligned` give exactly the
  JAX package's bounds, pad sizes and arrays at 2, 4 and 8 ranks.
- At 2 and 4 ranks, both layouts ("point_aligned", "obs"), 10 LM
  iterations from the perturbed world of tests/test_dist_ba.py, against
  the port's `BundleAdjuster`: final cost within rtol 1e-3 / atol 1e-4,
  poses within 5e-3, points within 2e-2 (tests/test_dist_ba.py's bounds;
  the sums run in another order, so ranks above 1 are not bit-equal).
  Measured on this problem (CPU): cost gaps up to 1.3e-7 absolute (the
  final costs are about 5e-7), poses up to 4.8e-7, points up to 8.1e-5.
  Every rank writes back the same world, bit for bit.
- At 4 ranks, the port against the JAX package's DistributedBundleAdjuster
  on `make_mesh(4)` with the same scheme, same bounds (measured: cost 2.3e-7,
  poses 3.4e-6, points 5.8e-5).
- The point-aligned dense path (dense_K, one [6C, 6C] all_reduce) against
  the matrix-free one, 8 LM iterations each with no exit: the same
  iteration count, cost within rtol 1e-3 / atol 1e-4, pose6 within 5e-3
  (tests/test_dist_ba.py:108).

The ranks run tests/dist_workers.py (JAX-free) with a join timeout.
"""

import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_workers  # noqa: E402
from dist_workers import file_store  # noqa: E402,F401 (fixture)
from test_ba import synth_ba_world  # noqa: E402
from test_torch_ba import port_world  # noqa: E402

from stereo_orb_slam_tpu.backend.ba import prepare_problem_arrays  # noqa: E402
from stereo_orb_slam_tpu.config import BAConfig as JBA  # noqa: E402
from stereo_orb_slam_tpu.parallel import dist_ba as jdist  # noqa: E402
from stereo_orb_slam_tpu.parallel.mesh import make_mesh  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.backend.ba import BundleAdjuster  # noqa: E402
from stereo_orb_slam_torch.config import BAConfig  # noqa: E402
from stereo_orb_slam_torch.parallel import dist_ba  # noqa: E402

torch.set_num_threads(1)
ITERS = 10
COST_RTOL, COST_ATOL, POSE_ATOL, POINT_ATOL = 1e-3, 1e-4, 5e-3, 2e-2
SCHEMES = ("point_aligned", "obs")


def rig_np(rig):
    """A JAX StereoRig as plain dicts of arrays (picklable without JAX)."""
    r = jax.tree.map(np.asarray, rig)
    return {"left": r.left._asdict(), "right": r.right._asdict(),
            "rectified": bool(r.rectified), "baseline": r.baseline}


def perturbed(seed=0):
    """tests/test_dist_ba.py's problem: 6 frames, 200 points, poses moved
    by 0.1 m and points by 0.15 m (numpy draws from `seed`)."""
    rng = np.random.default_rng(seed)
    world, rig, _, _ = synth_ba_world(rng, n_frames=6, n_points=200)
    for i in range(1, world.num_frames):
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = rng.normal(size=3) * 0.1
        world.pose_global[i] = world.pose_global[i] @ d
    world.points[: world.num_points] += rng.normal(
        0, 0.15, (world.num_points, 3)).astype(np.float32)
    return world, rig


def _single(world, rig):
    w = port_world(world)
    stats = BundleAdjuster(w, convert.rig_from_numpy(rig_np(rig), "cpu"),
                           BAConfig(max_iterations=ITERS)).optimize(0, w.num_frames)
    return stats, w.pose_global[:w.num_frames], w.points[:w.num_points]


def _assert_close(name, got, want):
    (s_got, poses_got, pts_got), (s_want, poses_want, pts_want) = got, want
    gaps = (abs(s_got["cost_final"] - s_want["cost_final"]),
            float(np.abs(poses_got - poses_want).max()),
            float(np.abs(pts_got - pts_want).max()))
    print(f"{name}: cost gap {gaps[0]:.3g}, poses {gaps[1]:.3g}, points {gaps[2]:.3g}")
    assert np.isclose(s_got["cost_final"], s_want["cost_final"], rtol=COST_RTOL,
                      atol=COST_ATOL), name
    np.testing.assert_allclose(poses_got, poses_want, atol=POSE_ATOL, err_msg=name)
    np.testing.assert_allclose(pts_got, pts_want, atol=POINT_ATOL, err_msg=name)


def _check_ranks(outs, single):
    for scheme in SCHEMES:
        stats, poses, pts, n_red = outs[0]["solves"][scheme]
        assert stats["scheme"] == scheme and stats["num_devices"] == len(outs)
        assert stats["iterations"] == ITERS and n_red > 0
        assert stats["cost_final"] < stats["cost_initial"] * 1e-3
        _assert_close(f"{scheme} x{len(outs)} vs single", (stats, poses, pts), single)
        for other in outs[1:]:   # SPMD write-back: every replica the same
            np.testing.assert_array_equal(other["solves"][scheme][1], poses)
            np.testing.assert_array_equal(other["solves"][scheme][2], pts)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_point_aligned_layout_matches_reference(n_dev):
    world, rig = perturbed()
    problem = world.ba_problem(0, world.num_frames)
    pose6, oc, op, ouv, cmask = prepare_problem_arrays(problem, sort_by_point=True)
    P_l, P_r = np.asarray(rig.left.projection), np.asarray(rig.right.projection)
    ref, ref_meta = jdist.build_point_aligned(pose6, problem["point_xyz"], oc, op, ouv, cmask,
                                              P_l, P_r, n_dev)
    port, meta = dist_ba.build_point_aligned(pose6, problem["point_xyz"], oc, op, ouv, cmask,
                                             P_l, P_r, n_dev)
    assert meta == ref_meta
    assert dist_ba.partition_points_balanced(op, len(problem["point_xyz"]), n_dev) == \
        jdist.partition_points_balanced(op, len(problem["point_xyz"]), n_dev)
    for f in ref._fields:
        a, b = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # A rank's shard as convert builds it from the JAX package's arrays.
    shard = convert.point_aligned_from_numpy(jax.tree.map(np.asarray, ref), ref_meta, 1, "cpu")
    lo, hi = ref_meta["bounds"][1], ref_meta["bounds"][2]
    np.testing.assert_array_equal(shard.points[: hi - lo].numpy(), problem["point_xyz"][lo:hi])
    assert shard.obs_cam.dtype == torch.int64 and shard.pose6.shape == (6, 6)


def test_two_ranks_both_schemes(file_store):
    world, rig = perturbed()
    single = _single(world, rig)
    outs = dist_workers.spawn(dist_workers.dist_ba_checks, 2, file_store, port_world(world),
                              rig_np(rig), ITERS, SCHEMES)
    _check_ranks(outs, single)


def test_four_ranks_against_single_and_reference(file_store):
    world, rig = perturbed()
    single = _single(world, rig)
    # The point-aligned problem of this world for the dense-vs-matrix-free check.
    problem = world.ba_problem(0, world.num_frames)
    pose6, oc, op, ouv, cmask = prepare_problem_arrays(problem, sort_by_point=True)
    host, meta = dist_ba.build_point_aligned(
        pose6, problem["point_xyz"], oc, op, ouv, cmask, np.asarray(rig.left.projection),
        np.asarray(rig.right.projection), 4)
    K = 1 << (max(int(np.bincount(op).max(initial=2)), 2) - 1).bit_length()
    outs = dist_workers.spawn(dist_workers.dist_ba_checks, 4, file_store, port_world(world),
                              rig_np(rig), ITERS, SCHEMES, host, meta, K, 8)
    _check_ranks(outs, single)

    mesh4 = make_mesh(4, devices=jax.devices()[:4])
    for scheme in SCHEMES:
        w = copy.deepcopy(world)
        ref_stats = jdist.DistributedBundleAdjuster(w, rig, mesh4, JBA(max_iterations=ITERS),
                                                    scheme=scheme).optimize(0, w.num_frames)
        stats, poses, pts, _ = outs[0]["solves"][scheme]
        _assert_close(f"{scheme} x4 vs JAX x4", (stats, poses, pts),
                      (ref_stats, w.pose_global[:w.num_frames], w.points[:w.num_points]))

    (it_mf, cost_mf, pose_mf), (it_dn, cost_dn, pose_dn) = (
        outs[0]["paths"]["matrix_free"], outs[0]["paths"]["dense"])
    print(f"dense vs matrix-free x4: cost {cost_dn:.6g} / {cost_mf:.6g}, pose6 gap "
          f"{np.abs(pose_dn - pose_mf).max():.3g}")
    assert it_mf == it_dn == 8
    assert np.isclose(cost_dn, cost_mf, rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(pose_dn, pose_mf, atol=POSE_ATOL)

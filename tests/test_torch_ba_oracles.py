"""The port's bundle adjustment against ground truth and its own invariants.

The oracles of `tests/test_ba.py`, ported: synthetic worlds with known
geometry (the same generator, here building the port's WorldMap and rig),
recovery from perturbation, outliers, the point bound, the equivalence of
the solver paths (dense, banded, matrix-free, evaluate-once, chunked), and
the port's own guarantees: a reduced system that is not positive definite
is a rejected LM step, not an exception; the solver runs with TF32 off
whatever the caller set; the refine app does not fall back to the CPU.

This file imports neither JAX nor the JAX package, so on the card it runs
with

    python -m pytest -q --noconftest -m cuda tests/test_torch_ba_oracles.py

(the `cuda`-marked test solves one problem on both devices and skips
without a card).
"""

import os

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

torch = pytest.importorskip("torch")

from stereo_orb_slam_torch.apps import refine  # noqa: E402
from stereo_orb_slam_torch.backend import ba, residuals, schur_dense  # noqa: E402
from stereo_orb_slam_torch.config import BAConfig  # noqa: E402
from stereo_orb_slam_torch.geometry import camera, se3_np  # noqa: E402
from stereo_orb_slam_torch.io import export  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402
from synth_ba import banded_problem, first_step  # noqa: E402

torch.set_num_threads(1)

FX, CX, CY, B = 200.0, 160.0, 120.0, 0.5


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_rig(device="cpu"):
    left = camera.Pinhole.create(FX, FX, CX, CY, device=device)
    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = B
    right = camera.Pinhole.create(FX, FX, CX, CY, pose=pose_r, device=device)
    return camera.StereoRig.create(left, right, rectified=True)


def project4(P_l, P_r, X_cam):
    def pr(P):
        Xh = np.concatenate([X_cam, np.ones((len(X_cam), 1), np.float32)], 1)
        uvw = Xh @ P.T
        return uvw[:, :2] / uvw[:, 2:3]
    return np.concatenate([pr(P_l), pr(P_r)], 1)


def synth_ba_world(rng, n_frames=5, n_points=120, noise_px=0.0, device="cpu"):
    """tests/test_ba.py's generator (the same draws from `rng`) building
    the port's WorldMap and rig: forward motion with small rotations,
    points 5-30 m ahead, stereo observations with optional pixel noise."""
    rig = make_rig(device)
    P_l = rig.left.projection.cpu().numpy()
    P_r = rig.right.projection.cpu().numpy()
    world = WorldMap()
    gt_poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, n_frames):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix()
        T[:3, 3] = [0.05, 0.0, 1.0]
        gt_poses.append(gt_poses[-1] @ T)
    pts_w = np.stack([rng.uniform(-8, 8, n_points), rng.uniform(-2, 2, n_points),
                      rng.uniform(5, 30, n_points)], 1).astype(np.float32)
    for i, G in enumerate(gt_poses):
        rel = np.eye(4, dtype=np.float32) if i == 0 else np.linalg.inv(gt_poses[i - 1]) @ G
        world.add_frame(rel)
        if i == 0:
            ids = world.add_points(pts_w, 0)
        Ginv = np.linalg.inv(G)
        X_cam = pts_w @ Ginv[:3, :3].T + Ginv[:3, 3]
        vis = X_cam[:, 2] > 1.0
        uv = project4(P_l, P_r, X_cam[vis])
        if noise_px:
            uv = uv + rng.normal(0, noise_px, uv.shape).astype(np.float32)
        world.add_observations(i, ids[vis], uv.astype(np.float32))
    return world, rig, np.stack(gt_poses), pts_w


def flat_problem(world, rig):
    """The whole world as a padded point-sorted BAProblem (tests/test_ba.py's
    _flat_prob_from_world, pow2 padding) plus its slot bucket K."""
    adj = ba.BundleAdjuster(world, rig)
    setup = adj.prepare(0, world.num_frames)
    K = schur_dense.group_slots(setup.prob.obs_point[: setup.num_obs].numpy(),
                                setup.prob.obs_cam[: setup.num_obs].numpy(),
                                setup.P_pad, setup.num_obs)[3]
    return setup, K


def perturb(world, rng, rot=0.01, trans=0.15, point=0.2):
    for i in range(1, world.num_frames):
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * rot).as_matrix()
        d[:3, 3] = rng.normal(size=3) * trans
        world.pose_global[i] = world.pose_global[i] @ d
    world.points[: world.num_points] += rng.normal(
        0, point, (world.num_points, 3)).astype(np.float32)


def test_residual_zero_at_ground_truth(rng):
    world, rig, *_ = synth_ba_world(rng)
    prob = world.ba_problem(0, world.num_frames)
    pose6 = se3_np.matrix_to_pose6_np(se3_np.inverse_np(prob["cam_world"]))
    t = torch.from_numpy
    cost = residuals.robust_cost(
        t(pose6), t(prob["point_xyz"]), t(prob["obs_cam"]).long(),
        t(prob["obs_point"]).long(), t(prob["obs_uv"]),
        torch.ones(len(prob["obs_cam"])), rig.left.projection, rig.right.projection, 1.0)
    assert float(cost) < 1e-3


def test_ba_recovers_from_perturbation(rng):
    world, rig, gt_poses, pts_gt = synth_ba_world(rng)
    perturb(world, rng)
    stats = ba.BundleAdjuster(world, rig, BAConfig(max_iterations=30)).optimize(0, world.num_frames)
    assert stats["cost_final"] < stats["cost_initial"] * 1e-2
    for i in range(world.num_frames):
        dT = np.linalg.inv(gt_poses[i]) @ world.pose_global[i]
        assert np.linalg.norm(dT[:3, 3]) < 0.03, i
        assert np.linalg.norm(Rotation.from_matrix(dT[:3, :3]).as_rotvec()) < 0.01, i
    err = np.linalg.norm(world.points[: world.num_points] - pts_gt, axis=1)
    assert np.percentile(err, 90) < 0.05


def test_ba_single_frame_moves_points_only(rng):
    world, rig, _, pts_gt = synth_ba_world(rng, n_frames=2)
    world.points[: world.num_points] += rng.normal(
        0, 0.3, (world.num_points, 3)).astype(np.float32)
    pose_before = world.pose_global[0].copy()
    ba.BundleAdjuster(world, rig, BAConfig(max_iterations=15)).optimize(0, 1)
    np.testing.assert_allclose(world.pose_global[0], pose_before, atol=1e-6)
    err = np.linalg.norm(world.points[: world.num_points] - pts_gt, axis=1)
    assert np.median(err) < 0.15


def test_ba_huber_robust_to_outliers(rng):
    world, rig, gt_poses, _ = synth_ba_world(rng, noise_px=0.3)
    idx = rng.choice(world.num_obs, world.num_obs // 20, replace=False)
    world.obs_uv[idx] += rng.normal(0, 50, (len(idx), 4)).astype(np.float32)
    world.points[: world.num_points] += rng.normal(
        0, 0.1, (world.num_points, 3)).astype(np.float32)
    ba.BundleAdjuster(world, rig, BAConfig(max_iterations=25)).optimize(0, world.num_frames)
    for i in range(world.num_frames):
        dT = np.linalg.inv(gt_poses[i]) @ world.pose_global[i]
        assert np.linalg.norm(dT[:3, 3]) < 0.05, i


def test_point_bound_clamp(rng):
    world, rig, *_ = synth_ba_world(rng)
    world.points[:3] = [[2e4, 0, 10], [0, -3e4, 10], [0, 0, 5e4]]
    ba.BundleAdjuster(world, rig, BAConfig(max_iterations=3, point_bound=1e4)).optimize(
        0, world.num_frames)
    assert np.all(np.abs(world.points[: world.num_points]) <= 1e4)


def test_dense_schur_full_optimize_converges(rng):
    world, rig, gt_poses, _ = synth_ba_world(rng, n_frames=6)
    for i in range(1, world.num_frames):
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = rng.normal(size=3) * 0.1
        world.pose_global[i] = world.pose_global[i] @ d
    stats = ba.BundleAdjuster(world, rig, BAConfig(max_iterations=30)).optimize(
        0, world.num_frames)
    assert stats["path"] == "dense"
    assert stats["cost_final"] < stats["cost_initial"] * 1e-2
    for i in range(world.num_frames):
        dT = np.linalg.inv(gt_poses[i]) @ world.pose_global[i]
        assert np.linalg.norm(dT[:3, 3]) < 0.03, i


def test_dense_schur_matches_matrix_free(rng):
    """One LM step with the materialized S must match the matrix-free PCG
    (same normal equations; CG to a tight tolerance)."""
    world, rig, *_ = synth_ba_world(rng, n_frames=6, n_points=150, noise_px=0.5)
    world.points[: world.num_points] += rng.normal(
        0, 0.1, (world.num_points, 3)).astype(np.float32)
    setup, K = flat_problem(world, rig)
    prob = setup.prob
    cfg = BAConfig(cg_iterations=200, cg_tol=1e-10)
    lam = torch.tensor(1e-4)
    slots = ba.build_slots_device(prob.obs_point, prob.obs_cam, prob.obs_weight,
                                  setup.P_pad, K)
    f1, _, acc_f, c0_f, c1_f = ba.lm_step(prob, lam, cfg)
    d1, _, acc_d, c0_d, c1_d = ba.lm_step(prob, lam, cfg, dense_slots=slots)
    np.testing.assert_allclose(float(c0_f), float(c0_d), rtol=1e-5)
    assert bool(acc_f) == bool(acc_d)
    np.testing.assert_allclose(float(c1_f), float(c1_d), rtol=1e-3)
    torch.testing.assert_close(f1.pose6, d1.pose6, rtol=0, atol=5e-4)
    torch.testing.assert_close(f1.points, d1.points, rtol=0, atol=5e-3)


def test_evaluate_once_lm_matches_two_pass(rng):
    """The cached-normal-equation loop (lm_init / lm_iteration) takes the
    two-pass lm_step sequence exactly: the same accepts, costs and poses.
    Both evaluate the trial cost through residual_one on the same gathered
    inputs (build_rows_soa's cost is robust_cost's), so they agree bit for
    bit, past the point where the steps change the cost by one float32 ulp
    and rejections begin (the tenth step here)."""
    world, rig, *_ = synth_ba_world(rng, n_frames=5, n_points=100, noise_px=0.8)
    world.points[: world.num_points] += rng.normal(
        0, 0.15, (world.num_points, 3)).astype(np.float32)
    setup, _ = flat_problem(world, rig)
    cfg = BAConfig(cg_iterations=200, cg_tol=1e-12)
    prob, lam = setup.prob, torch.tensor(cfg.lm_lambda_init)
    two_pass = []
    for _ in range(12):
        prob, lam, acc, c0, c1 = ba.lm_step(prob, lam, cfg)
        two_pass.append((bool(acc), float(c0), float(c1)))
    carry = ba.lm_init(setup.prob, cfg)
    cached = []
    for _ in range(12):
        carry, acc, c0, c1 = ba.lm_iteration(carry, cfg)
        cached.append((bool(acc), float(c0), float(c1)))
    assert cached == two_pass
    assert not all(a for a, _, _ in cached)
    torch.testing.assert_close(prob.pose6, carry.prob.pose6, rtol=0, atol=0)
    torch.testing.assert_close(prob.points, carry.prob.points, rtol=0, atol=0)


def test_ba_solve_matches_host_loop_and_explicit_slots(rng):
    """ba_solve's loop (convergence exit included) equals a host loop of
    lm_iteration, and device-derived slot maps equal host group_slots."""
    world, rig, *_ = synth_ba_world(rng, n_frames=5, n_points=100, noise_px=0.8)
    world.points[: world.num_points] += rng.normal(
        0, 0.15, (world.num_points, 3)).astype(np.float32)
    setup, K = flat_problem(world, rig)
    prob = setup.prob
    cfg = BAConfig(cg_iterations=200, cg_tol=1e-12, function_tolerance=1e-4)
    carry = ba.lm_init(prob, cfg)
    host_iters = 0
    for _ in range(12):
        carry, acc, c0, c1 = ba.lm_iteration(carry, cfg)
        host_iters += 1
        if bool(acc) and float(c0) > 0 and float(c0) - float(c1) < cfg.function_tolerance * float(c0):
            break
    dcarry, iters, cost_init = ba.ba_solve(prob, 12, cfg)
    # All 12 iterations ran, those after the exit masked: the count is the
    # host loop's, kept on the device.
    assert isinstance(iters, torch.Tensor) and iters.dim() == 0
    assert iters == host_iters < 12
    assert float(cost_init) > float(dcarry.cost)
    torch.testing.assert_close(dcarry.prob.pose6, carry.prob.pose6, rtol=0, atol=0)

    n = setup.num_obs
    sto, scam, smask, K = schur_dense.group_slots(prob.obs_point[:n].numpy(),
                                                  prob.obs_cam[:n].numpy(), setup.P_pad, n)
    slots = (torch.from_numpy(sto).long(), torch.from_numpy(scam).long(),
             torch.from_numpy(smask))
    c1, it1, _ = ba.ba_solve(prob, 5, cfg, dense_slots=slots)
    c2, it2, _ = ba.ba_solve(prob, 5, cfg, dense_K=K)
    assert it1 == it2
    torch.testing.assert_close(c1.prob.pose6, c2.prob.pose6, rtol=0, atol=0)
    torch.testing.assert_close(c1.prob.points, c2.prob.points, rtol=0, atol=0)


def test_banded_schur_matches_dense_on_the_reference_problem(rng):
    """Banded and dense assembly are the same math summed in another order.
    On this problem after 5 LM iterations the JAX package's two solves
    differ by up to 1.02e-5 in pose6 (3 of 384 entries above 1e-5) and the
    port's by up to 1.93e-5 (measured on the CPU): float32 accumulation
    order. Tolerance: pose6 within 5e-5, points within 1e-3 (the reference
    test's), cost within rtol 1e-4, the same iteration count."""
    prob, slots, plan = banded_problem(rng)
    assert plan is not None
    bases, B, Pc = plan
    assert B < prob.pose6.shape[0]
    cfg = BAConfig()
    cd, itd, _ = ba.ba_solve(prob, 5, cfg, dense_slots=slots)
    cb, itb, _ = ba.ba_solve(prob, 5, cfg, dense_slots=slots, band_bases=bases, band_B=B,
                             band_Pc=Pc)
    assert itd == itb
    torch.testing.assert_close(cb.prob.pose6, cd.prob.pose6, rtol=0, atol=5e-5)
    torch.testing.assert_close(cb.prob.points, cd.prob.points, rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(cb.cost), float(cd.cost), rtol=1e-4)


def test_non_positive_definite_step_is_rejected_without_an_exception(rng):
    world, rig, *_ = synth_ba_world(rng, noise_px=0.5)
    setup, K = flat_problem(world, rig)
    prob = setup.prob
    S = -torch.eye(12)
    dc = schur_dense.solve_reduced_chol(S, torch.ones(2, 6), torch.ones(2))
    assert torch.isnan(dc).all()

    cfg = BAConfig()
    slots = ba.build_slots_device(prob.obs_point, prob.obs_cam, prob.obs_weight,
                                  setup.P_pad, K)
    carry = ba.lm_init(prob, cfg, dense_slots=slots)
    # Negative damping turns every diagonal block negative: S is not SPD.
    bad = carry._replace(lam=torch.tensor(-3.0))
    new, accepted, c0, c1 = ba.lm_iteration(bad, cfg, dense_slots=slots)
    assert not bool(accepted) and torch.isnan(c1)
    assert float(new.cost) == float(carry.cost)
    torch.testing.assert_close(new.prob.pose6, prob.pose6, rtol=0, atol=0)
    torch.testing.assert_close(new.prob.points, prob.points, rtol=0, atol=0)
    assert float(new.lam) == np.float32(cfg.lm_lambda_min)  # -3 * up, clamped
    # The next (well-damped) iteration proceeds from the kept state.
    good, accepted, _, _ = ba.lm_iteration(new._replace(lam=carry.lam), cfg, dense_slots=slots)
    assert bool(accepted) and float(good.cost) < float(carry.cost)


def test_solver_runs_with_tf32_off_and_restores_the_callers_setting(rng, monkeypatch):
    world, rig, *_ = synth_ba_world(rng, noise_px=0.5)
    seen = []
    build = ba.build_normal_equations

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return build(*args, **kwargs)

    monkeypatch.setattr(ba, "build_normal_equations", spy)
    before = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ba.BundleAdjuster(world, rig, BAConfig(max_iterations=2)).optimize(0, world.num_frames)
        setup, _ = flat_problem(world, rig)
        ba.ba_solve(setup.prob, 2, BAConfig(cg_iterations=5))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
    assert len(seen) >= 6 and not any(seen)


def test_capped_solve_is_chunked_and_stops_at_the_cap(rng):
    """A wall cap sends a solve of >= 2**16 padded observations down the
    chunked path: a 1-iteration probe, then chunks sized from its time,
    stopping at the cap with the best state so far."""
    world, rig, *_ = synth_ba_world(rng, n_frames=5, n_points=8000, noise_px=0.5)
    assert world.num_obs > 1 << 15
    world.points[: world.num_points] += rng.normal(
        0, 0.05, (world.num_points, 3)).astype(np.float32)
    stats = ba.BundleAdjuster(world, rig, BAConfig()).optimize(0, world.num_frames,
                                                                max_seconds=1e-3)
    assert stats["chunked"] and stats["iterations"] == 1
    assert stats["cost_final"] < stats["cost_initial"]


def _write_calib(path, rig):
    P_l, P_r = rig.left.projection.cpu().numpy(), rig.right.projection.cpu().numpy()
    with open(path, "w") as f:
        for name, P in (("P0", P_l), ("P1", P_r)):
            f.write(name + ": " + " ".join(f"{v:.9g}" for v in P.reshape(-1)) + "\n")


def test_refine_app_on_cpu_and_asks_for_the_card_by_default(tmp_path, rng):
    world, rig, gt_poses, _ = synth_ba_world(rng)
    perturb(world, rng)
    dump = str(tmp_path / "dump")
    export.dump_world(dump, world)
    calib = str(tmp_path / "calib.txt")
    _write_calib(calib, rig)
    args = ["--input_dir", dump, "--camera", calib, "--output_dir", str(tmp_path / "out")]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        stats = refine.main(args + ["--iterations", "30", "--device", "cpu"])
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert stats["cost_final"] < stats["cost_initial"] * 1e-2
    refined = export.read_poses_txt(str(tmp_path / "out" / "poses.txt"))
    assert np.abs(refined[:, :3, 3] - gt_poses[:, :3, 3]).max() < 0.03
    assert os.path.exists(tmp_path / "out" / "trajectory_refined.txt")
    if torch.cuda.is_available():
        return  # a card is present: the default runs there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        refine.main(args)


@pytest.mark.parametrize("num, shape", [(7, (6,)), (40, (6, 3)), (300, (42,))])
def test_segment_sum_adds_each_segment_in_index_order(rng, num, shape):
    """_seg_sum equals a CPU scatter-add (`index_add_`, which adds in index
    order) bit for bit, with the grouping given or computed, with empty
    segments and unsorted ids."""
    ids = torch.as_tensor(rng.integers(0, num, 500) // 2 * 2)
    x = torch.as_tensor(rng.normal(0, 1e3, (500,) + shape).astype(np.float32))
    want = x.new_zeros((num,) + shape).index_add_(0, ids, x)
    assert torch.equal(ba._seg_sum(x, ids, num), want)
    assert torch.equal(ba._seg_sum(x, ids, num, ba.segments(ids, num)), want)


def test_padded_rows_fall_in_no_real_segment(rng):
    """BundleAdjuster pads the observations to a power of two with weight-0
    rows at camera 0 and point 0. The matrix-free plan's segments leave
    them out of every real segment and deal them over segments of their
    own of at most SPREAD_ROWS rows (with them in, camera 0's and point 0's segments held every
    padded row, and on the card each sum took as long as that segment:
    1.6 s of device time an LM iteration on the long canyon drive's final
    BA), and the solve is bit for bit the one with them in."""
    world, rig, *_ = synth_ba_world(rng, n_frames=6, n_points=150, noise_px=0.5)
    setup, _ = flat_problem(world, rig)
    prob, C, P = setup.prob, setup.C_pad, setup.P_pad
    assert setup.O_pad - setup.num_obs > 100   # padded rows
    plan = ba._cam_reduction(prob, None, None)
    old = ba.SegmentPlan(ba.segments(prob.obs_cam, C), ba.segments(prob.obs_point, P))
    for ids, num, new, was in ((prob.obs_cam, C, plan.cams, old.cams),
                               (prob.obs_point, P, plan.points, old.points)):
        real = np.bincount(ids[: setup.num_obs].numpy(), minlength=num)
        assert torch.equal(torch.diff(new.offsets[: num + 1]), torch.as_tensor(real))
        assert int(torch.diff(was.offsets).max()) == real[0] + setup.O_pad - setup.num_obs
        assert int(torch.diff(new.offsets[num:]).max()) <= ba.SPREAD_ROWS
        assert int(new.offsets[num]) == setup.num_obs and int(new.offsets[-1]) == setup.O_pad
    cfg = BAConfig(cg_iterations=30)
    (got, n_got, _), (want, n_want, _) = (
        ba.ba_resume(ba.lm_init(prob, cfg, cam_red=red), 4, cfg, cam_red=red)
        for red in (plan, old))
    assert int(n_got) == int(n_want) == 4 and torch.equal(got.cost, want.cost)
    assert torch.equal(got.prob.pose6, want.prob.pose6)
    assert torch.equal(got.prob.points, want.prob.points)


@pytest.mark.cuda
def test_segment_sum_on_the_card_equals_the_cpu(rng):
    """On the card the segmented sum adds in the same order as on the CPU,
    so the two agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ids = torch.as_tensor(rng.integers(0, 1000, 200_000))
    x = torch.as_tensor(rng.normal(0, 1e3, (200_000, 6)).astype(np.float32))
    got = ba._seg_sum(x.cuda(), ids.cuda(), 1000).cpu()
    assert torch.equal(got, ba._seg_sum(x, ids, 1000))


@pytest.mark.cuda
def test_matrix_free_solve_repeats_on_the_card(rng):
    """Two matrix-free solves of the reference's banded problem on the card
    give the same poses, points and cost bit for bit: no reduction on the
    path adds in a varying order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, _, _ = banded_problem(rng, device="cuda")
    cfg = BAConfig(cg_iterations=50)
    (c1, n1, _), (c2, n2, _) = (ba.ba_solve(prob, 4, cfg) for _ in range(2))
    assert int(n1) == int(n2) == 4
    for a, b in ((c1.prob.pose6, c2.prob.pose6), (c1.prob.points, c2.prob.points),
                 (c1.cost, c2.cost)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_solve_matches_cpu(rng):
    """The reference's banded problem on the card and on the CPU, on the
    banded, dense and matrix-free paths. The first LM step's H_cc within
    1e-5 of the CPU's (largest difference over largest entry); after 4
    iterations the same count, pose6 within 1e-4, points within 2.5e-3,
    and the initial and final costs within rtol 1e-6. The bounds sit
    between the readings on an H100 of sound runs and of runs with TF32
    left on (chip_smoke.py phase 6b, PERF.md): H_cc 2.6e-6 against 4.9e-5,
    pose6 at most 5.6e-5 against at least 1.4e-4 and points at most 1.5e-3
    against at least 4.9e-3 on the dense and banded paths; the final cost,
    at most 3.7e-7 apart, does not move with TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, slots, plan = banded_problem(rng)
    bases, B, Pc = plan
    out = {}
    for dev in ("cpu", "cuda"):
        p = prob.to(dev)
        for path, kw in (("banded", dict(dense_K=8, band_bases=bases, band_B=B, band_Pc=Pc)),
                         ("dense", dict(dense_K=8)), ("matrix-free", {})):
            cfg = BAConfig(cg_iterations=50) if path == "matrix-free" else BAConfig()
            out[dev, path] = first_step(p, cfg, **kw)["H_cc"], ba.ba_solve(p, 4, cfg, **kw)
    for path in ("banded", "dense", "matrix-free"):
        (h_c, (cc, ic, c0c)), (h_g, (cg, ig, c0g)) = out["cpu", path], out["cuda", path]
        assert float((h_g.cpu() - h_c).abs().max() / h_c.abs().max()) <= 1e-5, path
        assert int(ic) == int(ig), path
        torch.testing.assert_close(cg.prob.pose6.cpu(), cc.prob.pose6, rtol=0, atol=1e-4)
        torch.testing.assert_close(cg.prob.points.cpu(), cc.prob.points, rtol=0, atol=2.5e-3)
        np.testing.assert_allclose(float(cg.cost), float(cc.cost), rtol=1e-6)
        np.testing.assert_allclose(float(c0g), float(c0c), rtol=1e-6)


@pytest.mark.cuda
def test_lm_loop_does_not_wait_for_the_card(rng):
    """On the card, the LM loop (dense, and matrix-free with and without a
    segment plan) launches all its iterations without a host sync: the exit is masked on the device and
    the iteration count stays there (sync debug mode "error" raises on any
    sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, _, _ = banded_problem(rng, device="cuda")
    slots = ba.build_slots_device(prob.obs_point, prob.obs_cam, prob.obs_weight,
                                  prob.points.shape[0], 8)
    cam_red = ba._cam_reduction(prob, slots, None)
    mf = BAConfig(cg_iterations=20, function_tolerance=1e-3)
    for cfg, kw in ((BAConfig(function_tolerance=1e-3), dict(dense_slots=slots, cam_red=cam_red)),
                    (mf, {}), (mf, dict(cam_red=ba._cam_reduction(prob, None, None)))):
        carry = ba.lm_init(prob, cfg, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry, n_it, _ = ba.ba_resume(carry, 6, cfg, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert 1 <= int(n_it) <= 6
        assert torch.isfinite(carry.prob.pose6).all()

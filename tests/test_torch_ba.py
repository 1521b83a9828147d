"""The port's bundle adjustment against the JAX package's, on the CPU.

The same problems, made with numpy from a seed (`tests/test_ba.py`'s
synthetic worlds: 5-6 frames, 100-150 points, and random block systems),
go through the JAX functions and their counterparts in the port. The JAX
side runs as its package runs it (jitted, on the CPU). Tolerances, stated
where used:

- integer maps (slot maps, camera-run maps): equal;
- the Schur assembly (dense and banded), against JAX and against an
  explicit NumPy S = H_cc - W H_pp^-1 W^T: rtol 1e-4 of S's largest entry;
- the 3x3 / 6x6 inverses, the Cholesky solve and PCG: rtol 1e-4 of the
  result's largest entry (float32 eliminations in another order);
- one LM iteration: the same accept decision, costs within rtol 1e-4;
- whole solves (`ba_solve`, `BundleAdjuster.optimize`, the refine app):
  equal iteration counts, pose6 within 1e-4, points within 1e-3, cost
  within rtol 1e-3.

The solves stop before float32 noise decides accept steps: near the
minimum a step changes the cost by about one float32 ulp, and the two
packages' rounding then accept different steps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_ba import _flat_prob_from_world, synth_ba_world  # noqa: E402

from stereo_orb_slam_tpu.apps import refine as jrefine  # noqa: E402
from stereo_orb_slam_tpu.backend import ba as jba  # noqa: E402
from stereo_orb_slam_tpu.backend import schur_dense as jsd  # noqa: E402
from stereo_orb_slam_tpu.config import BAConfig as JBAConfig  # noqa: E402
from stereo_orb_slam_tpu.io import checkpoint as jcheckpoint  # noqa: E402
from stereo_orb_slam_tpu.io import export as jexport  # noqa: E402
from stereo_orb_slam_tpu.utils import cache as jcache  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import refine as trefine  # noqa: E402
from stereo_orb_slam_torch.backend import ba as tba  # noqa: E402
from stereo_orb_slam_torch.backend import schur_dense as tsd  # noqa: E402
from stereo_orb_slam_torch.config import BAConfig  # noqa: E402
from stereo_orb_slam_torch.io import checkpoint as tcheckpoint  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close_to_max(got, want, rtol):
    want = np_(want)
    np.testing.assert_allclose(np_(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def port_world(world) -> WorldMap:
    """The port's WorldMap holding copies of a JAX-package WorldMap's
    arrays (the two classes share their fields)."""
    out = WorldMap.__new__(WorldMap)
    out.__dict__.update({k: v.copy() if isinstance(v, np.ndarray) else v
                         for k, v in vars(world).items()})
    return out


def perturbed_world(rng, n_frames=5, n_points=120, pose_sigma=0.05, point_sigma=0.1,
                    noise_px=0.5):
    """A synthetic world with pixel noise (so the minimum's cost is well
    above zero) and perturbed poses (all but frame 0) and points."""
    world, rig, gt_poses, pts_gt = synth_ba_world(rng, n_frames=n_frames, n_points=n_points,
                                                  noise_px=noise_px)
    for i in range(1, world.num_frames):
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = rng.normal(size=3) * pose_sigma
        world.pose_global[i] = world.pose_global[i] @ d
    world.points[: world.num_points] += rng.normal(
        0, point_sigma, (world.num_points, 3)).astype(np.float32)
    return world, rig, gt_poses, pts_gt


@pytest.fixture(scope="module")
def noisy_problem():
    """tests/test_ba.py's LM-loop world: 0.8 px noise, perturbed points,
    as a padded point-sorted BAProblem in both packages."""
    rng = np.random.default_rng(0)
    world, rig, *_ = synth_ba_world(rng, n_frames=5, n_points=100, noise_px=0.8)
    world.points[: world.num_points] += rng.normal(
        0, 0.15, (world.num_points, 3)).astype(np.float32)
    adj = jba.BundleAdjuster(world, rig)
    _, flat, n_obs, P_pad = _flat_prob_from_world(world, adj)
    _, _, _, K = jsd.group_slots(np.asarray(flat.obs_point)[:n_obs],
                                 np.asarray(flat.obs_cam)[:n_obs], P_pad, n_obs)
    return flat, convert.ba_problem_from_numpy(flat, "cpu"), K


# ------------------------------------------------------------------ configs
def test_ba_config_is_the_jax_config():
    assert convert.ba_config_from(JBAConfig()) == BAConfig()
    cfg = JBAConfig(max_iterations=7, cg_tol=1e-9, banded_schur=False)
    assert convert.ba_config_from(cfg) == BAConfig(max_iterations=7, cg_tol=1e-9,
                                                   banded_schur=False)
    # The port has no bfloat16 assembly: a config asking for it is refused.
    with pytest.raises(ValueError, match="dense_assemble_bf16"):
        convert.ba_config_from(JBAConfig(dense_assemble_bf16=True))


# --------------------------------------------------------------- slot maps
def _sorted_obs(rng, n_pts=37, n_obs=200, O_pad=256, n_cams=9):
    obs_point = np.zeros(O_pad, np.int32)
    obs_cam = np.zeros(O_pad, np.int32)
    obs_w = np.zeros(O_pad, np.float32)
    obs_point[:n_obs] = np.sort(rng.integers(0, n_pts, n_obs))
    obs_cam[:n_obs] = rng.integers(0, n_cams, n_obs)
    obs_w[:n_obs] = 1.0
    return obs_point, obs_cam, obs_w, n_obs


def test_group_slots_equal_jax(rng):
    obs_point, obs_cam, _, n_obs = _sorted_obs(rng)
    want = jsd.group_slots(obs_point[:n_obs], obs_cam[:n_obs], 64, n_obs)
    got = tsd.group_slots(obs_point[:n_obs], obs_cam[:n_obs], 64, n_obs)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)


def test_build_slots_device_equal_jax(rng):
    obs_point, obs_cam, obs_w, n_obs = _sorted_obs(rng)
    K = jsd.group_slots(obs_point[:n_obs], obs_cam[:n_obs], 64, n_obs)[3]
    want = jba.build_slots_device(jnp.asarray(obs_point), jnp.asarray(obs_cam),
                                  jnp.asarray(obs_w), 64, K)
    got = tba.build_slots_device(torch.from_numpy(obs_point).long(),
                                 torch.from_numpy(obs_cam).long(),
                                 torch.from_numpy(obs_w), 64, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np_(w))


def test_build_cam_slots_device_equal_jax(rng):
    obs_point, obs_cam, obs_w, n_obs = _sorted_obs(rng)
    kc = 1 << (int(np.bincount(obs_cam[:n_obs]).max()) - 1).bit_length()
    want = jba.build_cam_slots_device(jnp.asarray(obs_cam), jnp.asarray(obs_w), 12, kc)
    got = tba.build_cam_slots_device(torch.from_numpy(obs_cam).long(),
                                     torch.from_numpy(obs_w), 12, kc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np_(w))


# ------------------------------------------------------------ Schur system
def _track_local_system(rng, C=64, P=2048):
    """A random reduced-system input on a track-local layout (each point
    seen by up to 6 consecutive cameras, point ids in camera order), so the
    band plan is feasible: H_cc blocks SPD, H_pp^-1 blocks SPD, W random."""
    c0 = (np.arange(P) * C // P).astype(np.int32)
    tlen = np.minimum(rng.integers(1, 7, P), C - c0)
    obs_point = np.repeat(np.arange(P, dtype=np.int32), tlen)
    obs_cam = (np.repeat(c0, tlen) + np.concatenate([np.arange(t) for t in tlen])).astype(np.int32)
    O = len(obs_point)
    A = rng.normal(size=(C, 6, 6))
    H_cc = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    Bm = rng.normal(size=(P, 3, 3))
    Hpp_inv = (Bm @ Bm.transpose(0, 2, 1) / 3 + 0.1 * np.eye(3)).astype(np.float32)
    W = rng.normal(0, 0.3, (O, 6, 3)).astype(np.float32)
    cam_mask = np.ones(C, np.float32)
    cam_mask[0] = 0.0
    return obs_point, obs_cam, H_cc, Hpp_inv, W, cam_mask


def _explicit_schur(obs_point, obs_cam, H_cc, Hpp_inv, W, cam_mask):
    """S = H_cc - sum_p (sum_o in p W_o) ... built pair by pair in float64,
    then put in the IC order with fixed cameras pinned."""
    C = H_cc.shape[0]
    S = np.zeros((C, 6, C, 6))
    for c in range(C):
        S[c, :, c, :] += H_cc[c]
    W64, M64 = W.astype(np.float64), Hpp_inv.astype(np.float64)
    starts = np.searchsorted(obs_point, np.arange(len(Hpp_inv)))
    ends = np.searchsorted(obs_point, np.arange(len(Hpp_inv)), side="right")
    for p, (lo, hi) in enumerate(zip(starts, ends)):
        for a in range(lo, hi):
            for b in range(lo, hi):
                S[obs_cam[a], :, obs_cam[b], :] -= W64[a] @ M64[p] @ W64[b].T
    S_ic = S.transpose(1, 0, 3, 2).reshape(6 * C, 6 * C)
    m = np.tile(cam_mask, 6)
    return S_ic * m[:, None] * m[None, :] + np.diag(1.0 - m)


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_assemble_schur_matches_jax_and_numpy(rng, banded):
    obs_point, obs_cam, H_cc, Hpp_inv, W, cam_mask = _track_local_system(rng)
    C, P, O = len(H_cc), len(Hpp_inv), len(W)
    sto, scam, smask, K = jsd.group_slots(obs_point, obs_cam, P, O)
    Wg = (W.reshape(O, 18)[sto] * smask[..., None]).reshape(P, K, 6, 3)
    t = dict(H_cc=torch.from_numpy(H_cc), Hpp_inv=torch.from_numpy(Hpp_inv),
             scam=torch.from_numpy(scam).long(), smask=torch.from_numpy(smask),
             cam_mask=torch.from_numpy(cam_mask), Wg=torch.from_numpy(Wg))
    if banded:
        plan = jsd.band_plan(obs_point, obs_cam, P, O, C, K)
        assert plan is not None and plan[1] < C
        assert tsd.band_plan(obs_point, obs_cam, P, O, C, K) is not None
        bases, B, Pc = plan
        np.testing.assert_array_equal(tsd.band_plan(obs_point, obs_cam, P, O, C, K)[0], bases)
        want = jsd.assemble_schur_banded(jnp.asarray(H_cc), jnp.asarray(Hpp_inv),
                                         jnp.asarray(scam), jnp.asarray(smask),
                                         jnp.asarray(cam_mask), jnp.asarray(Wg),
                                         jnp.asarray(bases), B, Pc)
        got = tsd.assemble_schur_banded(t["H_cc"], t["Hpp_inv"], t["scam"], t["smask"],
                                        t["cam_mask"], t["Wg"], bases, B, Pc)
    else:
        want = jsd.assemble_schur(jnp.asarray(H_cc), jnp.asarray(W), jnp.asarray(Hpp_inv),
                                  jnp.asarray(sto), jnp.asarray(scam), jnp.asarray(smask),
                                  jnp.asarray(cam_mask))
        got = tsd.assemble_schur(t["H_cc"], torch.from_numpy(W), t["Hpp_inv"],
                                 torch.from_numpy(sto).long(), t["scam"], t["smask"],
                                 t["cam_mask"])
    # rtol 1e-4 of S's largest entry.
    close_to_max(got, want, 1e-4)
    close_to_max(got, _explicit_schur(obs_point, obs_cam, H_cc, Hpp_inv, W, cam_mask), 1e-4)


def _spd(rng, n, k, ridge):
    A = rng.normal(size=(n, k, k))
    return (A @ A.transpose(0, 2, 1) + ridge * np.eye(k)).astype(np.float32)


def test_block_inverses_and_cholesky_match_jax(rng):
    # rtol 1e-4 of each result's largest entry.
    A3, A6 = _spd(rng, 64, 3, 0.5), _spd(rng, 64, 6, 1.0)
    close_to_max(tba._inv3(torch.from_numpy(A3)), jba._inv3(jnp.asarray(A3)), 1e-4)
    close_to_max(tba._inv6_gj(torch.from_numpy(A6)), jba._inv6_gj(jnp.asarray(A6)), 1e-4)
    close_to_max(tba._inv6_gj(torch.from_numpy(A6)), np.linalg.inv(A6.astype(np.float64)), 1e-4)

    C = 24
    S = _spd(rng, 1, 6 * C, 6 * C)[0]
    b = rng.normal(size=(C, 6)).astype(np.float32)
    mask = np.ones(C, np.float32)
    mask[:2] = 0.0
    m = np.tile(mask, 6)
    S = S * m[:, None] * m[None, :] + np.diag(1.0 - m)
    want = jsd.solve_reduced_chol(jnp.asarray(S), jnp.asarray(b), jnp.asarray(mask))
    got = tsd.solve_reduced_chol(torch.from_numpy(S), torch.from_numpy(b),
                                 torch.from_numpy(mask))
    close_to_max(got, want, 1e-4)


def test_pcg_matches_jax(rng):
    C = 16
    S = _spd(rng, 1, 6 * C, 6 * C)[0].astype(np.float64)
    S = (S / np.abs(S).max()).astype(np.float32)
    blocks = np.stack([S[6 * c:6 * c + 6, 6 * c:6 * c + 6] for c in range(C)])
    M_inv = np.linalg.inv(blocks.astype(np.float64)).astype(np.float32)
    b = rng.normal(size=(C, 6)).astype(np.float32)
    for iters, tol in ((8, 1e-6), (200, 1e-5)):  # cut by the count, then by tol
        want = jba.pcg(lambda x: (jnp.asarray(S) @ x.reshape(-1)).reshape(C, 6),
                       jnp.asarray(b), jnp.asarray(M_inv), iters, tol)
        got = tba.pcg(lambda x: (torch.from_numpy(S) @ x.reshape(-1)).reshape(C, 6),
                      torch.from_numpy(b), torch.from_numpy(M_inv), iters, tol)
        close_to_max(got, want, 1e-4)
    close_to_max(got, np.linalg.solve(S.astype(np.float64), b.reshape(-1)).reshape(C, 6), 1e-3)


# -------------------------------------------------------------- LM and solves
@pytest.mark.parametrize("path", ["matrix-free", "dense"])
def test_lm_iterations_match_jax(noisy_problem, path):
    flat, tprob, K = noisy_problem
    cfg = JBAConfig(cg_iterations=200, cg_tol=1e-12)
    tcfg = convert.ba_config_from(cfg)
    jslots = tslots = None
    if path == "dense":
        jslots = jba.build_slots_device(flat.obs_point, flat.obs_cam, flat.obs_weight,
                                        flat.points.shape[0], K)
        tslots = tba.build_slots_device(tprob.obs_point, tprob.obs_cam, tprob.obs_weight,
                                        tprob.points.shape[0], K)
    jc = jba.lm_init(flat, cfg, dense_slots=jslots)
    tc = tba.lm_init(tprob, tcfg, dense_slots=tslots)
    np.testing.assert_allclose(float(tc.cost), float(jc.cost), rtol=1e-4)
    for _ in range(4):  # the first four steps: well above float32 noise
        jc, jacc, j0, j1 = jba.lm_iteration(jc, cfg, dense_slots=jslots)
        tc, tacc, t0, t1 = tba.lm_iteration(tc, tcfg, dense_slots=tslots)
        assert bool(tacc) == bool(jacc)
        np.testing.assert_allclose(float(t0), float(j0), rtol=1e-4)
        np.testing.assert_allclose(float(t1), float(j1), rtol=1e-4)


@pytest.mark.parametrize("path", ["matrix-free", "dense"])
def test_ba_solve_matches_jax(noisy_problem, path):
    flat, tprob, K = noisy_problem
    cfg = JBAConfig(cg_iterations=100)
    kw = {"dense_K": K} if path == "dense" else {}
    jc, jit, jc0 = jba.ba_solve(flat, jnp.int32(6), cfg, **kw)
    tc, tit, tc0 = tba.ba_solve(tprob, 6, convert.ba_config_from(cfg), **kw)
    assert tit == int(jit) == 6
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-3)
    np.testing.assert_allclose(float(tc.cost), float(jc.cost), rtol=1e-3)
    np.testing.assert_allclose(np_(tc.prob.pose6), np_(jc.prob.pose6), atol=1e-4)
    np.testing.assert_allclose(np_(tc.prob.points), np_(jc.prob.points), atol=1e-3)


@pytest.mark.parametrize("path", ["matrix-free", "dense"])
def test_schur_float64_solves_the_float32_normal_equations_in_float64(noisy_problem, path):
    """With `float64` (a short-baseline rig's, `marginalize_in_float64`) a
    windowed step is the float64 solve of the float32 normal equations (the
    same step computed with every input cast to float64), handed back in
    float32; the matrix-free path is as without it."""
    _, tprob, K = noisy_problem
    cfg = BAConfig()
    slots = cam_red = None
    if path == "dense":
        slots = tba.build_slots_device(tprob.obs_point, tprob.obs_cam, tprob.obs_weight,
                                       tprob.points.shape[0], K)
        cam_red = tba._cam_reduction(tprob, slots, None, False)
    H_cc, H_pp, W, b_c, b_p, _, Wg = tba.build_normal_equations(tprob, cfg.huber_delta, slots,
                                                                cam_red)
    lam = torch.tensor(1e-3)
    eqs = (H_cc, H_pp, W, b_c, b_p, lam)
    got = tba._solve_lm(tprob, *eqs, cfg, slots, cam_red, Wg, float64=True)
    assert all(x.dtype == torch.float32 for x in got)
    if path == "matrix-free":
        for a, b in zip(got, tba._solve_lm(tprob, *eqs, cfg, slots, cam_red, Wg)):
            assert torch.equal(a, b)
        return
    prob64 = tba.BAProblem(*(t.double() if t.is_floating_point() else t for t in tprob))
    want = tba._solve_lm(prob64, *(x.double() for x in eqs), cfg, slots, cam_red,
                         Wg.double())
    for a, b, x0 in zip(got, want, (tprob.pose6, tprob.points)):
        # The float64 step, added to the float32 start: within one float32
        # rounding of the float64 sum.
        np.testing.assert_allclose(np_(a - x0), np_(b - x0.double()), rtol=0,
                                   atol=2 ** -23 * float(b.abs().max()))


def test_ba_resume_chunks_match_single_solve(noisy_problem):
    _, tprob, _ = noisy_problem
    cfg = BAConfig(cg_iterations=30)
    single, n_single, cost0 = tba.ba_solve(tprob, 9, cfg)
    carry = tba.lm_init(tprob, cfg)
    total = 0
    for chunk in (4, 4, 4):
        carry, k, conv = tba.ba_resume(carry, min(chunk, 9 - total), cfg)
        total += k
        if conv or total >= 9:
            break
    assert total == n_single
    torch.testing.assert_close(carry.prob.pose6, single.prob.pose6, rtol=0, atol=0)
    torch.testing.assert_close(carry.cost, single.cost, rtol=0, atol=0)


def _optimize_both(world, rig, cfg, start, end):
    tworld = port_world(world)
    jstats = jba.BundleAdjuster(world, rig, cfg).optimize(start, end)
    tadj = tba.BundleAdjuster(tworld, convert.rig_from_numpy(rig, "cpu"),
                              convert.ba_config_from(cfg))
    tstats = tadj.optimize(start, end)
    return jstats, tstats, tworld


@pytest.mark.parametrize("window", ["all", "per_frame"])
def test_bundle_adjuster_optimize_matches_jax(rng, window):
    world, rig, *_ = perturbed_world(rng)
    n = world.num_frames
    start, end = (0, n) if window == "all" else (n - 1, n)
    cfg = JBAConfig(max_iterations=6)
    jstats, tstats, tworld = _optimize_both(world, rig, cfg, start, end)
    # 5 cameras span more than half the padded 6: dense; one camera: banded.
    assert tstats["path"] == ("dense" if window == "all" else "banded")
    for key in ("iterations", "num_cams", "num_points", "num_obs"):
        assert tstats[key] == jstats[key], key
    for key in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-3)
    # World poses within 1e-4 (entries of the camera-to-world matrices).
    np.testing.assert_allclose(tworld.pose_global[:n], world.pose_global[:n], atol=1e-4)
    np.testing.assert_allclose(tworld.points[: world.num_points],
                               world.points[: world.num_points], atol=1e-3)


def test_checkpoint_restore_matches_jax(tmp_path, rng):
    world, *_ = perturbed_world(rng)
    jexport.dump_world(str(tmp_path), world)
    want = jcheckpoint.restore_world(str(tmp_path))
    got = tcheckpoint.restore_world(str(tmp_path))
    assert sorted(vars(got)) == sorted(vars(want))
    for k, v in vars(want).items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    tcheckpoint.save_npz(str(tmp_path / "w.npz"), got)
    back = tcheckpoint.load_npz(str(tmp_path / "w.npz"))
    for k in ("pose_global", "points", "obs_frame", "obs_point", "obs_uv"):
        np.testing.assert_array_equal(getattr(back, k)[:5], getattr(got, k)[:5], err_msg=k)


def test_refine_app_matches_jax(tmp_path, rng, monkeypatch):
    world, rig, *_ = perturbed_world(rng)
    dump = str(tmp_path / "dump")
    jexport.dump_world(dump, world)
    calib_path = str(tmp_path / "calib.txt")
    P_l, P_r = np.asarray(rig.left.projection), np.asarray(rig.right.projection)
    with open(calib_path, "w") as f:
        for name, P in (("P0", P_l), ("P1", P_r)):
            f.write(name + ": " + " ".join(f"{v:.9g}" for v in P.reshape(-1)) + "\n")
    # The JAX CLI would point XLA's persistent compile cache at the repo.
    monkeypatch.setattr(jcache, "_enabled", True)
    args = ["--input_dir", dump, "--camera", calib_path, "--iterations", "6"]
    jrefine.main(args + ["--output_dir", str(tmp_path / "jax")])
    stats = trefine.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["iterations"] == 6 and stats["cost_final"] < stats["cost_initial"]
    want = jcheckpoint.restore_world(str(tmp_path / "jax"))
    got = tcheckpoint.restore_world(str(tmp_path / "port"))
    n = want.num_frames
    np.testing.assert_allclose(got.pose_global[:n], want.pose_global[:n], atol=1e-4)
    np.testing.assert_allclose(got.points[: want.num_points], want.points[: want.num_points],
                               atol=1e-3)
    assert os.path.exists(tmp_path / "port" / "trajectory_refined.txt")

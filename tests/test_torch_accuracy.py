"""Port parity on the accuracy harness of tests/test_accuracy.py, on the CPU.

The same `CloudScene` frames (forward + yaw motion, depth-varying
landmarks, 240 px focal length, 0.6 m baseline) go through the JAX
package and the port, at the reference tests' sizes and configs:

- VO over 20 frames (128 features, `RansacConfig(final_model_fitting=True)`):
  with its own draws the port meets the reference gates (ATE < 0.35 m,
  rotation RPE < 0.02 rad, estimated yaw > 15 degrees, at most 2 RANSAC
  failures);
- VO over 14 frames with sensor noise sigma 3 and the reference test's
  relaxed gates (48 / 0.65, min_pairs 8): ATE < 0.35 m, at most 3 failures;
- with the JAX package's draws injected (frame i takes the minimal sets of
  fold_in(key(0), i)), both VO runs give per-frame counts identical to the
  JAX package's and poses within POSE_ATOL (tests/test_torch_realism.py);
- SlamSystem with per-frame, window and final BA over 24 frames (refine
  interval 8, no vocabulary), the port under the JAX package's draws: ATE
  < 0.15 m; with the JAX package's run beside it (marked slow, as the
  reference test is), ATE < 0.15 m for both and the poses within POSE_ATOL;
- the pose-graph closure of test_pose_graph_closure_reduces_ate: odometry
  with an injected 1 degree yaw bias and noise over a 60-frame circuit, one
  true loop edge; the port's PoseGraphOptimizer cuts ATE at least 3x, and
  its poses agree with the JAX optimizer's within PG_POSE_ATOL.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import CloudScene, forward_yaw_trajectory  # noqa: E402
from synth_canyon import make_rig  # noqa: E402
from test_torch_realism import POSE_ATOL, jax_sampler_for_frame, vo_runs  # noqa: E402

from stereo_orb_slam_tpu.apps import slam as jslam  # noqa: E402
from stereo_orb_slam_tpu.backend.pose_graph import PoseGraphOptimizer as JPGO  # noqa: E402
from stereo_orb_slam_tpu.config import (  # noqa: E402
    FrontendConfig as JFE, PoseGraphConfig as JPG, RansacConfig as JRC, SlamConfig as JSlam,
)
from stereo_orb_slam_tpu.worldmap import WorldMap as JWorld  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import slam as tslam  # noqa: E402
from stereo_orb_slam_torch.backend.pose_graph import PoseGraphOptimizer  # noqa: E402
from stereo_orb_slam_torch.config import PoseGraphConfig  # noqa: E402
from stereo_orb_slam_torch.utils import evaluate  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
# The closure graph's solves in the two packages: measured 1.4e-6 m and
# 4.8e-7 in the rotation entries. Converged float32 solves of other graphs
# sat up to 1.2 mm apart (ROADMAP queue 3, settled), so the bound leaves
# room for float32 noise without hiding a wrong solve (the drift is 0.3 m).
PG_POSE_ATOL = 1e-4


def _scene(n_frames, noise_sigma=0.0):
    traj = forward_yaw_trajectory(n_frames, speed=0.25, yaw_rate_deg=1.5)
    scene = CloudScene(np.random.default_rng(1), traj, fx=240.0, baseline=0.6,
                       depth_range=(4.0, 14.0), n_per_anchor=40, anchor_stride=4,
                       noise_sigma=noise_sigma)
    return traj, scene


@functools.lru_cache(maxsize=None)
def accuracy_runs(name):
    if name == "forward_yaw":
        traj, scene = _scene(20)
        fe_kw, rc_kw = dict(num_features=128), dict(final_model_fitting=True)
    else:
        traj, scene = _scene(14, noise_sigma=3.0)
        fe_kw = dict(num_features=128, match_max_distance=48, match_ratio=0.65)
        rc_kw = dict(final_model_fitting=True, min_pairs=8)
    return traj, vo_runs(scene, traj, fe_kw, rc_kw)


@pytest.mark.parametrize("who", ["own", "jax"])
def test_vo_forward_yaw_ate(who):
    traj, runs = accuracy_runs("forward_yaw")
    r = runs[who]
    assert r["frames"] == 20
    assert r["fails"] <= 2
    est = r["poses"]
    t_rpe, r_rpe = evaluate.rpe(est, traj[: r["frames"]])
    assert r["ate"] < 0.35, r["ate"]
    assert r_rpe < 0.02, r_rpe
    yaw = np.arctan2(est[-1][0, 2], est[-1][2, 2])
    assert np.degrees(yaw) > 15.0


@pytest.mark.parametrize("who", ["own", "jax"])
def test_vo_image_noise(who):
    _, runs = accuracy_runs("noise")
    r = runs[who]
    assert r["frames"] == 14
    assert r["fails"] <= 3
    assert r["ate"] < 0.35, r["ate"]


@pytest.mark.parametrize("name", ["forward_yaw", "noise"])
def test_vo_with_jax_draws_matches_the_reference(name):
    _, runs = accuracy_runs(name)
    ref, got = runs["jax"], runs["jax_draws"]
    assert got["counts"] == ref["counts"]
    assert got["fails"] == ref["fails"]
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("packages", [
    "port", pytest.param("both", marks=pytest.mark.slow)])
def test_slam_ba_forward_yaw_ate(packages):
    """Full SLAM (per-frame + windowed + final BA) over 24 frames, the port
    under the JAX package's draws: ATE < 0.15 m (measured 0.0631 m). The
    `both` case (slow: the JAX package's BA compiles take about 45 s on a
    CPU, the port's run about 16 s) also runs the JAX package's SlamSystem:
    ATE < 0.15 m, and the two trajectories within POSE_ATOL (measured
    2.8e-5 m)."""
    traj, scene = _scene(24)
    frames = scene.render_sequence(traj)
    jcfg = JSlam().replace(frontend=JFE(num_features=128),
                           ransac=JRC(final_model_fitting=True), refine_interval=8)
    cfg = convert.slam_config_from(jcfg)
    systems = [tslam.SlamSystem(make_rig(scene, "cpu"), cfg, vocab=None,
                                vocab_train_frames=10 ** 9,
                                sampler_for_frame=jax_sampler_for_frame(
                                    0, cfg.ransac.num_hypotheses))]
    if packages == "both":
        systems.append(jslam.SlamSystem(scene.make_rig(), jcfg, vocab=None,
                                        vocab_train_frames=10 ** 9))
    for il, ir in frames:
        for system in systems:
            system.process(il, ir)
    for system in systems:
        system.finish()
        w = system.world
        assert w.num_frames == 24
        ate = evaluate.ate_rmse(w.pose_global[: w.num_frames], traj[: w.num_frames])
        assert ate < 0.15, ate
    if packages == "both":
        np.testing.assert_allclose(systems[0].world.pose_global[:24],
                                   systems[1].world.pose_global[:24], rtol=0, atol=POSE_ATOL)


def _drifted_worlds(n=60, seed=7):
    """test_pose_graph_closure_reduces_ate's odometry: a 60-frame circuit,
    each relative pose with a 1 degree yaw bias and 4 mm of translation
    noise, in a JAX package world and a port world alike."""
    rng = np.random.default_rng(seed)
    traj = forward_yaw_trajectory(n, speed=0.35, yaw_rate_deg=6.0)
    c, s = np.cos(np.deg2rad(1.0)), np.sin(np.deg2rad(1.0))
    R_bias = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    worlds = (JWorld(), WorldMap())
    for i in range(n):
        if i == 0:
            rel = np.eye(4, dtype=np.float32)
        else:
            rel = (np.linalg.inv(traj[i - 1]) @ traj[i]).astype(np.float32)
            rel[:3, :3] = rel[:3, :3] @ R_bias
            rel[:3, 3] += rng.normal(0, 0.004, 3).astype(np.float32)
        for w in worlds:
            w.add_frame(rel)
    return traj, worlds


def test_pose_graph_closure_reduces_ate():
    """One true loop edge (first <-> last) cuts the drifted ATE at least 3x
    in the port, and the port's optimized poses agree with the JAX
    optimizer's on the same world within PG_POSE_ATOL (ATE 0.0114 m after,
    in both)."""
    n = 60
    traj, (jworld, world) = _drifted_worlds(n)
    np.testing.assert_array_equal(world.pose_global[:n], jworld.pose_global[:n])
    ate_before = evaluate.ate_rmse(world.pose_global[:n], traj)
    assert ate_before > 0.3
    Z_true = (np.linalg.inv(traj[n - 1]) @ traj[0]).astype(np.float32)
    pgo = PoseGraphOptimizer(world, PoseGraphConfig(),
                             loop_matcher=lambda src, dst: (Z_true, True), device="cpu")
    pgo.add_loop_edge(0, n - 1)
    stats = pgo.optimize(run_global_ba=False)
    assert stats["num_loop_edges"] == 1
    assert stats["cost_final"] < stats["cost_initial"]
    ate_after = evaluate.ate_rmse(world.pose_global[:n], traj)
    assert ate_after < ate_before / 3.0, (ate_before, ate_after)

    jpgo = JPGO(jworld, JPG(), loop_matcher=lambda src, dst: (Z_true, True))
    jpgo.add_loop_edge(0, n - 1)
    jpgo.optimize(run_global_ba=False)
    gap = np.abs(world.pose_global[:n, :3, 3] - jworld.pose_global[:n, :3, 3]).max()
    assert gap < PG_POSE_ATOL, gap
    np.testing.assert_allclose(world.pose_global[:n, :3, :3], jworld.pose_global[:n, :3, :3],
                               rtol=0, atol=PG_POSE_ATOL)

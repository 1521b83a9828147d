"""Port parity on the realistic scenes of tests/test_realism.py, on the CPU.

The same rendered frames go through the JAX package's VisualOdometer and
the port's, at the reference tests' sizes and configs (320x480; the
reference matching gates 30 / 0.5; `RansacConfig(final_model_fitting=True,
min_pairs=8)`):

- `canyon`: CanyonScene, sensor noise sigma 1.5, exposure drift 0.1, 384
  features, 12 frames of forward + yaw motion (gates: at most 1 RANSAC
  failure, ATE < 0.25 m);
- `canyon_heavy`: sigma 3, drift 0.15, 768 features (at most 2 failures,
  ATE < 0.25 m);
- `cloud_warped`: CloudScene with tilted planar patches, drift 0.1 and
  near-field occluders, 384 features, 14 frames (at most 1 failure, ATE <
  0.3 m).

With its own RANSAC draws the port meets each reference gate. With the JAX
package's draws injected (frame i takes the minimal sets of
fold_in(key(0), i), the JAX VisualOdometer's own), the per-frame stereo,
temporal and inlier counts are identical and every pose agrees within
POSE_ATOL: 2e-4 m, a few float32 Horn refits (sums in another order)
chained over 12-14 frames (measured 6.3e-5 on the canyon).

Also: the cv2.ORB recall parity of test_orb_cv2_recall_parity_on_canyon
with the port's descriptors (within 5 % of cv2's, within 1e-3 of the JAX
package's), and the canyon loop of test_canyon_full_slam_loop_closure in
miniature through the port's SLAM CLI on the CPU (320x480, 384 features,
one circuit of a 3 m square and its revisit, the canyon drive's flags):
the loop filter fires, a loop edge is committed, ATE < 0.08 m after finish
and not above the live ATE + 0.02 m. Its finish budget is 20 s, not the
drive's 150 s: the capped global BA takes what it is given on a CPU
(measured ATE 0.0224 m in 82 s against 0.0244 m in 198 s).
`tests/synth_canyon.py` (JAX-free) writes that tree with a pool of
processes; a test holds its PNGs to the drive's sequential render.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import CanyonScene, CloudScene, forward_yaw_trajectory  # noqa: E402
from synth_canyon import (  # noqa: E402
    CANYON, CANYON_FLAGS, loop_events, make_rig, make_scene, render_tree, two_episode_trajectory,
    write_kitti,
)

from stereo_orb_slam_tpu.config import FrontendConfig as JFE, RansacConfig as JRC  # noqa: E402
from stereo_orb_slam_tpu.frontend.odometer import VisualOdometer as JVO  # noqa: E402
from stereo_orb_slam_tpu.worldmap import WorldMap as JWorld  # noqa: E402
from stereo_orb_slam_torch.config import FrontendConfig, LoopConfig, RansacConfig  # noqa: E402
from stereo_orb_slam_torch.frontend import ransac as pransac  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.utils import evaluate  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
POSE_ATOL = 2e-4
REF_GATES = dict(match_max_distance=30, match_ratio=0.5)
RC_KW = dict(final_model_fitting=True, min_pairs=8)


def jax_sampler_for_frame(seed, num_hypotheses):
    """sampler_for_frame(i) drawing the JAX package's minimal sets of
    fold_in(key(seed), i)."""
    base = jax.random.key(seed)

    def sampler_for(i):
        # `_sample_minimal_sets` draws jax.random.gumbel(key, (K, N)); the
        # port takes the same top 3 (ties as lax.top_k breaks them).
        key = jax.random.fold_in(base, i)
        return pransac.KeyedSampler(lambda n, device: torch.from_numpy(
            np.array(jax.random.gumbel(key, (num_hypotheses, n)))).to(device))
    return sampler_for


def run_vo(package, scene, frames, fe_kw, rc_kw, jax_draws=False):
    """One package's VisualOdometer (seed 0) over `frames`: per-frame counts
    (stereo, temporal, inliers), RANSAC failures and the world's poses."""
    if package == "jax":
        fe, rc = JFE(**fe_kw), JRC(**rc_kw)
        world = JWorld(feat_slots=fe.num_features)
        vo = JVO(world, scene.make_rig(), fe, rc, seed=0)
    else:
        fe, rc = FrontendConfig(**fe_kw), RansacConfig(**rc_kw)
        world = WorldMap(feat_slots=fe.num_features)
        sampler = jax_sampler_for_frame(0, rc.num_hypotheses) if jax_draws else None
        vo = VisualOdometer(world, make_rig(scene, "cpu"), fe, rc, seed=0,
                            sampler_for_frame=sampler)
    counts, fails = [], 0
    for il, ir in frames:
        vo.track(il, ir)
        fails += not vo.success
        r = vo.last_result
        counts.append((int(r.num_stereo), int(r.num_temporal), int(r.num_inliers)))
    return {"counts": counts, "fails": fails, "frames": world.num_frames,
            "poses": world.pose_global[: world.num_frames].copy()}


def vo_runs(scene, traj, fe_kw, rc_kw):
    """The JAX package's run, the port's with its own draws and the port's
    with the JAX draws, on one rendering of the frames."""
    frames = scene.render_sequence(traj)
    runs = {"jax": run_vo("jax", scene, frames, fe_kw, rc_kw),
            "own": run_vo("port", scene, frames, fe_kw, rc_kw),
            "jax_draws": run_vo("port", scene, frames, fe_kw, rc_kw, jax_draws=True)}
    for r in runs.values():
        r["ate"] = evaluate.ate_rmse(r["poses"], traj[: r["frames"]])
    return runs


@functools.lru_cache(maxsize=None)
def realism_runs(name):
    rng = np.random.default_rng(0)  # the reference tests' `rng` fixture
    traj = forward_yaw_trajectory(14 if name == "cloud_warped" else 12, speed=0.25,
                                  yaw_rate_deg=1.5)
    if name == "canyon":
        scene = CanyonScene(rng, noise_sigma=1.5, illum_drift=0.1)
        fe_kw = dict(num_features=384, **REF_GATES)
    elif name == "canyon_heavy":
        scene = CanyonScene(rng, noise_sigma=3.0, illum_drift=0.15)
        fe_kw = dict(num_features=768, **REF_GATES)
    else:
        scene = CloudScene(rng, traj, fx=300.0, baseline=0.54, h=320, w=480,
                           depth_range=(5.0, 20.0), n_per_anchor=120, anchor_stride=4,
                           warp=True, tilt_max_deg=25.0, illum_drift=0.1,
                           n_occluders_per_anchor=1)
        fe_kw = dict(num_features=384, **REF_GATES)
    return traj, vo_runs(scene, traj, fe_kw, RC_KW)


# name -> (frames, max failures, ATE gate), the reference tests' gates.
GATES = {"canyon": (12, 1, 0.25), "canyon_heavy": (12, 2, 0.25), "cloud_warped": (14, 1, 0.3)}


@pytest.mark.parametrize("name", list(GATES))
def test_port_meets_the_reference_gates(name):
    frames, max_fails, max_ate = GATES[name]
    _, runs = realism_runs(name)
    for who in ("own", "jax"):
        r = runs[who]
        assert r["frames"] == frames, (who, r["frames"])
        assert r["fails"] <= max_fails, (who, r["fails"])
        assert r["ate"] < max_ate, (who, r["ate"])


@pytest.mark.parametrize("name", list(GATES))
def test_port_with_jax_draws_matches_the_reference(name):
    _, runs = realism_runs(name)
    ref, got = runs["jax"], runs["jax_draws"]
    assert got["counts"] == ref["counts"]
    assert got["fails"] == ref["fails"]
    assert all(c[2] > 20 for c in ref["counts"][1:])  # RANSAC really ran
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=POSE_ATOL)
    assert abs(got["ate"] - ref["ate"]) < POSE_ATOL


# ----------------------------------------------------- cv2 recall parity
def _cv2_descriptors(img, xy):
    """cv2.ORB descriptors at the given corners, joined back by coordinates
    (tests/test_realism.py's helper)."""
    cv2 = pytest.importorskip("cv2")
    orb = cv2.ORB_create(nfeatures=len(xy))
    kps = [cv2.KeyPoint(float(x), float(y), 31) for x, y in xy]
    kept, desc = orb.compute(np.clip(img, 0, 255).astype(np.uint8), kps)
    out = np.zeros((len(xy), 32), np.uint8)
    ok = np.zeros(len(xy), bool)
    if desc is None:
        return out, ok
    lut = {(round(k.pt[0], 2), round(k.pt[1], 2)): i for i, k in enumerate(kept)}
    for i, (x, y) in enumerate(xy):
        j = lut.get((round(float(x), 2), round(float(y), 2)))
        if j is not None:
            out[i] = desc[j]
            ok[i] = True
    return out, ok


def _recall(d_a, ok_a, d_b, ok_b, xy_b, gt_b, gt_ok, ratio=0.8):
    """Brute-force Hamming kNN(2) + ratio; correct = the matched B corner
    within 1.5 px of A's exact reprojection into B."""
    bits_a = np.unpackbits(d_a, axis=1).astype(np.int32)
    bits_b = np.unpackbits(d_b, axis=1).astype(np.int32)
    D = (bits_a[:, None, :] != bits_b[None, :, :]).sum(-1)
    D = np.where(ok_b[None, :], D, 10 ** 6)
    correct = queries = 0
    for i in range(len(d_a)):
        if not (ok_a[i] and gt_ok[i]):
            continue
        order = np.argsort(D[i])
        d1, d2 = D[i][order[0]], D[i][order[1]]
        if d1 >= 10 ** 6:
            continue
        queries += 1
        if d2 > 0 and d1 / max(d2, 1) > ratio:
            continue
        j = order[0]
        if np.hypot(xy_b[j, 0] - gt_b[i, 0], xy_b[j, 1] - gt_b[i, 1]) < 1.5:
            correct += 1
    return correct / max(queries, 1)


def test_orb_cv2_recall_parity_on_canyon():
    """test_orb_cv2_recall_parity_on_canyon with the port's corners and
    descriptors: recall within 5 % of cv2.ORB's on the same corners, and
    within 1e-3 of the JAX package's, under true viewpoint change judged
    against exact reprojection."""
    pytest.importorskip("cv2")
    from stereo_orb_slam_tpu.ops import detect as jdetect, orb as jorb
    from stereo_orb_slam_torch.ops import detect, orb

    scene = CanyonScene(np.random.default_rng(0))
    traj = forward_yaw_trajectory(3, speed=0.3, yaw_rate_deg=2.0)
    img_a = scene.render_pose(traj[0])
    img_s = scene.render_pose(traj[0], right=True)
    img_t = scene.render_pose(traj[1])
    n = 384

    def port(img):
        t = torch.from_numpy(img)
        xy, _, v = detect.detect_corners(t, num_features=n)
        d, _ = orb.compute_descriptors(t, xy, v)
        return (xy.numpy(), v.numpy(),
                d.numpy().view(np.uint32).view(np.uint8).reshape(n, 32))

    def ref(img):
        xy, _, v = jdetect.detect_corners(jnp.asarray(img), num_features=n)
        d, _ = jorb.compute_descriptors(jnp.asarray(img), xy, v)
        return np.asarray(xy), np.asarray(v), np.asarray(d).view(np.uint8).reshape(n, 32)

    results = {}
    for name, img_b, t_b, right_b in (("stereo", img_s, traj[0], True),
                                      ("temporal", img_t, traj[1], False)):
        rec = {}
        for who, fn in (("port", port), ("jax", ref)):
            xy_a, v_a, d_a = fn(img_a)
            xy_b, v_b, d_b = fn(img_b)
            gt_b, gt_ok = scene.reproject(xy_a, traj[0], t_b, right_b=right_b)
            rec[who] = _recall(d_a, v_a, d_b, v_b, xy_b, gt_b, gt_ok)
            if who == "port":
                c_a, ok_a = _cv2_descriptors(img_a, xy_a)
                c_b, ok_b = _cv2_descriptors(img_b, xy_b)
                rec["cv2"] = _recall(c_a, ok_a & v_a, c_b, ok_b & v_b, xy_b, gt_b, gt_ok)
        results[name] = rec
    for name, r in results.items():
        assert r["cv2"] > 0.4, (name, results)
        assert r["port"] >= r["cv2"] - 0.05, (name, results)
        assert abs(r["port"] - r["jax"]) <= 1e-3, (name, results)


# ------------------------------------------------ the canyon tree and loop
def test_render_tree_equals_the_sequential_render(tmp_path):
    """synth_canyon.render_tree with a pool of 3 processes writes the PNGs,
    calibration and ground truth that the canyon drive's sequential
    `write_kitti(scene.render_sequence(traj))` writes (a small 60x90 frame,
    20 frames, sensor noise sigma 1: each frame's noise comes from the
    parent's in-order draws)."""
    from PIL import Image

    small = dict(h=60, w=90, fx=300.0 * (90 / 480.0), cx=45.0, cy=30.0)
    render_tree(str(tmp_path / "pool"), 20, workers=3, scene_kw=small)
    kw = dict(CANYON, **small)
    traj = two_episode_trajectory(20, kw.pop("side_a"), kw.pop("side_b"))
    kw.pop("frames")
    scene = make_scene(**kw)
    frames = [(l.astype(np.uint8), r.astype(np.uint8)) for l, r in scene.render_sequence(traj)]
    write_kitti(str(tmp_path / "seq"), frames, traj, scene.fx, scene.cx, scene.cy,
                scene.baseline)
    for name in ("calib.txt", "gt.txt"):
        assert (tmp_path / "pool" / name).read_text() == (tmp_path / "seq" / name).read_text()
    for eye in ("image_0", "image_1"):
        names = sorted(os.listdir(tmp_path / "seq" / eye))
        assert names == sorted(os.listdir(tmp_path / "pool" / eye)) and len(names) == 20
        for n in names:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "pool" / eye / n)),
                                          np.asarray(Image.open(tmp_path / "seq" / eye / n)))



def test_canyon_slam_loop_closure_small(tmp_path):
    """The port's SLAM CLI (--device cpu) over the canyon drive's small
    tree (320x480, 384 features, --batch_frames 8, 192 frames: one circuit
    of a 3 m square and its revisit) with the drive's other flags and a
    20 s finish budget: the loop
    probability passes is_loop_thresh, a loop edge is committed, and the
    final ATE is below 0.08 m and at most 0.02 m above the live ATE."""
    from stereo_orb_slam_torch.apps import slam

    folder = str(tmp_path / "canyon")
    _, traj, gt = render_tree(folder, 192, workers=4,
                              scene_kw=dict(h=320, w=480, fx=300.0, cx=240.0, cy=160.0))
    flags = list(CANYON_FLAGS)
    flags[flags.index("--batch_frames") + 1] = "8"
    flags[flags.index("--num_features") + 1] = "384"
    flags[flags.index("--finish_seconds") + 1] = "20"
    summary = slam.main(["--dataset", "kitti", "--folder", folder,
                         "--camera", os.path.join(folder, "calib.txt"),
                         "--output_dir", str(tmp_path / "out"), "--gt", gt, "--device", "cpu",
                         *flags])
    system = summary["system"]
    cfg = LoopConfig()
    events = loop_events(str(tmp_path / "out" / "loop_matches.txt"), cfg.is_loop_thresh,
                         cfg.not_loop_thresh)
    assert summary["frames"] == system.world.num_frames == len(traj) == 192
    assert events["max_probability"] > cfg.is_loop_thresh and events["episodes"] >= 1, events
    assert len(system.pgo.committed_edges) >= 1
    # Each loop exit in the trace ran a live closure (none on this tree:
    # the revisit lasts to the last frame, so the closure is at finish).
    assert sum(h["live"] for h in system.pgo.history) == events["exits"]
    assert summary["ate_m"] < 0.08, summary["ate_m"]
    assert summary["ate_m"] <= summary["live_ate_m"] + 0.02, (summary["ate_m"],
                                                             summary["live_ate_m"])

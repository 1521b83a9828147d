"""Port parity for the general (distorted, non-rectified) stereo rig: the
camera functions and `VisualOdometer` against the JAX package, on the CPU.

The scene is tests/synth_distorted.py's copy of `DistortedPlaneScene`
(240x320, fx 220, k1 -0.15, k2 0.03, baseline 0.4 m), with the plane at
11 m (8 px of disparity) and whole-pixel motion in undistorted
coordinates (4 px, 0.2 m per frame). The JAX package's rig is built with
its own `geometry.camera` from the same scene fields.

Tolerances:
- `distort_normalized` against JAX 1e-6 (the same float32 formula); the
  round trip through `undistort_points` 0.05 px (tests/test_camera.py:100);
  `undistort_points` against cv2 0.1 px (tests/test_camera.py:78).
- `triangulate` (rectified None / True / False) against JAX: validity
  identical, points within DLT_PAIR_ATOL on the general path (two SVD
  routines) and 1e-5 on the rectified one.
- The float32 DLT of either package sits up to about 1e-4 m from a float64
  DLT of the same undistorted pixels at these depths (measured 9.6e-5 for
  JAX's and 1.2e-4 for the port's on the 6 frames' slots, 1.9e-4 on random
  pixels up to 15 m; asserted below at DLT_F64_ATOL = 3e-4). The two
  packages' points, and the transforms Horn fits to them, can therefore
  differ by twice that: they are held at DLT_PAIR_ATOL = 6e-4 (measured
  2.1e-4 for points and transforms, 1.8e-4 for poses), not the rectified
  test's 1e-4.
- `VisualOdometer` over 6 frames, `track` and `track_batch(K=3)`, with the
  port's RANSAC sets injected from JAX's per-frame keys: num_stereo,
  num_temporal and num_inliers identical, the world's frame, point and
  observation counts and ids identical, transforms, poses and points within
  DLT_PAIR_ATOL.
- The port's own property: `track_batch(3)` equals `track`, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth_distorted import DistortedPlaneScene, dlt_float64  # noqa: E402

from stereo_orb_slam_tpu.config import FrontendConfig as RFE, RansacConfig as RRC  # noqa: E402
from stereo_orb_slam_tpu.frontend import ransac as rransac  # noqa: E402
from stereo_orb_slam_tpu.frontend.odometer import VisualOdometer as RVO  # noqa: E402
from stereo_orb_slam_tpu.geometry import camera as rcam  # noqa: E402
from stereo_orb_slam_tpu.worldmap import WorldMap as RWorld  # noqa: E402
from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.geometry import camera as pcam  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
N_FEAT, K_HYP, SEED, N_FRAMES = 256, 64, 3, 6
STEP_PX, DEPTH = 4, 11.0
DLT_F64_ATOL = 3e-4
DLT_PAIR_ATOL = 2 * DLT_F64_ATOL
EUROC_DIST = np.array([-0.28, 0.07, 1e-4, -2e-4, 0.0], np.float32)
EUROC_K = (458.654, 457.296, 367.215, 248.375)


def reference_rig(scene):
    """The JAX package's rig from the scene's fields."""
    left = rcam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, dist=scene.dist)
    right = rcam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, dist=scene.dist,
                                pose=scene.right_pose())
    return rcam.StereoRig.create(left, right, rectified=False, baseline=scene.baseline)


def keyed_sampler(key):
    """The port's sampler drawing the reference's minimal sets for `key`."""
    def sample(valid):
        sets = rransac._sample_minimal_sets(key, jnp.asarray(valid.cpu().numpy()), K_HYP)
        return torch.from_numpy(np.array(sets))
    return sample


def reference_sampler(frame, seed=SEED):
    return keyed_sampler(jax.random.fold_in(jax.random.key(seed), frame))


@pytest.fixture(scope="module")
def sequence():
    scene = DistortedPlaneScene(np.random.default_rng(11), depth=DEPTH)
    step = STEP_PX * scene.depth / scene.fx
    frames = [(scene.render(step * i), scene.render(step * i, right=True))
              for i in range(N_FRAMES)]
    return scene, frames


def _track(vo, frames, batch):
    counts, transforms = [], []
    if batch:
        for s in range(0, len(frames), batch):
            chunk = frames[s:s + batch]
            transforms += vo.track_batch(np.stack([f[0] for f in chunk]),
                                         np.stack([f[1] for f in chunk]))
            b = vo.last_batch
            counts += list(zip(b.num_stereo, b.num_temporal, b.num_inliers))
    else:
        for il, ir in frames:
            transforms.append(vo.track(il, ir))
            r = vo.last_result
            counts.append((r.num_stereo, r.num_temporal, r.num_inliers))
    return [tuple(int(x) for x in c) for c in counts], transforms


def _run_reference(scene, frames, batch):
    world = RWorld(feat_slots=N_FEAT)
    vo = RVO(world, reference_rig(scene), RFE(num_features=N_FEAT),
             RRC(num_hypotheses=K_HYP), seed=SEED)
    return (world,) + tuple(_track(vo, frames, batch))


def _run_port(scene, frames, batch, sampler_for_frame=reference_sampler):
    world = WorldMap(feat_slots=N_FEAT)
    vo = VisualOdometer(world, scene.make_rig("cpu"), FrontendConfig(num_features=N_FEAT),
                        RansacConfig(num_hypotheses=K_HYP), seed=SEED,
                        sampler_for_frame=sampler_for_frame)
    return (world,) + tuple(_track(vo, frames, batch))


def _camera_pair():
    dist = EUROC_DIST
    ref = rcam.Pinhole.create(*EUROC_K, dist=dist)
    port = pcam.Pinhole.create(*EUROC_K, dist=dist, device="cpu")
    return ref, port


def test_distort_normalized_matches_reference_and_round_trips(rng):
    """tests/test_camera.py:100 in the port, plus the JAX function itself
    on the same points, for one camera and for two stacked cameras."""
    ref_cam, cam = _camera_pair()
    fx, fy, cx, cy = EUROC_K
    xy = np.stack([rng.uniform(-0.5, 0.5, 100), rng.uniform(-0.4, 0.4, 100)],
                  axis=1).astype(np.float32)
    xyd = pcam.distort_normalized(cam, torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(xyd, np.asarray(rcam.distort_normalized(ref_cam, jnp.asarray(xy))),
                               rtol=0, atol=1e-6)
    uv_dist = np.stack([fx * xyd[:, 0] + cx, fy * xyd[:, 1] + cy], axis=1)
    uv_undist = pcam.undistort_points(cam, torch.from_numpy(uv_dist), iterations=20).numpy()
    expect = np.stack([fx * xy[:, 0] + cx, fy * xy[:, 1] + cy], axis=1)
    np.testing.assert_allclose(uv_undist, expect, atol=0.05)

    # Stacked cameras (fields [S]): sequence s through camera s.
    other = pcam.Pinhole.create(*EUROC_K, dist=EUROC_DIST * 0.5, device="cpu")
    stacked = pcam.Pinhole(*(torch.stack(f) for f in zip(cam, other)))
    both = pcam.distort_normalized(stacked, torch.from_numpy(np.stack([xy, xy]))).numpy()
    np.testing.assert_array_equal(both[0], xyd)
    np.testing.assert_array_equal(
        both[1], pcam.distort_normalized(other, torch.from_numpy(xy)).numpy())


def test_undistort_matches_cv2(rng):
    """tests/test_camera.py:78 in the port: cv2 stops its fixed-point
    iteration early, so agreement is 0.1 px."""
    cv2 = pytest.importorskip("cv2")
    _, cam = _camera_pair()
    uv = np.stack([rng.uniform(100, 650, 200), rng.uniform(80, 420, 200)],
                  axis=1).astype(np.float32)
    ours = pcam.undistort_points(cam, torch.from_numpy(uv), iterations=20).numpy()
    K = cam.K.numpy()
    cv_out = cv2.undistortPoints(uv[:, None, :], K, EUROC_DIST).reshape(-1, 2)
    cv_px = np.stack([K[0, 0] * cv_out[:, 0] + K[0, 2], K[1, 1] * cv_out[:, 1] + K[1, 2]],
                     axis=1)
    np.testing.assert_allclose(ours, cv_px, atol=0.1)


def _stereo_pixels(rng, scene, n=400):
    """Raw (distorted) stereo pixels of plane points at 4-40 m."""
    uv_l = np.stack([rng.uniform(5, scene.w - 5, n), rng.uniform(5, scene.h - 5, n)], axis=1)
    uv_r = uv_l.copy()
    uv_r[:, 0] -= rng.uniform(2.0, 22.0, n)
    return uv_l.astype(np.float32), uv_r.astype(np.float32)


@pytest.mark.parametrize("rectified", [None, True, False])
def test_triangulate_matches_reference(rng, rectified):
    """The dispatcher on raw pixels: None reads the rig's flag (the general
    path on the distorted rig, the closed form on a rectified one)."""
    scene = DistortedPlaneScene(np.random.default_rng(0))
    uv_l, uv_r = _stereo_pixels(rng, scene)
    cases = [(reference_rig(scene), scene.make_rig("cpu"))]
    if rectified is not False:
        rect = DistortedPlaneScene(np.random.default_rng(0), k1=0.0, k2=0.0)
        jrig = rcam.StereoRig.create(
            rcam.Pinhole.create(rect.fx, rect.fx, rect.cx, rect.cy),
            rcam.Pinhole.create(rect.fx, rect.fx, rect.cx, rect.cy, pose=rect.right_pose()),
            rectified=True, baseline=rect.baseline)
        cases.append((jrig, pcam.StereoRig.create(
            pcam.Pinhole.create(rect.fx, rect.fx, rect.cx, rect.cy, device="cpu"),
            pcam.Pinhole.create(rect.fx, rect.fx, rect.cx, rect.cy, pose=rect.right_pose(),
                                device="cpu"),
            rectified=True, baseline=rect.baseline)))
    for jrig, prig in cases:
        ref_pts, ref_ok = rcam.triangulate(jrig, jnp.asarray(uv_l), jnp.asarray(uv_r),
                                           max_depth=30.0, rectified=rectified)
        pts, ok = pcam.triangulate(prig, torch.from_numpy(uv_l), torch.from_numpy(uv_r),
                                   max_depth=30.0, rectified=rectified)
        general = not (prig.rectified if rectified is None else rectified)
        ref_ok = np.asarray(ref_ok)
        np.testing.assert_array_equal(ok.numpy(), ref_ok)
        assert 0.3 * len(ref_ok) < ref_ok.sum() < len(ref_ok)
        np.testing.assert_allclose(pts.numpy()[ref_ok], np.asarray(ref_pts)[ref_ok], rtol=0,
                                   atol=DLT_PAIR_ATOL if general else 1e-5)
        if general:
            # triangulate_general = undistort both sides + triangulate_ideal.
            ideal = pcam.triangulate_ideal(
                prig, pcam.undistort_points(prig.left, torch.from_numpy(uv_l)),
                pcam.undistort_points(prig.right, torch.from_numpy(uv_r)), 30.0,
                rectified=False)
            np.testing.assert_array_equal(ideal[0].numpy(), pts.numpy())


def test_triangulate_general_takes_stacked_rigs(rng):
    """Two stacked distorted rigs: sequence s's pixels through rig s, as
    each rig alone."""
    a = DistortedPlaneScene(np.random.default_rng(0))
    b = DistortedPlaneScene(np.random.default_rng(0), k1=-0.1, k2=0.01, baseline=0.3)
    rigs = [a.make_rig("cpu"), b.make_rig("cpu")]
    uv = [_stereo_pixels(rng, a) for _ in rigs]
    pts, ok = pcam.triangulate_general(pcam.stack_rigs(rigs),
                                       torch.from_numpy(np.stack([u[0] for u in uv])),
                                       torch.from_numpy(np.stack([u[1] for u in uv])))
    for s, (rig, (uv_l, uv_r)) in enumerate(zip(rigs, uv)):
        one, one_ok = pcam.triangulate_general(rig, torch.from_numpy(uv_l),
                                               torch.from_numpy(uv_r))
        np.testing.assert_array_equal(ok[s].numpy(), one_ok.numpy())
        np.testing.assert_allclose(pts[s].numpy(), one.numpy(), rtol=0, atol=1e-6)


def test_dlt_float32_distance_from_float64(sequence):
    """The bound DLT_PAIR_ATOL rests on: on the ideal pixels of the slots
    the reference's VO produces, each package's float32 DLT lies within
    DLT_F64_ATOL of a float64 DLT of the same pixels."""
    scene, frames = sequence
    world = RWorld(feat_slots=N_FEAT)
    vo = RVO(world, reference_rig(scene), RFE(num_features=N_FEAT),
             RRC(num_hypotheses=K_HYP), seed=SEED)
    jrig, prig = reference_rig(scene), scene.make_rig("cpu")
    checked = 0
    for il, ir in frames[:3]:
        vo.track(il, ir)
        slots = vo.last_result.slots
        valid = np.asarray(slots.valid)
        kp_l, kp_r = np.asarray(slots.kp_l)[valid], np.asarray(slots.kp_r)[valid]
        x64 = dlt_float64(jrig.left.projection, jrig.right.projection, kp_l, kp_r)
        ref = np.asarray(rcam.triangulate_dlt(jrig.left.projection, jrig.right.projection,
                                              jnp.asarray(kp_l), jnp.asarray(kp_r)))
        port = pcam.triangulate_dlt(prig.left.projection, prig.right.projection,
                                    torch.from_numpy(kp_l), torch.from_numpy(kp_r)).numpy()
        np.testing.assert_allclose(ref, x64, rtol=0, atol=DLT_F64_ATOL)
        np.testing.assert_allclose(port, x64, rtol=0, atol=DLT_F64_ATOL)
        # The VO's own slot points are the float32 DLT of those pixels.
        np.testing.assert_array_equal(np.asarray(slots.pts)[valid], ref)
        checked += len(kp_l)
    assert checked > 300


def _assert_worlds_close(w_port, w_ref):
    assert (w_port.num_frames, w_port.num_points, w_port.num_obs) == \
        (w_ref.num_frames, w_ref.num_points, w_ref.num_obs)
    nf, npt, no = w_ref.num_frames, w_ref.num_points, w_ref.num_obs
    np.testing.assert_allclose(w_port.pose_global[:nf], w_ref.pose_global[:nf], rtol=0,
                               atol=DLT_PAIR_ATOL)
    np.testing.assert_allclose(w_port.points[:npt], w_ref.points[:npt], rtol=0,
                               atol=DLT_PAIR_ATOL)
    np.testing.assert_allclose(w_port.obs_uv[:no], w_ref.obs_uv[:no], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(w_port.obs_point[:no], w_ref.obs_point[:no])
    np.testing.assert_array_equal(w_port.obs_frame[:no], w_ref.obs_frame[:no])
    np.testing.assert_array_equal(w_port.point_obs_count[:npt], w_ref.point_obs_count[:npt])
    np.testing.assert_array_equal(w_port.frame_desc[:nf], w_ref.frame_desc[:nf])


@pytest.mark.parametrize("batch", [0, 3])
def test_visual_odometer_matches_reference(sequence, batch):
    scene, frames = sequence
    w_ref, c_ref, t_ref = _run_reference(scene, frames, batch)
    w_port, c_port, t_port = _run_port(scene, frames, batch)
    assert c_port == c_ref
    assert all(c[2] > 50 for c in c_ref[1:])  # RANSAC really ran
    np.testing.assert_allclose(np.stack(t_port), np.stack(t_ref), rtol=0, atol=DLT_PAIR_ATOL)
    _assert_worlds_close(w_port, w_ref)
    # Motion along +x, within the JAX test's own gate for this scene
    # (tests/test_general_stereo.py: 1.6 steps).
    step = STEP_PX * scene.depth / scene.fx
    np.testing.assert_allclose(w_port.pose_global[:N_FRAMES, 0, 3],
                               np.arange(N_FRAMES) * step, atol=1.6 * step)


def test_port_track_batch_equals_track(sequence):
    """The port's own property with its default Gumbel sampler on the
    distorted rig: K-frame batches replay K single-frame calls bit for bit,
    including a frame with no texture (not recorded) inside a batch."""
    scene, frames = sequence
    frames = list(frames)
    frames[4] = (np.full_like(frames[4][0], 96.0), np.full_like(frames[4][1], 96.0))
    w1, c1, t1 = _run_port(scene, frames, 0, sampler_for_frame=None)
    w2, c2, t2 = _run_port(scene, frames, 3, sampler_for_frame=None)
    assert c1 == c2 and c1[4][0] == 0
    assert w1.num_frames == w2.num_frames == N_FRAMES - 1
    np.testing.assert_array_equal(np.stack(t1), np.stack(t2))
    for name in ("pose_global", "points", "obs_point", "obs_uv", "point_obs_count",
                 "frame_desc", "frame_feat_point"):
        np.testing.assert_array_equal(getattr(w1, name), getattr(w2, name))


def test_distortion_scatters_depth_alike_in_both_packages(sequence):
    """Why VO alone is far less accurate on the distorted rig than on a
    rectified one, in both packages: corners are detected in the distorted
    images, where the local warp moves each corner's detected position, so
    the undistorted disparities scatter. Frame 0's landmark depths: on this
    scene's distorted rig a relative scatter (std) of 2.65 % (max 10.5 %)
    in both packages; on the same rig without distortion 1e-5, the DLT's
    float32 noise."""
    scene, frames = sequence
    flat = DistortedPlaneScene(np.random.default_rng(11), depth=DEPTH, k1=0.0, k2=0.0)
    scatter = {}
    for name, sc, first in (("distorted", scene, frames[0]),
                            ("flat", flat, (flat.render(0.0), flat.render(0.0, right=True)))):
        (w_ref, c_ref, _), (w_port, c_port, _) = (run(sc, [first], 0)
                                                  for run in (_run_reference, _run_port))
        assert c_port == c_ref
        rel = [w.points[:w.num_points, 2] / sc.depth - 1.0 for w in (w_ref, w_port)]
        np.testing.assert_allclose(rel[1], rel[0], rtol=0, atol=DLT_PAIR_ATOL / sc.depth)
        scatter[name] = float(np.std(rel[1]))
    assert scatter["distorted"] > 0.01
    assert scatter["flat"] < 1e-4

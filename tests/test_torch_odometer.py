"""Port parity for the slice as a whole: VisualOdometer through both
packages on 6 PlaneScene frames (240x320, 256 features, 64 hypotheses),
with the port's RANSAC sets injected from the JAX package's per-frame keys
(fold_in(key(seed), frame)), for `track` and for `track_batch(K=3)`.

Tolerances: per frame, num_stereo, num_temporal and num_inliers identical
(integer counts) and transforms within 1e-4 (float32 Horn fits whose sums
run in another order, chained through 6 frames); the world's frame, point
and observation counts identical, its poses and points within 1e-4 m.
Also the port's own batched == sequential property, bitwise, as
tests/test_batch_tracking.py holds it for the JAX package.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402

from stereo_orb_slam_tpu.config import FrontendConfig as RFE, RansacConfig as RRC  # noqa: E402
from stereo_orb_slam_tpu.frontend import odometer as rodo  # noqa: E402
from stereo_orb_slam_tpu.frontend.odometer import VisualOdometer as RVO  # noqa: E402
from stereo_orb_slam_tpu.ops import orb as rorb  # noqa: E402
from stereo_orb_slam_tpu.worldmap import WorldMap as RWorld  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig  # noqa: E402
from stereo_orb_slam_torch.frontend import odometer as podo, ransac as pransac  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
N_FEAT, K_HYP, SEED, N_FRAMES = 256, 64, 3, 6


@pytest.fixture(scope="module")
def sequence():
    scene = PlaneScene(np.random.default_rng(11))
    frames = [(scene.render(0.2 * i), scene.render(0.2 * i, right=True))
              for i in range(N_FRAMES)]
    return scene, frames


def _keyed_sampler(key):
    """The port's sampler drawing the reference's minimal sets for `key`:
    the JAX package's Gumbel keys (`_sample_minimal_sets` draws
    `jax.random.gumbel(key, (K, N))`), with the port's top-3, which breaks
    ties as `lax.top_k` does; the captured front end reads the keys."""
    return pransac.KeyedSampler(lambda n, device: torch.from_numpy(
        np.array(jax.random.gumbel(key, (K_HYP, n)))).to(device))


def _reference_sampler(frame):
    return _keyed_sampler(jax.random.fold_in(jax.random.key(SEED), frame))


def _run_reference(scene, frames, batch):
    world = RWorld(feat_slots=N_FEAT)
    vo = RVO(world, scene.make_rig(), RFE(num_features=N_FEAT),
             RRC(num_hypotheses=K_HYP), seed=SEED)
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
            counts.append((int(r.num_stereo), int(r.num_temporal), int(r.num_inliers)))
    return world, [tuple(int(x) for x in c) for c in counts], transforms


def _port_rig(scene):
    ref = jax.tree.map(np.asarray, scene.make_rig())
    return convert.rig_from_numpy(ref, "cpu")


def _run_port(scene, frames, batch, sampler_for_frame=_reference_sampler):
    world = WorldMap(feat_slots=N_FEAT)
    vo = VisualOdometer(world, _port_rig(scene), FrontendConfig(num_features=N_FEAT),
                        RansacConfig(num_hypotheses=K_HYP), seed=SEED,
                        sampler_for_frame=sampler_for_frame)
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
            counts.append((int(r.num_stereo), int(r.num_temporal), int(r.num_inliers)))
    return world, [tuple(int(x) for x in c) for c in counts], transforms


def _assert_worlds_close(w_port, w_ref):
    assert (w_port.num_frames, w_port.num_points, w_port.num_obs) == \
        (w_ref.num_frames, w_ref.num_points, w_ref.num_obs)
    nf, npt, no = w_ref.num_frames, w_ref.num_points, w_ref.num_obs
    np.testing.assert_allclose(w_port.pose_global[:nf], w_ref.pose_global[:nf], atol=1e-4)
    np.testing.assert_allclose(w_port.points[:npt], w_ref.points[:npt], atol=1e-4)
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
    assert all(c[2] > 20 for c in c_ref[1:])  # RANSAC really ran
    np.testing.assert_allclose(np.stack(t_port), np.stack(t_ref), atol=1e-4)
    _assert_worlds_close(w_port, w_ref)
    np.testing.assert_allclose(w_port.pose_global[N_FRAMES - 1, 0, 3], 0.2 * (N_FRAMES - 1),
                               atol=0.02)


def test_frontend_step_from_the_same_previous_state(sequence):
    """One frame step of each package from the same previous-frame state:
    the reference's slots of frame 0, carried into the port by convert."""
    scene, frames = sequence
    fe, rc = FrontendConfig(num_features=N_FEAT), RansacConfig(num_hypotheses=K_HYP)
    ref_rig = scene.make_rig()
    key = jax.random.key(SEED)
    step = partial(rodo.frontend_step, rig=ref_rig,
                   max_distance=ref_rig.max_sensible_distance(), fe=RFE(num_features=N_FEAT),
                   rc=RRC(num_hypotheses=K_HYP), rectified=True,
                   steer=rorb.steer_table(False))
    first = step(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]),
                 rodo.empty_slots(N_FEAT), jnp.asarray(False), key)
    ref = step(jnp.asarray(frames[1][0]), jnp.asarray(frames[1][1]), first.slots,
               jnp.asarray(True), key)

    prev = convert.slots_from_numpy(jax.tree.map(np.asarray, first.slots), "cpu")
    rig = _port_rig(scene)
    port = podo.frontend_step(
        torch.from_numpy(frames[1][0].copy()), torch.from_numpy(frames[1][1].copy()), prev,
        torch.tensor(True), _keyed_sampler(key), rig, rig.max_sensible_distance(), fe, rc,
        rectified=True)

    for name in ("num_stereo", "num_temporal", "num_inliers", "ransac_success"):
        assert int(getattr(port, name)) == int(getattr(ref, name)), name
    valid = np.asarray(ref.slots.valid)
    np.testing.assert_array_equal(port.slots.valid.numpy(), valid)
    np.testing.assert_array_equal(port.slots.desc.numpy().view(np.uint32),
                                  np.asarray(ref.slots.desc))
    np.testing.assert_array_max_ulp(port.slots.kp_l.numpy(), np.asarray(ref.slots.kp_l), 1)
    np.testing.assert_array_max_ulp(port.slots.kp_r.numpy()[valid],
                                    np.asarray(ref.slots.kp_r)[valid], 1)
    np.testing.assert_array_equal(port.prev_idx.numpy()[valid], np.asarray(ref.prev_idx)[valid])
    np.testing.assert_array_equal(port.tracked.numpy(), np.asarray(ref.tracked))
    np.testing.assert_allclose(port.transform.numpy(), np.asarray(ref.transform), atol=1e-4)


@pytest.mark.parametrize("batch, lost", [(1, None), (3, None), (6, None), (3, 1)],
                         ids=["K1", "K3", "K6", "K3-ransac-fails-in-batch"])
def test_port_track_batch_equals_track(sequence, batch, lost):
    """The port's own property with its default Gumbel sampler: K-frame
    batches replay K single-frame calls bitwise, including a frame with no
    texture (not recorded) inside a batch; K = 1 is dispatch/collect a
    frame at a time, K = 6 the whole drive as one batch. With `lost`, that
    frame views another part of the plane: it is recorded, its RANSAC
    fails (identity pose, every point a new landmark) and the next frame
    matches the one before it, all inside the first batch."""
    scene, frames = sequence
    frames = list(frames)
    frames[4] = (np.full_like(frames[4][0], 96.0), np.full_like(frames[4][1], 96.0))
    if lost is not None:
        frames[lost] = (scene.render(30.0), scene.render(30.0, right=True))
    w1, c1, t1 = _run_port(scene, frames, 0, sampler_for_frame=None)
    w2, c2, t2 = _run_port(scene, frames, batch, sampler_for_frame=None)
    assert c1 == c2 and c1[4][0] == 0
    assert w1.num_frames == w2.num_frames == N_FRAMES - 1
    np.testing.assert_array_equal(np.stack(t1), np.stack(t2))
    for name in ("pose_global", "points", "obs_point", "obs_uv", "point_obs_count",
                 "frame_desc", "frame_feat_point"):
        np.testing.assert_array_equal(getattr(w1, name), getattr(w2, name))
    if lost is not None:
        assert c1[lost][0] >= FrontendConfig().min_stereo_matches
        np.testing.assert_array_equal(t1[lost], np.eye(4, dtype=np.float32))
        obs = w1.obs_frame[:w1.num_obs] == lost
        assert obs.any()
        assert (w1.point_first_frame[w1.obs_point[:w1.num_obs][obs]] == lost).all()
        assert c1[lost + 1][2] > 20  # the next frame tracks against the one before

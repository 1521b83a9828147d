"""The SLAM app's path and multi-sequence tracking on the general
(distorted, non-rectified) rig, port against the JAX package, on the CPU.

- `SlamSystem` over an out-and-back-and-dwell trajectory of
  tests/synth_distorted.py's `DistortedPlaneScene` (240x320, the plane at
  11 m, whole 4 px steps in undistorted coordinates; the whole-slice
  setting of tests/test_torch_slam.py: 256 features, 64 hypotheses, the
  vocabulary trained at frame 8, distant_frame_thresh 10), with per-frame
  and window BA on (BAConfig(max_iterations=4), refine_interval 6), the
  port's RANSAC sets injected from the JAX keys (frames and loop edges).
  Loop edges are measured on the general branch of `measure_edges` (the
  stored ideal observations of all E edges re-triangulated by one batched
  DLT). Held as
  tests/test_torch_slam.py holds the rectified slice: every frame tracked
  in both; the vocabulary bit-identical; the loop trace's matched ids
  identical, its scores within 1e-6 and its probabilities within rtol
  1e-5; the same committed and loop edges, the same loop edges at finish;
  the final poses within 1e-3 m.
- The loop-edge batch on the DLT branch (port only): 4 edges as one batch
  equal the 4 single calls bit for bit.
- `MultiSequenceSLAM` with S = 2 stacked distorted rigs (different
  distortion, 4 and 5 px steps): against the JAX package's, the port's sets
  injected, relative poses within test_torch_general_stereo.DLT_PAIR_ATOL
  (the float32 DLT, see there); and each sequence's poses, points and
  observations equal to its own `VisualOdometer` run, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth_distorted import DistortedPlaneScene  # noqa: E402
from test_torch_general_stereo import (  # noqa: E402
    DLT_PAIR_ATOL, reference_rig, reference_sampler,
)
from test_torch_slam import keyed_sampler  # noqa: E402

from stereo_orb_slam_tpu.apps import slam as jslam  # noqa: E402
from stereo_orb_slam_tpu.config import (  # noqa: E402
    BAConfig as JBA, FrontendConfig as JFE, LoopConfig as JLoop, RansacConfig as JRC,
    SlamConfig as JSlam,
)
from stereo_orb_slam_tpu.parallel.multi_seq import MultiSequenceSLAM as JMulti  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import slam as tslam  # noqa: E402
from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.parallel.multi_seq import MultiSequenceSLAM  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
N_FEAT, K_HYP, DEPTH = 256, 64, 11.0


def _scene(**kw):
    return DistortedPlaneScene(np.random.default_rng(0), depth=DEPTH, **kw)


def test_slam_system_on_the_general_rig_matches_reference():
    jcfg = JSlam(
        frontend=JFE(num_features=N_FEAT), ransac=JRC(num_hypotheses=K_HYP),
        ba=JBA(max_iterations=4),
        loop=JLoop(distant_frame_thresh=10, adjacent_frame_thresh=3, database_capacity=64,
                   query_size=8),
        refine_interval=6, per_frame_ba=True,
    )
    scene = _scene()
    step = 4 * scene.depth / scene.fx
    xs = ([i * step for i in range(12)] + [(11 - i) * step for i in range(12)]
          + [step * (i % 3) for i in range(14)])
    frames = [(scene.render(x), scene.render(x, right=True)) for x in xs]

    ref = jslam.SlamSystem(reference_rig(scene), jcfg, vocab_train_frames=8)
    got = tslam.SlamSystem(scene.make_rig("cpu"), convert.slam_config_from(jcfg),
                           vocab_train_frames=8, sampler_for_frame=keyed_sampler(0),
                           sampler_for_edge=keyed_sampler(1234))
    assert got.rig.rectified is False
    for il, ir in frames:
        ref.process(il, ir)
        got.process(il, ir)

    np.testing.assert_array_equal(got.vocab.centroids_u32(), np.asarray(ref.vocab.centroids))
    np.testing.assert_array_equal(got.vocab.idf.numpy(), np.asarray(ref.vocab.idf))
    assert [m[0] for m in got.loop.matches] == [m[0] for m in ref.loop.matches]
    np.testing.assert_allclose([m[1] for m in got.loop.matches],
                               [m[1] for m in ref.loop.matches], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.loop.probabilities, ref.loop.probabilities,
                               rtol=1e-5, atol=0)
    assert max(got.loop.probabilities) > 0.9
    assert got.pgo.loop_edges == ref.pgo.loop_edges and got.pgo.loop_edges
    for stage in ("ba.per_frame", "ba.window"):
        assert got.timers.counts[stage] == ref.timers.counts[stage] > 0, stage

    ts, rs = got.finish(), ref.finish()
    assert ts["pose_graph"]["num_loop_edges"] == rs["pose_graph"]["num_loop_edges"] >= 1
    assert got.pgo.committed_edges == ref.pgo.committed_edges
    n = ref.world.num_frames
    assert got.world.num_frames == n == len(xs)
    np.testing.assert_allclose(got.world.pose_global[:n, :3, 3],
                               ref.world.pose_global[:n, :3, 3], rtol=0, atol=1e-3)
    ids = np.arange(got.world.num_points, dtype=np.int32)
    assert (got.world.canonical(ids) != ids).sum() > 10  # landmarks merged


STEPS_PX = (4, 5)


@pytest.fixture(scope="module")
def sequences():
    scenes = [_scene(), _scene(k1=-0.1, k2=0.01)]
    steps = [px * s.depth / s.fx for px, s in zip(STEPS_PX, scenes)]
    frames = [(np.stack([s.render(i * st) for s, st in zip(scenes, steps)]),
               np.stack([s.render(i * st, right=True) for s, st in zip(scenes, steps)]))
              for i in range(4)]
    return scenes, steps, frames


def _run_multi(scenes, frames, sampler_for_frame=None):
    multi = MultiSequenceSLAM([s.make_rig("cpu") for s in scenes],
                              FrontendConfig(num_features=N_FEAT),
                              RansacConfig(num_hypotheses=K_HYP), seed=7,
                              sampler_for_frame=sampler_for_frame)
    assert multi.rig_batch.rectified is False
    return multi, np.stack([np.stack(multi.process(il, ir)) for il, ir in frames])


def test_multi_seq_general_rigs_match_reference(sequences):
    scenes, steps, frames = sequences
    ref = JMulti([reference_rig(s) for s in scenes], JFE(num_features=N_FEAT),
                 JRC(num_hypotheses=K_HYP), seed=7)
    ref_T = np.stack([np.stack(ref.process(il, ir)) for il, ir in frames])
    _, port_T = _run_multi(scenes, frames,
                           lambda s, i: reference_sampler(i, seed=7 + s))
    np.testing.assert_allclose(port_T, ref_T, rtol=0, atol=DLT_PAIR_ATOL)
    for s, st in enumerate(steps):
        assert all(T[s][0, 3] > 0.5 * st for T in port_T[1:])


def test_multi_seq_general_rigs_equal_each_sequence_alone(sequences):
    scenes, _, frames = sequences
    multi, multi_T = _run_multi(scenes, frames)
    for s, scene in enumerate(scenes):
        world = WorldMap(feat_slots=N_FEAT)
        vo = VisualOdometer(world, scene.make_rig("cpu"), FrontendConfig(num_features=N_FEAT),
                            RansacConfig(num_hypotheses=K_HYP), seed=7 + s)
        alone = np.stack([vo.track(il[s], ir[s]) for il, ir in frames])
        np.testing.assert_array_equal(multi_T[:, s], alone)
        mw = multi.worlds[s]
        assert (mw.num_frames, mw.num_points, mw.num_obs) == \
            (world.num_frames, world.num_points, world.num_obs)
        np.testing.assert_array_equal(mw.pose_global[:mw.num_frames],
                                      world.pose_global[:world.num_frames])
        np.testing.assert_array_equal(mw.points[:mw.num_points], world.points[:world.num_points])
        np.testing.assert_array_equal(mw.obs_uv[:mw.num_obs], world.obs_uv[:world.num_obs])


def test_loop_edge_batch_on_the_general_rig_equals_serial():
    """`measure_edges` on the DLT branch: 4 edges of an out-and-back over
    the distorted plane, measured as one batch (one batched DLT and one
    RANSAC over the 4), equal the 4 single calls bit for bit, merges
    included."""
    import copy

    scene = _scene()
    step = 4 * scene.depth / scene.fx
    cfg = convert.slam_config_from(JSlam(frontend=JFE(num_features=N_FEAT),
                                         ransac=JRC(num_hypotheses=K_HYP),
                                         refine_interval=10 ** 6, per_frame_ba=False))
    system = tslam.SlamSystem(scene.make_rig("cpu"), cfg, vocab_train_frames=10 ** 9)
    for x in [i * step for i in range(8)] + [(7 - i) * step for i in range(8)]:
        system.process(scene.render(x), scene.render(x, right=True))
    edges = [(0, 15), (1, 14), (2, 13), (3, 12)]
    worlds = [copy.deepcopy(system.world) for _ in range(2)]
    batch_m, serial_m = (tslam.make_loop_matcher(w, system.rig, cfg, seed=9) for w in worlds)
    batch = batch_m.batch(edges)
    serial = [serial_m(s, d) for s, d in edges]
    assert all(ok for _, ok in batch)
    for (Zb, okb), (Zs, oks) in zip(batch, serial):
        assert okb == oks
        np.testing.assert_array_equal(Zb, Zs)
    np.testing.assert_array_equal(worlds[0].point_parent, worlds[1].point_parent)
    np.testing.assert_array_equal(worlds[0].point_obs_count, worlds[1].point_obs_count)

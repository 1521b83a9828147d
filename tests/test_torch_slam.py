"""Port parity for the SLAM app's path: the loop-edge matcher and the whole
slice (`SlamSystem`) against the JAX package's, on the CPU.

The port's RANSAC draws are injected from the JAX package's keys: frame i
of the odometer takes the minimal sets of fold_in(key(seed), i), loop edge
i of the matcher those of fold_in(key(matcher seed), i).

- `make_loop_matcher(...).batch` on the out-and-back scene of
  tests/test_loop_integration.py::test_batched_loop_matcher_equals_serial
  (16 PlaneScene frames, 256 features, 64 hypotheses): ok flags and inlier
  counts identical, Z within 1e-4 (float32 Horn fits in another order),
  the landmark merges (`point_parent`, `point_obs_count`) identical. Also the
  port's batch against its own serial calls, bit for bit.
- The batch as one program (port only, on a world the port tracked): E = 5
  edges call the Hamming wrapper once and RANSAC's solver once; E = 0
  measures nothing and draws nothing; edges that fail inside a batch (too
  few valid features) give the serial calls' flags, counts and merges.
- The slice as a whole: `SlamSystem.process` over the 38-frame
  out-and-back-and-dwell trajectory of
  tests/test_loop_integration.py::test_slam_loop_closure_end_to_end (240x320,
  256 features, the SlamConfig there, BAConfig(max_iterations=4) in both:
  longer solves wander in float32 noise), then `finish()`. The vocabulary
  bit-identical; the loop trace's matched ids identical, its scores within
  1e-6 and its probabilities within rtol 1e-5 (the filter's erf z-score
  divides the float32 score gaps by the adjacent scores' spread: measured
  5.1e-6 relative); the same committed loop edges and the same
  number measured at finish; the final poses within 1e-3 m.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402
from test_torch_ba import port_world  # noqa: E402

from stereo_orb_slam_tpu.apps import slam as jslam  # noqa: E402
from stereo_orb_slam_tpu.config import (  # noqa: E402
    BAConfig as JBA, FrontendConfig as JFE, LoopConfig as JLoop, RansacConfig as JRC,
    SlamConfig as JSlam,
)
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import slam as tslam  # noqa: E402
from stereo_orb_slam_torch.frontend import ransac as pransac  # noqa: E402

torch.set_num_threads(1)
K_HYP = 64


def keyed_sampler(seed):
    """sampler_for(i) drawing the JAX package's sets of fold_in(key(seed), i)."""
    base = jax.random.key(seed)

    def sampler_for(i):
        # `_sample_minimal_sets` draws jax.random.gumbel(key, (K, N)); the
        # port takes the same top 3 (ties as lax.top_k breaks them).
        key = jax.random.fold_in(base, i)
        return pransac.KeyedSampler(lambda n, device: torch.from_numpy(
            np.array(jax.random.gumbel(key, (K_HYP, n)))).to(device))
    return sampler_for


def port_rig(scene):
    return convert.rig_from_numpy(jax.tree.map(np.asarray, scene.make_rig()), "cpu")


def test_loop_matcher_batch_matches_reference():
    scene = PlaneScene(np.random.default_rng(0))
    rig = scene.make_rig()
    jcfg = JSlam(frontend=JFE(num_features=256), ransac=JRC(num_hypotheses=K_HYP),
                 refine_interval=10 ** 6, per_frame_ba=False)
    system = jslam.SlamSystem(rig, jcfg, vocab_train_frames=10 ** 9)
    xs = [i * 0.2 for i in range(8)] + [(7 - i) * 0.2 for i in range(8)]
    for x in xs:
        system.process(scene.render(x), scene.render(x, right=True))
    edges = [(0, 15), (1, 14), (2, 13), (3, 12)]

    cfg = convert.slam_config_from(jcfg)
    trig = port_rig(scene)
    w_batch, w_serial = port_world(system.world), port_world(system.world)
    w_ref = system.world
    seed = 77
    ref = jslam.make_loop_matcher(w_ref, rig, jcfg, seed=seed).batch(edges)
    got = tslam.make_loop_matcher(w_batch, trig, cfg, seed=seed,
                                  sampler_for_edge=keyed_sampler(seed))
    batch = got.batch(edges)
    serial_m = tslam.make_loop_matcher(w_serial, trig, cfg, seed=seed,
                                       sampler_for_edge=keyed_sampler(seed))
    serial = [serial_m(s, d) for s, d in edges]

    # The reference's inlier counts, from its packed edge program with the
    # keys its batch used.
    n = 256
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(4))
    w = system.world
    packed = np.asarray(jslam._loop_edges_program(
        *(jnp.asarray(np.stack([getattr(w, f)[s] for s, _ in edges] if side == 0 else
                               [getattr(w, f)[d] for _, d in edges]))
          for f, side in (("frame_desc", 0), ("frame_desc", 1), ("frame_feat_valid", 0),
                          ("frame_feat_valid", 1), ("frame_feat_uv", 0), ("frame_feat_uv", 1))),
        keys, rig, jcfg.frontend, jcfg.ransac, True))
    ref_inliers = (packed[:, 16 + n + 1].astype(np.int64) - 1).tolist()

    assert [ok for _, ok in batch] == [ok for _, ok in ref]
    assert any(ok for _, ok in ref)
    assert got.last["num_inliers"] == ref_inliers
    for (Zt, ok), (Zr, _) in zip(batch, ref):
        if ok:
            np.testing.assert_allclose(Zt, Zr, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(w_batch.point_parent, w_ref.point_parent)
    np.testing.assert_array_equal(w_batch.point_obs_count, w_ref.point_obs_count)
    # The port's batch against its serial calls, bit for bit.
    for (Zb, okb), (Zs, oks) in zip(batch, serial):
        assert okb == oks
        np.testing.assert_array_equal(Zb, Zs)
    np.testing.assert_array_equal(w_batch.point_parent, w_serial.point_parent)
    np.testing.assert_array_equal(w_batch.point_obs_count, w_serial.point_obs_count)


def test_slam_system_matches_reference():
    jcfg = JSlam(
        frontend=JFE(num_features=256), ransac=JRC(num_hypotheses=K_HYP),
        ba=JBA(max_iterations=4),
        loop=JLoop(distant_frame_thresh=10, adjacent_frame_thresh=3, database_capacity=64,
                   query_size=8),
        refine_interval=10 ** 6, per_frame_ba=False,
    )
    scene = PlaneScene(np.random.default_rng(0))
    xs = ([i * 0.2 for i in range(12)] + [(11 - i) * 0.2 for i in range(12)]
          + [0.02 * (i % 3) for i in range(14)])
    frames = [(scene.render(x), scene.render(x, right=True)) for x in xs]

    ref = jslam.SlamSystem(scene.make_rig(), jcfg, vocab_train_frames=8)
    got = tslam.SlamSystem(port_rig(scene), convert.slam_config_from(jcfg),
                           vocab_train_frames=8, sampler_for_frame=keyed_sampler(0),
                           sampler_for_edge=keyed_sampler(1234))
    for il, ir in frames:
        ref.process(il, ir)
        got.process(il, ir)

    np.testing.assert_array_equal(got.vocab.centroids_u32(), np.asarray(ref.vocab.centroids))
    np.testing.assert_array_equal(got.vocab.idf.numpy(), np.asarray(ref.vocab.idf))
    assert [m[0] for m in got.loop.matches] == [m[0] for m in ref.loop.matches]
    np.testing.assert_allclose([m[1] for m in got.loop.matches],
                               [m[1] for m in ref.loop.matches], rtol=0, atol=1e-6)
    # The filter multiplies by erf((score - mean) / std) of the adjacent
    # scores: 1e-7 score gaps come out as a few 1e-6 relative (measured 5.1e-6).
    np.testing.assert_allclose(got.loop.probabilities, ref.loop.probabilities,
                               rtol=1e-5, atol=0)
    assert max(got.loop.probabilities) > 0.9
    assert got.pgo.loop_edges == ref.pgo.loop_edges and got.pgo.loop_edges

    ts, rs = got.finish(), ref.finish()
    assert ts["pose_graph"]["num_loop_edges"] == rs["pose_graph"]["num_loop_edges"] >= 1
    assert got.pgo.committed_edges == ref.pgo.committed_edges
    n = ref.world.num_frames
    assert got.world.num_frames == n == len(xs)
    np.testing.assert_allclose(got.world.pose_global[:n, :3, 3],
                               ref.world.pose_global[:n, :3, 3], rtol=0, atol=1e-3)
    ids = np.arange(got.world.num_points, dtype=np.int32)
    assert (got.world.canonical(ids) != ids).sum() > 10  # landmarks merged


@pytest.fixture(scope="module")
def port_loop_world():
    """The out-and-back PlaneScene world of the matcher test, tracked by the
    port's own SlamSystem on the CPU (no vocabulary, no BA)."""
    scene = PlaneScene(np.random.default_rng(0))
    cfg = convert.slam_config_from(JSlam(frontend=JFE(num_features=256),
                                         ransac=JRC(num_hypotheses=K_HYP),
                                         refine_interval=10 ** 6, per_frame_ba=False))
    system = tslam.SlamSystem(port_rig(scene), cfg, vocab_train_frames=10 ** 9)
    xs = [i * 0.2 for i in range(8)] + [(7 - i) * 0.2 for i in range(8)]
    for x in xs:
        system.process(scene.render(x), scene.render(x, right=True))
    return system.world, port_rig(scene), cfg


def _matchers(world, rig, cfg, n=2, seed=5):
    worlds = [copy.deepcopy(world) for _ in range(n)]
    return worlds, [tslam.make_loop_matcher(w, rig, cfg, seed=seed) for w in worlds]


def test_loop_matcher_batch_is_one_hamming_launch_and_one_ransac(port_loop_world, monkeypatch):
    """A batch of E = 5 edges calls the Hamming wrapper once (B = E on the
    kernel's grid) and RANSAC's solver once, and equals the 5 single calls
    bit for bit."""
    from stereo_orb_slam_torch.frontend import ransac as transac
    from stereo_orb_slam_torch.ops import match as tmatch

    world, rig, cfg = port_loop_world
    edges = [(0, 15), (1, 14), (2, 13), (3, 12), (4, 11)]
    calls = {"hamming": 0, "ransac": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tmatch, "hamming_top2", counted("hamming", tmatch.hamming_top2))
    monkeypatch.setattr(transac, "_solve", counted("ransac", transac._solve))
    (w_b, w_s), (m_b, m_s) = _matchers(world, rig, cfg)
    batch = m_b.batch(edges)
    assert calls == {"hamming": 1, "ransac": 1}
    assert m_b.batches == 1
    serial = [m_s(s, d) for s, d in edges]
    assert calls == {"hamming": 1 + len(edges), "ransac": 1 + len(edges)}
    assert m_s.batches == len(edges)
    assert all(ok for _, ok in batch)
    for (Zb, okb), (Zs, oks) in zip(batch, serial):
        assert okb == oks
        np.testing.assert_array_equal(Zb, Zs)
    np.testing.assert_array_equal(w_b.point_parent, w_s.point_parent)
    np.testing.assert_array_equal(w_b.point_obs_count, w_s.point_obs_count)


def test_loop_matcher_empty_batch(port_loop_world):
    """E = 0 measures nothing, launches nothing and leaves the edge counter
    where it was: the next edge draws the sets it would have drawn."""
    world, rig, cfg = port_loop_world
    (w_a, w_b), (m_a, m_b) = _matchers(world, rig, cfg)
    assert m_a.batch([]) == []
    assert m_a.batches == 0 and m_a.last is None
    Za, oka = m_a(0, 15)
    Zb, okb = m_b(0, 15)
    assert oka and okb
    np.testing.assert_array_equal(Za, Zb)
    np.testing.assert_array_equal(w_a.point_parent, w_b.point_parent)


def test_loop_matcher_batch_with_failing_edges(port_loop_world):
    """Edges whose frames keep too few valid features fail inside the batch
    (identity, ok False, no merge) while the others are measured: the flags,
    inlier counts, transforms and merges equal the serial calls'."""
    world, rig, cfg = port_loop_world
    world = copy.deepcopy(world)
    for f in (5, 9):  # keep 4 valid slots: below min_pairs
        keep = np.flatnonzero(world.frame_feat_valid[f])[:4]
        world.frame_feat_valid[f] = False
        world.frame_feat_valid[f][keep] = True
    edges = [(0, 15), (5, 10), (2, 13), (6, 9), (3, 12)]
    (w_b, w_s), (m_b, m_s) = _matchers(world, rig, cfg)
    batch = m_b.batch(edges)
    flags = m_b.last["ok"]
    serial = []
    inliers = []
    for s, d in edges:
        serial.append(m_s(s, d))
        inliers += m_s.last["num_inliers"]
    assert flags == [True, False, True, False, True]
    assert [ok for _, ok in batch] == flags == [ok for _, ok in serial]
    assert m_b.last["num_inliers"] == inliers
    for (Zb, _), (Zs, _) in zip(batch, serial):
        np.testing.assert_array_equal(Zb, Zs)
    np.testing.assert_array_equal(batch[1][0], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(w_b.point_parent, w_s.point_parent)
    np.testing.assert_array_equal(w_b.point_obs_count, w_s.point_obs_count)

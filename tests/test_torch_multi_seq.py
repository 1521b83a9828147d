"""Concurrent multi-sequence tracking in the port (`parallel/multi_seq.py`,
the batched front end) against the JAX package's and against itself.

- The port's MultiSequenceSLAM against the JAX one (tests/test_multi_seq.py's
  setting: 2 PlaneScene sequences at 240x320, 256 features, 64 hypotheses,
  4 frames, steps 0.2 and 0.25 m, seeds 7 and 8), the port's RANSAC sets
  injected from the JAX keys fold_in(key(7 + s), frame): relative poses
  within 1e-4 (JAX's own bound, tests/test_multi_seq.py:41); measured
  5.2e-5 (float32 Horn fits whose sums run in another order, chained
  over the frames, as in tests/test_torch_odometer.py).
- The batched port against each sequence tracked alone by the port's
  VisualOdometer with its default sampler: equal, bit for bit on the CPU
  (poses, world points and observations).
- The batched plain versions of the three kernels against their unbatched
  calls on each slice: bit for bit.
- With a mesh: 3 sequences over 2 gloo ranks (2 + 1) against mesh=None,
  3 frames at 120x160 (tests/test_multi_seq_mesh.py's shapes): equal, and
  rank 0 holds sequences 0-1, rank 1 sequence 2.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_workers  # noqa: E402
from dist_workers import file_store  # noqa: E402,F401 (fixture)
from synth import PlaneScene  # noqa: E402
from test_torch_dist_ba import rig_np  # noqa: E402

from stereo_orb_slam_tpu.config import FrontendConfig as JFE, RansacConfig as JRC  # noqa: E402
from stereo_orb_slam_tpu.parallel.multi_seq import MultiSequenceSLAM as JMulti  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig  # noqa: E402
from stereo_orb_slam_torch.frontend import ransac as pransac  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.ops import orb  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import describe, hamming, patches  # noqa: E402
from stereo_orb_slam_torch.parallel.multi_seq import MultiSequenceSLAM  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
N_FEAT, K_HYP, SEED, N_FRAMES = 256, 64, 7, 4
STEPS = (0.2, 0.25)


@pytest.fixture(scope="module")
def sequences():
    rng = np.random.default_rng(0)
    scenes = [PlaneScene(rng), PlaneScene(rng)]
    frames = [(np.stack([s.render(i * st) for s, st in zip(scenes, STEPS)]),
               np.stack([s.render(i * st, right=True) for s, st in zip(scenes, STEPS)]))
              for i in range(N_FRAMES)]
    return scenes, frames


def _jax_sampler(s, frame):
    # `_sample_minimal_sets` draws jax.random.gumbel(key, (K, N)); the port
    # takes the same top 3 (ties as lax.top_k breaks them).
    key = jax.random.fold_in(jax.random.key(SEED + s), frame)
    return pransac.KeyedSampler(lambda n, device: torch.from_numpy(
        np.array(jax.random.gumbel(key, (K_HYP, n)))).to(device))


def _port_rigs(scenes):
    return [convert.rig_from_numpy(rig_np(s.make_rig()), "cpu") for s in scenes]


def _run_port(scenes, frames, sampler_for_frame=None):
    multi = MultiSequenceSLAM(_port_rigs(scenes), FrontendConfig(num_features=N_FEAT),
                              RansacConfig(num_hypotheses=K_HYP), seed=SEED,
                              sampler_for_frame=sampler_for_frame)
    return multi, [np.stack(multi.process(il, ir)) for il, ir in frames]


def test_multi_seq_matches_reference(sequences):
    scenes, frames = sequences
    ref = JMulti([s.make_rig() for s in scenes], JFE(num_features=N_FEAT),
                 JRC(num_hypotheses=K_HYP), seed=SEED)
    ref_T = [np.stack(ref.process(il, ir)) for il, ir in frames]
    _, port_T = _run_port(scenes, frames, _jax_sampler)
    gap = float(np.abs(np.stack(port_T) - np.stack(ref_T)).max())
    print(f"port vs JAX MultiSequenceSLAM: max pose gap {gap:.3g}")
    np.testing.assert_allclose(np.stack(port_T), np.stack(ref_T), atol=1e-4)
    for s, st in enumerate(STEPS):   # both sequences recover their motion
        for T in port_T[1:]:
            np.testing.assert_allclose(T[s][:3, 3], [st, 0, 0], atol=0.05)


def test_batched_equals_each_sequence_alone(sequences):
    scenes, frames = sequences
    multi, multi_T = _run_port(scenes, frames)
    for s, rig in enumerate(_port_rigs(scenes)):
        world = WorldMap(feat_slots=N_FEAT)
        vo = VisualOdometer(world, rig, FrontendConfig(num_features=N_FEAT),
                            RansacConfig(num_hypotheses=K_HYP), seed=SEED + s)
        alone = np.stack([vo.track(il[s], ir[s]) for il, ir in frames])
        np.testing.assert_array_equal(np.stack([T[s] for T in multi_T]), alone)
        mw = multi.worlds[s]
        assert (mw.num_frames, mw.num_points, mw.num_obs) == \
            (world.num_frames, world.num_points, world.num_obs)
        np.testing.assert_array_equal(mw.points[:mw.num_points], world.points[:world.num_points])
        np.testing.assert_array_equal(mw.obs_uv[:mw.num_obs], world.obs_uv[:world.num_obs])


def test_batched_plain_kernels_equal_unbatched():
    rng = np.random.default_rng(3)
    B, N, M, H, W = 3, 64, 96, 70, 90
    q = convert.desc_to_tensor(rng.integers(0, 2 ** 32, (B, N, 8), dtype=np.uint32), "cpu")
    ta, tb = (convert.desc_to_tensor(rng.integers(0, 2 ** 32, (B, M, 8), dtype=np.uint32),
                                     "cpu") for _ in range(2))
    va, vb = (torch.from_numpy(rng.random((B, M)) > 0.3) for _ in range(2))
    batched = hamming.hamming_top2_pair(q, ta, va, tb, vb)
    for b in range(B):
        single = hamming.hamming_top2_pair(q[b], ta[b], va[b], tb[b], vb[b])
        for got, want in zip(batched, single):
            for g, w in zip(got, want):
                assert torch.equal(g[b], w)

    img = torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32))
    xy = torch.from_numpy(np.stack([rng.uniform(0, W - 2 * orb.PATCH_R - 1, (B, N)),
                                    rng.uniform(0, H - 2 * orb.PATCH_R - 1, (B, N))], -1)
                          .astype(np.float32))
    valid = torch.from_numpy(rng.random((B, N)) > 0.25)
    table = orb.steer_table(False, "cpu")
    words = describe.orb_describe(img, xy, valid, table)
    ys, xs = orb.window_starts(xy)
    cut = patches.extract_patches(img, ys - 40, xs, orb.PATCH)   # some starts negative
    for b in range(B):
        assert torch.equal(words[b], describe.orb_describe(img[b], xy[b], valid[b], table))
        assert torch.equal(cut[b], patches.extract_patches(img[b], ys[b] - 40, xs[b], orb.PATCH))
    assert words.shape == (B, N, 8) and cut.shape == (B, N, orb.PATCH, orb.PATCH)


def test_mesh_split_matches_unsplit(file_store):
    rng = np.random.default_rng(5)
    scenes = [PlaneScene(rng, h=120, w=160, fx=100.0, cx=80.0, cy=60.0) for _ in range(3)]
    steps = [0.1, 0.12, 0.14]
    imgs_l = [np.stack([s.render(i * st) for s, st in zip(scenes, steps)]) for i in range(3)]
    imgs_r = [np.stack([s.render(i * st, right=True) for s, st in zip(scenes, steps)])
              for i in range(3)]
    rigs = [rig_np(s.make_rig()) for s in scenes]
    outs = dist_workers.spawn(dist_workers.multi_seq_frames, 2, file_store, imgs_l, imgs_r,
                              rigs, 128, 32, 3)
    plain = MultiSequenceSLAM([convert.rig_from_numpy(r, "cpu") for r in rigs],
                              FrontendConfig(num_features=128), RansacConfig(num_hypotheses=32),
                              seed=3)
    want = [np.stack(plain.process(il, ir)) for il, ir in zip(imgs_l, imgs_r)]
    assert [o[1] for o in outs] == [[0, 1], [2]]
    for frames, _ in outs:
        np.testing.assert_array_equal(np.stack(frames), np.stack(want))

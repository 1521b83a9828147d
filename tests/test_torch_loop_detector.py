"""Port parity: the Bayesian loop detector (loop/detector.py) against the JAX
package's, on the CPU.

Both detectors take the same vocabulary (the JAX package's, carried over by
`convert.vocabulary_from_numpy`) and the same frames, made with numpy from a
seed, through query() + track(): 70 distinct scenes on a strip of
descriptors, a revisit of scenes 0-8 (the filter enters a loop), then fresh
scenes (it decays and leaves the loop, committing its edges and calling the
optimizer). Tolerances: the matched frame ids, the in-loop flag and the
committed edges and optimizer calls identical; scores and probabilities
within 1e-6 (float32 BoW sums in another order, then the same float64 host
filter). The database rows within 1e-6.

Also the port's own property that process_batch (one scoring pass per K
frames) replays sequential query() + track() exactly, with unrecorded
frames, as tests/test_batch_tracking.py holds it for the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_loop import frame_descs  # noqa: E402

from stereo_orb_slam_tpu.config import LoopConfig as JLoopConfig  # noqa: E402
from stereo_orb_slam_tpu.loop import LoopDetector as JDetector, OrbVocabulary as JVocab  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.config import LoopConfig  # noqa: E402
from stereo_orb_slam_torch.loop import LoopDetector, OrbVocabulary  # noqa: E402

torch.set_num_threads(1)


class FakeOptimizer:
    def __init__(self):
        self.edges = []
        self.optimize_calls = 0

    def add_loop_edge(self, a, b):
        self.edges.append((a, b))

    def optimize(self, live=False):
        self.optimize_calls += 1


def _revisit_frames(rng, n_scenes=70):
    strip = rng.integers(0, 2 ** 32, (n_scenes * 8 + 64, 8), dtype=np.uint32)
    scenes = [strip[i * 8: i * 8 + 64] for i in range(n_scenes)]
    frames = [frame_descs(rng, scenes[i]) for i in range(n_scenes)]
    frames += [frame_descs(rng, scenes[i]) for i in range(9)]
    frames += [rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32) for _ in range(12)]
    return strip, frames


def test_bayes_filter_trace_matches_reference():
    rng = np.random.default_rng(12)
    strip, frames = _revisit_frames(rng)
    jv = JVocab.train(strip, num_words=128, iterations=5, seed=2)
    tv = convert.vocabulary_from_numpy(np.asarray(jv.centroids), np.asarray(jv.idf), "cpu")
    cfg = dict(distant_frame_thresh=50, database_capacity=256)
    jopt, topt = FakeOptimizer(), FakeOptimizer()
    jd = JDetector(jv, JLoopConfig(**cfg), optimizer=jopt)
    td = LoopDetector(tv, LoopConfig(**cfg), optimizer=topt)
    valid = np.ones(64, bool)
    in_loop = []
    for f in frames:
        for d in (jd, td):
            d.query(f, valid)
            d.track(f, valid)
        assert td.in_loop == jd.in_loop
        in_loop.append(td.in_loop)

    assert any(in_loop) and not in_loop[-1]       # entered, then left
    assert topt.optimize_calls == jopt.optimize_calls >= 1
    assert topt.edges == jopt.edges and len(topt.edges) >= 1
    assert min(td.probabilities) == LoopConfig().min_loop_probability  # decayed to the floor
    assert [m[0] for m in td.matches] == [m[0] for m in jd.matches]
    np.testing.assert_allclose([m[1] for m in td.matches], [m[1] for m in jd.matches],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.probabilities, jd.probabilities, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.frame_scores, jd.frame_scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.database.numpy(), np.asarray(jd.database), rtol=0, atol=1e-6)


def test_process_batch_equals_sequential(rng):
    n_frames, n_feat = 40, 64
    corpus = rng.integers(0, 2 ** 32, (4096, 8), dtype=np.uint32)
    vocab = OrbVocabulary.train(corpus, num_words=128, iterations=3, device="cpu")
    frames = []
    for i in range(n_frames):
        d = (frames[i - 30][0].copy() if i >= 30
             else rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32))
        frames.append((d, np.ones(n_feat, bool)))
    recorded = np.ones(n_frames, bool)
    recorded[[5, 17]] = False

    cfg = LoopConfig(distant_frame_thresh=20, database_capacity=16)
    d1 = LoopDetector(vocab, cfg)
    for i in range(n_frames):
        if recorded[i]:
            d1.query(*frames[i])
            d1.track(*frames[i])
    d2 = LoopDetector(vocab, cfg)
    k = 8
    for s in range(0, n_frames, k):
        chunk = frames[s: s + k]
        d2.process_batch(np.stack([c[0] for c in chunk]), np.stack([c[1] for c in chunk]),
                         recorded[s: s + k])
    assert d1.db_size == d2.db_size == int(recorded.sum())
    assert d2.database.shape[0] == 64  # grown from 16 on the way
    assert d1.matches == d2.matches
    np.testing.assert_allclose(d1.frame_scores, d2.frame_scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d1.probabilities, d2.probabilities, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d1.database[: d1.db_size].numpy(),
                               d2.database[: d2.db_size].numpy(), rtol=0, atol=1e-6)

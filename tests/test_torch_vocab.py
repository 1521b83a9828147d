"""Port parity: the flat ORB vocabulary (loop/vocab.py) against the JAX
package's, on the CPU.

Seeded descriptor corpora (tests/test_loop.py's clustered generator) go
through `stereo_orb_slam_tpu.loop.vocab` and the port's `loop/vocab.py`.
Tolerances:

- `assign_words`: words identical on valid rows, word 0 at distance 257 on
  invalid rows (both exact: integer Hamming distances, first-index ties);
- `OrbVocabulary.train` (W = 64 to 256, 4 iterations, the same seed):
  centroids and idf bit-identical (the majority sums are integer-valued
  and the assignment is exact);
- `bow_vector` and `l1_scores`: within 1e-6 (float32 sums over W words in
  another order);
- `batch_score_update` with K = 4, duplicate frames (equal scores) and
  -1 padding: top ids identical, scores and database rows within 1e-6;
- the `.npz` of either package loads in the other, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_loop import clustered_descriptors  # noqa: E402

from stereo_orb_slam_tpu.loop import vocab as jvocab  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.loop import vocab as tvocab  # noqa: E402

torch.set_num_threads(1)


def _t(desc_u32):
    return tvocab.desc_tensor(desc_u32, "cpu")


@pytest.fixture(scope="module")
def corpus():
    packed, _ = clustered_descriptors(np.random.default_rng(5), n_clusters=48,
                                      per_cluster=24, flip_bits=12)
    return packed


@pytest.fixture(scope="module")
def vocabs(corpus):
    jv = jvocab.OrbVocabulary.train(corpus, num_words=128, iterations=4, seed=3)
    tv = tvocab.OrbVocabulary.train(corpus, num_words=128, iterations=4, seed=3, device="cpu")
    return jv, tv


def test_assign_words_matches_reference(corpus, vocabs):
    jv, tv = vocabs
    valid = np.random.default_rng(1).random(len(corpus)) >= 0.2
    jw, jd = jvocab.assign_words(jnp.asarray(corpus), jnp.asarray(valid), jv.centroids)
    tw, td = tvocab.assign_words(_t(corpus), torch.from_numpy(valid), _t(np.asarray(jv.centroids)))
    np.testing.assert_array_equal(tw.numpy()[valid], np.asarray(jw)[valid])
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd, np.float32))
    assert (tw.numpy()[~valid] == 0).all() and (td.numpy()[~valid] == 257).all()


@pytest.mark.parametrize("words", [64, 256])
def test_train_is_bit_identical(corpus, words):
    jv = jvocab.OrbVocabulary.train(corpus, num_words=words, iterations=4, seed=7)
    tv = tvocab.OrbVocabulary.train(corpus, num_words=words, iterations=4, seed=7,
                                    device="cpu")
    np.testing.assert_array_equal(tv.centroids_u32(), np.asarray(jv.centroids))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))


def test_bow_vector_and_l1_scores(corpus, vocabs):
    jv, tv = vocabs
    rng = np.random.default_rng(2)
    frames = [corpus[rng.choice(len(corpus), 64, replace=False)] for _ in range(5)]
    valid = rng.random(64) >= 0.1
    jb = [np.asarray(jv.bow_vector(jnp.asarray(f), jnp.asarray(valid))) for f in frames]
    tb = [tv.bow_vector(_t(f), torch.from_numpy(valid)).numpy() for f in frames]
    np.testing.assert_allclose(np.stack(tb), np.stack(jb), rtol=0, atol=1e-6)
    js = np.asarray(jvocab.l1_scores(jnp.asarray(jb[0]), jnp.asarray(np.stack(jb))))
    ts = tvocab.l1_scores(torch.from_numpy(jb[0]), torch.from_numpy(np.stack(jb))).numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    assert abs(ts[0] - 1.0) < 1e-6


def test_batch_score_update_matches_reference(corpus, vocabs):
    """K = 4 frames of 64 descriptors against a 16-row database with 6 rows
    in use: frame 2 repeats frame 0 and database row 3 repeats row 1 (equal
    scores, lower index first), frame 1 is not recorded, a quarter of the
    slots are invalid; with query_size 10 the tail of each top-k is -1
    padding."""
    jv, tv = vocabs
    rng = np.random.default_rng(4)
    pick = lambda: corpus[rng.choice(len(corpus), 64, replace=False)]  # noqa: E731
    db_frames = [pick() for _ in range(6)]
    db_frames[3] = db_frames[1]
    vdb = np.ones(64, bool)
    database = np.zeros((16, 128), np.float32)
    for i, f in enumerate(db_frames):
        database[i] = np.asarray(jv.bow_vector(jnp.asarray(f), jnp.asarray(vdb)))
    desc = np.stack([pick() for _ in range(4)])
    desc[2] = desc[0]
    desc[3, :32] = db_frames[1][:32]
    valid = rng.random((4, 64)) >= 0.25
    valid[2] = valid[0]
    recorded = np.array([True, False, True, True])
    for q in (4, 10):
        ji, js, jdb = jvocab.batch_score_update(
            jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(recorded), jv.centroids,
            jv.idf, jnp.asarray(database), jnp.int32(6), query_size=q)
        ti, ts, tdb = tvocab.batch_score_update(
            _t(desc.reshape(-1, 8)).reshape(4, 64, 8), torch.from_numpy(valid),
            torch.from_numpy(recorded), tv.centroids, tv.idf,
            convert.loop_database_from_numpy(database, 6, "cpu"), 6, query_size=q)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), rtol=0, atol=1e-6)
        # The duplicated frame's earlier copy and the repeated database rows
        # rank as the JAX top_k ranks ties.
        assert ti.numpy()[2][0] == 6
    assert (ti.numpy()[:, -1] == -1).any()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_round_trip_between_packages(corpus, vocabs, tmp_path, writer):
    jv, tv = vocabs
    path = str(tmp_path / "vocab.npz")
    if writer == "jax":
        jv.save(path)
        got = tvocab.OrbVocabulary.load(path, device="cpu")
        np.testing.assert_array_equal(got.centroids_u32(), np.asarray(jv.centroids))
        np.testing.assert_array_equal(got.idf.numpy(), np.asarray(jv.idf))
    else:
        tv.save(path)
        data = np.load(path)
        assert data["centroids"].dtype == np.uint32 and data["idf"].dtype == np.float32
        got = jvocab.OrbVocabulary.load(path)
        np.testing.assert_array_equal(np.asarray(got.centroids), tv.centroids_u32())
        np.testing.assert_array_equal(np.asarray(got.idf), tv.idf.numpy())

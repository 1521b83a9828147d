"""The loop-closure path on the card against the port's CPU path.

Tolerances: the vocabulary assignment (the hamming_top2 kernel with the
words as its train set) and the trained vocabulary bit for bit (integer
distances, first-index ties, integer-valued majority sums);
`batch_score_update` ids identical, scores and database rows within 1e-6
(no matrix product: a min and a sum over W in another order); the pose
graph's first Gauss-Newton step within 1e-5 rad / 1e-4 m, with no host
sync. These need a CUDA device and skip without one; on the card run

    python -m pytest -q --noconftest -m cuda tests/test_torch_loop_card.py

The CPU-only checks here (the wrappers' device rules) run everywhere. This
file imports neither JAX nor the JAX package.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereo_orb_slam_torch.backend import pose_graph as tpg  # noqa: E402
from stereo_orb_slam_torch.config import PoseGraphConfig  # noqa: E402
from stereo_orb_slam_torch.geometry import se3  # noqa: E402
from stereo_orb_slam_torch.loop import vocab as tvocab  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _corpus(rng, n=4096):
    base = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    flips = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32) & rng.integers(
        0, 2 ** 32, (n, 8), dtype=np.uint32) & rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    return base[rng.integers(0, 64, n)] ^ flips  # clustered: about 1/8 of the bits flipped


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 12000, 3])
def test_assign_words_kernel_matches_plain(rng, cuda, n):
    words = tvocab.desc_tensor(rng.integers(0, 2 ** 32, (1024, 8), dtype=np.uint32), cuda)
    desc = tvocab.desc_tensor(_corpus(rng, n), cuda)
    valid = torch.as_tensor(rng.random(n) >= 0.1, device=cuda)
    got = tvocab.assign_words(desc, valid, words)
    want = tvocab.assign_words(desc.cpu(), valid.cpu(), words.cpu())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_vocabulary_training_matches_cpu(rng, cuda):
    corpus = _corpus(rng)
    got = tvocab.OrbVocabulary.train(corpus, num_words=256, iterations=4, seed=3, device=cuda)
    want = tvocab.OrbVocabulary.train(corpus, num_words=256, iterations=4, seed=3, device="cpu")
    np.testing.assert_array_equal(got.centroids_u32(), want.centroids_u32())
    np.testing.assert_array_equal(got.idf.cpu().numpy(), want.idf.numpy())


@pytest.mark.cuda
def test_batch_score_update_matches_cpu(rng, cuda):
    vocab = tvocab.OrbVocabulary.train(_corpus(rng), num_words=1024, iterations=2,
                                       device="cpu")
    frames = [_corpus(rng, 1024) for _ in range(40)]
    frames[38] = frames[3]  # a revisit (batch row 2, recorded): equal scores
    valid = torch.ones(1024, dtype=torch.bool)
    db = torch.zeros((64, 1024))
    for i in range(36):
        db[i] = vocab.bow_vector(frames[i], valid)
    desc = torch.stack([tvocab.desc_tensor(f, "cpu") for f in frames[36:]])
    args = (desc, torch.ones((4, 1024), dtype=torch.bool),
            torch.tensor([True, False, True, True]), vocab.centroids, vocab.idf, db, 36)
    want = tvocab.batch_score_update(*args, query_size=4)
    got = tvocab.batch_score_update(
        *(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args), query_size=4)
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=1e-6)
    assert int(want[0][2, 0]) == 3


def _drift_graph(rng, n=40):
    rel = [torch.eye(4)]
    for _ in range(n - 1):
        xi = torch.tensor(np.concatenate([rng.normal(size=3) * 0.02, [0.0, 0.0, 0.5]]),
                          dtype=torch.float32)
        rel.append(se3.se3_exp(xi))
    poses = [rel[0]]
    for r in rel[1:]:
        poses.append(poses[-1] @ r)
    poses = torch.stack(poses)
    noisy = poses.clone()
    noisy[1:, :3, 3] += torch.as_tensor(rng.normal(size=(n - 1, 3)) * 0.05, dtype=torch.float32)
    ea = torch.cat([torch.arange(n - 1), torch.tensor([n - 1])])
    eb = torch.cat([torch.arange(1, n), torch.tensor([0])])
    meas = torch.cat([torch.stack(rel[1:]), (se3.inverse(poses[n - 1]) @ poses[0])[None]])
    vm = torch.ones(n)
    vm[0] = 0.0
    return tpg.PoseGraphProblem(noisy, ea, eb, meas, torch.ones(n), vm)


@pytest.mark.cuda
def test_pg_solve_first_step_matches_cpu_without_sync(rng, cuda):
    prob = _drift_graph(rng)
    cfg = PoseGraphConfig(iterations=1)
    want, _, _ = tpg.pg_solve(prob, cfg)
    dev_prob = tpg.PoseGraphProblem(*(t.to(cuda) for t in prob))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, c0, c1 = tpg.pg_solve(dev_prob, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    P, R = got.poses.cpu(), want.poses
    assert float((P[:, :3, :3] - R[:, :3, :3]).abs().max()) <= 1e-5
    assert float((P[:, :3, 3] - R[:, :3, 3]).abs().max()) <= 1e-4


def test_assign_words_needs_one_device(rng):
    words = tvocab.desc_tensor(rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32), "cpu")
    desc = tvocab.desc_tensor(rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint32), "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        word, dist = tvocab.assign_words(desc, torch.tensor([True, False, True, True, True]),
                                         words)
    assert word[1] == 0 and dist[1] == 257 and dist.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            tvocab.assign_words(desc.to("meta"), torch.ones(5, dtype=torch.bool, device="meta"),
                                words.to("meta"))

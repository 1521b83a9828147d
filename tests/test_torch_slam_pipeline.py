"""The port's SLAM live loop against itself, and its CLI, on the CPU.

The properties tests/test_batch_tracking.py holds for the JAX package, on
the port (its own seeded samplers), on the CloudScene sequence there (128
features, RANSAC with refit):
- `process_batch` with the BoW scoring fused into the front-end chain (K = 1
  and K = 4) replays sequential `process()`: the same database size and
  matched ids, probabilities and database rows within 1e-6 (the fused
  scoring's float32 sums over a batch run in another order), poses bit for
  bit;
- a vocabulary that trains while a batch is in flight keeps database row f
  equal to frame f's recomputed BoW vector (1e-6);
- fused batches, then sequential frames (the previous frame's descriptors
  come from the device carry): the same trajectory and host descriptors as
  a sequential run, bit for bit;
- pipelined BA (draining after every batch or not) gives the same world,
  bit for bit;
and the fixes of three reference findings (ADVICE.md): the pipelined BA
log records the stats its own finisher returned, and a deferred polish
that finds the pending-BA slot taken finishes the pending solve first.
Last, the CLIs on the synthetic-KITTI recipe with `--device cpu`: the SLAM
app's nine artifacts and ATE < 0.01 m for --batch_frames 1 and 4, and
train_vocab's `.npz` loading back to the vocabulary it trained.
"""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from synth import CloudScene, forward_yaw_trajectory  # noqa: E402
from test_torch_vo_app import _write_sequence  # noqa: E402

from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import slam as tslam  # noqa: E402
from stereo_orb_slam_torch.config import (  # noqa: E402
    FrontendConfig, LoopConfig, RansacConfig, SlamConfig,
)
from stereo_orb_slam_torch.loop import OrbVocabulary  # noqa: E402

torch.set_num_threads(1)
FE = FrontendConfig(num_features=128)
RC = RansacConfig(final_model_fitting=True)
LOOP = LoopConfig(vocab_words=128, database_capacity=8, distant_frame_thresh=6,
                  adjacent_frame_thresh=2)


def _make_seq(n, blank=()):
    traj = forward_yaw_trajectory(n, speed=0.25, yaw_rate_deg=1.5)
    scene = CloudScene(np.random.default_rng(1), traj, fx=240.0, baseline=0.6,
                       depth_range=(4.0, 14.0), n_per_anchor=40, anchor_stride=4)
    seq = scene.render_sequence(traj)
    for b in blank:
        seq[b] = (np.full_like(seq[b][0], 96.0), np.full_like(seq[b][1], 96.0))
    return traj, scene, seq


def _rig(scene):
    return convert.rig_from_numpy(jax.tree.map(np.asarray, scene.make_rig()), "cpu")


@pytest.fixture(scope="module")
def vocab():
    corpus = np.random.default_rng(0).integers(0, 2 ** 32, (4096, 8), dtype=np.uint32)
    return OrbVocabulary.train(corpus, num_words=128, iterations=3, device="cpu")


def _batched(system, seq, k, stop=None):
    stop = len(seq) if stop is None else stop
    out = []
    for s in range(0, stop, k):
        out += system.process_batch(np.stack([seq[i][0] for i in range(s, s + k)]),
                                    np.stack([seq[i][1] for i in range(s, s + k)]))
    return out


@pytest.mark.parametrize("k", [1, 4])
def test_fused_bow_batch_equals_sequential(vocab, k):
    n = 16
    _, scene, seq = _make_seq(n, blank=(9,))
    cfg = SlamConfig(frontend=FE, ransac=RC, per_frame_ba=False, refine_interval=10 ** 6,
                     batch_frames=k, loop=LOOP)
    s1 = tslam.SlamSystem(_rig(scene), cfg, vocab=vocab)
    for il, ir in seq:
        s1.process(il, ir)
    s2 = tslam.SlamSystem(_rig(scene), cfg, vocab=vocab)
    out = _batched(s2, seq, k)
    out += s2.flush()
    assert len(out) == n
    assert s2.fused_score_batches == n // k
    assert s1.loop.db_size == s2.loop.db_size == n - 1
    assert s1.loop.matches == s2.loop.matches
    np.testing.assert_allclose(s1.loop.probabilities, s2.loop.probabilities, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s1.loop.database[: s1.loop.db_size].numpy(),
                               s2.loop.database[: s2.loop.db_size].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(s1.world.pose_global[: s1.world.num_frames],
                                  s2.world.pose_global[: s2.world.num_frames])


def test_vocab_trains_midflight_database_consistent():
    n = 24
    _, scene, seq = _make_seq(n)
    cfg = SlamConfig(frontend=FE, ransac=RC, per_frame_ba=False, refine_interval=10 ** 6,
                     batch_frames=4, loop=LoopConfig(**{**LOOP.__dict__, "vocab_iterations": 2}))
    system = tslam.SlamSystem(_rig(scene), cfg, vocab=None, vocab_train_frames=10)
    out = _batched(system, seq, 4)
    out += system.flush()
    assert system.loop is not None, "vocabulary never trained"
    assert len(out) == n
    w = system.world
    assert system.loop.db_size == w.num_frames
    assert w.frame_desc_stale
    system.sync_feature_banks()
    assert not w.frame_desc_stale
    db = system.loop.database[: system.loop.db_size].numpy()
    for f in range(w.num_frames):
        expected = system.vocab.bow_vector(w.frame_desc[f], w.frame_feat_valid[f]).numpy()
        np.testing.assert_allclose(db[f], expected, rtol=0, atol=1e-6,
                                   err_msg=f"database row {f} is not frame {f}'s BoW vector")


def test_bow_batch_then_sequential_remainder(vocab):
    n = 16
    _, scene, seq = _make_seq(n)
    cfg = SlamConfig(frontend=FE, ransac=RC, per_frame_ba=False, refine_interval=10 ** 6,
                     batch_frames=4, loop=LOOP)
    s1 = tslam.SlamSystem(_rig(scene), cfg, vocab=vocab)
    for il, ir in seq:
        s1.process(il, ir)
    s2 = tslam.SlamSystem(_rig(scene), cfg, vocab=vocab)
    _batched(s2, seq, 4, stop=12)
    for i in range(12, n):  # the remainder through the sequential path
        s2.process(*seq[i])
    s2.flush()
    assert s1.loop.db_size == s2.loop.db_size == n
    np.testing.assert_allclose(s1.loop.probabilities, s2.loop.probabilities, rtol=0, atol=1e-6)
    nf = s1.world.num_frames
    np.testing.assert_array_equal(s1.world.pose_global[:nf], s2.world.pose_global[:nf])
    np.testing.assert_array_equal(s1.world.frame_desc[:nf], s2.world.frame_desc[:nf])


def test_pipelined_ba_is_bitwise_neutral():
    n = 24
    _, scene, seq = _make_seq(n)
    cfg = SlamConfig(frontend=FE, ransac=RC, refine_interval=8, batch_frames=6,
                     live_ba_iterations=4)

    def run(force_sync):
        system = tslam.SlamSystem(_rig(scene), cfg, vocab=None, vocab_train_frames=10 ** 9)
        for s in range(0, n, 6):
            system.process_batch(np.stack([seq[i][0] for i in range(s, s + 6)]),
                                 np.stack([seq[i][1] for i in range(s, s + 6)]))
            if force_sync:
                system.flush()
        system.flush()
        assert len(system.ba_log) == n // 6
        return system.world

    w1, w2 = run(True), run(False)
    np.testing.assert_array_equal(w1.pose_global[: w1.num_frames], w2.pose_global[: w2.num_frames])
    np.testing.assert_array_equal(w1.points[: w1.num_points], w2.points[: w2.num_points])


class _Stats:
    """A finisher returning its own stats dict; the adjuster's last_stats
    says something else (a stale solve's)."""

    def __init__(self, log):
        self.log = log

    def __call__(self, name, iterations):
        def fin():
            self.log.append(name)
            return {"iterations": iterations, "num_obs": 100 + iterations}
        return fin


def test_ba_log_and_deferred_polish_adoption():
    _, scene, _ = _make_seq(2)
    system = tslam.SlamSystem(_rig(scene), SlamConfig(frontend=FE), vocab_train_frames=10 ** 9)
    system.ba.last_stats = {"iterations": -7, "num_obs": -7}
    log = []
    make = _Stats(log)
    system._pending_ba = make("window", 3)
    system._finish_pending_ba()
    assert system.ba_log[-1][2:] == (3, 103)  # the finisher's dict, not last_stats
    # A polish arriving while a window solve is pending: the window solve is
    # finished first, then the polish takes the slot.
    system._pending_ba = make("window", 5)
    system.pgo.deferred_ba_finish = make("polish", 9)
    system._adopt_deferred_polish()
    assert log == ["window", "window"] and system.pgo.deferred_ba_finish is None
    system.flush()
    assert log == ["window", "window", "polish"]
    assert [e[2] for e in system.ba_log] == [3, 5, 9]


ARTIFACTS = ("poses.txt", "points.txt", "constraints.txt", "waypoints_slam.ply",
             "map_slam.ply", "pose_graph_slam.ply", "trajectory_slam.txt",
             "loop_matches.txt", "vocabulary.npz")


@pytest.mark.parametrize("batch_frames", [1, 4])
def test_slam_cli_on_cpu_writes_the_artifacts(tmp_path, batch_frames):
    seq, gt = _write_sequence(str(tmp_path), n=14)
    out = str(tmp_path / "slam_out")
    summary = tslam.main([
        "--dataset", "kitti", "--folder", seq, "--camera", os.path.join(seq, "calib.txt"),
        "--output_dir", out, "--gt", gt, "--refine_interval", "4", "--num_features", "256",
        "--batch_frames", str(batch_frames), "--device", "cpu",
    ])
    assert summary["frames"] == summary["tracked"] == 14
    assert summary["ate_m"] < 0.01
    system = summary["system"]
    assert system.loop is not None and system.loop.db_size == 14
    for name in ARTIFACTS:
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    with open(os.path.join(out, "loop_matches.txt")) as f:
        assert len(f.read().splitlines()) == 14 - 12  # queries after the vocabulary


def test_slam_cli_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    seq, _ = _write_sequence(str(tmp_path), n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tslam.main(["--dataset", "kitti", "--folder", seq,
                    "--camera", os.path.join(seq, "calib.txt"),
                    "--output_dir", str(tmp_path / "o")])


def test_train_vocab_cli_on_cpu(tmp_path):
    from stereo_orb_slam_torch.apps import train_vocab

    seq, _ = _write_sequence(str(tmp_path), n=4)
    out = str(tmp_path / "vocab.npz")
    trained = train_vocab.main(["--dataset", "kitti", "--folder", seq, "--out", out,
                                "--stride", "1", "--words", "256", "--iterations", "2",
                                "--device", "cpu"])
    loaded = OrbVocabulary.load(out, device="cpu")
    assert loaded.num_words == 256
    np.testing.assert_array_equal(loaded.centroids_u32(), trained.centroids_u32())
    np.testing.assert_array_equal(loaded.idf.numpy(), trained.idf.numpy())

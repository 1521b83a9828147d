"""The live loop's readback order: a batch is read back right after its own
chain, and nothing waits on the stream between the next batch's dispatch
and the window BA's launch.

On the CPU (JAX-free, the CloudScene drive of
tests/test_torch_slam_pipeline.py at 128 features):
- two batches dispatched before either is collected give the transforms and
  the world of `track_batch` called in order, bit for bit;
- `SlamSystem.process_batch` (each batch collected after the next one's
  dispatch) gives the transforms, the world and the BA log of the same
  drive with every batch collected at once, bit for bit;
- `Readback` unpacks what `_to_host` reads;
- `BundleAdjuster.prepare`'s problem tensors equal `torch.as_tensor` of the
  same arrays, and `ba.upload` into a tensor writes those bytes.

On the card (marker `cuda`; skipped without one):

    python -m pytest -q --noconftest -m cuda tests/test_torch_live_overlap.py

- a drive past its vocabulary's training, then a second drive on that
  vocabulary (every program captured by the first) with each
  `_collect_pending_batch` under `torch.cuda.set_sync_debug_mode("error")`:
  no collect syncs the stream, and the pipelined collects find their
  readback arrived (`readback_stats["ready"]`), while a `track_batch`
  collect waits for it;
- the problem tensors as above, on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import CloudScene, forward_yaw_trajectory  # noqa: E402
from synth_canyon import make_rig  # noqa: E402

from stereo_orb_slam_torch.apps import slam as tslam  # noqa: E402
from stereo_orb_slam_torch.backend import ba as tba  # noqa: E402
from stereo_orb_slam_torch.config import (  # noqa: E402
    FrontendConfig, LoopConfig, RansacConfig, SlamConfig,
)
from stereo_orb_slam_torch.frontend import odometer  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)
FE = FrontendConfig(num_features=128)
RC = RansacConfig(final_model_fitting=True)
# No frame is ever distant enough to be a loop candidate: no closure.
LOOP = LoopConfig(vocab_words=128, vocab_iterations=2, database_capacity=8,
                  distant_frame_thresh=10 ** 6, adjacent_frame_thresh=2)
K = 4
WORLD = ("pose_global", "pose_rel", "points", "point_first_frame", "point_obs_count",
         "point_parent", "obs_frame", "obs_point", "obs_uv", "frame_desc", "frame_feat_uv",
         "frame_feat_point", "frame_feat_valid")


@pytest.fixture(scope="module")
def drive():
    traj = forward_yaw_trajectory(24, speed=0.25, yaw_rate_deg=1.5)
    scene = CloudScene(np.random.default_rng(1), traj, fx=240.0, baseline=0.6,
                       depth_range=(4.0, 14.0), n_per_anchor=40, anchor_stride=4)
    return scene, scene.render_sequence(traj)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream and its syncs exist only on the card")
    return torch.device("cuda")


def _batches(seq, device):
    for s in range(0, len(seq) - len(seq) % K, K):
        yield tuple(torch.as_tensor(np.stack([seq[i][e] for i in range(s, s + K)]),
                                    device=device) for e in (0, 1))


def _assert_same_world(a: WorldMap, b: WorldMap):
    assert (a.num_frames, a.num_points, a.num_obs) == (b.num_frames, b.num_points, b.num_obs)
    counts = {"pose": a.num_frames, "frame": a.num_frames, "point": a.num_points,
              "points": a.num_points, "obs": a.num_obs}
    for name in WORLD:
        n = counts[name.split("_")[0]]
        np.testing.assert_array_equal(getattr(a, name)[:n], getattr(b, name)[:n],
                                      err_msg=name)


def _slam(scene, device, vocab=None, **kw):
    cfg = SlamConfig(frontend=FE, ransac=RC, refine_interval=8, batch_frames=K,
                     live_ba_iterations=4, loop=LOOP)
    return tslam.SlamSystem(make_rig(scene, device), cfg, vocab=vocab, **kw)


def test_two_batches_in_flight_equal_track_batch_in_order(drive):
    scene, seq = drive
    rig = make_rig(scene, "cpu")

    def odometer_(world):
        return odometer.VisualOdometer(world, rig, FE, RC, seed=3)

    w1, w2 = WorldMap(feat_slots=FE.num_features), WorldMap(feat_slots=FE.num_features)
    vo1, vo2 = odometer_(w1), odometer_(w2)
    in_order, in_flight, pending = [], [], None
    for imgs in _batches(seq, "cpu"):
        in_order += vo1.track_batch(*imgs)
        handle = vo2.dispatch_batch(*imgs)
        if pending is not None:
            in_flight += vo2.collect_batch(pending)
        pending = handle
    in_flight += vo2.collect_batch(pending)
    assert len(in_order) == len(in_flight) == len(seq)
    for a, b in zip(in_order, in_flight):
        np.testing.assert_array_equal(a, b)
    _assert_same_world(w1, w2)
    assert w1.num_frames > len(seq) - 2
    # Off the card the bytes are on the host when the collect begins.
    assert vo2.readback_stats == {"ready": len(seq) // K, "waited": 0}


def test_pipelined_loop_equals_collecting_each_batch_at_once(drive):
    scene, seq = drive

    def run(at_once):
        system = _slam(scene, "cpu", vocab_train_frames=8)
        out = []
        for imgs in _batches(seq, "cpu"):
            out += system.process_batch(*imgs)
            if at_once:
                out += system.flush()
        out += system.flush()
        assert system.loop is not None, "the vocabulary never trained"
        # The fused batches' descriptors are on the device rings.
        system.sync_feature_banks()
        return system, out

    (s1, out1), (s2, out2) = run(True), run(False)
    assert len(out1) == len(out2) == len(seq)
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)
    _assert_same_world(s1.world, s2.world)
    assert len(s1.ba_log) == len(s2.ba_log) == len(seq) // K
    assert [e[0] for e in s1.ba_log] == [e[0] for e in s2.ba_log]
    assert [e[2:] for e in s1.ba_log] == [e[2:] for e in s2.ba_log]
    assert s1.loop.db_size == s2.loop.db_size
    assert s1.loop.matches == s2.loop.matches


def test_readback_unpacks_what_to_host_reads(drive):
    scene, seq = drive
    world = WorldMap(feat_slots=FE.num_features)
    vo = odometer.VisualOdometer(world, make_rig(scene, "cpu"), FE, RC)
    stacked = vo.dispatch_batch(*next(_batches(seq, "cpu")))["stacked"]
    for with_desc in (True, False):
        want = odometer._to_host(stacked, with_desc)
        fields = odometer._step_fields(stacked, with_desc)
        got = odometer._host_result(odometer.Readback(fields).arrays(), stacked, with_desc)
        for g, w in zip(odometer._leaves(got), odometer._leaves(want)):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _prepared(scene, seq, device):
    system = _slam(scene, device, vocab_train_frames=10 ** 9)
    for imgs in _batches(seq, device):
        system.process_batch(*imgs)
    system.flush()
    n = system.world.num_frames
    return system.ba.prepare(max(0, n - 12), n)


def _assert_problem_is_as_tensor(setup, device):
    problem = setup.problem
    pose6, s_cam, s_point, s_uv, cam_mask = tba.prepare_problem_arrays(problem,
                                                                       sort_by_point=True)
    C, P, O = setup.num_cams, setup.num_points, setup.num_obs
    want = {"pose6": pose6, "obs_cam": s_cam, "obs_point": s_point, "obs_uv": s_uv,
            "cam_mask": cam_mask, "points": problem["point_xyz"],
            "obs_weight": np.ones(O, np.float32), "point_mask": np.ones(P, np.float32)}
    rows = {"pose6": C, "cam_mask": C, "points": P, "point_mask": P}
    for name, arr in want.items():
        t = getattr(setup.prob, name)
        ref = torch.as_tensor(np.asarray(arr), device=device).to(t.dtype)
        assert t.device.type == torch.device(device).type
        assert torch.equal(t[: rows.get(name, O)].cpu(), ref.cpu()), name
    # The padding: zero rows, held fixed.
    assert not setup.prob.obs_weight[O:].any() and not setup.prob.cam_mask[C:].any()
    band = np.arange(5, dtype=np.int64)[::-1]   # a strided array
    out = torch.full((5,), -1, dtype=torch.int64, device=device)
    tba.upload(band, device, out=out)
    assert torch.equal(out.cpu(), torch.as_tensor(band.copy()))


def test_ba_prepare_uploads_are_as_tensor(drive):
    scene, seq = drive
    setup = _prepared(scene, seq, "cpu")
    assert setup is not None and setup.num_obs > 0
    _assert_problem_is_as_tensor(setup, "cpu")


@pytest.mark.cuda
def test_ba_prepare_uploads_are_as_tensor_on_the_card(drive, cuda):
    scene, seq = drive
    setup = _prepared(scene, seq, cuda)
    torch.cuda.synchronize()
    _assert_problem_is_as_tensor(setup, cuda)


@pytest.mark.cuda
def test_collect_syncs_no_stream_and_finds_its_readback(drive, cuda):
    scene, seq = drive
    # A drive past the vocabulary's training: it captures every program the
    # second drive replays, whose BA windows have the same shapes.
    trainer = _slam(scene, cuda, vocab_train_frames=8)
    for imgs in _batches(seq, cuda):
        trainer.process_batch(*imgs)
    trainer.flush()
    vocab = trainer.vocab
    assert vocab is not None, "the vocabulary never trained"
    del trainer
    batches = list(_batches(seq, cuda))
    torch.cuda.synchronize()

    system = _slam(scene, cuda, vocab=vocab)
    collect, guarded = system._collect_pending_batch, []

    def under_sync_debug():
        if system._pending_batch is None:
            return collect()
        closures = len(system.pgo.history)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = collect()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert len(system.pgo.history) == closures, "a loop closed"
        guarded.append(len(out))
        return out

    system._collect_pending_batch = under_sync_debug
    for imgs in batches:
        system.process_batch(*imgs)
    # The drain finishes the last BA first: a host read, not guarded.
    system._collect_pending_batch = collect
    system.flush()
    assert guarded == [K] * (len(batches) - 1)
    assert len(system.ba_log) == len(batches)
    stats = system.vo.readback_stats
    assert sum(stats.values()) == len(batches)
    # Each call first finishes the BA launched behind the chain it then
    # collects: from the second batch on, the bytes have arrived.
    assert stats["ready"] >= len(batches) - 1, stats

    vo = odometer.VisualOdometer(WorldMap(feat_slots=FE.num_features),
                                 make_rig(scene, cuda), FE, RC)
    vo.track_batch(*batches[0])
    assert vo.readback_stats == {"ready": 0, "waited": 1}

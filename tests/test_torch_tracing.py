"""The port's span facility (`stereo_orb_slam_torch/utils/profiling.py`)
and the spans the program opens.

- Off, a span records nothing, reads no clock and opens no profiler region,
  even while a torch.profiler records; `VisualOdometer.track` then reads
  no clock of the tracer either.
- On, spans nest with their parent and the frame id of their root; a span's
  self time is its duration less its children's; the buffer grows by
  doubling; a profiler region is opened only while a profiler records.
- `StageTimers` stages are spans of their names; a program's capture is a
  `program.capture` span whose clock gives `capture_ms` (one span for each
  capture the program counts), and a replay a `program.replay` span.
- `VisualOdometer.track` over PlaneScene frames on the CPU gives the same
  poses and world map, bit for bit, with tracing on and off, and its
  children (`vo.upload`, `vo.launch`, `vo.readback`, `vo.map`) cover each
  `vo.track`; the batch path (`track_batch`) opens no span.
- `SlamSystem.process_batch` over a tiny canyon drive that closes a loop
  live: one `slam.batch` root a call, its frame id the batch's first frame;
  the stages' spans under it (or in the flush after the last batch); a
  closure's `pg.optimize` under the batch's `loop.query`, with `pg.edges`
  and `pg.solve` its children, and `pg.polish` where the polish is applied.
  With the tracer off, no span, and the same poses.

This file imports neither JAX nor the JAX package.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402

from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.geometry import camera as cam  # noqa: E402
from stereo_orb_slam_torch.utils import profiling, programs  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _nest(tracer):
    with tracer.span("vo.track", frame=7):
        with tracer.span("vo.upload"):
            pass
        with tracer.span("vo.launch"):
            with tracer.span("program.replay"):
                pass
    with tracer.span("loose"):
        pass


@pytest.fixture
def ticks(monkeypatch):
    """The tracer's clock as a counter: 10 ns a read."""
    clock = itertools.count(0, 10)
    monkeypatch.setattr(profiling, "_clock", lambda: next(clock))


def _no_clock():
    raise AssertionError("the tracer read its clock")


def test_off_records_nothing_reads_no_clock_and_opens_no_region(monkeypatch):
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "_clock", _no_clock)
    assert tracer.span("a") is tracer.span("b", frame=1)   # one shared no-op
    names = _profiled_names(lambda: (_nest(tracer), torch.ones(4).add_(1.0)))
    assert "aten::add_" in names
    assert not names & {"vo.track", "vo.upload", "vo.launch", "program.replay", "loose"}
    assert tracer.spans() == []


def test_on_spans_nest_with_parent_frame_and_self_time(ticks):
    tracer = profiling.Tracer()
    tracer.enable()
    _nest(tracer)
    spans = tracer.spans()
    assert [(s.name, s.parent, s.frame) for s in spans] == [
        ("vo.track", -1, 7), ("vo.upload", 0, 7), ("vo.launch", 0, 7),
        ("program.replay", 2, 7), ("loose", -1, -1)]
    # One clock read at each start and each end, 10 ns apart.
    assert [(s.start_ns, s.end_ns) for s in spans] == [
        (0, 70), (10, 20), (30, 60), (40, 50), (80, 90)]
    assert profiling.self_ns(spans) == [70 - 10 - 30, 10, 30 - 10, 10, 10]
    assert profiling.frame_totals(spans, [7]) == {
        "vo.track": 70, "vo.upload": 10, "vo.launch": 30, "program.replay": 10}
    assert profiling.frame_totals(spans, [-1]) == {"loose": 10}
    assert profiling.frame_totals(spans, [7], profiling.self_ns(spans)) == {
        "vo.track": 30, "vo.upload": 10, "vo.launch": 20, "program.replay": 10}


def test_an_open_span_reads_end_minus_one_and_blocks_a_reset():
    tracer = profiling.Tracer()
    tracer.enable()
    with tracer.span("outer"):
        assert tracer.spans()[0].end_ns == -1
        with pytest.raises(RuntimeError):
            tracer.reset()
    assert tracer.spans()[0].end_ns >= tracer.spans()[0].start_ns


def test_the_buffer_grows_by_doubling():
    tracer = profiling.Tracer(capacity=2)
    tracer.enable()
    sizes = []
    for i in range(9):
        with tracer.span("s", frame=i):
            pass
        sizes.append(len(tracer._buf) // 5)
    assert sizes == [2, 2, 4, 4, 8, 8, 8, 8, 16]
    assert [s.frame for s in tracer.spans()] == list(range(9))


@pytest.mark.parametrize("profiler", [True, False])
def test_on_a_region_is_opened_only_while_a_profiler_records(monkeypatch, profiler):
    tracer = profiling.Tracer()
    tracer.enable()
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    if profiler:
        names = _profiled_names(lambda: _nest(tracer))
        assert {"vo.track", "vo.upload", "vo.launch", "program.replay", "loose"} <= names
    else:
        _nest(tracer)
    assert opened == (["vo.track", "vo.upload", "vo.launch", "program.replay", "loose"]
                      if profiler else [])
    assert len(tracer.spans()) == 5


@pytest.mark.parametrize("on", [True, False])
def test_stage_timers_time_their_stages_as_spans(ticks, on):
    tracer = profiling.Tracer()
    tracer.enable(on)
    timers = profiling.StageTimers(tracer)
    with timers.time("vo.track"):
        with tracer.span("vo.upload"):
            pass
    with pytest.raises(ValueError):
        with timers.time("ba.window"):
            raise ValueError("a stage that fails is timed all the same")
    s = timers.summary()
    assert (s["vo.track"]["count"], s["ba.window"]["count"]) == (1, 1)
    if on:
        spans = tracer.spans()
        assert [(x.name, x.parent) for x in spans] == [
            ("vo.track", -1), ("vo.upload", 0), ("ba.window", -1)]
        assert s["vo.track"]["total_s"] == (spans[0].end_ns - spans[0].start_ns) * 1e-9
        assert s["vo.track"]["total_s"] == pytest.approx(30e-9)
    else:
        assert tracer.spans() == []
        # Timed on the host clock all the same.
        assert s["vo.track"]["total_s"] == pytest.approx(10e-9)


class _Graph:
    def __init__(self, work):
        self.work = work

    def replay(self):
        self.work()

    def reset(self):
        pass


class _Captured(programs.Program):
    """A Program that captures on the CPU with a fake graph, to reach the
    capture's span, which only the card runs."""

    def __init__(self):
        super().__init__("cpu")
        self.x = torch.zeros(1)

    @property
    def captures(self):
        return True

    def _warm_up(self, body):
        body()

    def _record(self, body):
        return _Graph(body)

    def body(self):
        self.x.add_(1)


@pytest.mark.parametrize("on", [True, False])
def test_a_capture_is_a_span_that_gives_capture_ms(monkeypatch, ticks, on):
    tracer = profiling.Tracer()
    tracer.enable(on)
    monkeypatch.setattr(programs, "TRACER", tracer)
    unit = _Captured()
    for _ in range(3):
        unit.run("body", unit.body)
    stat = unit.stats["_Captured.body"]
    assert (stat["captures"], stat["replays"], int(unit.x)) == (1, 2, 3)
    if on:
        spans = tracer.spans()
        assert [s.name for s in spans] == ["program.capture", "program.replay",
                                           "program.replay"]
        assert stat["capture_ms"] == (spans[0].end_ns - spans[0].start_ns) * 1e-9 * 1e3
        assert sum(s.name == "program.capture" for s in spans) == stat["captures"]
    else:
        assert tracer.spans() == []
        # The same clock, read with tracing off.
        assert stat["capture_ms"] == pytest.approx(10e-6)


# -- VisualOdometer.track on the CPU ---------------------------------------

N_FEAT, FRAMES = 128, 4


@pytest.fixture(scope="module")
def scene_frames():
    scene = PlaneScene(np.random.default_rng(3))
    return scene, [(scene.render(0.2 * i), scene.render(0.2 * i, right=True))
                   for i in range(FRAMES)]


def _odometer(scene):
    right = np.eye(4, dtype=np.float32)
    right[0, 3] = scene.baseline
    rig = cam.StereoRig.create(
        cam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, device="cpu"),
        cam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, pose=right, device="cpu"),
        True, scene.baseline)
    fe = FrontendConfig(num_features=N_FEAT)
    return VisualOdometer(WorldMap(feat_slots=N_FEAT), rig, fe=fe,
                          rc=RansacConfig(num_hypotheses=16), seed=5)


def _drive(scene, frames):
    vo = _odometer(scene)
    poses = [vo.track(l, r) for l, r in frames]
    return poses, vo.world


def test_track_with_tracing_off_reads_no_clock_and_opens_no_region(monkeypatch, scene_frames):
    monkeypatch.setattr(profiling, "_clock", _no_clock)
    assert not profiling.TRACER.enabled
    names = _profiled_names(lambda: _drive(*scene_frames))
    assert not {n for n in names if n.startswith(("vo.", "program."))}
    assert profiling.TRACER.spans() == []


def test_track_is_the_same_with_tracing_on_and_covered_by_its_children(monkeypatch,
                                                                       scene_frames):
    tracer = profiling.Tracer()
    for module in ("stereo_orb_slam_torch.frontend.odometer",
                   "stereo_orb_slam_torch.utils.programs"):
        monkeypatch.setattr(f"{module}.TRACER", tracer)
    poses_off, world_off = _drive(*scene_frames)
    assert tracer.spans() == []
    tracer.enable()
    poses_on, world_on = _drive(*scene_frames)

    for a, b in zip(poses_off, poses_on):
        assert np.array_equal(a, b)
    assert world_on.num_points == world_off.num_points > 0
    for key, value in vars(world_off).items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(value, getattr(world_on, key)), key
        elif isinstance(value, (int, float)):
            assert value == getattr(world_on, key), key

    spans = tracer.spans()
    roots = [i for i, s in enumerate(spans) if s.name == "vo.track"]
    assert [spans[i].frame for i in roots] == list(range(FRAMES))
    for i in roots:
        track = spans[i]
        children = [s for s in spans if s.parent == i]
        assert [s.name for s in children] == ["vo.upload", "vo.launch", "vo.readback",
                                              "vo.map"]
        assert all(track.start_ns <= s.start_ns <= s.end_ns <= track.end_ns
                   for s in children)
        covered = sum(s.end_ns - s.start_ns for s in children)
        assert covered >= 0.9 * (track.end_ns - track.start_ns)
        assert all(s.frame == track.frame for s in spans if s.parent == i)


def test_the_batch_path_opens_no_span(monkeypatch, scene_frames):
    tracer = profiling.Tracer()
    for module in ("stereo_orb_slam_torch.frontend.odometer",
                   "stereo_orb_slam_torch.utils.programs"):
        monkeypatch.setattr(f"{module}.TRACER", tracer)
    tracer.enable()
    scene, frames = scene_frames
    vo = _odometer(scene)
    poses = vo.track_batch(np.stack([l for l, _ in frames]), np.stack([r for _, r in frames]))
    assert len(poses) == FRAMES
    assert tracer.spans() == []


# -- the SLAM live loop -------------------------------------------------------

STAGES = ("vo.dispatch", "vo.collect", "ba.window", "ba.finish", "loop.query")


@pytest.fixture(scope="module")
def shuttle():
    """The SLAM cell's tiny drive (tests/test_portbench_slam.py): 160 canyon
    frames whose revisit ends inside a batch, so a loop closes live."""
    from portbench.entries import slam as entry
    from test_portbench_slam import tiny_cell

    cell, cfg = tiny_cell()
    pairs, _ = entry.render(cfg, cell["traffic"], 7, "cpu")
    return pairs, entry._rig(cfg, "cpu"), entry.slam_config(cfg)


def _slam_drive(shuttle, on: bool):
    """The drive through `SlamSystem.process_batch`, 32 frames a call, then
    `flush`, with the process's tracer on or off; (system, spans)."""
    from stereo_orb_slam_torch.apps.slam import SlamSystem

    pairs, rig, cfg = shuttle
    tracer, k = profiling.TRACER, cfg.batch_frames
    tracer.reset()
    tracer.enable(on)
    try:
        system = SlamSystem(rig, cfg, seed=7)
        for lo in range(0, len(pairs), k):
            batch = torch.from_numpy(pairs[lo:lo + k])
            system.process_batch(batch[:, 0], batch[:, 1])
        system.flush()
    finally:
        tracer.enable(False)
    spans = tracer.spans()
    tracer.reset()
    return system, spans


def test_slam_spans_nest_under_the_batch_and_the_closure(shuttle):
    off, none = _slam_drive(shuttle, False)
    assert none == []
    assert off.pgo.live_stall_log, "the drive closed no loop live"
    system, spans = _slam_drive(shuttle, True)
    assert np.array_equal(system.world.pose_global, off.world.pose_global)

    def ancestors(i):
        while spans[i].parent >= 0:
            i = spans[i].parent
            yield i

    batches = [i for i, s in enumerate(spans) if s.name == "slam.batch"]
    assert [spans[i].frame for i in batches] == [0, 32, 64, 96, 128]
    assert all(spans[i].parent == -1 for i in batches)
    flush_start = spans[batches[-1]].end_ns
    for i, s in enumerate(spans):
        root = ([i] + list(ancestors(i)))[-1]
        assert s.frame == spans[root].frame
        if s.name in STAGES:
            # Under the batch's root, or in the flush after the last batch.
            assert spans[root].name == "slam.batch" or (s.parent == -1
                                                        and s.start_ns >= flush_start)
    closures = [i for i, s in enumerate(spans) if s.name == "pg.optimize"]
    assert len(closures) == len(system.pgo.live_stall_log) >= 1
    for i in closures:
        up = [spans[a].name for a in ancestors(i)]
        assert up[0] == "loop.query" and up[-1] == "slam.batch"
        assert [s.name for s in spans if s.parent == i and s.name.startswith("pg.")] == [
            "pg.edges", "pg.solve"]
    polish = [i for i, s in enumerate(spans) if s.name == "pg.polish"]
    assert polish and all(spans[spans[i].parent].name in ("ba.finish", "pg.optimize")
                          for i in polish)

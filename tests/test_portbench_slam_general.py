"""The general-rig SLAM cell of the port's benchmark
(`portbench/entries/slam_general.py`, `euroc_slam_wide`), its scene, its
plain references and its readers, on the CPU at small sizes with seeded
inputs.

- The distorted canyon (`scene/canyon_distorted.py`): at zero distortion
  (fy = fx) its frames are `CanyonScene`'s bit for bit; each pixel's ideal
  coordinates, distorted again by the model, land within 1e-6 px of the
  pixel.
- `reference/general.py::frame` (the general branch with RANSAC's refit)
  against the port's general step (`VisualOdometer.track`), and
  `reference/general.py::edges` against the port's `measure_edges` on the
  general rig (its DLT branch), on frames of a distorted drive the port
  tracked, with the port's keys: within the cell's limits.
- The window BA's numbers read only the landmarks that the reference
  resolves (in front of their first camera, nearer than fx * baseline,
  every observation within Huber's width).
- A window of the cell's drive on which float32's Schur complement
  strays (tests/data/euroc_weak_window.npz: 33 cameras, 8,554 landmarks,
  recorded on the card, seed 2147483931's drive): the program's solve in
  float32 fails the cell's limits and in float64, which the program
  chooses for this rig and a program that lacks it is refused for, passes
  them.
- The entry end to end on a tiny distorted drive that closes a loop live
  (a shuttle) is judged correct, and the control in the port's place is
  not; nor is a run whose timed path is broken underneath.
- The three readers the cell adds (`chain_device_ms`, `ba_device_ms`,
  `roofline.triangulate_dlt.edges`) on synthetic traces, each None where
  its data is absent.
- The program's device timers (`utils/profiling.py`): none made and
  nothing recorded while the tracer is off; on, a timer adds the
  milliseconds between its events under its name.

This file imports neither JAX nor the JAX package.
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402
from portbench import run as bench_run  # noqa: E402
from portbench.entries import slam as slam_entry  # noqa: E402
from portbench.entries import slam_general as entry  # noqa: E402
from portbench.reference import frontend as ref_fe  # noqa: E402
from portbench.reference import general as ref_gen  # noqa: E402
from portbench.reference import judge  # noqa: E402
from portbench.reference.judge import NUMBERS, worst  # noqa: E402
from portbench.roofline import triangulate_dlt as dlt_roof  # noqa: E402
from portbench.scene import canyon  # noqa: E402
from portbench.scene import canyon_distorted as cd  # noqa: E402

from stereo_orb_slam_torch.backend import ba as pba  # noqa: E402
from stereo_orb_slam_torch.backend import pose_graph as ppg  # noqa: E402
from stereo_orb_slam_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)
SEED = 2**31 + 29
CELL = "euroc_slam_wide"


def tiny_cell():
    """The cell cut to run on the CPU: 400 px wide (the intrinsics scaled,
    the distortion as published: it acts on normalised coordinates), 256
    features, the texture blurred by 2 texels, a 160-frame shuttle drive
    whose revisit closes a loop, one judged run of 3 frames, the loop-edge
    judge over batches of any size, the traced slice at the second
    batch."""
    cell, cfg = harness.cell_files(CELL)
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    s = 400.0 / cfg["w"]
    cfg.update(h=int(round(cfg["h"] * s / 4)) * 4, w=400, fx=cfg["fx"] * s, fy=cfg["fy"] * s,
               cx=cfg["cx"] * s, cy=cfg["cy"] * s)
    cfg["frontend"]["num_features"] = 256
    cfg["scene"]["blur_texels"] = 2.0
    cell["traffic"]["trajectory"] = {"kind": "shuttle", "frames_per_leg": 40, "step_m": 0.05}
    cell["judge"].update(runs=1, frames=3, min_edges=1)
    cell.update(trace={"batch": 1, "batches": 1})
    return cell, cfg


_renders = {}


@pytest.fixture
def cached_render(monkeypatch):
    """The entry's render, once per configuration and seed in this process."""
    render = entry.render

    def cached(cfg, traffic, seed, device):
        key = (repr(cfg), repr(traffic), seed, str(device))
        if key not in _renders:
            _renders[key] = render(cfg, traffic, seed, device)
        return _renders[key]

    monkeypatch.setattr(entry, "render", cached)


# ------------------------------------------------------------------ scene
def _textures():
    gen = torch.Generator()
    gen.manual_seed(5)
    return canyon.make_textures(gen, n=5, tex_hw=256, sigma=1.0)


def test_distorted_canyon_without_distortion_is_the_canyon():
    tex = _textures()
    args = (300.0, 150.5, 60.25, 0.11, 120, 304)
    plain = canyon.CanyonScene(tex, *args, noise_sigma=1.0, illum_drift=0.2)
    fx, cx, cy, b, h, w = args
    bent = cd.DistortedCanyonScene(tex, fx, fx, cx, cy, b, h, w, [0.0] * 5, noise_sigma=1.0,
                                   illum_drift=0.2)
    traj = canyon.two_episode_trajectory(40, 3.0, 2.0)[::7]
    frames = [scene.render_pairs(traj, torch.Generator().manual_seed(3))
              for scene in (plain, bent)]
    assert torch.equal(frames[0], frames[1])
    # With the configuration's distortion the frames differ.
    cfg = harness.cell_files(CELL)[1]
    real = cd.DistortedCanyonScene(tex, fx, fx, cx, cy, b, h, w, cfg["dist"], noise_sigma=1.0,
                                   illum_drift=0.2)
    assert not torch.equal(real.render_pairs(traj, torch.Generator().manual_seed(3)),
                           frames[0])


def _distort(xn, yn, fx, fy, cx, cy, dist):
    """Distorted pixels of normalised ideal coordinates: the model itself."""
    k1, k2, p1, p2, k3 = dist
    r2 = xn * xn + yn * yn
    rad = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * rad + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * rad + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return fx * xd + cx, fy * yd + cy


def test_ideal_pixels_distort_back_onto_their_pixels():
    cfg = harness.cell_files(CELL)[1]
    intr = [cfg[k] for k in ("fx", "fy", "cx", "cy")]
    scene = cd.DistortedCanyonScene(_textures(), *intr, cfg["baseline_m"], cfg["h"], cfg["w"],
                                    cfg["dist"])
    vv, uu = torch.meshgrid(torch.arange(cfg["h"], dtype=torch.float64),
                            torch.arange(cfg["w"], dtype=torch.float64), indexing="ij")
    xn, yn, _, _ = cd.ideal(uu, vv, *intr, cfg["dist"])
    u, v = _distort(xn, yn, *intr, cfg["dist"])
    assert float((u - uu).abs().max()) < 1e-6 and float((v - vv).abs().max()) < 1e-6
    # The traced ray is the ideal one: (xn, yn, 1) through CanyonScene's
    # division of both axes by fx.
    assert float(((scene._uu - cfg["cx"]) / cfg["fx"] - xn).abs().max()) < 1e-12
    assert float(((scene._vv - cfg["cy"]) / cfg["fx"] - yn).abs().max()) < 1e-12
    # The corners move: k1 = -0.283 pulls them in by tens of pixels.
    assert float((scene._uu - uu).abs().max()) > 20.0


# ------------------------------------------------------------------ references
def _tracked(frames: int):
    """The tiny drive's pairs, its configuration, rig and SlamConfig, and a
    general-rig odometer (its RANSAC refit on) that tracked `frames`
    frames, with each frame's (counter, result)."""
    from stereo_orb_slam_torch.frontend import odometer
    from stereo_orb_slam_torch.worldmap import WorldMap

    cell, cfg = tiny_cell()
    pairs, _ = entry.render(cfg, cell["traffic"], SEED, "cpu")
    scfg = slam_entry.slam_config(cfg)
    rig = entry._rig(cfg, "cpu")
    world = WorldMap(feat_slots=scfg.frontend.num_features)
    vo = odometer.VisualOdometer(world, rig, scfg.frontend, scfg.ransac, seed=3)
    results = []
    for f in range(frames):
        counter = vo._frame_counter
        vo.track(pairs[f, 0], pairs[f, 1])
        results.append((counter, vo.last_result, vo.success))
    return cfg, pairs, scfg, rig, world, results


def test_frame_reference_matches_the_general_step(cached_render):
    cfg, pairs, _, _, _, results = _tracked(6)
    limits = harness.cell_files(CELL)[0]["limits"]
    fe, rc = cfg["frontend"], cfg["ransac"]
    assert rc["final_model_fitting"]
    rig, table = ref_fe.Rig(cfg, "cpu"), ref_fe.sampling_table("cpu")
    prev = ref_fe.empty_slots(fe["num_features"], "cpu")
    tracked = 0
    for f, (counter, res, _ok) in enumerate(results):
        keys = ref_fe.gumbel_keys(3, counter, rc["num_hypotheses"], fe["num_features"], "cpu")
        ref = ref_gen.frame(torch.from_numpy(pairs[f, 0]), torch.from_numpy(pairs[f, 1]), prev,
                            keys, rig, fe, rc, table)
        if ref["success"] or f == 0:
            prev = ref
        if f == 0:
            continue   # the stream's first frame: nothing to track against
        port = dict(judge.slots(res.slots), prev_idx=res.prev_idx, tracked=res.tracked,
                    T=res.transform)
        got = judge.numbers(port, ref)
        # The same corners, descriptors and matches; the points and pose
        # within the cell's limits (the port's plain DLT on the CPU is
        # float32's SVD, the reference's float64's).
        assert got["corners"] == got["descriptors"] == got["stereo"] == got["temporal"] == 0.0
        assert all(got[k] <= limits[k] for k in got), got
        tracked += int(ref["success"])
    assert tracked >= 4


def test_edges_reference_matches_measure_edges(cached_render):
    """Edges between frames of the distorted drive that the port tracked,
    measured by the port's `measure_edges` on the general rig (the DLT)
    and by the reference with the same keys."""
    from stereo_orb_slam_torch.apps.slam import frame_banks, measure_edges
    from stereo_orb_slam_torch.frontend import ransac

    cfg, _, scfg, rig, world, _ = _tracked(12)
    src, dst = [0, 1, 2, 9], [3, 5, 11, 10]
    E, n = len(src), scfg.frontend.num_features
    banks = [frame_banks(ids, None, world, "cpu") for ids in (src, dst)]
    keys = [ref_gen.edge_keys(100 + e, scfg.ransac.num_hypotheses, n, "cpu") for e in range(E)]
    samplers = [ransac.KeyedSampler(lambda n_, d_, k=k: k) for k in keys]
    T, idx, inl, ok, _ = measure_edges(banks[0][0], banks[1][0], banks[0][1], banks[1][1],
                                       banks[0][2], banks[1][2], samplers, rig, scfg.frontend,
                                       scfg.ransac, False)
    ref = ref_gen.edges(banks[0], banks[1], keys, ref_fe.Rig(cfg, "cpu"), cfg["frontend"],
                        cfg["ransac"])
    assert [bool(x) for x in ok] == [r["success"] for r in ref]
    assert sum(r["success"] for r in ref) >= 3
    for e, r in enumerate(ref):
        assert torch.equal(idx[e][r["ok"]].long(), r["idx"][r["ok"]].long())
    readings = slam_entry._edge_numbers((T, idx, inl), ref)
    assert all(x["temporal"] <= 0.02 and x["pose"] < 1e-3 for x in readings), readings


def test_stereo_points_are_the_dlt_points_of_ideal_observations():
    cfg = harness.cell_files(CELL)[1]
    rig = ref_fe.Rig(cfg, "cpu")
    g = np.random.default_rng(0)
    X = np.stack([g.uniform(-3, 3, 50), g.uniform(-2, 2, 50), g.uniform(1, 20, 50)], 1)
    h = np.concatenate([X, np.ones((50, 1))], 1)
    ul, ur = h @ rig.P_l.double().numpy().T, h @ rig.P_r.double().numpy().T
    uv = torch.tensor(np.concatenate([ul[:, :2] / ul[:, 2:], ur[:, :2] / ur[:, 2:]], 1))
    pts, ok = ref_gen.stereo_points(uv, torch.ones(50, dtype=torch.bool), rig)
    assert bool(ok.all())
    assert float((pts - torch.tensor(X)).abs().max()) < 1e-6


def test_ba_numbers_read_the_landmarks_the_reference_resolves():
    """The window BA's `points` and `pose` over the landmarks that the
    reference puts in front of their first camera and nearer than
    fx * baseline, every observation within Huber's width; NaN where it
    resolves none."""
    from types import SimpleNamespace

    from stereo_orb_slam_torch.config import BAConfig

    cfg = harness.cell_files(CELL)[1]
    rig = ref_fe.Rig(cfg, "cpu")
    # Landmarks near (10 m), far (200 m), past infinity (z < 0) and near
    # with an observation 3 px off its fit; each seen by both cameras.
    pts_r = torch.tensor([[1.0, 0.0, 10.0], [0.0, 1.0, 200.0], [0.0, 0.0, -8000.0],
                          [-1.0, 0.5, 12.0]], dtype=torch.float64)
    cam = torch.tensor([0, 1] * 4)
    pt = torch.arange(4).repeat_interleave(2)
    pose_r = torch.zeros(2, 6, dtype=torch.float64)
    h = torch.cat([pts_r[pt], torch.ones(8, 1, dtype=torch.float64)], 1)
    uv_l, uv_r = (h @ P.double().T for P in (rig.P_l, rig.P_r))
    obs_uv = torch.cat([uv_l[:, :2] / uv_l[:, 2:], uv_r[:, :2] / uv_r[:, 2:]], 1)
    obs_uv[7, 0] += 3.0
    prob = SimpleNamespace(obs_cam=cam, obs_point=pt, obs_uv=obs_uv.float(), P_l=rig.P_l,
                           P_r=rig.P_r)
    b = {"setup": SimpleNamespace(num_cams=2, num_points=4, num_obs=8, prob=prob),
         "cfg": BAConfig()}
    pts_s = pts_r.numpy() + np.array([[0.05, 0.0, 0.0], [0.0, 0.0, 40.0], [0.0, 0.0, 900.0],
                                      [0.6, 0.0, 0.0]])
    pose_s = np.zeros((2, 6))
    pose_s[1, 1] = 1e-5      # a rotation that moves a landmark at 200 m by 2 mm
    pose_s[1, 3] = 1e-4
    max_depth = cfg["fx"] * cfg["baseline_m"]
    got = entry._ba_numbers_within(max_depth)((pose_s, pts_s), (pose_r, pts_r), b)
    assert got["points"] == pytest.approx(0.005)
    # The near landmark (1, 0, 10) moved by w x X + t = (2e-4, 0, -1e-5).
    assert got["pose"] == pytest.approx(float(np.hypot(2e-4, 1e-5)), rel=1e-6)
    # entries/slam.py's numbers read every landmark.
    every = slam_entry._ba_numbers((pose_s, pts_s), (pose_r, pts_r), b)
    assert every["points"] > 0.04 and every["pose"] > 1e-3
    assert all(np.isnan(v) for v in entry._ba_numbers_within(5.0)(
        (pose_s, pts_s), (pose_r, pts_r), b).values())


def test_a_program_without_the_ba_setting_is_refused_at_once(monkeypatch):
    """A program that would solve this rig's window BA in float32, or has
    no such choice (as a program before `marginalize_in_float64`), stops
    the run before the render: it fails at once."""
    cell, cfg = tiny_cell()
    monkeypatch.setattr(entry, "render", lambda *a: pytest.fail("rendered"))
    monkeypatch.setattr(pba, "marginalize_in_float64", lambda rig: False)
    with pytest.raises(RuntimeError, match="float64"):
        entry.run(cfg, cell, SEED, 1.0, False, device="cpu")
    monkeypatch.delattr(pba, "marginalize_in_float64")
    with pytest.raises(RuntimeError, match="float64"):
        entry.run(cfg, cell, SEED, 1.0, False, device="cpu")


@pytest.fixture(scope="module")
def weak_window():
    """The recorded window as the recorder keeps a window BA, its problem
    as `BundleAdjuster.prepare` hands it to the LM program (every landmark
    and observation real; the first camera held), and the float64
    reference's solve of its iterations."""
    from types import SimpleNamespace

    from stereo_orb_slam_torch.config import BAConfig

    d = np.load(os.path.join(os.path.dirname(__file__), "data", "euroc_weak_window.npz"))
    C, P, O = len(d["pose6"]), len(d["points"]), len(d["obs_cam"])

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    prob = pba.BAProblem(f32(d["pose6"]), f32(d["points"]),
                         torch.as_tensor(d["obs_cam"], dtype=torch.int64),
                         torch.as_tensor(d["obs_point"], dtype=torch.int64), f32(d["obs_uv"]),
                         torch.ones(O), f32(d["cam_mask"]), torch.ones(P), f32(d["P_l"]),
                         f32(d["P_r"]))
    b = {"setup": SimpleNamespace(prob=prob, num_cams=C, num_points=P, num_obs=O),
         "cfg": BAConfig(), "iterations": int(d["iterations"])}
    return b, slam_entry._ba_solve(b, torch.float64)


@pytest.mark.parametrize("float64", [False, True], ids=["float32", "float64"])
def test_the_weak_window_passes_the_cell_only_in_float64(weak_window, float64):
    """The program's solve of the recorded window (its captured LM program,
    run as it is on the CPU) against the float64 reference, by the cell's
    judge and limits: in float32 it stops about a metre off (`points`
    about 2.4, `pose` about 0.96 m), in float64 within 3e-4 and 5e-5 m."""
    b, ref = weak_window
    cell, cfg = harness.cell_files(CELL)
    prob, K = b["setup"].prob, 32
    assert K >= int(torch.bincount(prob.obs_point).max())
    prog = pba.lm_program(prob, b["cfg"], K, None, None, False, float64=float64)
    prog.solve(prob, b["iterations"])
    got = entry._ba_numbers_within(cfg["fx"] * cfg["baseline_m"])(
        (prog.prob.pose6, prog.prob.points), ref, b)
    within = all(got[k] <= cell["limits"][k] for k in ("points", "pose"))
    assert within is float64, got
    if not float64:
        assert got["points"] > 1.0 and got["pose"] > 0.1


# ------------------------------------------------------------------ the entry
def _run(control=False, seconds=1.0):
    cell, cfg = tiny_cell()
    out = entry.run(cfg, cell, SEED, seconds, False, device="cpu", control=control)
    return cell, out


def test_tiny_drive_is_correct_and_control_is_not(cached_render):
    cell, out = _run(control=True)
    assert out["failed"] == 0
    assert out["stats"]["closures"], "the drive closed no loop live"
    readings = worst(out["readings"])
    assert set(readings) == set(NUMBERS)
    checks = bench_run.checks_of(cell, readings)
    assert bench_run.is_correct(checks), checks
    kinds = {tuple(sorted(r)) for r in out["readings"]}
    assert {("pose", "temporal"), ("trajectory",), ("points", "pose")} <= kinds
    control = bench_run.checks_of(cell, worst(out["control_readings"]))
    assert not bench_run.is_correct(control)
    # The entry leaves `entries/slam.py` and the harness as they were.
    assert slam_entry.render is not entry.render
    assert harness.reduce_profile.__module__ == "portbench.harness"


def _no_undistortion(cam, uv, iterations=8):
    return uv


@pytest.mark.parametrize("fault", ["pose_graph_returns_input", "window_ba_skipped",
                                   "front_end_not_undistorted"])
def test_broken_timed_path_is_not_correct(cached_render, monkeypatch, fault):
    from stereo_orb_slam_torch.geometry import camera

    if fault == "pose_graph_returns_input":
        monkeypatch.setattr(ppg.GNProgram, "solve", lambda self: None)
    elif fault == "window_ba_skipped":
        monkeypatch.setattr(pba.LMProgram, "iteration", lambda self: None)
    else:
        monkeypatch.setattr(camera, "undistort_points", _no_undistortion)
    cell, out = _run()
    checks = bench_run.checks_of(cell, worst(out["readings"]))
    assert not bench_run.is_correct(checks), checks
    part = {"pose_graph_returns_input": "trajectory", "window_ba_skipped": "points",
            "front_end_not_undistorted": "corners"}[fault]
    v, lim = checks[part]
    assert v > lim


# ------------------------------------------------------------------ readers
def test_the_cell_reads_its_metrics():
    cell, cfg = harness.cell_files(CELL)
    assert set(cell["limits"]) == set(NUMBERS)
    # The program marginalizes this rig's window BA in float64, and
    # kitti_slam_revisit's in float32.
    assert pba.marginalize_in_float64(entry._rig(cfg, "cpu"))
    kitti = harness.cell_files("kitti_slam_revisit")[1]
    assert not pba.marginalize_in_float64(slam_entry._rig(kitti, "cpu"))
    bench = harness.benchmark()
    names = [m["name"] for m in harness.per_layer_for(bench, CELL)]
    assert names == ["closure_stall_ms", "edge_batch_ms", "pg_solve_ms.live", "ba_wait_ms",
                     "closures_in_window", "device_idle.slam", "chain_device_ms",
                     "ba_device_ms", "roofline.triangulate_dlt.edges"]
    assert [m["name"] for m in harness.end_to_end_for(bench, CELL)] == ["fps", "setup_s"]


def _edge_calls(E_pad=2, n=64, seed=0):
    cfg = harness.cell_files(CELL)[1]
    rig = ref_fe.Rig(cfg, "cpu")
    g = np.random.default_rng(seed)
    X = np.stack([g.uniform(-3, 3, E_pad * n), g.uniform(-2, 2, E_pad * n),
                  g.uniform(1, 20, E_pad * n)], 1)
    h = np.concatenate([X, np.ones((len(X), 1))], 1)
    P1, P2 = rig.P_l.numpy(), rig.P_r.numpy()
    ul, ur = h @ P1.T, h @ P2.T
    uv1, uv2 = ul[:, :2] / ul[:, 2:], ur[:, :2] / ur[:, 2:]
    return [{"P1": P1, "P2": P2, "uv1": uv1, "uv2": uv2},
            {"P1": P1, "P2": P2, "uv1": uv1[::-1].copy(), "uv2": uv2[::-1].copy()}]


def test_readers_on_synthetic_traces():
    calls = _edge_calls()
    bound = sum(dlt_roof.bound_s(**c)[0] for c in calls) / 2
    us = 1e-6
    # The slice: two frames' launches (1 us each), the edge batch's two
    # (4 and 6 us), then one more frame's; `after` counts that last one.
    kernels = [("triangulate_dlt_kernel", 0 * us, 1 * us), ("hamming_top2_kernel", 2 * us, 3 * us),
               ("triangulate_dlt_kernel", 5 * us, 6 * us),
               ("triangulate_dlt_kernel", 10 * us, 14 * us),
               ("triangulate_dlt_kernel", 20 * us, 26 * us),
               ("triangulate_dlt_kernel", 30 * us, 31 * us)]
    trace = {"kernels": kernels, "busy_s": 1.0, "window_s": 2.0,
             "device_ms": {"dev.chain": [40.0, 50.0], "dev.ba": [30.0, 31.0, 35.0]},
             "edge_dlt": [{"launches": 2, "after": 1, "calls": calls}]}
    read = {m: harness.reader(m).read(trace)
            for m in ("chain_device_ms", "ba_device_ms", "roofline.triangulate_dlt.edges")}
    assert read["chain_device_ms"] == 45.0 and read["ba_device_ms"] == 32.0
    assert read["roofline.triangulate_dlt.edges"] == pytest.approx(100.0 * bound / 5e-6)
    # A trace without device timers (a program without them) or without a
    # loop-edge batch or its launches in the slice reads nothing.
    timers = ("chain_device_ms", "ba_device_ms")
    roof = ("roofline.triangulate_dlt.edges",)
    for bare, names in (({"kernels": kernels, "busy_s": 1.0, "window_s": 2.0}, timers + roof),
                        (dict(trace, device_ms={}, edge_dlt=[]), timers + roof),
                        (dict(trace, device_ms={"dev.chain": [], "dev.ba": []}), timers),
                        (dict(trace, kernels=kernels[:3]), roof),
                        (dict(trace, kernels=[]), roof)):
        for m in names:
            assert harness.reader(m).read(bare) is None, (m, bare.keys())


# ------------------------------------------------------------------ timers
@pytest.mark.parametrize("kineto", [True, False], ids=["kineto", "events"])
def test_the_slice_reads_the_events_that_prof_events_gives(kineto):
    """`_Profile` reads the profiler's kineto result as `prof.events()`
    does (the same names, times and device types, so the same reduction),
    and falls back to `prof.events()` where there is no kineto result."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x = torch.randn(32, 32)
        for _ in range(20):
            x = (x @ x).tanh().add_(1.0)
    want = harness.reduce_profile(prof, 1.0, 1)
    wrapped = entry._Profile(prof if kineto else _EventsOnly(prof))
    key = lambda e: (e.name, e.time_range.start, e.time_range.end, e.device_type)  # noqa: E731
    got = sorted(map(key, wrapped.events()))
    assert len(got) > 40 and got == sorted(map(key, prof.events()))
    assert harness.reduce_profile(wrapped, 1.0, 1) == want


class _EventsOnly:
    def __init__(self, prof):
        self.events = prof.events


class _FakeEvent:
    """A CUDA event on the host clock's ticks: `record` stamps it."""

    ticks = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.ticks[0] += 2.5
        self.t = self.ticks[0]

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_timers_record_nothing_while_the_tracer_is_off(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an event was made while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    tracer = profiling.Tracer()
    assert tracer.device_timer("dev.chain", "cuda") is None
    assert tracer.device_times() == {}
    tracer.enable(True)
    assert tracer.device_timer("dev.chain", "cpu") is None   # no card, no timer
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    timer = tracer.device_timer("dev.ba", torch.device("cuda"))
    timer.stop()
    timer.read()
    assert tracer.device_times() == {"dev.ba": [2.5]}
    tracer.reset()
    assert tracer.device_times() == {}


def test_the_batch_path_makes_no_timer_while_the_tracer_is_off(cached_render, monkeypatch):
    """`dispatch_batch` asks the process's tracer for a timer and carries
    it to `collect_batch` (None off the card or while tracing is off), and
    the live loop's results are the same either way."""
    from stereo_orb_slam_torch.apps.slam import SlamSystem

    cell, cfg = tiny_cell()
    pairs, _ = entry.render(cfg, cell["traffic"], SEED, "cpu")
    rig, scfg = entry._rig(cfg, "cpu"), slam_entry.slam_config(cfg)
    asked = []
    make = profiling.TRACER.device_timer
    monkeypatch.setattr(profiling.TRACER, "device_timer",
                        lambda name, device: asked.append((name, str(device))) or make(name,
                                                                                      device))
    system = SlamSystem(rig, scfg, seed=SEED)
    for lo in range(0, 64, scfg.batch_frames):
        batch = torch.from_numpy(pairs[lo:lo + scfg.batch_frames])
        system.process_batch(batch[:, 0], batch[:, 1])
    system.flush()
    assert ("dev.chain", "cpu") in asked and ("dev.ba", "cpu") in asked
    assert profiling.TRACER.device_times() == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device timers are CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_timers_time_the_chain_and_the_ba_on_the_card(cached_render, cuda):
    """With the tracer on, a tiny general drive on the card reads one
    `dev.chain` a collected batch and one `dev.ba` a window solve, each a
    positive number of device milliseconds; off, none."""
    from stereo_orb_slam_torch.apps.slam import SlamSystem

    cell, cfg = tiny_cell()
    pairs, _ = entry.render(cfg, cell["traffic"], SEED, "cpu")
    rig, scfg = entry._rig(cfg, cuda), slam_entry.slam_config(cfg)
    tracer = profiling.TRACER

    def drive(on: bool):
        tracer.reset()
        tracer.enable(on)
        try:
            system = SlamSystem(rig, scfg, seed=SEED)
            for lo in range(0, 96, scfg.batch_frames):
                batch = torch.from_numpy(pairs[lo:lo + scfg.batch_frames]).to(cuda)
                system.process_batch(batch[:, 0], batch[:, 1])
            system.flush()
            return tracer.device_times(), system.ba_log
        finally:
            tracer.enable(False)

    times, ba_log = drive(True)
    assert len(times["dev.chain"]) == 3 and min(times["dev.chain"]) > 0.0
    # Each finished solve is a window's (`dev.ba`) or a capped polish.
    polish = times.get("dev.ba.capped", [])
    assert len(times["dev.ba"]) + len(polish) == len(ba_log) and len(times["dev.ba"]) >= 1
    assert min(times["dev.ba"] + polish) > 0.0
    assert drive(False)[0] == {}
    tracer.reset()

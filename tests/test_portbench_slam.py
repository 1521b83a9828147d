"""The SLAM cell of the port's benchmark (`portbench/entries/slam.py`) and
its plain references, on the CPU at small sizes with seeded inputs.

- `reference/pose_graph.py` (float64; each step by its CG solve, the
  program's stated one, or exactly by dense Cholesky) against the port's
  `pg_solve` on random graphs with loop edges: the same costs and poses,
  within float32 noise; where the CG's budget stops short of the exact
  step, the reference's CG stops where the port's does.
- `reference/ba.py` (float64, dense Schur) against the port's window LM
  solve (`ba_solve`, the dense path): the same costs and solution, within
  float32 noise.
- `reference/loop_edges.py::edges` against the port's `measure_edges` on
  canyon frames the port tracked, with the keys the loop matcher draws: the
  same matches, inlier masks and flags, the transforms within float32 noise;
  where rounding moves an error across RANSAC's threshold and the winner
  jumps, the reference's answers under rounding (`tied`) hold the new one.
- The entry end to end on a tiny canyon drive that closes a loop (a
  shuttle: sideways out, back over the same ground and on past the start) is
  judged correct, and the control in the port's place is not; nor is a run
  whose timed path is broken underneath: a pose-graph solve that returns
  its input poses, or a window BA whose iterations are skipped.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402
from portbench import run as bench_run  # noqa: E402
from portbench.entries import slam as entry  # noqa: E402
from portbench.reference import ba as ref_ba  # noqa: E402
from portbench.reference import frontend as ref_fe  # noqa: E402
from portbench.reference import loop_edges as ref_le  # noqa: E402
from portbench.reference import pose_graph as ref_pg  # noqa: E402
from portbench.reference.judge import NUMBERS, worst  # noqa: E402

from stereo_orb_slam_torch.backend import ba as pba  # noqa: E402
from stereo_orb_slam_torch.backend import pose_graph as ppg  # noqa: E402
from stereo_orb_slam_torch.config import BAConfig, PoseGraphConfig  # noqa: E402

torch.set_num_threads(1)
SEED = 2**31 + 17
CELL = "kitti_slam_revisit"


def tiny_cell():
    """The cell cut to run on the CPU: 400 px wide, 256 features, the
    texture blurred by 2 texels (a pixel here spans three of the full
    image's), a 160-frame shuttle drive whose revisit ends inside its fourth
    batch, one judged run of 3 frames, the traced slice at the second
    batch."""
    cell, cfg = harness.cell_files(CELL)
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    s = 400.0 / cfg["w"]
    cfg.update(h=int(round(cfg["h"] * s / 4)) * 4, w=400, fx=cfg["fx"] * s, fy=cfg["fy"] * s,
               cx=cfg["cx"] * s, cy=cfg["cy"] * s)
    cfg["frontend"]["num_features"] = 256
    cfg["scene"]["blur_texels"] = 2.0
    cell["traffic"]["trajectory"] = {"kind": "shuttle", "frames_per_leg": 40, "step_m": 0.05}
    cell["judge"].update(runs=1, frames=3)
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


def _run(control=False, seconds=1.0):
    cell, cfg = tiny_cell()
    out = entry.run(cfg, cell, SEED, seconds, False, device="cpu", control=control)
    return cell, out


# ------------------------------------------------------------------ pose graph
def _graph(seed: int, n: int, loops: int):
    """A chain of n noisy odometry edges over a drifting true trajectory and
    `loops` exact loop edges from its first third to its last."""
    rng = np.random.default_rng(seed)

    def jitter(s_rot, s_t):
        xi = np.concatenate([rng.normal(0, s_rot, 3), rng.normal(0, s_t, 3)])
        return ref_pg.exp(torch.tensor(xi)).numpy()

    step = np.eye(4)
    step[2, 3] = 0.1
    true = [np.eye(4)]
    for _ in range(n - 1):
        true.append(true[-1] @ step @ jitter(0.02, 0.0))
    rel = [np.linalg.inv(true[i - 1]) @ true[i] @ jitter(0.002, 0.003) for i in range(1, n)]
    poses = [np.eye(4)]
    for r in rel:
        poses.append(poses[-1] @ r)
    a, b, meas = list(range(n - 1)), list(range(1, n)), rel
    for _ in range(loops):
        i, j = int(rng.integers(0, n // 3)), int(rng.integers(2 * n // 3, n))
        a.append(i)
        b.append(j)
        meas.append(np.linalg.inv(true[i]) @ true[j])
    return (np.asarray(poses, np.float32), a, b, np.asarray(meas, np.float32))


def _ref_solve(poses, a, b, meas, cfg, **kw):
    return ref_pg.solve(poses.astype(np.float64), a, b, meas.astype(np.float64),
                        cfg.iterations, cfg.info_translation, cfg.info_rotation,
                        cfg.huber_delta, cfg.damping, cg_iterations=cfg.cg_iterations,
                        cg_tol=cfg.cg_tol, **kw)


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 120)])
def test_pose_graph_reference_matches_pg_solve(seed, n):
    """Graphs small enough that the CG converges: the port, the reference's
    CG solve and its exact one agree."""
    poses, a, b, meas = _graph(seed, n, loops=6)
    cfg = PoseGraphConfig()
    out, c0, c1 = ppg.pg_solve(ppg.bucketed_problem(poses, a, b, meas, "cpu"), cfg)
    ref, r0, r1, _ = _ref_solve(poses, a, b, meas, cfg, linear="pcg")
    exact, e0, e1, ok = _ref_solve(poses, a, b, meas, cfg, linear="cholesky")
    assert ok
    assert r1 < 0.1 * r0
    np.testing.assert_allclose([float(c0), float(c1)], [r0, r1], rtol=1e-4)
    np.testing.assert_allclose([r0, r1], [e0, e1], rtol=1e-6)
    port = out.poses[:n].double()
    for want in (ref, exact):
        assert float((port[:, :3, 3] - want[:, :3, 3]).abs().max()) < 1e-4
        assert float((port[:, :3, :3] - want[:, :3, :3]).abs().max()) < 1e-5
    # The starting poses are far from the solution: the check can tell.
    assert float((torch.from_numpy(poses).double()[:, :3, 3] - ref[:, :3, 3]).abs().max()) > 0.01


def test_pose_graph_reference_stops_where_the_port_stops():
    """Where the CG's budget stops short of the exact step (here 10
    iterations on 150 vertices), the reference's CG solve stops where the
    port's does, and both stand apart from the exact solve."""
    import dataclasses as dc

    poses, a, b, meas = _graph(3, 150, loops=6)
    cfg = dc.replace(PoseGraphConfig(), cg_iterations=10)
    out, _, _ = ppg.pg_solve(ppg.bucketed_problem(poses, a, b, meas, "cpu"), cfg)
    ref = _ref_solve(poses, a, b, meas, cfg, linear="pcg")[0]
    exact = _ref_solve(poses, a, b, meas, cfg, linear="cholesky")[0]
    port = out.poses[:150].double()
    gap = float((port[:, :3, 3] - ref[:, :3, 3]).abs().max())
    short = float((ref[:, :3, 3] - exact[:, :3, 3]).abs().max())
    assert gap < 1e-3 and short > 20 * gap, (gap, short)


def test_pose_graph_control_is_the_same_solve_in_float32():
    poses, a, b, meas = _graph(2, 60, loops=4)
    cfg = PoseGraphConfig()
    ref = _ref_solve(poses, a, b, meas, cfg, linear="pcg")[0]
    low = ref_pg.solve(poses, a, b, meas, dtype=torch.float32, linear="pcg")[0]
    assert low.dtype == torch.float32
    gap = float((low.double()[:, :3, 3] - ref[:, :3, 3]).abs().max())
    assert 0.0 < gap < 1e-2


# ------------------------------------------------------------------ BA
def _window(seed: int, C=8, P=150):
    """A window of C cameras along the view axis (world-to-camera pose6),
    P landmarks each seen by 2-5 consecutive cameras, noisy pixels, and
    perturbed starting values."""
    rng = np.random.default_rng(seed)
    fx, cx, cy, base = 300.0, 200.0, 60.0, 0.537
    K34 = np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0]])
    right = np.eye(4)
    right[0, 3] = base
    P_l = torch.tensor(K34, dtype=torch.float32)
    P_r = torch.tensor(K34 @ np.linalg.inv(right), dtype=torch.float32)
    pose6 = np.zeros((C, 6))
    pose6[:, 5] = -0.1 * np.arange(C)
    pose6[:, 1] = rng.normal(0, 0.01, C)
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 20, P)], 1)
    cam, pt, uv = [], [], []
    for p in range(P):
        c0 = int(rng.integers(0, C - 2))
        for c in range(c0, min(C, c0 + int(rng.integers(2, 6)))):
            r = ref_ba.residual(torch.tensor(pose6[c]), torch.tensor(pts[p]),
                                torch.zeros(4, dtype=torch.float64), P_l.double(), P_r.double())
            cam.append(c)
            pt.append(p)
            uv.append(r.numpy() + rng.normal(0, 0.3, 4))
    start6 = (pose6 + rng.normal(0, 0.002, pose6.shape)).astype(np.float32)
    start6[0] = pose6[0]
    start_pts = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
    return start6, start_pts, np.asarray(cam), np.asarray(pt), np.asarray(uv, np.float32), P_l, P_r


@pytest.mark.parametrize("seed", [0, 1])
def test_ba_reference_matches_window_solve(seed):
    pose6, pts, cam, pt, uv, P_l, P_r = _window(seed)
    C, P, O = len(pose6), len(pts), len(cam)
    mask = np.ones(C, np.float32)
    mask[0] = 0.0
    prob = pba.BAProblem(torch.from_numpy(pose6), torch.from_numpy(pts), torch.from_numpy(cam),
                         torch.from_numpy(pt), torch.from_numpy(uv), torch.ones(O),
                         torch.from_numpy(mask), torch.ones(P), P_l, P_r)
    cfg = BAConfig()
    carry, iters, c0 = pba.ba_solve(prob, 20, cfg, dense_K=8)
    r6, rpts, ran, r0, r1 = ref_ba.solve(pose6, pts, cam, pt, uv, P_l, P_r, 20,
                                         dataclasses.asdict(cfg))
    # The same rule stops them at other iterations: float32 costs never fall
    # by less than 1e-9 of themselves on an accepted step.
    assert 1 <= ran <= int(iters) == 20
    assert r1 < 0.5 * r0
    np.testing.assert_allclose([float(c0), float(carry.cost)], [r0, r1], rtol=1e-4)
    assert float((carry.prob.pose6.double() - r6).abs().max()) < 1e-4
    depth = rpts[:, 2].abs()
    assert float(((carry.prob.points.double() - rpts).abs().amax(-1) / depth).max()) < 1e-3
    # The start is far from the solution: the check can tell.
    assert float(((torch.from_numpy(pts).double() - rpts).abs().amax(-1) / depth).max()) > 1e-3


# ------------------------------------------------------------------ loop edges
def test_edge_keys_are_the_loop_matchers():
    """The judge draws each edge's keys itself: they equal the ones the loop
    matcher's default sampler draws for that edge."""
    from stereo_orb_slam_torch.apps.slam import _edge_seed
    from stereo_orb_slam_torch.frontend import ransac

    for edge in (0, 1, 77):
        gen = torch.Generator()
        gen.manual_seed(_edge_seed(1234, edge))
        port = ransac.gumbel_keys(gen, 128, 64, "cpu")
        assert torch.equal(port, ref_le.edge_keys(edge, 128, 64, "cpu"))


def test_edges_reference_matches_measure_edges(cached_render):
    """Edges between frames of one canyon drive that the port tracked, as
    `SlamSystem`'s banks hold them, measured by the port's `measure_edges`
    and by the reference with the same keys."""
    from stereo_orb_slam_torch.apps.slam import frame_banks, measure_edges
    from stereo_orb_slam_torch.frontend import odometer, ransac
    from stereo_orb_slam_torch.worldmap import WorldMap

    cell, cfg = tiny_cell()
    pairs, _ = entry.render(cfg, cell["traffic"], SEED, "cpu")
    scfg = entry.slam_config(cfg)
    rig = entry._rig(cfg, "cpu")
    world = WorldMap(feat_slots=scfg.frontend.num_features)
    vo = odometer.VisualOdometer(world, rig, scfg.frontend, scfg.ransac, seed=3)
    for f in range(12):
        vo.track(pairs[f, 0], pairs[f, 1])
    src, dst = [0, 1, 2, 9], [3, 5, 11, 10]
    E, n = len(src), scfg.frontend.num_features
    banks = [frame_banks(ids, None, world, "cpu") for ids in (src, dst)]
    keys = [ref_le.edge_keys(100 + e, scfg.ransac.num_hypotheses, n, "cpu") for e in range(E)]
    samplers = [ransac.KeyedSampler(lambda n_, d_, k=k: k) for k in keys]
    T, idx, inl, ok, _ = measure_edges(banks[0][0], banks[1][0], banks[0][1], banks[1][1],
                                       banks[0][2], banks[1][2], samplers, rig, scfg.frontend,
                                       scfg.ransac, True)
    ref = ref_le.edges(banks[0], banks[1], keys, ref_fe.Rig(cfg, "cpu"), cfg["frontend"],
                       cfg["ransac"])
    assert [bool(x) for x in ok] == [r["success"] for r in ref]
    assert sum(r["success"] for r in ref) >= 3
    for e, r in enumerate(ref):
        assert torch.equal(idx[e][r["ok"]].long(), r["idx"][r["ok"]].long())
        assert torch.equal(inl[e], r["inliers"])
        assert float((T[e] - r["T"]).abs().max()) < 1e-4
    readings = entry._edge_numbers((T, idx, inl), ref)
    assert all(x["temporal"] == 0.0 and x["pose"] < 1e-4 for x in readings)


def _edge_problem(seed, n=200, k=128):
    """A loop edge's RANSAC problem at the KITTI rig: n points 4-15 m deep
    moved by a small translation, their observations with 1.5 px of noise,
    so that many errors lie near the 3 px threshold; the loop matcher's
    keys."""
    cell, cfg = harness.cell_files(CELL)
    rig = ref_fe.Rig(cfg, "cpu")
    g = np.random.default_rng(seed)
    X = np.stack([g.uniform(-4, 4, n), g.uniform(-2, 2, n), g.uniform(4, 15, n)], 1)
    Xp = X + g.normal(0, 0.1, 3)
    h = np.concatenate([Xp, np.ones((n, 1))], 1)
    ul, ur = h @ rig.P_l.double().numpy().T, h @ rig.P_r.double().numpy().T
    obs = np.concatenate([ul[:, :2] / ul[:, 2:], ur[:, :2] / ur[:, 2:]], 1)
    obs += g.normal(0, 1.5, (n, 4))
    keys = ref_le.edge_keys(seed, k, n, "cpu")
    pts = [torch.tensor(a, dtype=torch.float32) for a in (X + g.normal(0, 0.01, X.shape), Xp, obs)]
    return (keys, *pts, torch.ones(n, dtype=torch.bool), rig.P_l, rig.P_r,
            cfg["ransac"]["inlier_threshold_px"], cfg["ransac"]["min_pairs"],
            cfg["ransac"]["min_inliers"])


def test_edge_answers_hold_the_winners_of_rounded_inputs():
    """An edge's winner jumps between hypotheses where rounding moves an
    error across the threshold: the src points moved by a few float32
    ulps change the winner on some problems, and the reference's answers
    under rounding (`tied`) hold every such winner, the edge's own first.
    A pose 1 cm off every answer still reads 1 cm."""
    jumped = 0
    for seed in range(40):
        args = _edge_problem(seed)
        T, inl, ok = ref_le.ransac(*args)
        answers = ref_le.tied(*args)
        assert ok and any(torch.equal(T, a[0]) and torch.equal(inl, a[1]) for a in answers)
        for j in range(4):
            gen = torch.Generator().manual_seed(seed * 10 + j)
            moved = args[1] * (1 + 2e-7 * torch.randn(args[1].shape, generator=gen))
            T1, _, _ = ref_le.ransac(args[0], moved, *args[2:])
            jumped += float((T1 - T).abs().max()) > 1e-3
            assert min(float((T1 - a[0]).abs().max()) for a in answers) < 5e-5
        r = {"pts": args[1], "valid": args[4], "answers": answers}
        off = T.clone()
        off[0, 3] += 0.01
        far = [entry.judge._moved_gap(off, a[0], r) for a in answers]
        assert min(far) > 0.005
    assert jumped, "no rounding changed a winner: the test shows nothing"


# ------------------------------------------------------------------ the entry
def test_tiny_drive_is_correct_and_control_is_not(cached_render):
    cell, out = _run(control=True)
    assert out["failed"] == 0
    assert out["stats"]["closures"], "the drive closed no loop live"
    readings = worst(out["readings"])
    assert set(readings) == set(NUMBERS)
    checks = bench_run.checks_of(cell, readings)
    assert bench_run.is_correct(checks), checks
    # Every part was judged: the front end's frames, the loop edges, the
    # pose graph and the window BA.
    kinds = {tuple(sorted(r)) for r in out["readings"]}
    assert {("pose", "temporal"), ("trajectory",), ("points", "pose")} <= kinds
    control = bench_run.checks_of(cell, worst(out["control_readings"]))
    assert not bench_run.is_correct(control)


def test_a_new_system_writes_a_dropped_ones_rings(cached_render):
    """The window's drives: a fresh SlamSystem after a dropped one takes
    the same feature rings from the program cache, so it builds no program,
    and the rows its predecessor left there change none of its poses."""
    from stereo_orb_slam_torch.apps.slam import SlamSystem
    from stereo_orb_slam_torch.utils import programs

    cell, cfg = tiny_cell()
    pairs, _ = entry.render(cfg, cell["traffic"], SEED, "cpu")
    rig, scfg = entry._rig(cfg, "cpu"), entry.slam_config(cfg)

    def drive(system):
        for lo in range(0, 64, scfg.batch_frames):
            batch = torch.from_numpy(pairs[lo:lo + scfg.batch_frames])
            system.process_batch(batch[:, 0], batch[:, 1])
        system.flush()
        return system

    vocab = drive(SlamSystem(rig, scfg, seed=SEED)).vocab
    first = drive(SlamSystem(rig, scfg, vocab=vocab, seed=SEED))
    ring, poses = first._bank_dev[0].data_ptr(), first.world.pose_global.copy()
    del first
    builds = programs.PROGRAMS.builds
    second = drive(SlamSystem(rig, scfg, vocab=vocab, seed=SEED))
    assert second._bank_dev[0].data_ptr() == ring
    assert programs.PROGRAMS.builds == builds
    assert np.array_equal(second.world.pose_global, poses)


@pytest.mark.parametrize("fault", ["pose_graph_returns_input", "window_ba_skipped"])
def test_broken_timed_path_is_not_correct(cached_render, monkeypatch, fault):
    if fault == "pose_graph_returns_input":
        monkeypatch.setattr(ppg.GNProgram, "solve", lambda self: None)
    else:
        monkeypatch.setattr(pba.LMProgram, "iteration", lambda self: None)
    cell, out = _run()
    checks = bench_run.checks_of(cell, worst(out["readings"]))
    assert not bench_run.is_correct(checks), checks
    part = {"pose_graph_returns_input": "trajectory", "window_ba_skipped": "points"}[fault]
    v, lim = checks[part]
    assert v > lim


def test_numbers_are_the_limits_and_the_cell_reads():
    cell, cfg = harness.cell_files(CELL)
    assert set(cell["limits"]) == set(NUMBERS)
    bench = harness.benchmark()
    names = [m["name"] for m in harness.per_layer_for(bench, CELL)]
    assert names == ["closure_stall_ms", "edge_batch_ms", "pg_solve_ms.live", "ba_wait_ms",
                     "closures_in_window", "device_idle.slam"]
    trace = {"spans": {"pg.optimize": [10.0, 20.0], "pg.edges": [3.0], "pg.solve": [5.0, 7.0],
                       "ba.finish": [1.0, 2.0, 3.0], "slam.batch": [40.0, 50.0]},
             # The window's closures, the profiler slice's (no span) included.
             "closures": [{"num_vertices": 1664}, {"num_vertices": 1888}, {"num_vertices": 1696}],
             "kernels": [("k", 0.0, 0.5)], "busy_s": 0.5, "window_s": 2.0}
    read = {m: harness.reader(m).read(trace) for m in names}
    assert read == {"closure_stall_ms": 15.0, "edge_batch_ms": 3.0, "pg_solve_ms.live": 6.0,
                    "ba_wait_ms": 3.0, "closures_in_window": 3, "device_idle.slam": 75.0}
    # A trace without the program's spans (a program that opens none) reads
    # nothing and raises nothing.
    bare = {"kernels": [], "busy_s": 0.0, "window_s": 1.0}
    assert all(harness.reader(m).read(bare) is None for m in names)

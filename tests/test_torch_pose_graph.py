"""Port parity: the SE(3) pose graph against the JAX package's, on the CPU.

The same graphs, made with numpy from a seed, go through
`stereo_orb_slam_tpu.backend.pose_graph` (jitted, on the CPU) and the port's
`backend/pose_graph.py`. Tolerances:

- `edge_terms` (residuals and the forward-mode Jacobians J_a, J_b,
  whitened and Huber-weighted) and the cost: atol 1e-5, on unit-scale
  graphs with random edges, identity edges (Z = T_a^-1 T_b exactly, so the
  residual is zero and se3_log sits on its small-angle branch) and
  rotations near pi/2;
- `pg_solve` on the drift-plus-loop graph of
  tests/test_pose_graph.py::test_loop_closure_corrects_drift: after one
  Gauss-Newton step rotations within 1e-5, translations within 1e-4 m, both
  costs within rtol 1e-5; after 15 steps, where the graph is solved to
  float32 noise, each package within 1e-4 / 2e-3 m of the port's float64
  solve and of each other;
- both `pg_solve` cases again on the graph padded to its power-of-two
  bucket as the optimizer pads it (`bucketed_problem`), its real vertices
  held to the same bounds and to the float64 solve at the graph's own
  size;
- `PoseGraphOptimizer.optimize` (one iteration) over a small world with
  two loop edges: the same vertex, edge and loop-edge counts and committed
  edges, world poses within 1e-4 m; the problem each optimizer hands its
  solve, recorded by monkeypatching the JAX package's `pg_solve` in the
  test, equal array for array (the padding).

Also, in the port only: the padded edges fall in no real vertex's segment
of the vertex sums, and a Gauss-Newton step is bit for bit the one with
them in; a second live closure before the first closure's polish was
collected runs that polish first (the JAX package overwrites it).

The CG iterations that run (`cg_iterations_run`, the port's masked PCG
counting `active`) against the JAX package's `while_loop` trip counts
(tests/pg_cg_witness.py) on the drift-plus-loop graph: equal in the first
Gauss-Newton step; past it the right-hand side is float32 noise, which
differs between the packages, and so do the counts (port 88, 75, 63, ...
against JAX 86, 89, 86, ...), both below the 200 cap. The counted solve
ends bit for bit where `pg_solve` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_pose_graph import rt, square_loop_world  # noqa: E402
from test_torch_ba import port_world  # noqa: E402

from stereo_orb_slam_tpu.backend import pose_graph as jpg  # noqa: E402
from stereo_orb_slam_tpu.config import PoseGraphConfig as JPGConfig  # noqa: E402
from stereo_orb_slam_torch.backend import ba, pose_graph as tpg  # noqa: E402
from stereo_orb_slam_torch.config import PoseGraphConfig  # noqa: E402

torch.set_num_threads(1)


def _graph(rng, kind, n=12, e=20):
    poses = np.stack([rt(rng.normal(size=3) * 0.5, rng.normal(size=3))
                      for _ in range(n)]).astype(np.float32)
    a = rng.integers(0, n, e)
    b = (a + rng.integers(1, n, e)) % n
    rel = np.linalg.inv(poses[a]) @ poses[b]
    if kind == "identity":
        meas = rel
    elif kind == "random":
        meas = rel @ np.stack([rt(rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.1)
                               for _ in range(e)])
    else:  # rotations near pi/2 between measurement and estimate
        axis = rng.normal(size=(e, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        ang = np.pi / 2 + rng.uniform(-0.05, 0.05, e)
        meas = rel @ np.stack([rt(axis[i] * ang[i], rng.normal(size=3)) for i in range(e)])
    w = np.ones(e, np.float32)
    w[-2:] = 0.0  # padding rows
    return poses, a.astype(np.int32), b.astype(np.int32), meas.astype(np.float32), w


@pytest.mark.parametrize("kind", ["random", "identity", "near_half_pi"])
def test_edge_terms_match_reference(rng, kind):
    poses, a, b, meas, w = _graph(rng, kind)
    info = np.asarray([0.1] * 3 + [1.0] * 3, np.float32)
    ref = jpg.edge_terms(jnp.asarray(poses), jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(meas), jnp.asarray(w), jnp.asarray(info), 1.0)
    got = tpg.edge_terms(torch.from_numpy(poses), torch.from_numpy(a).long(),
                         torch.from_numpy(b).long(), torch.from_numpy(meas),
                         torch.from_numpy(w), torch.from_numpy(info), 1.0)
    for name, g, r in zip(("r", "J_a", "J_b", "cost"), got, ref):
        g = g.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-5, err_msg=name)
    if kind == "identity":
        assert np.abs(got[0].numpy()).max() < 1e-5


def _drift_problem():
    world, gt = square_loop_world(drift=0.02)
    n = world.num_frames
    Z = (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32)
    ea = np.concatenate([np.arange(n - 1), [n - 1]]).astype(np.int32)
    eb = np.concatenate([np.arange(1, n), [0]]).astype(np.int32)
    em = np.concatenate([world.pose_rel[1:n], Z[None]]).astype(np.float32)
    vmask = np.ones(n, np.float32)
    vmask[0] = 0.0
    return world.pose_global[:n].copy(), ea, eb, em, np.ones(len(ea), np.float32), vmask


def _bucketed(poses, ea, eb, em, ew, vm):
    """The drift problem padded to its bucket by the port's optimizer's
    padding, as NumPy arrays."""
    assert ew.all() and vm[0] == 0 and vm[1:].all()
    return tuple(t.numpy() for t in tpg.bucketed_problem(poses, ea, eb, em, "cpu"))


def _solve(poses, ea, eb, em, ew, vm, iterations, dtype=torch.float32, padded=False):
    """Both packages' pg_solve on the problem (padded to its bucket when
    `padded`), the real vertices' poses as float64 and both costs."""
    n = len(poses)
    if padded:
        poses, ea, eb, em, ew, vm = _bucketed(poses, ea, eb, em, ew, vm)
    ref, rc0, rc1 = jpg.pg_solve(jpg.PoseGraphProblem(
        *(jnp.asarray(x) for x in (poses, ea.astype(np.int32), eb.astype(np.int32), em, ew,
                                   vm))), JPGConfig(iterations=iterations))
    got, c0, c1 = tpg.pg_solve(tpg.PoseGraphProblem(
        torch.from_numpy(poses).to(dtype), torch.from_numpy(ea).long(),
        torch.from_numpy(eb).long(), torch.from_numpy(em).to(dtype),
        torch.from_numpy(ew).to(dtype), torch.from_numpy(vm).to(dtype)),
        PoseGraphConfig(iterations=iterations))
    return (got.poses[:n].double().numpy(), float(c0), float(c1)), \
        (np.asarray(ref.poses, np.float64)[:n], float(rc0), float(rc1))


def _pose_gaps(P, R):
    return (np.abs(P[:, :3, :3] - R[:, :3, :3]).max(), np.abs(P[:, :3, 3] - R[:, :3, 3]).max())


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "bucketed"])
def test_pg_solve_first_step_matches_reference(padded):
    """One Gauss-Newton step on the drift-plus-loop graph, at its own size
    and padded to its bucket: rotations within 1e-5, translations within
    1e-4 m, both costs within rtol 1e-5."""
    (P, c0, c1), (R, rc0, rc1) = _solve(*_drift_problem(), iterations=1, padded=padded)
    rot, trans = _pose_gaps(P, R)
    assert rot <= 1e-5 and trans <= 1e-4, (rot, trans)
    np.testing.assert_allclose([c0, c1], [rc0, rc1], rtol=1e-5)


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "bucketed"])
def test_pg_solve_converged_within_float32_noise(padded):
    """15 iterations: past the first step the graph is solved to float32
    noise (the CG's right-hand side is a few ulps of the residual), and both
    packages wander alike. Each float32 solve, at the graph's own size or
    padded to its bucket, is held against the port's float64 solve at the
    graph's own size (rotations 1e-4, translations 2e-3 m) and the two
    against each other (the same bounds); the initial cost within rtol
    1e-5, the final within 1e-2, and the loop edge must have pulled the
    drift out."""
    prob = _drift_problem()
    (P, c0, c1), (R, rc0, rc1) = _solve(*prob, iterations=15, padded=padded)
    (P64, _, c1_64), _ = _solve(*prob, iterations=15, dtype=torch.float64)
    for a, b in ((P, P64), (R, P64), (P, R)):
        rot, trans = _pose_gaps(a, b)
        assert rot <= 1e-4 and trans <= 2e-3, (rot, trans)
    np.testing.assert_allclose(c0, rc0, rtol=1e-5)
    np.testing.assert_allclose([c1, rc1], [c1_64, c1_64], rtol=1e-2)
    assert c1 < 0.1 * c0


def test_padded_rows_fall_in_no_real_segment():
    """The padded edges (weight 0, vertex 0 at both ends) are left out of
    every real vertex's segment and dealt over segments of their own of at
    most SPREAD_ROWS rows (in vertex 0's two segments they would make each
    of its sums as long as the padding, which the card adds in one thread a
    column), and a Gauss-Newton step is bit for bit the one with them in."""
    arrays = _drift_problem()
    n, E = len(arrays[0]), len(arrays[1])
    prob = tpg.bucketed_problem(*arrays[:4], "cpu")
    N, E_pad = prob.poses.shape[0], prob.edge_a.shape[0]
    assert (N, E_pad) == (tpg.bucket(n), tpg.bucket(E)) and E_pad - E >= 4
    plan = tpg.edge_plan(prob)
    old = tpg.EdgePlan(plan.ends, ba.segments(torch.cat([prob.edge_a, prob.edge_b + N]),
                                              2 * N))
    real = np.bincount(np.concatenate([arrays[1], arrays[2] + N]), minlength=2 * N)
    assert torch.equal(torch.diff(plan.seg.offsets[: 2 * N + 1]), torch.as_tensor(real))
    assert int(plan.seg.offsets[2 * N]) == 2 * E and int(plan.seg.offsets[-1]) == 2 * E_pad
    assert int(torch.diff(plan.seg.offsets[2 * N:]).max()) <= ba.SPREAD_ROWS
    assert int(torch.diff(old.seg.offsets)[0]) == real[0] + E_pad - E
    cfg = PoseGraphConfig()
    got, want = prob, prob
    for _ in range(3):
        (got, c_got), (want, c_want) = (tpg.gn_step(got, cfg, plan), tpg.gn_step(want, cfg, old))
        assert torch.equal(got.poses, want.poses) and torch.equal(c_got, c_want)


def test_cg_iterations_run_match_the_reference_loop():
    """The iterations whose exit test held in the port's masked PCG equal
    the trip count of the JAX package's while_loop in the first
    Gauss-Newton step of the same graph; in every step both exits fire
    below the 200 cap; the counting solve is pg_solve, bit for bit."""
    from pg_cg_witness import jax_cg_iterations

    arrays = _drift_problem()
    cfg = PoseGraphConfig()
    prob = tpg.PoseGraphProblem(*(torch.as_tensor(a, dtype=dt) for a, dt in zip(
        arrays, (torch.float32, torch.int64, torch.int64) + (torch.float32,) * 3)))
    final, counts = tpg.cg_iterations_run(prob, cfg)
    ref = jax_cg_iterations(arrays)
    assert len(counts) == len(ref) == cfg.iterations and counts[0] == ref[0]
    assert 0 < min(*counts, *ref) and max(*counts, *ref) < cfg.cg_iterations
    assert torch.equal(final.poses, tpg.pg_solve(prob, cfg)[0].poses)


def test_optimizer_matches_reference():
    world, gt = square_loop_world(drift=0.02)
    n = world.num_frames
    meas = {(0, n - 1): np.linalg.inv(gt[n - 1]) @ gt[0],
            (2, n - 3): np.linalg.inv(gt[n - 3]) @ gt[2]}

    def matcher(a, b):
        return meas[(a, b)].astype(np.float32), True

    wt = port_world(world)
    # One iteration: past the first step both solves are float32 noise
    # (test_pg_solve_converged_within_float32_noise).
    jopt = jpg.PoseGraphOptimizer(world, JPGConfig(iterations=1), loop_matcher=matcher)
    topt = tpg.PoseGraphOptimizer(wt, PoseGraphConfig(iterations=1), loop_matcher=matcher,
                                  device="cpu")
    for opt in (jopt, topt):
        for a, b in meas:
            opt.add_loop_edge(a, b)
    js = jopt.optimize(run_global_ba=False)
    ts = topt.optimize(run_global_ba=False)
    for key in ("num_vertices", "num_edges", "num_loop_edges"):
        assert ts[key] == js[key], key
    assert topt.committed_edges == jopt.committed_edges
    np.testing.assert_allclose(ts["cost_final"], js["cost_final"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wt.pose_global[:n], world.pose_global[:n], rtol=0, atol=1e-4)


def test_optimizer_pads_as_the_reference(monkeypatch):
    """The problem each optimizer hands its solve, recorded: the port's
    equals the JAX optimizer's array for array (vertices and edges padded
    to their power-of-two buckets, identity vertices held fixed, edges
    (0, 0) with the identity and weight 0); the stats keep the real counts
    and add the padded ones; one Gauss-Newton step on the recorded problems
    agrees within test_pg_solve_first_step_matches_reference's pose bounds
    and test_optimizer_matches_reference's cost bound (on this nearly
    consistent graph the cost is 6e-4, and the packages' se3_log differ at
    its small angles)."""
    world, gt = square_loop_world(drift=0.02)
    n = world.num_frames
    meas = {(0, n - 1): np.linalg.inv(gt[n - 1]) @ gt[0],
            (2, n - 3): np.linalg.inv(gt[n - 3]) @ gt[2]}

    def matcher(a, b):
        return meas[(a, b)].astype(np.float32), True

    seen = {}
    real_j, real_t = jpg.pg_solve, tpg.pg_solve_program

    def record_j(prob, cfg):
        seen["jax"] = prob
        return real_j(prob, cfg)

    def record_t(prob, cfg, cache=None):
        seen["port"] = prob
        return real_t(prob, cfg, cache)

    monkeypatch.setattr(jpg, "pg_solve", record_j)
    monkeypatch.setattr(tpg, "pg_solve_program", record_t)
    wt = port_world(world)
    jopt = jpg.PoseGraphOptimizer(world, JPGConfig(iterations=1), loop_matcher=matcher)
    topt = tpg.PoseGraphOptimizer(wt, PoseGraphConfig(iterations=1), loop_matcher=matcher,
                                  device="cpu")
    for opt in (jopt, topt):
        for a, b in meas:
            opt.add_loop_edge(a, b)
    js = jopt.optimize(run_global_ba=False)
    ts = topt.optimize(run_global_ba=False)
    for field, j, t in zip(tpg.PoseGraphProblem._fields, seen["jax"], seen["port"]):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape and np.array_equal(j, t), field
    N, E = tpg.bucket(n), tpg.bucket(n + 1)
    assert seen["port"].poses.shape[0] == N > n and seen["port"].edge_a.shape[0] == E > n + 1
    assert (ts["num_vertices"], ts["num_edges"]) == (js["num_vertices"], js["num_edges"]) \
        == (n, n + 1)
    assert (ts["vertices_padded"], ts["edges_padded"]) == (N, E)
    assert topt.last_problem is seen["port"]
    P = wt.pose_global[:n].astype(np.float64)
    rot, trans = _pose_gaps(P, world.pose_global[:n].astype(np.float64))
    assert rot <= 1e-5 and trans <= 1e-4, (rot, trans)
    np.testing.assert_allclose([ts["cost_initial"], ts["cost_final"]],
                               [js["cost_initial"], js["cost_final"]], rtol=1e-4, atol=1e-6)


class _CountingBA:
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def optimize(self, lo, hi, max_seconds=None):
        self.calls.append((lo, hi))
        return {"iterations": 1}


def test_second_live_closure_keeps_the_first_polish():
    """With live_polish_min_spacing_frames = 0, two live closures before the
    live loop collects the first polish: the second optimize() runs the
    first polish before its solve, and defers its own."""
    world, _ = square_loop_world(drift=0.02)
    ba = _CountingBA()
    opt = tpg.PoseGraphOptimizer(world, PoseGraphConfig(live_polish_min_spacing_frames=0),
                                 bundle_adjuster=ba)
    opt.optimize(live=True)
    first = opt.deferred_ba_finish
    assert first is not None and ba.calls == []
    opt.optimize(live=True)
    n = world.num_frames
    lo = max(0, n - 1 - PoseGraphConfig().live_ba_window_frames)
    assert ba.calls == [(lo, n - 1)]          # the first polish ran
    assert opt.deferred_ba_finish is not None  # the second is deferred
    opt.deferred_ba_finish()
    assert ba.calls == [(lo, n - 1)] * 2

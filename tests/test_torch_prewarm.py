"""`SlamSystem.prewarm_closure_path`, the port against the JAX package, on
the CPU.

The JAX package's prewarm compiles, off the live loop, the loop-closure
path's programs for a drive of up to `max_frames` frames: `pg_solve` at the
top two vertex buckets N with E_pad = N and 2N edges, and the loop-edge
measurement at each E of its edge ladder. Its calls are recorded here by
monkeypatching the JAX package's `pose_graph.pg_solve` and
`apps.slam._loop_edges_from_banks` in the test (nothing of the package is
compiled). The port's prewarm must build exactly those programs into the
process's program cache (a fresh `ProgramCache` put in its place): a
`GNProgram` per (N, E_pad) pair, each solving the JAX package's problem
array for array, and an `EdgeProgram` per rung of the ladder. A later pose-graph solve and loop-edge batch at a warmed bucket
then build nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402
from test_torch_slam import port_rig  # noqa: E402

from stereo_orb_slam_tpu.apps import slam as jslam  # noqa: E402
from stereo_orb_slam_tpu.backend import pose_graph as jpg  # noqa: E402
from stereo_orb_slam_tpu.config import (  # noqa: E402
    FrontendConfig as JFE, LoopConfig as JLoop, RansacConfig as JRC, SlamConfig as JSlam,
)
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import slam as tslam  # noqa: E402
from stereo_orb_slam_torch.backend import pose_graph as tpg  # noqa: E402
from stereo_orb_slam_torch.utils import programs  # noqa: E402

torch.set_num_threads(1)
JCFG = JSlam(frontend=JFE(num_features=64), ransac=JRC(num_hypotheses=16),
             loop=JLoop(database_capacity=16), per_frame_ba=False)


def _jax_prewarm(scene, monkeypatch, max_frames, edge_ladder):
    """The problem of each pose-graph solve (as NumPy arrays) and the E of
    each loop-edge measurement that the JAX package's prewarm compiles, in
    call order."""
    solves, edges = [], []

    def pg_solve(prob, cfg):
        solves.append([np.asarray(a) for a in prob])
        return prob, 0.0, 0.0

    def loop_edges(bank_desc, bank_valid, bank_uv, src_ids, *rest):
        edges.append(src_ids.shape[0])
        return jnp.zeros(1)

    monkeypatch.setattr(jpg, "pg_solve", pg_solve)
    monkeypatch.setattr(jslam, "_loop_edges_from_banks", loop_edges)
    jslam.SlamSystem(scene.make_rig(), JCFG).prewarm_closure_path(max_frames, edge_ladder)
    return solves, edges


@pytest.mark.parametrize("max_frames, edge_ladder", [(20, None), (5, (4, 32))])
def test_prewarm_builds_the_reference_buckets(monkeypatch, max_frames, edge_ladder):
    scene = PlaneScene(np.random.default_rng(0))
    jax_problems, edges = _jax_prewarm(scene, monkeypatch, max_frames, edge_ladder)
    cache = programs.ProgramCache()
    monkeypatch.setattr(programs, "PROGRAMS", cache)
    problems, real = [], tslam.pg_solve_program
    monkeypatch.setattr(tslam, "pg_solve_program",
                        lambda prob, cfg: problems.append(prob) or real(prob, cfg))
    system = tslam.SlamSystem(port_rig(scene), convert.slam_config_from(JCFG))
    system.prewarm_closure_path(max_frames, edge_ladder)
    progs = list(cache._programs.values())
    gn = [(p.prob.poses.shape[0], p.prob.edge_a.shape[0]) for p in progs
          if isinstance(p, tpg.GNProgram)]
    ep = [p.keys.shape[0] for p in progs if isinstance(p, tslam.EdgeProgram)]
    solves = [(p[0].shape[0], p[1].shape[0]) for p in jax_problems]
    assert sorted(gn) == sorted(set(solves)) and len(solves) == len(set(solves))
    # The same all-padding problems (the JAX package warms its vertex buckets
    # in set order): identity poses and measurements, edges (0, 0) of weight
    # 0, every vertex held fixed.
    by_shape = {(p.poses.shape[0], p.edge_a.shape[0]): p for p in problems}
    assert len(by_shape) == len(problems) == len(jax_problems)
    for want in jax_problems:
        got = by_shape[(want[0].shape[0], want[1].shape[0])]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert ep == edges and cache.builds == len(progs) == len(gn) + len(ep)
    assert cache.hits == 0
    if edge_ladder is None:   # the defaults: N_top 32, live_max_edges 128
        assert sorted(gn) == [(16, 16), (16, 32), (32, 32), (32, 64)] and ep == [16, 128]

    # A later closure at a warmed bucket builds nothing: a pose graph of
    # max_frames vertices (N_top, E_pad = N_top) and a loop-edge batch of
    # the ladder's first rung.
    for _ in range(max_frames):
        system.world.add_frame(np.eye(4, dtype=np.float32))
    stats = system.pgo.optimize(run_global_ba=False)
    assert (stats["vertices_padded"], stats["edges_padded"]) in gn
    assert not stats["program_built"]
    system.pgo.loop_matcher.batch([(0, max_frames - 1)] * ep[0])
    assert system.pgo.loop_matcher.last["edges_padded"] == ep[0]
    assert cache.builds == len(progs) and cache.hits == 2

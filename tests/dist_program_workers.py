"""The distributed solves' entry points beside their eager bodies, and the
rank function of tests/test_torch_dist_programs.py. JAX-free: spawned
gloo ranks import this module by name (through tests/dist_workers.py's
`spawn`), and the card's test runs it where JAX is not installed.

`cases(mesh, ...)` gives, for each entry point of parallel/dist_ba.py and
parallel/dist_pose_graph.py, a thunk that calls it (the captured program
when `mesh.capturable(mesh.group)`, the eager body under gloo) and a thunk
that calls its eager body with the same group on the same shard. `run`
calls a thunk and returns its results as NumPy with the all_reduces it
made (count, bytes, shapes).
"""

import numpy as np
import torch

from stereo_orb_slam_torch.backend import ba, pose_graph as pg
from stereo_orb_slam_torch.config import BAConfig, PoseGraphConfig
from stereo_orb_slam_torch.parallel import dist_ba, dist_pose_graph
from stereo_orb_slam_torch.parallel import mesh as mesh_mod
from stereo_orb_slam_torch.utils import programs

LM_ITERS, CG, PG_ITERS = 3, 8, 2


def numpy_tree(tree):
    """Tensors of a (nested) tuple as NumPy arrays, in a flat list."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    return [a for t in tree for a in numpy_tree(t)]


def run(fn):
    """(fn()'s tensors as NumPy, (all_reduces, bytes, shapes) it made)."""
    n0, b0 = mesh_mod.ALL_REDUCES, mesh_mod.ALL_REDUCE_BYTES
    with mesh_mod.recording() as shapes:
        out = fn()
    return numpy_tree(out), (mesh_mod.ALL_REDUCES - n0, mesh_mod.ALL_REDUCE_BYTES - b0,
                             list(shapes))


def _poses(solve):
    """A pose-graph entry's results without the padded problem's edges
    (the entry returns the whole graph, the eager body this rank's shard)."""
    def fn():
        out = solve()
        return (out[0].poses,) + tuple(out[1:])
    return fn


def cases(mesh, ba_np, pa_host, pa_meta, dense_K, graph):
    """name -> (entry point thunk, eager body thunk) on this rank's shards:
    the point-aligned solve (matrix-free and dense), the "obs" solve, both
    LM steps, the pose-graph solve and its GN step."""
    cfg = BAConfig(max_iterations=LM_ITERS, cg_iterations=CG, function_tolerance=0.0)
    pg_cfg = PoseGraphConfig(iterations=PG_ITERS, cg_iterations=CG)
    g = mesh.group
    obs = dist_ba.shard_problem(mesh, ba_np)
    pa = dist_ba.place_point_aligned(mesh, pa_host, pa_meta)
    lam = torch.tensor(1e-4, device=mesh.device)
    pgp = dist_pose_graph.padded_problem(*graph, mesh)
    shard = dist_pose_graph._shard(mesh, pgp)

    def pa_solve(K):
        return (lambda: dist_ba.sharded_ba_solve_point_aligned(mesh, cfg, K)(pa, LM_ITERS),
                lambda: ba.ba_solve(pa, LM_ITERS, cfg, dense_K=K, group=g, point_sharded=True))

    return {
        "point_aligned": pa_solve(None),
        "point_aligned_dense": pa_solve(dense_K),
        "obs": (lambda: dist_ba.sharded_ba_solve(mesh, cfg)(obs, LM_ITERS),
                lambda: ba.ba_solve(obs, LM_ITERS, cfg, group=g)),
        "lm_step": (lambda: dist_ba.sharded_lm_step(mesh, cfg)(obs, lam),
                    lambda: ba.lm_step(obs, lam, cfg, group=g)),
        "lm_step_point_aligned": (
            lambda: dist_ba.sharded_lm_step_point_aligned(mesh, cfg, dense_K)(pa, lam),
            lambda: ba.lm_step_on_shard(pa, lam, cfg, dense_K, g, True)),
        "pose_graph": (_poses(lambda: dist_pose_graph.sharded_pg_solve(mesh, pg_cfg)(pgp)),
                       _poses(lambda: pg.pg_solve(shard, pg_cfg, group=g))),
        "gn_step": (_poses(lambda: dist_pose_graph.sharded_gn_step(mesh, pg_cfg)(pgp)),
                    _poses(lambda: pg.gn_step(shard, pg_cfg, group=g))),
    }


def program_bodies(mesh, ba_np, pa_host, pa_meta, dense_K, graph, cache):
    """name -> thunk of the programs themselves with the mesh's group (on
    the CPU a program runs its bodies as they are, so a gloo group's
    programs run there), in the order and on the shards of `cases`."""
    cfg = BAConfig(max_iterations=LM_ITERS, cg_iterations=CG, function_tolerance=0.0)
    pg_cfg = PoseGraphConfig(iterations=PG_ITERS, cg_iterations=CG)
    g = mesh.group
    obs = dist_ba.shard_problem(mesh, ba_np)
    pa = dist_ba.place_point_aligned(mesh, pa_host, pa_meta)
    lam = torch.tensor(1e-4, device=mesh.device)
    shard = dist_pose_graph._shard(mesh, dist_pose_graph.padded_problem(*graph, mesh))
    return {
        "point_aligned": lambda: ba.ba_solve_program(pa, LM_ITERS, cfg, group=g,
                                                     point_sharded=True, cache=cache),
        "point_aligned_dense": lambda: ba.ba_solve_program(
            pa, LM_ITERS, cfg, dense_K=dense_K, group=g, point_sharded=True, cache=cache),
        "obs": lambda: ba.ba_solve_program(obs, LM_ITERS, cfg, group=g, cache=cache),
        "lm_step": lambda: ba.lm_step_program(obs, lam, cfg, group=g, cache=cache),
        "lm_step_point_aligned": lambda: ba.lm_step_program(
            pa, lam, cfg, dense_K, g, True, cache=cache),
        "pose_graph": _poses(lambda: pg.pg_solve_program(shard, pg_cfg, cache, group=g)),
        "gn_step": _poses(lambda: pg.gn_step_program(shard, pg_cfg, g, cache)),
    }


class _FakeCaptured(programs.Program):
    """A Program that captures on the CPU with a fake graph whose replay
    runs the body's device work only, to count a replay's collectives."""

    def __init__(self, group, program_group=None):
        super().__init__("cpu", program_group)
        self.sum_group = group   # the body sums over it
        self.x = torch.ones(4)

    @property
    def captures(self):
        return True

    def _warm_up(self, body):
        body()

    def _record(self, body):
        body()   # a capture runs the Python and launches nothing

        class Graph:
            def replay(self):
                pass

            def reset(self):
                pass
        return Graph()

    def body(self):
        a, b = mesh_mod.all_reduce_many([self.x, self.x[:2]], self.sum_group)
        self.x.copy_(a)


def two_ranks(rank, world_size, ba_np, pa_host, pa_meta, dense_K, graph):
    """Everything tests/test_torch_dist_programs.py checks at 2 gloo ranks."""
    torch.set_num_threads(1)
    mesh = mesh_mod.make_mesh(device="cpu")
    g = mesh.group
    out = {"capturable": (mesh_mod.capturable(None), mesh_mod.capturable(g))}

    # all_reduce_many against one all_reduce per tensor.
    rng = np.random.default_rng(rank)
    parts = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in ((5, 7), (3,), ())]
    separate = [mesh_mod.all_reduce(p.clone(), g) for p in parts]
    got, counted = run(lambda: mesh_mod.all_reduce_many([p.clone() for p in parts], g))
    out["many"] = (numpy_tree(separate), got, counted)

    # One build's all_reduces on each layout.
    cfg = BAConfig(cg_iterations=CG)
    obs = dist_ba.shard_problem(mesh, ba_np)
    pa = dist_ba.place_point_aligned(mesh, pa_host, pa_meta)
    plans = ba._cam_reduction(pa, None, None, distributed=True)
    out["build_obs"] = run(lambda: ba.build_normal_equations(obs, cfg.huber_delta, group=g))[1]
    out["build_point_aligned"] = run(lambda: ba.build_normal_equations(
        pa, cfg.huber_delta, None, plans, g, True))[1]

    # The entry points run their eager bodies under gloo: no program built.
    cache = programs.ProgramCache()
    saved, programs.PROGRAMS = programs.PROGRAMS, cache
    try:
        out["entries"] = {name: (run(entry), run(body)) for name, (entry, body) in
                          cases(mesh, ba_np, pa_host, pa_meta, dense_K, graph).items()}
        out["entry_programs"] = cache.builds + cache.hits
    finally:
        programs.PROGRAMS = saved

    # The programs with the gloo group, run on the CPU as they are.
    out["programs"] = {name: run(fn) for name, fn in
                       program_bodies(mesh, ba_np, pa_host, pa_meta, dense_K, graph,
                                      cache).items()}
    out["program_groups"] = all(p.group is g for p in cache._programs.values())
    cache.release_groups()
    out["left_after_release"] = len(cache)

    # A program on the card (here: one that says it captures) refuses gloo.
    try:
        _FakeCaptured(g, program_group=g)
        out["card_program_refuses_gloo"] = False
    except ValueError:
        out["card_program_refuses_gloo"] = True

    # A captured body's collectives: counted in the warm-up, taken back at
    # the capture, added again by each replay.
    fake = _FakeCaptured(g)
    n0 = mesh_mod.ALL_REDUCES
    with mesh_mod.recording() as shapes:
        for _ in range(4):
            fake.run("body", fake.body)
    out["replayed"] = (mesh_mod.ALL_REDUCES - n0, shapes)
    return out

"""Rank functions for the port's multi-process tests, and their FileStore
fixture. JAX-free: the ranks are spawned processes that import this module
by name, so it imports only numpy, torch and the port.

Each function runs on every rank of a group that
`stereo_orb_slam_torch.parallel.multihost.launch` started, gets its rank
and the world size first, and returns NumPy results (the parent compares
them). Several checks that share a world size share one spawn.
"""

import copy

import numpy as np
import pytest
import torch

from stereo_orb_slam_torch import convert
from stereo_orb_slam_torch.config import BAConfig, FrontendConfig, PoseGraphConfig, RansacConfig
from stereo_orb_slam_torch.parallel import dist_ba, dist_pose_graph, multihost
from stereo_orb_slam_torch.parallel import mesh as mesh_mod
from stereo_orb_slam_torch.parallel.multi_seq import MultiSequenceSLAM

JOIN_TIMEOUT_S = 240.0   # a spawn that takes longer fails its test


@pytest.fixture
def file_store(tmp_path):
    """A FileStore init_method under the test's tmp_path (fixed TCP ports
    collide across test workers)."""
    return "file://" + str(tmp_path / "store")


def spawn(fn, world_size, init_method, *args):
    """fn on `world_size` gloo ranks; the results in rank order."""
    return multihost.launch(fn, world_size, args=args, backend="gloo",
                            init_method=init_method, timeout_s=JOIN_TIMEOUT_S)


def _cpu_mesh():
    torch.set_num_threads(1)
    return mesh_mod.make_mesh(device="cpu")


def group_info(rank, world_size):
    """initialize()'s summary inside the group, is_primary, and an
    all_reduce of rank + 1 (counted by the port's wrapper)."""
    info = multihost.initialize()
    mesh = _cpu_mesh()
    x = torch.full((3,), float(rank + 1))
    n0 = mesh_mod.ALL_REDUCES
    mesh_mod.all_reduce(x, mesh.group)
    return dict(info, primary=multihost.is_primary(), sum=x.tolist(),
                counted=mesh_mod.ALL_REDUCES - n0, mesh=(mesh.rank, mesh.size))


def lm_steps(rank, world_size, prob_np, pa_host, pa_meta, dense_K, cg_iterations):
    """The obs layout's sharded LM step on prob_np (a whole problem as
    arrays), and the point-aligned step (matrix-free and dense) on
    pa_host/pa_meta with the shapes of every all_reduce recorded."""
    mesh = _cpu_mesh()
    cfg = BAConfig(cg_iterations=cg_iterations)
    lam = torch.tensor(1e-4)
    p, _, _, c0, c1 = dist_ba.sharded_lm_step(mesh, cfg)(
        dist_ba.shard_problem(mesh, prob_np), lam)
    out = {"obs": (p.pose6.numpy(), p.points.numpy(), float(c0), float(c1))}
    prob = dist_ba.place_point_aligned(mesh, pa_host, pa_meta)
    for name, K in (("matrix_free", None), ("dense", dense_K)):
        with mesh_mod.recording() as shapes:
            p, _, _, c0, c1 = dist_ba.sharded_lm_step_point_aligned(mesh, cfg, K)(prob, lam)
        out[name] = (p.pose6.numpy(), float(c0), float(c1), shapes)
    return out


def dist_ba_solves(rank, world_size, world, rig_np, max_iterations, schemes):
    """DistributedBundleAdjuster over a copy of `world` for each scheme:
    stats, the written-back poses and points, all_reduces per solve."""
    mesh = _cpu_mesh()
    rig = convert.rig_from_numpy(rig_np, "cpu")
    out = {}
    for scheme in schemes:
        w = copy.deepcopy(world)
        n0 = mesh_mod.ALL_REDUCES
        adj = dist_ba.DistributedBundleAdjuster(w, rig, mesh, BAConfig(max_iterations=max_iterations),
                                                scheme=scheme)
        stats = adj.optimize(0, w.num_frames)
        out[scheme] = (stats, w.pose_global[:w.num_frames].copy(),
                       w.points[:w.num_points].copy(), mesh_mod.ALL_REDUCES - n0)
    return out


def dist_ba_checks(rank, world_size, world, rig_np, max_iterations, schemes,
                   pa_host=None, pa_meta=None, dense_K=None, pa_iters=0):
    """dist_ba_solves and, with a point-aligned problem, point_aligned_paths
    in one spawn."""
    out = {"solves": dist_ba_solves(rank, world_size, world, rig_np, max_iterations, schemes)}
    if pa_host is not None:
        out["paths"] = point_aligned_paths(rank, world_size, pa_host, pa_meta, dense_K,
                                           pa_iters)
    return out


def point_aligned_paths(rank, world_size, pa_host, pa_meta, dense_K, iters):
    """The point-aligned solve, matrix-free and dense (dense_K), over the
    same shards with no convergence exit: (iterations, cost, pose6) each."""
    mesh = _cpu_mesh()
    cfg = BAConfig(max_iterations=iters, function_tolerance=0.0)
    prob = dist_ba.place_point_aligned(mesh, pa_host, pa_meta)
    out = {}
    for name, K in (("matrix_free", None), ("dense", dense_K)):
        carry, n_it, _ = dist_ba.sharded_ba_solve_point_aligned(mesh, cfg, K)(prob, iters)
        out[name] = (int(n_it), float(carry.cost), carry.prob.pose6.numpy())
    return out


def pose_graph_solves(rank, world_size, poses, edge_a, edge_b, meas, iteration_counts):
    """dist_pose_graph.solve of the graph for each GN iteration count,
    [(poses, costs), ...], and one sharded_gn_step of the padded graph
    (poses, cost)."""
    mesh = _cpu_mesh()
    solves = [dist_pose_graph.solve(poses, edge_a, edge_b, meas, mesh,
                                    PoseGraphConfig(iterations=n))
              for n in iteration_counts]
    prob = dist_pose_graph.padded_problem(poses, edge_a, edge_b, meas, mesh)
    stepped, cost = dist_pose_graph.sharded_gn_step(mesh, PoseGraphConfig())(prob)
    return solves, (stepped.poses.numpy(), float(cost))


def multi_seq_frames(rank, world_size, imgs_l, imgs_r, rigs_np, n_feat, n_hyp, seed):
    """MultiSequenceSLAM over the mesh: every frame's S transforms, and the
    sequences this rank tracked."""
    mesh = _cpu_mesh()
    rigs = [convert.rig_from_numpy(r, "cpu") for r in rigs_np]
    multi = MultiSequenceSLAM(rigs, FrontendConfig(num_features=n_feat),
                              RansacConfig(num_hypotheses=n_hyp), mesh=mesh, seed=seed)
    frames = [np.stack(multi.process(il, ir)) for il, ir in zip(imgs_l, imgs_r)]
    return frames, list(multi.sequences)


def refine_rank(rank, world_size, argv):
    """apps.refine.main(argv) on this rank (argv has --distributed): its
    stats and the refined poses."""
    from stereo_orb_slam_torch.apps import refine

    torch.set_num_threads(1)
    out = refine.main(argv)
    world = out.pop("world")
    return out, world.pose_global[:world.num_frames].copy()

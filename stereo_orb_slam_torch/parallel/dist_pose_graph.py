"""Distributed pose-graph Gauss-Newton over the ranks of a mesh.

PyTorch counterpart of the JAX package's `parallel/dist_pose_graph.py`:
edges sharded over the ranks, vertex state replicated; the per-edge
Hessian and gradient contributions and the vertex sum inside each CG
matvec are summed over the ranks (backend/pose_graph.py with `group`):
1 + cg_iterations all_reduces a Gauss-Newton step. Every rank runs the
same steps on the same replicated vertices, so all ranks end with the
same poses.

The JAX package compiles the sharded solve into one program
(`jax.jit(shard_map(...))`); here it runs as the captured `GNProgram`
with the mesh's group when `mesh.capturable(group)` (one process, or
NCCL), and as the eager `pg_solve` / `gn_step` under gloo, chosen by the
group's backend.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereo_orb_slam_torch.backend.pose_graph import (
    PoseGraphProblem, gn_step, gn_step_program, pad_problem, pg_solve, pg_solve_program,
)
from stereo_orb_slam_torch.config import PoseGraphConfig
from stereo_orb_slam_torch.parallel.mesh import Mesh, capturable


def _shard(mesh: Mesh, prob: PoseGraphProblem) -> PoseGraphProblem:
    """This rank's slice of the edge arrays (whose length the mesh size
    divides); vertex state whole."""
    E = prob.edge_a.shape[0]
    if E % mesh.size:
        raise ValueError(f"{E} edges do not split over {mesh.size} ranks")
    k = E // mesh.size
    lo, hi = mesh.rank * k, (mesh.rank + 1) * k
    return prob._replace(edge_a=prob.edge_a[lo:hi], edge_b=prob.edge_b[lo:hi],
                         edge_meas=prob.edge_meas[lo:hi], edge_weight=prob.edge_weight[lo:hi])


def sharded_gn_step(mesh: Mesh, cfg: PoseGraphConfig):
    """fn(prob) -> (prob', cost): one GN step with prob's edges split over
    the mesh (prob holds all edges; each rank keeps its slice): the
    GNProgram's step when the group is capturable, gn_step under gloo."""
    def step(prob):
        fn = gn_step_program if capturable(mesh.group) else gn_step
        new, cost = fn(_shard(mesh, prob), cfg, group=mesh.group)
        return prob._replace(poses=new.poses), cost
    return step


def sharded_pg_solve(mesh: Mesh, cfg: PoseGraphConfig):
    """fn(prob) -> (prob', cost0, cost_final): all GN iterations
    (backend.pose_graph.pg_solve) with prob's edges split over the mesh:
    the captured program when the group is capturable (as
    PoseGraphOptimizer runs it at one process), the eager solve under
    gloo, whose host-staged all_reduces no graph can hold."""
    def run(prob):
        fn = pg_solve_program if capturable(mesh.group) else pg_solve
        new, c0, c1 = fn(_shard(mesh, prob), cfg, group=mesh.group)
        return prob._replace(poses=new.poses), c0, c1
    return run


def padded_problem(poses, edge_a, edge_b, edge_meas, mesh: Mesh,
                   fixed_vertex: int = 0) -> PoseGraphProblem:
    """The whole graph on the mesh's device, its edges padded to a
    multiple of the mesh size with zero-weight identity edges and
    `fixed_vertex` held fixed (the gauge)."""
    E_pad = -(-max(len(edge_a), 1) // mesh.size) * mesh.size
    return pad_problem(poses, edge_a, edge_b, edge_meas, len(poses), E_pad, mesh.device,
                       fixed_vertex)


def solve(poses, edge_a, edge_b, edge_meas, mesh: Mesh,
          cfg: Optional[PoseGraphConfig] = None, fixed_vertex: int = 0):
    """Standalone distributed pose-graph solve, called on every rank with
    the same graph: poses [N,4,4], edges as arrays (see padded_problem).
    Returns (poses_new [N,4,4] as NumPy, the same on every rank,
    [cost_initial, cost_final])."""
    cfg = cfg or PoseGraphConfig()
    prob = padded_problem(poses, edge_a, edge_b, edge_meas, mesh, fixed_vertex)
    prob, c0, c_last = sharded_pg_solve(mesh, cfg)(prob)
    costs = torch.stack([c0, c_last]).cpu().numpy()
    return prob.poses.cpu().numpy(), [float(costs[0]), float(costs[1])]

"""Distributed bundle adjustment over the ranks of a mesh.

PyTorch counterpart of the JAX package's `parallel/dist_ba.py`. The math is
backend/ba.py's with a process group (`group`, JAX's `axis_name`): each
rank evaluates residuals, Jacobians and W blocks of its own observations,
sums them locally in the fixed segment order, and one all_reduce per
reduction completes the normal equations; the PCG loop (or the dense
Cholesky) runs replicated, so every rank takes the same LM steps.

Two layouts, as in the JAX package:
- "obs": observations split 1/N over the ranks in any order, cameras and
  points replicated; every camera and point sum is all-reduced.
- "point_aligned" (the default): points partitioned into contiguous
  ranges balanced by observation count (`partition_points_balanced`),
  each point's whole observation run on its rank (`build_point_aligned`),
  so point blocks and point updates stay local and only camera-sized
  tensors cross the ranks: the camera blocks, the reduced right-hand
  side, one [C, 6] sum per CG iteration (or one [6C, 6C] sum on the
  dense path, `dense_K`) and the cost.

SPMD: every rank builds the same host problem from its replica of the
world and keeps its shard; after a solve, the points are summed over the
ranks from a zero-filled full array (the shards are disjoint, so the sum
is exact; one eager all_reduce outside the solve's program, as the JAX
package gathers outside its program), and every rank writes the same
cameras and points back.

How it runs: the JAX package compiles each sharded solve and step into
one program (`jax.jit(shard_map(...))`). Here each runs through its
captured program (backend/ba.py: `ba_solve_program`, `lm_step_program`)
with the mesh's group when `mesh.capturable(group)`: one process, or an
NCCL group, whose all_reduces the CUDA graphs record. Under gloo, which
stages every collective through the host, the same solves run as their
eager bodies (`ba_solve`, `lm_step_on_shard`), chosen by the group's
backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stereo_orb_slam_torch.backend import ba as ba_mod
from stereo_orb_slam_torch.backend.ba import BAProblem, full_f32
from stereo_orb_slam_torch.config import BAConfig
from stereo_orb_slam_torch.geometry import se3_np
from stereo_orb_slam_torch.parallel.mesh import (
    Mesh, all_reduce, capturable, obs_sharding, replicated,
)
from stereo_orb_slam_torch.utils import programs

_OBS_FIELDS = ("obs_cam", "obs_point", "obs_uv", "obs_weight")
_INDEX_FIELDS = ("obs_cam", "obs_point")


def _as_tensor(name, x, device):
    dtype = torch.int64 if name in _INDEX_FIELDS else torch.float32
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device,
                           dtype=dtype)


def shard_problem(mesh: Mesh, prob: BAProblem) -> BAProblem:
    """This rank's part of a whole BAProblem (tensors or arrays) for the
    "obs" layout: the observation arrays split 1/N along their axis (whose
    length the mesh size must divide), pose and point state replicated."""
    return BAProblem(**{
        f: (obs_sharding(mesh, _as_tensor(f, x, "cpu")) if f in _OBS_FIELDS
            else replicated(mesh, _as_tensor(f, x, "cpu")))
        for f, x in zip(BAProblem._fields, prob)
    })


def _step(mesh: Mesh, cfg: BAConfig, dense_K, point_sharded: bool):
    """fn(prob_shard, lam) -> lm_step's results: through LMStepProgram when
    the group is capturable, else the eager step."""
    def step(prob, lam):
        fn = (ba_mod.lm_step_program if capturable(mesh.group)
              else ba_mod.lm_step_on_shard)
        return fn(prob, lam, cfg, dense_K, mesh.group, point_sharded)
    return step


def _solve(mesh: Mesh, cfg: BAConfig, dense_K, point_sharded: bool):
    """fn(prob_shard, max_iters) -> ba_solve's results: through its LMProgram
    when the group is capturable, else the eager solve."""
    def solve(prob, max_iters):
        fn = ba_mod.ba_solve_program if capturable(mesh.group) else ba_mod.ba_solve
        return fn(prob, max_iters, cfg, dense_K=dense_K, group=mesh.group,
                  point_sharded=point_sharded)
    return solve


def sharded_lm_step(mesh: Mesh, cfg: BAConfig):
    """fn(prob_shard, lam) -> (prob', lam', accepted, c0, c1): backend.ba's
    lm_step over this rank's shard of the "obs" layout (one captured
    program when the group is capturable)."""
    return _step(mesh, cfg, None, False)


def sharded_ba_solve(mesh: Mesh, cfg: BAConfig):
    """fn(prob_shard, max_iters) -> (carry, iterations, cost_initial): the
    whole LM solve (backend.ba.ba_solve) over this rank's shard of the
    "obs" layout, with no host sync (one captured program when the group
    is capturable)."""
    return _solve(mesh, cfg, None, False)


class DistributedBundleAdjuster:
    """BundleAdjuster's counterpart whose solves are split over the mesh's ranks.

    Every rank constructs it over its own replica of the same world and
    calls `optimize` with the same arguments; afterwards every replica
    holds the same cameras and points. scheme="point_aligned" (default)
    or "obs" (see the module docstring). `last_stats` says whether the
    solve ran as a captured program on the card ("captured"; a capturable
    group's program runs its bodies as they are on the CPU), whether this
    call built a program ("program_built") and the milliseconds of its
    captures ("capture_ms")."""

    def __init__(self, world, rig, mesh: Mesh, cfg: Optional[BAConfig] = None,
                 scheme: str = "point_aligned"):
        if scheme not in ("point_aligned", "obs"):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.mesh = mesh
        self.scheme = scheme
        self.cfg = cfg or BAConfig()
        self.world = world
        self.P_l = rig.left.projection.to(mesh.device)
        self.P_r = rig.right.projection.to(mesh.device)
        self.last_stats = {}

    @full_f32
    def optimize(self, start_frame: int, end_frame: int,
                 max_iterations: Optional[int] = None) -> dict:
        """The solve of world frames [start, end) with BundleAdjuster's
        window semantics (first camera fixed), its iterations capped at
        `max_iterations` (the config's by default)."""
        world = self.world
        end_frame = min(end_frame, world.num_frames)
        if end_frame - start_frame < 1:
            return {}
        problem = world.ba_problem(start_frame, end_frame)
        n_obs = len(problem["obs_cam"])
        if n_obs == 0:
            return {}
        iters = max_iterations or self.cfg.max_iterations
        cache = programs.PROGRAMS
        builds, capture_ms = cache.builds, cache.capture_ms
        if self.scheme == "obs":
            pose6, points, n_it, c0, c1, extra = self._solve_obs(problem, iters)
        else:
            pose6, points, n_it, c0, c1, extra = self._solve_point_aligned(problem, iters)
        cam_world_new = se3_np.inverse_np(se3_np.pose6_to_matrix_np(pose6))
        world.ba_writeback(problem, cam_world_new, points)
        self.last_stats = {
            "iterations": n_it,
            "cost_initial": c0,
            "cost_final": c1,
            "num_cams": len(problem["frame_ids"]),
            "num_points": len(problem["point_ids"]),
            "num_obs": n_obs,
            "num_devices": self.mesh.size,
            "scheme": self.scheme,
            "captured": capturable(self.mesh.group) and self.mesh.device.type == "cuda",
            "program_built": cache.builds > builds,
            "capture_ms": cache.capture_ms - capture_ms,
            **extra,
        }
        return self.last_stats

    def _solve_obs(self, problem, iters):
        mesh = self.mesh
        P_real = len(problem["point_ids"])
        n_obs = len(problem["obs_cam"])
        P_pad = ba_mod._pad_to(P_real)
        O_pad = ba_mod._pad_to(n_obs, mult=256 * mesh.size)
        pose6, s_cam, s_point, s_uv, cam_mask = ba_mod.prepare_problem_arrays(
            problem, sort_by_point=False)
        points = np.zeros((P_pad, 3), np.float32)
        points[:P_real] = problem["point_xyz"]
        obs_cam = np.zeros(O_pad, np.int64)
        obs_point = np.zeros(O_pad, np.int64)
        obs_uv = np.zeros((O_pad, 4), np.float32)
        obs_w = np.zeros(O_pad, np.float32)
        obs_cam[:n_obs] = s_cam
        obs_point[:n_obs] = s_point
        obs_uv[:n_obs] = s_uv
        obs_w[:n_obs] = 1.0
        point_mask = np.zeros(P_pad, np.float32)
        point_mask[:P_real] = 1.0
        prob = shard_problem(mesh, BAProblem(pose6, points, obs_cam, obs_point, obs_uv, obs_w,
                                             cam_mask, point_mask, self.P_l.cpu(),
                                             self.P_r.cpu()))
        carry, n_it, c0 = sharded_ba_solve(mesh, self.cfg)(prob, iters)
        flat = ba_mod._pack_ba_result(carry.prob.pose6, carry.prob.points, n_it, c0,
                                      carry.cost).cpu().numpy()
        C = pose6.shape[0]
        n_it, c0, c1 = flat[-3:]
        return (flat[:C * 6].reshape(C, 6), flat[C * 6:C * 6 + P_real * 3].reshape(P_real, 3),
                int(n_it), float(c0), float(c1), {})

    def _solve_point_aligned(self, problem, iters):
        mesh, cfg = self.mesh, self.cfg
        C = len(problem["frame_ids"])
        pose6, obs_cam, obs_point, obs_uv, cam_mask = ba_mod.prepare_problem_arrays(
            problem, sort_by_point=True)
        host, meta = build_point_aligned(pose6, problem["point_xyz"], obs_cam, obs_point,
                                         obs_uv, cam_mask, self.P_l.cpu().numpy(),
                                         self.P_r.cpu().numpy(), mesh.size)
        prob = place_point_aligned(mesh, host, meta)
        # The dense Schur bucket when the camera system is small enough for
        # one [6C, 6C] sum (the single-process dense gate); otherwise
        # matrix-free (dense_K None).
        dense_K = None
        if C <= cfg.dense_schur_max_cams:
            kmax = max(int(np.bincount(obs_point).max(initial=2)), 2)
            K = 1 << (kmax - 1).bit_length()
            if meta["P_s"] * K <= cfg.dense_schur_max_slots:
                dense_K = K
        carry, n_it, c0 = sharded_ba_solve_point_aligned(mesh, cfg, dense_K)(prob, iters)
        points = gather_points(mesh, carry.prob.points, meta)
        flat = ba_mod._pack_ba_result(carry.prob.pose6, points, n_it, c0,
                                      carry.cost).cpu().numpy()
        n_it, c0, c1 = flat[-3:]
        bounds = meta["bounds"]
        pts = flat[C * 6:-3].reshape(mesh.size, meta["P_s"], 3)
        pts_real = (np.concatenate([pts[d, :bounds[d + 1] - bounds[d]]
                                    for d in range(mesh.size)])
                    if bounds[-1] else np.zeros((0, 3), np.float32))
        return (flat[:C * 6].reshape(C, 6), pts_real, int(n_it), float(c0), float(c1),
                {"dense_K": dense_K})


# -------------------------------------------------- point-aligned sharding
def partition_points_balanced(obs_point_sorted, P_real: int, n_dev: int):
    """Contiguous point ranges with about balanced observation counts.

    Returns boundaries [n_dev + 1]: rank d owns points [bounds[d],
    bounds[d+1]) and, because observations are point-sorted, a contiguous
    run of observations. (The JAX package's host planner, copied.)
    """
    counts = np.bincount(np.asarray(obs_point_sorted), minlength=P_real)
    cum = np.cumsum(counts)
    total = int(cum[-1]) if len(cum) else 0
    bounds = [0]
    for k in range(1, n_dev):
        bounds.append(int(np.searchsorted(cum, k * total / n_dev)))
    bounds.append(P_real)
    return bounds


def build_point_aligned(pose6, points, obs_cam, obs_point, obs_uv,
                        cam_mask, P_l, P_r, n_dev: int, pad_mult: int = 8):
    """Host-side construction of the point-aligned distributed problem.

    Points are partitioned into contiguous ranges (balanced by observation
    count) and each point's whole observation run lands on one rank, so
    point blocks, point updates and per-point CG quantities are local and
    only camera-sized tensors are summed over the ranks.

    Inputs are unpadded host arrays with obs sorted by point id. Returns
    (BAProblem of NumPy arrays with [n_dev * S] leading-axis layouts, meta)
    where meta carries the ranks' point ranges ("bounds") and pad sizes
    ("P_s", "O_s"). The same arrays as the JAX package's
    `build_point_aligned` (index arrays int32 here as there).
    """
    P_real = len(points)
    O_real = len(obs_cam)
    bounds = partition_points_balanced(obs_point, P_real, n_dev)
    obs_starts = np.searchsorted(np.asarray(obs_point), np.asarray(bounds[:-1]))
    obs_ends = np.concatenate([obs_starts[1:], [O_real]])

    P_s = max(int(np.max(np.diff(bounds))), 1)
    P_s = -(-P_s // pad_mult) * pad_mult
    O_s = max(int(np.max(obs_ends - obs_starts)), 1)
    O_s = -(-O_s // pad_mult) * pad_mult

    pts = np.zeros((n_dev, P_s, 3), np.float32)
    pmask = np.zeros((n_dev, P_s), np.float32)
    oc = np.zeros((n_dev, O_s), np.int32)
    op = np.zeros((n_dev, O_s), np.int32)
    ouv = np.zeros((n_dev, O_s, 4), np.float32)
    ow = np.zeros((n_dev, O_s), np.float32)
    for d in range(n_dev):
        lo, hi = bounds[d], bounds[d + 1]
        npts = hi - lo
        pts[d, :npts] = points[lo:hi]
        pmask[d, :npts] = 1.0
        s, e = obs_starts[d], obs_ends[d]
        k = e - s
        oc[d, :k] = obs_cam[s:e]
        op[d, :k] = obs_point[s:e] - lo     # local point indices
        ouv[d, :k] = obs_uv[s:e]
        ow[d, :k] = 1.0

    prob = BAProblem(
        pose6=np.asarray(pose6, np.float32), points=pts.reshape(-1, 3),
        obs_cam=oc.reshape(-1), obs_point=op.reshape(-1), obs_uv=ouv.reshape(-1, 4),
        obs_weight=ow.reshape(-1), cam_mask=np.asarray(cam_mask, np.float32),
        point_mask=pmask.reshape(-1), P_l=np.asarray(P_l, np.float32),
        P_r=np.asarray(P_r, np.float32),
    )
    meta = {"bounds": bounds, "P_s": P_s, "O_s": O_s, "n_dev": n_dev}
    return prob, meta


def place_point_aligned(mesh: Mesh, prob: BAProblem, meta) -> BAProblem:
    """This rank's shard of a point-aligned problem (build_point_aligned's
    host arrays) on the mesh's device: its points and observations, camera
    state and projections whole."""
    if meta["n_dev"] != mesh.size:
        raise ValueError(f"problem built for {meta['n_dev']} ranks, mesh has {mesh.size}")
    sharded = _OBS_FIELDS + ("points", "point_mask")
    return BAProblem(**{
        f: (obs_sharding(mesh, _as_tensor(f, x, "cpu")) if f in sharded
            else replicated(mesh, _as_tensor(f, x, "cpu")))
        for f, x in zip(BAProblem._fields, prob)
    })


def gather_points(mesh: Mesh, local_points, meta):
    """Every rank's [P_s, 3] point shard in the [n_dev * P_s, 3] layout, on
    every rank: one all_reduce over a zero-filled full array (the shards
    are disjoint, so the sum is exact)."""
    full = torch.zeros((mesh.size * meta["P_s"], 3), dtype=local_points.dtype,
                       device=local_points.device)
    full[mesh.rank * meta["P_s"]:(mesh.rank + 1) * meta["P_s"]] = local_points
    return all_reduce(full, mesh.group)


def sharded_ba_solve_point_aligned(mesh: Mesh, cfg: BAConfig, dense_K=None):
    """fn(prob_shard, max_iters) -> (carry, iterations, cost_initial): the
    whole LM solve over this rank's shard of a point-aligned problem
    (place_point_aligned), point state local, camera state replicated.

    `dense_K` (pow2 >= the most observations of any point) takes the
    distributed dense Schur: each rank assembles its points' share of S,
    one [6C, 6C] all_reduce, the Cholesky replicated: 3 all_reduces per LM
    iteration (the right-hand side, S, and the trial build's camera blocks
    and cost in one) instead of one per CG iteration. dense_K None is
    matrix-free. One captured program when the group is capturable."""
    return _solve(mesh, cfg, dense_K, True)


def sharded_lm_step_point_aligned(mesh: Mesh, cfg: BAConfig, dense_K=None):
    """fn(prob_shard, lam) -> (prob', lam', accepted, c0, c1): one LM step
    over this rank's shard of a point-aligned problem (the scaling
    harness's step). `dense_K`: see sharded_ba_solve_point_aligned. One
    captured program when the group is capturable."""
    return _step(mesh, cfg, dense_K, True)

"""SE(3) pose-graph optimization (Gauss-Newton, Huber, gauge-fixed).

PyTorch counterpart of the JAX package's `backend/pose_graph.py`, which
replaces the reference's g2o pipeline (ref `src/pose_graph_optimizer.cpp`):
a vertex per frame, an edge per odometry step (measurement = the stored
relative pose, ref :126-172) and per loop closure (measurement from
descriptor re-matching + RANSAC, ref :175-217), information I6 with the
translation block scaled to 0.01 (ref :23-26), Huber kernel, frame 0 held
fixed (ref :61-65,119-121), 10 iterations (ref :69).

Per-edge residuals r = log(Z^-1 T_a^-1 T_b) with local right-increment
Jacobians by forward-mode differentiation (`torch.func.jvp`); the normal
equations are assembled with the BA slice's segmented sums (each vertex's
rows added in index order, no atomics) and solved matrix-free by the BA
slice's block-Jacobi PCG (`ba.pcg`: the same masked full-count CG as the
JAX `while_loop`, with the same exit test). The graph Hessian is never
materialised. The error vector is ordered [translation, rotation], as the
g2o information matrix is indexed in the reference.

Distributed (parallel/dist_pose_graph.py): with `group`, the problem's
edges are this rank's shard and the vertex state is replicated; each
vertex sum is taken locally in edge order and then summed over the ranks
(JAX's `psum`), and so is the cost: the assembly's three sums (gradient,
block diagonal, cost) in one all_reduce (`all_reduce_many`, as XLA's
combiner merges them), and one per CG matvec, so a Gauss-Newton step
makes 1 + cg_iterations all_reduces.

How it runs: the JAX package jits the whole solve (`pg_solve_impl`, a
`lax.scan` of GN steps whose CG is a `while_loop`) into one device
program, and its optimizer pads the graph to power-of-two buckets so that
XLA compiles one program per bucket, not per graph. The port pads as it
does (`pad_problem`: identity vertices held fixed, edges (0, 0) with
the identity measurement and weight 0; the padded rows fall in no real
vertex's segment, `edge_plan`), and `PoseGraphOptimizer` runs
`pg_solve_program`: a `GNProgram` (utils/programs.py) whose three bodies
(the assembly, one masked CG iteration, the step's update) are captured
once per bucket as CUDA graphs and replayed iterations x (cg_iterations
+ 2) times a solve, so a closure whose graph falls in a bucket met before
captures nothing; `SlamSystem.prewarm_closure_path` captures the large
buckets ahead. The distributed pose graph runs the same program with its
process group when `mesh.capturable(group)` (an NCCL group: the graphs
record its all_reduces). `pg_solve` and `gn_step` are the same solve as
eager launches: the plain versions the tests and the smoke hold the
program to, bit for bit, and the solve of a gloo group, which stages its
collectives through the host and so cannot be captured.
The padding adds exact zeros and changes no real vertex's segment sum,
but it changes the trees of the whole-vector reductions (CG's dot
products, the cost), so a bucketed solve equals the exact-size one only
within float32 noise (tests/test_torch_pose_graph.py holds both to a
float64 solve).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jvp, vmap

from stereo_orb_slam_torch.backend.ba import (
    SPREAD_ROWS, CGState, Segments, _inv6_gj, _seg_sum, full_f32, pcg, pcg_iteration, pcg_start,
    segments,
)
from stereo_orb_slam_torch.backend.residuals import bmv
from stereo_orb_slam_torch.config import PoseGraphConfig
from stereo_orb_slam_torch.geometry import se3
from stereo_orb_slam_torch.parallel.mesh import all_reduce, all_reduce_many
from stereo_orb_slam_torch.utils import programs
from stereo_orb_slam_torch.utils.profiling import TRACER


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor        # [N,4,4] global poses (camera-to-world)
    edge_a: torch.Tensor       # [E] int64
    edge_b: torch.Tensor       # [E] int64
    edge_meas: torch.Tensor    # [E,4,4] measurement Z: expected T_a^-1 @ T_b
    edge_weight: torch.Tensor  # [E] 1.0 real / 0.0 padding
    vertex_mask: torch.Tensor  # [N] 1.0 free / 0.0 fixed (gauge)


def bucket(count: int) -> int:
    """The padded size of a vertex or edge count: the next power of two,
    at least 8 (the JAX optimizer's N_pad and E_pad)."""
    return max(8, 1 << (count - 1).bit_length())


def pad_problem(poses, edge_a, edge_b, edge_meas, N_pad: int, E_pad: int, device,
                fixed_vertex: int = 0) -> PoseGraphProblem:
    """The graph of n = len(poses) vertices and E edges (host arrays) as a
    problem of N_pad vertices and E_pad edges on `device`: the real vertices
    free but `fixed_vertex` (the gauge), the padded ones identity poses held
    fixed (vertex_mask 0) with no edge; the padded edges (0, 0) with the
    identity measurement and weight 0, which change no sum."""
    n, E = len(poses), len(edge_a)
    ea = np.zeros(E_pad, np.int64)
    eb = np.zeros(E_pad, np.int64)
    em = np.tile(np.eye(4, dtype=np.float32), (E_pad, 1, 1))
    ew = np.zeros(E_pad, np.float32)
    ea[:E] = edge_a
    eb[:E] = edge_b
    em[:E] = edge_meas
    ew[:E] = 1.0
    P = np.tile(np.eye(4, dtype=np.float32), (N_pad, 1, 1))
    P[:n] = poses
    vmask = np.zeros(N_pad, np.float32)
    vmask[:n] = 1.0
    vmask[fixed_vertex] = 0.0
    return PoseGraphProblem(*(torch.as_tensor(a, device=device)
                              for a in (P, ea, eb, em, ew, vmask)))


def bucketed_problem(poses, edge_a, edge_b, edge_meas, device) -> PoseGraphProblem:
    """The graph padded as the JAX optimizer pads it: to bucket(n) vertices
    and bucket(E) edges, vertex 0 fixed (the gauge, ref :61-65, frame 0
    fixed at :119-121)."""
    return pad_problem(poses, edge_a, edge_b, edge_meas, bucket(len(poses)),
                       bucket(len(edge_a)), device)


def edge_residual(Ta, Tb, Z, da, db):
    """The 6-residual of edges with local increments applied, batched over
    leading dims: r = log(Z^-1 (Ta e^da)^-1 (Tb e^db)), reordered to
    [trans, rot]."""
    Ta_i = Ta @ se3.se3_exp(da)
    Tb_i = Tb @ se3.se3_exp(db)
    diff = se3.inverse(Z) @ (se3.inverse(Ta_i) @ Tb_i)
    xi = se3.se3_log(diff)  # [w, v]
    return torch.cat([xi[..., 3:], xi[..., :3]], dim=-1)  # -> [v, w]


def edge_jacobians(Ta, Tb, Z):
    """d r / d da and d r / d db at zero increments, [E, 6, 6] each.

    The JAX package vmaps `jacfwd` over single edges. Here one forward-mode
    product per basis direction runs over all E edges at once (vmapped over
    the 12 directions), so no intermediate is a 0-d tensor: under
    torch.func's forward mode, a 0-d tensor plus a Python scalar gives a
    float64 tangent."""
    E = Ta.shape[0]
    z = torch.zeros((E, 6), dtype=Ta.dtype, device=Ta.device)
    basis = torch.eye(12, dtype=Ta.dtype, device=Ta.device)

    def column(t):
        ta, tb = t[:6].expand(E, 6), t[6:].expand(E, 6)
        return jvp(lambda da, db: edge_residual(Ta, Tb, Z, da, db), (z, z), (ta, tb))[1]

    cols = vmap(column)(basis)          # [12, E, 6]: direction, edge, residual
    J = cols.permute(1, 2, 0)           # [E, 6, 12]
    return J[..., :6], J[..., 6:]


_forward_mode_ready = False


def warm_up():
    """Run forward mode once, on the CPU, at a tiny size. PyTorch's first
    forward-mode product in a process imports a large part of the library
    (seconds: PERF.md has the H100 host's 6.7-8.0 s); PoseGraphOptimizer
    calls this when it is built, so a live loop's first closure does not
    stall for it."""
    global _forward_mode_ready
    if not _forward_mode_ready:
        eye = torch.eye(4)[None]
        edge_jacobians(eye, eye, eye)
        _forward_mode_ready = True


def edge_terms(poses, edge_a, edge_b, edge_meas, edge_weight, info_sqrt,
               huber_delta: float):
    """Whitened residuals + Jacobians of all edges.

    info_sqrt: [6] sqrt of the diagonal information ([trans x3, rot x3]).
    Returns (r [E,6], J_a [E,6,6], J_b [E,6,6], cost).
    """
    Ta = poses[edge_a]
    Tb = poses[edge_b]
    z = torch.zeros((edge_a.shape[0], 6), dtype=poses.dtype, device=poses.device)
    r = edge_residual(Ta, Tb, edge_meas, z, z)
    J_a, J_b = edge_jacobians(Ta, Tb, edge_meas)

    r = r * info_sqrt[None, :]
    J_a = J_a * info_sqrt[None, :, None]
    J_b = J_b * info_sqrt[None, :, None]

    s = torch.sum(r * r, dim=-1)
    d2 = huber_delta * huber_delta
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-18))
    hw = torch.where(s <= d2, 1.0, huber_delta / sqrt_s)
    rho = torch.where(s <= d2, s, 2.0 * huber_delta * sqrt_s - d2)
    cost = 0.5 * torch.sum(rho * edge_weight)

    wscale = (torch.sqrt(hw) * edge_weight)[:, None]
    return r * wscale, J_a * wscale[..., None], J_b * wscale[..., None], cost


def _bmtv(J, r):
    """[E, k, i]^T [E, k] -> [E, i] (the JAX `eki,ek->ei` einsum)."""
    return torch.sum(J * r[..., :, None], dim=-2)


class EdgePlan(NamedTuple):
    """The graph's edge ends, fixed for a solve: `ends` = [edge_a; edge_b]
    [2E] and their grouping for the vertex sums, edge_a's rows in segments
    0..N-1 and edge_b's in N..2N-1 (ba.segments), so one segmented sum gives
    both per-vertex sums and adding the two halves gives the JAX package's
    `seg_sum(a) + seg_sum(b)`, each segment added in edge order. The rows
    of weight-0 (padded) edges, which carry vertex 0, go to segments of
    their own after the 2N, which the sums drop: in vertex 0's segments
    they would make its sums as long as the padding (the card adds a
    segment's rows one after another)."""

    ends: torch.Tensor
    seg: Segments


def edge_plan(prob: PoseGraphProblem) -> EdgePlan:
    N = prob.poses.shape[0]
    keep = prob.edge_weight > 0
    return EdgePlan(torch.cat([prob.edge_a, prob.edge_b]),
                    segments(torch.cat([prob.edge_a, prob.edge_b + N]), 2 * N,
                             keep=torch.cat([keep, keep])))


def _vertex_sum(rows_a, rows_b, plan: EdgePlan, N: int):
    """seg_sum(rows_a by edge_a) + seg_sum(rows_b by edge_b), rows [E, ...],
    this rank's share."""
    both = _seg_sum(torch.cat([rows_a, rows_b]), None, 2 * N, plan.seg)
    return both.view((2, N) + both.shape[1:]).sum(0)


def _normal_equations(prob: PoseGraphProblem, cfg: PoseGraphConfig, plan: EdgePlan,
                      group=None):
    """A GN step's system at prob's poses: (J [2E,6,6], the rows of
    `plan.ends`; b [N,6] = -(J^T r) per vertex; M_inv [N,6,6], the inverse
    of H's damped block diagonal, identity for fixed vertices; the cost, a
    0-d tensor). With `group`, the two vertex sums and the cost are summed
    over the ranks in one all_reduce."""
    dt, dev = prob.poses.dtype, prob.poses.device
    # Made on the device: a host tensor would be a copy and a sync per step.
    info_sqrt = torch.cat([torch.full((3,), float(np.sqrt(cfg.info_translation)), dtype=dt,
                                      device=dev),
                           torch.full((3,), float(np.sqrt(cfg.info_rotation)), dtype=dt,
                                      device=dev)])
    r, J_a, J_b, cost = edge_terms(prob.poses, prob.edge_a, prob.edge_b, prob.edge_meas,
                                   prob.edge_weight, info_sqrt, cfg.huber_delta)
    N = prob.poses.shape[0]
    vm = prob.vertex_mask[:, None]

    # Gradient: b = -(J^T r) accumulated per vertex, and the block
    # diagonal of H for the Jacobi preconditioner.
    grad = _vertex_sum(_bmtv(J_a, r), _bmtv(J_b, r), plan, N)
    diag = _vertex_sum(J_a.transpose(-1, -2) @ J_a, J_b.transpose(-1, -2) @ J_b, plan, N)
    grad, diag, cost = all_reduce_many([grad, diag, cost], group)
    b = -grad * vm
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = diag + cfg.damping * eye6[None]
    diag = torch.where(prob.vertex_mask[:, None, None] > 0, diag, eye6[None])
    return torch.cat([J_a, J_b]), b, _inv6_gj(diag), cost


def _matvec(x, J, vertex_mask, plan: EdgePlan, damping: float, group=None):
    """(J^T J + damping I) x over the free vertices, x unchanged on the
    fixed ones."""
    N, E = x.shape[0], J.shape[0] // 2
    vm = vertex_mask[:, None]
    xm = x * vm
    v = bmv(J, xm[plan.ends])                        # J_a xm[a]; J_b xm[b]
    y = v.view(2, E, 6).sum(0)                       # [E,6] = J_e @ x
    w = _bmtv(J, y.repeat(2, 1))                     # J_a^T y; J_b^T y
    both = _seg_sum(w, None, 2 * N, plan.seg)
    out = all_reduce(both.view(2, N, 6).sum(0), group) + damping * xm
    return out * vm + x * (1.0 - vm)


def _apply_step(poses, delta, vertex_mask):
    return se3.normalize_pose(poses @ se3.se3_exp(delta * vertex_mask[:, None]))


def gn_step(prob: PoseGraphProblem, cfg: PoseGraphConfig, plan: Optional[EdgePlan] = None,
            group=None):
    """One damped Gauss-Newton iteration over the whole graph. Returns the
    updated problem and the cost before the step (a 0-d tensor). `plan` is
    edge_plan(prob), computed here when not given. With `group`, prob's
    edges are this rank's shard (JAX's `axis_name`)."""
    plan = plan if plan is not None else edge_plan(prob)
    J, b, M_inv, cost = _normal_equations(prob, cfg, plan, group)

    def matvec(x):
        return _matvec(x, J, prob.vertex_mask, plan, cfg.damping, group)

    delta = pcg(matvec, b, M_inv, cfg.cg_iterations, cfg.cg_tol)
    return prob._replace(poses=_apply_step(prob.poses, delta, prob.vertex_mask)), cost


@full_f32
def cg_iterations_run(prob: PoseGraphProblem, cfg: PoseGraphConfig):
    """The PCG iterations that run in each Gauss-Newton step of `pg_solve`:
    those whose exit test (||r|| > cg_tol ||b||) holds, i.e. the iterations
    of the JAX package's `while_loop`. An eager measurement (one readback
    at the end), the same solve as `pg_solve` step for step. Returns
    (final problem, [iterations] int64 counts on the host)."""
    plan = edge_plan(prob)
    counts = []
    for _ in range(cfg.iterations):
        J, b, M_inv, _ = _normal_equations(prob, cfg, plan)
        s = pcg_start(b, M_inv, cfg.cg_tol)
        ran = torch.zeros((), dtype=torch.int64, device=b.device)
        for _ in range(cfg.cg_iterations):
            pcg_iteration(s, lambda x: _matvec(x, J, prob.vertex_mask, plan, cfg.damping), M_inv)
            ran += s.active
        counts.append(ran)
        prob = prob._replace(poses=_apply_step(prob.poses, s.x, prob.vertex_mask))
    return prob, torch.stack(counts).cpu().numpy()


@full_f32
def pg_solve(prob: PoseGraphProblem, cfg: PoseGraphConfig, group=None):
    """All `cfg.iterations` Gauss-Newton iterations (the reference runs a
    fixed 10 g2o iterations with no convergence exit, ref
    pose_graph_optimizer.cpp:68-69) as a stream of eager launches with no
    host sync; TF32 is off for its products. This is the plain version of
    `pg_solve_program`, which the optimizer runs, and the solve of a gloo
    group's distributed pose graph (which cannot be captured).

    Returns (final problem, cost_initial, cost_final), the costs as 0-d
    tensors: the cost before the first and before the last step. `group`
    as in gn_step."""
    plan = edge_plan(prob)
    costs = []
    for _ in range(cfg.iterations):
        prob, c = gn_step(prob, cfg, plan, group)
        costs.append(c)
    return prob, costs[0], costs[-1]


class GNProgram(programs.Program):
    """`pg_solve` as a captured program for one (vertex, edge) bucket: the
    problem, its edge plan, the step's J and preconditioner and the PCG
    state in static tensors, and three bodies: `assemble` (the normal
    equations and PCG's start), `cg` (one PCG iteration) and `update` (the
    step applied to the poses). A solve replays them as iterations x (1 +
    cg_iterations + 1). With `group`, prob's edges are this rank's shard
    and the bodies sum over the ranks (gn_step's `group`); `cost` is the
    summed cost."""

    def __init__(self, prob: PoseGraphProblem, cfg: PoseGraphConfig, group=None):
        super().__init__(prob.poses.device, group)
        self.cfg = cfg
        N, E = prob.poses.shape[0], prob.edge_a.shape[0]
        dt, dev = prob.poses.dtype, prob.poses.device
        self.prob = PoseGraphProblem(*(torch.empty_like(t) for t in prob))
        # edge_plan's shapes: 2E rows; 2N segments and the 2E // SPREAD_ROWS
        # (at least 1) that the weight-0 rows are spread over.
        n_seg = 2 * N + max(1, 2 * E // SPREAD_ROWS)
        self.plan = EdgePlan(torch.empty(2 * E, dtype=torch.int64, device=dev),
                             Segments(torch.empty(2 * E, dtype=torch.int64, device=dev),
                                      torch.empty(n_seg + 1, dtype=torch.int64, device=dev)))
        self.J = torch.empty((2 * E, 6, 6), dtype=dt, device=dev)
        self.M_inv = torch.empty((N, 6, 6), dtype=dt, device=dev)
        self.cost = torch.empty((), dtype=dt, device=dev)
        self.cost0 = torch.empty((), dtype=dt, device=dev)
        vec = (N, 6)
        self.state = CGState(*(torch.empty(vec, dtype=dt, device=dev) for _ in range(3)),
                             torch.empty((), dtype=dt, device=dev),
                             torch.empty((), dtype=dt, device=dev),
                             torch.empty((), dtype=torch.bool, device=dev))

    @staticmethod
    def key(prob: PoseGraphProblem, cfg: PoseGraphConfig, group=None):
        return (GNProgram, programs.tensor_key(*prob), cfg, group)

    def load(self, prob: PoseGraphProblem):
        programs.copy_into(self.prob, prob)
        programs.copy_into(self.plan, edge_plan(prob))

    def assemble(self):
        J, b, M_inv, cost = _normal_equations(self.prob, self.cfg, self.plan, self.group)
        self.J.copy_(J)
        self.M_inv.copy_(M_inv)
        self.cost.copy_(cost)
        pcg_start(b, M_inv, self.cfg.cg_tol, out=self.state)

    def cg(self):
        pcg_iteration(self.state, self._matvec, self.M_inv)

    def _matvec(self, x):
        return _matvec(x, self.J, self.prob.vertex_mask, self.plan, self.cfg.damping,
                       self.group)

    def update(self):
        self.prob.poses.copy_(_apply_step(self.prob.poses, self.state.x, self.prob.vertex_mask))

    def step(self):
        """One Gauss-Newton step (gn_step); `cost` is the cost before it."""
        self.run("assemble", self.assemble)
        for _ in range(self.cfg.cg_iterations):
            self.run("cg", self.cg)
        self.run("update", self.update)

    def solve(self):
        for it in range(self.cfg.iterations):
            self.step()
            if it == 0:
                self.cost0.copy_(self.cost)


def gn_program(prob: PoseGraphProblem, cfg: PoseGraphConfig, group=None,
               cache: Optional[programs.ProgramCache] = None) -> GNProgram:
    """The cache's GNProgram for this problem's shapes and group, loaded
    with `prob`."""
    cache = programs.PROGRAMS if cache is None else cache
    prog = cache.get(GNProgram.key(prob, cfg, group), lambda: GNProgram(prob, cfg, group))
    prog.load(prob)
    return prog


@full_f32
def pg_solve_program(prob: PoseGraphProblem, cfg: PoseGraphConfig,
                     cache: Optional[programs.ProgramCache] = None, group=None):
    """`pg_solve` through its captured program: on the card the three
    bodies are captured once per problem shape and group (the optimizer
    makes the shape a power-of-two bucket, `bucketed_problem`), and a solve
    is iterations x (cg_iterations + 2) graph replays; on the CPU the
    bodies run as they are. Equal to `pg_solve` with the same `group` on
    the same problem bit for bit. Returns what `pg_solve` returns, as new
    tensors."""
    prog = gn_program(prob, cfg, group, cache)
    prog.solve()
    return prob._replace(poses=prog.prob.poses.clone()), prog.cost0.clone(), prog.cost.clone()


@full_f32
def gn_step_program(prob: PoseGraphProblem, cfg: PoseGraphConfig, group=None,
                    cache: Optional[programs.ProgramCache] = None):
    """`gn_step` through the GNProgram of pg_solve_program (one step's
    replays). Equal to `gn_step` with the same `group` bit for bit;
    returns what it returns, as new tensors."""
    prog = gn_program(prob, cfg, group, cache)
    prog.step()
    return prob._replace(poses=prog.prob.poses.clone()), prog.cost.clone()


class PoseGraphOptimizer:
    """Host orchestration over the WorldMap.

    As in the JAX package, the graph is stateless array data rebuilt from
    the WorldMap at each call (the reference extends a persistent g2o graph,
    ref pose_graph_optimizer.cpp:56-59); committed loop edges are kept in
    `committed_edges` and pending edges are consumed exactly once (ref :216).
    Runs on `device` (the bundle adjuster's when one is given).
    """

    def __init__(self, world, cfg: Optional[PoseGraphConfig] = None,
                 bundle_adjuster=None, loop_matcher=None, device=None):
        self.world = world
        self.cfg = cfg or PoseGraphConfig()
        self.ba = bundle_adjuster
        if device is None:
            device = bundle_adjuster.device if bundle_adjuster is not None else "cuda"
        self.device = torch.device(device)
        self.loop_matcher = loop_matcher  # callable (a, b) -> (Z 4x4, ok)
        self.loop_edges: list = []        # pending (a, b) pairs
        self.committed_edges: list = []   # all (a, b) ever optimized (for PLY)
        self.last_stats = {}
        self.history: list = []           # the stats of every solve, in order
        self.last_problem = None          # the last solve's input problem, padded
        # Wall seconds of each LIVE (loop-exit) optimize() call, the closure
        # stall, and its split (edge measure / solve / global BA).
        self.live_stall_log: list = []
        self.live_stall_splits: list = []
        # Finisher of a live closure's deferred polish BA (collected by
        # SlamSystem at the next batch boundary; see optimize()).
        self.deferred_ba_finish = None
        self._last_polish_frame = None
        # Called before any solve: the live loop registers its pending
        # (pipelined) BA finisher here, so a loop-triggered optimization
        # always sees the refined map first (SlamSystem._finish_pending_ba).
        self.pre_optimize_hook = None
        warm_up()

    def add_loop_edge(self, a: int, b: int):
        self.loop_edges.append((int(a), int(b)))

    def optimize(self, run_global_ba: bool = True, live: bool = False,
                 ba_max_seconds=None) -> dict:
        """`live=True` marks a mid-run (loop-exit) solve on the live loop's
        critical path (ref loop_detector.cpp:146): its polish BA is deferred
        and capped at cfg.live_ba_max_seconds, and the stall is logged to
        live_stall_log. `ba_max_seconds` caps the non-live global BA instead;
        None = BAConfig default.

        A live solve is a `pg.optimize` span, with children `pg.edges` (the
        loop-edge batch: load, replay, readback) and `pg.solve` (the GN
        program's replays and the readback); its deferred polish is a
        `pg.polish` span wherever it is applied.

        A live closure's polish that was not collected yet (two closures in
        one batch replay) is applied before this solve, as the pending
        window BA is by `pre_optimize_hook`: the JAX package overwrites it
        there, so the first polish never runs."""
        span = TRACER.span if live else contextlib.nullcontext
        with span("pg.optimize"):
            t_start = time.perf_counter()
            if self.pre_optimize_hook is not None:
                self.pre_optimize_hook()
            if self.deferred_ba_finish is not None:
                fin, self.deferred_ba_finish = self.deferred_ba_finish, None
                fin()
            world = self.world
            n = world.num_frames
            if n < 2:
                return {}

            end_id = n - 1
            # Odometry measurements for frames [1, end_id] from the stored
            # relative poses (ref :126-172).
            edge_a = list(range(0, end_id))
            edge_b = list(range(1, end_id + 1))
            meas = [world.pose_rel[i] for i in range(1, end_id + 1)]

            # Loop-closure edges: re-match features, RANSAC a relative transform
            # (ref :175-217). Z satisfies T_dst^-1 T_src = Z for the edge
            # (a=dst, b=src). All pending edges are measured in one batch when
            # the matcher has `.batch` (apps/slam.make_loop_matcher).
            n_loop = 0
            n_measured = 0
            measured_edges = []
            t_batch = 0.0
            edges_padded = 0
            t_match = time.perf_counter()
            if (live and self.cfg.live_max_edges > 0
                    and len(self.loop_edges) > self.cfg.live_max_edges):
                # Bound the per-closure measurement cost: keep the most recent
                # candidates (a sustained revisit queues one near-duplicate per
                # frame); the older ones are discarded, not deferred.
                self.loop_edges = self.loop_edges[-self.cfg.live_max_edges:]
            if self.loop_matcher is not None and self.loop_edges:
                n_measured = edges_padded = len(self.loop_edges)
                measured_edges = list(self.loop_edges)
                t_batch = time.perf_counter()
                with span("pg.edges"):
                    if hasattr(self.loop_matcher, "batch"):
                        measured = self.loop_matcher.batch(self.loop_edges)
                        edges_padded = self.loop_matcher.last["edges_padded"]
                    else:
                        measured = [self.loop_matcher(s, d) for (s, d) in self.loop_edges]
                t_batch = time.perf_counter() - t_batch
                for (src, dst), (Z, ok) in zip(self.loop_edges, measured):
                    if not ok:
                        continue
                    edge_a.append(dst)
                    edge_b.append(src)
                    meas.append(np.asarray(Z, np.float32))
                    self.committed_edges.append((src, dst))
                    n_loop += 1
            self.loop_edges.clear()  # consumed (ref :216)

            E = len(edge_a)
            # Padded to the graph's bucket (the JAX optimizer's N_pad, E_pad), so
            # that a closure reuses its bucket's program.
            prob = bucketed_problem(world.pose_global[:n], edge_a, edge_b, np.stack(meas),
                                    self.device)
            t_match = time.perf_counter() - t_match

            # All GN iterations launched at once (the captured program on the
            # card); one readback.
            t_solve = time.perf_counter()
            self.last_problem = prob
            cache = programs.PROGRAMS
            builds, capture_ms = cache.builds, cache.capture_ms
            with span("pg.solve"):
                prob, c0, c_last = pg_solve_program(prob, self.cfg)
                costs = torch.stack([c0, c_last]).cpu().numpy()
                new_poses = prob.poses[:n].cpu().numpy()
            cost0, cost = float(costs[0]), float(costs[1])
            t_solve = time.perf_counter() - t_solve
            world.set_global_poses(np.arange(n, dtype=np.int32), new_poses)
            # Tail propagation is a no-op here (all frames optimized), kept for
            # parity with ref :89-92 when optimizing a prefix.
            world.propagate_tail(n)

            stats = {
                "live": live,
                "num_vertices": n,
                "num_edges": E,
                "vertices_padded": int(prob.poses.shape[0]),
                "edges_padded": int(prob.edge_a.shape[0]),
                # The solve's GNProgram: built for a bucket met for the first
                # time (so captured on the card), and the capture's ms.
                "program_built": cache.builds > builds,
                "pg_capture_ms": cache.capture_ms - capture_ms,
                "loop_edges_measured": n_measured,
                "loop_edges_padded": edges_padded,
                "num_loop_edges": n_loop,
                "loop_edges": measured_edges,   # (src, dst), measured in this order
                "cost_initial": cost0,
                "cost_final": cost,
            }

            # Global BA after the pose-graph solve (ref :95). Live solves are
            # capped and window-bounded (cfg.live_ba_window_frames): the pose
            # graph has already applied the closure correction, the BA here is
            # polish.
            t_ba = time.perf_counter()
            if run_global_ba and self.ba is not None and n >= 2:
                lo = 0
                if live and self.cfg.live_ba_window_frames > 0:
                    lo = max(0, n - 1 - self.cfg.live_ba_window_frames)
                if live:
                    # DEFER the polish entirely: a thunk runs at the next batch
                    # boundary (SlamSystem adopts it); nothing touches the world
                    # in between, so it sees the same state.
                    spacing = self.cfg.live_polish_min_spacing_frames
                    if (spacing > 0 and self._last_polish_frame is not None
                            and n - self._last_polish_frame < spacing):
                        # Back-to-back polishes over the same window are
                        # redundant (finish() runs the full-depth solve).
                        stats["global_ba"] = {"skipped_redundant": True}
                    else:
                        self._last_polish_frame = n
                        cap = self.cfg.live_ba_max_seconds
                        ba, lo_, hi_ = self.ba, lo, n - 1

                        def polish():
                            with TRACER.span("pg.polish"):
                                return ba.optimize(lo_, hi_, max_seconds=cap)

                        self.deferred_ba_finish = polish
                        stats["global_ba"] = {"deferred": True}
                else:
                    stats["global_ba"] = self.ba.optimize(lo, n - 1, max_seconds=ba_max_seconds)
            # Phase split of the stall: edge measurement (of which the loop-edge
            # batch) / GN solve + writeback / global BA.
            stats["wall_split_seconds"] = {
                "edge_measure": round(t_match, 4),
                "loop_edge_batch": round(t_batch, 4),
                "pg_solve_writeback": round(t_solve, 4),
                "global_ba": round(time.perf_counter() - t_ba, 4),
            }
            stats["wall_seconds"] = round(time.perf_counter() - t_start, 4)
            if live:
                self.live_stall_log.append(stats["wall_seconds"])
                self.live_stall_splits.append(stats["wall_split_seconds"])
            self.last_stats = stats
            self.history.append(stats)
            return stats

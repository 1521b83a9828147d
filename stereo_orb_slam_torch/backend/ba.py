"""Bundle adjustment: Levenberg-Marquardt with Schur complement.

PyTorch counterpart of the JAX package's `backend/ba.py`, which replaces the
reference's Ceres solve (LM trust region, SPARSE_SCHUR, JACOBI
preconditioner, ref `src/bundle_adjuster.cpp:13-36`) with batched dense
tensor ops:

- per-observation normal-equation rows from the batched residuals and
  Jacobians and one broadcast product (residuals.build_rows_soa),
- camera blocks H_cc [C,6,6] and gradients reduced by a [C,O] one-hot
  product (windowed) or a segmented sum (matrix-free); point blocks
  H_pp [P,3,3] by a slot gather + local sum (windowed) or a segmented sum,
- point marginalization by closed-form 3x3 inverses,
- the reduced camera system either materialized and solved by Cholesky
  (windowed: backend/schur_dense.py, dense or banded assembly) or solved
  MATRIX-FREE by block-Jacobi PCG (global problems past the dense gate).

On a rig whose baseline is under FLOAT64_BELOW_BASELINE_M
(`marginalize_in_float64`, which BundleAdjuster asks of its rig) the
windowed path marginalizes, solves and back-substitutes in float64, from
normal equations accumulated in float32. A landmark's depth is fixed z/b
times more weakly than its bearing, so its point block's condition grows
as (z/b)^2; at EuRoC's 0.110 m (landmarks at 1-6 px of disparity)
float32's S = H_cc - W H_pp^-1 W^T cancels the weak modes of a window
whose camera blocks few tracks join, and its LM can stop a metre from the
float64 solve of the same iterations. At KITTI's 0.537 m no judged window
strayed; the limit lies between the two, near their geometric mean. The
matrix-free path stays in float32.

Every reduction runs in a fixed order (no float atomics), so a solve on
the card gives the same result on every run. Device syncs: none inside a
solve. The LM loop and the PCG loop each run
their full iteration count and freeze their state on the device once
their exit condition holds, which leaves the result of an early exit;
the LM loop counts its iterations in a device tensor. The Cholesky
failure flag stays on the device (a failed factorization is a NaN step,
rejected by the LM). The results come back in one packed readback, and
the chunked path of BundleAdjuster reads one count per chunk.

How it runs: the JAX package jits `ba_solve_impl` / `lm_iteration_impl`
into device programs, and its distributed solves (`jax.jit(shard_map)`)
likewise. BundleAdjuster runs `lm_program`: an `LMProgram`
(utils/programs.py) whose `start` (plans + lm_init) and `iteration`
(one masked lm_iteration) bodies are captured once per padded shape,
path and process group as CUDA graphs, so a solve is 1 + max_iters graph
launches; one `lm_step` is an `LMStepProgram`. The distributed solves
(parallel/dist_ba.py) run the same programs with their group when
`mesh.capturable(group)`: one process, or an NCCL group, whose
all_reduces the graphs record. The eager `ba_solve` / `ba_resume` /
`_lm_loop` / `lm_step` are the same solves as launch streams: the plain
versions the programs are held to bit for bit, and the solves of a gloo
group (which stages its collectives through the host, so no graph can
hold them).

Every solver entry point (`lm_step`, `lm_init`, `lm_iteration`,
`ba_solve`, `ba_resume`, `BundleAdjuster.optimize*`) runs with TF32 off
for float32 matrix products, whatever the caller's setting, and restores
that setting on return: TF32 rounds the Schur products and the one-hot
reductions.

Distributed solves (parallel/dist_ba.py) pass `group`, a process group,
wherever the JAX package takes `axis_name`: each rank holds its shard of
the observations (and, with `point_sharded`, of the points), sums it
locally in the same fixed order, and an `all_reduce` (parallel/mesh.py,
JAX's `psum`) completes each reduction; the independent sums of one
build (the camera sum, the cost and, on the "obs" layout, the point sum)
go in one `all_reduce_many`, as XLA's combiner merges them. `group` None
is one process.

Window semantics match the reference (ref `src/bundle_adjuster.cpp:39-133`):
cameras parameterized as world->camera pose6, first camera in the window
held constant (ref :113), point coordinates clamped to ±bound (ref
:104-108 box constraints), writeback via world.ba_writeback which drags
first-observed landmarks exactly as Frame::GlobalPose does.
"""

from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from stereo_orb_slam_torch.backend import residuals as res_mod
from stereo_orb_slam_torch.backend import schur_dense
from stereo_orb_slam_torch.backend.residuals import bmv
from stereo_orb_slam_torch.config import BAConfig
from stereo_orb_slam_torch.geometry import se3_np
from stereo_orb_slam_torch.parallel.mesh import all_reduce, all_reduce_many
from stereo_orb_slam_torch.utils import programs
from stereo_orb_slam_torch.utils.profiling import TRACER


class BAProblem(NamedTuple):
    """Static-shape BA problem (padded). Index tensors are int64."""

    pose6: torch.Tensor      # [C,6] world->camera
    points: torch.Tensor     # [P,3]
    obs_cam: torch.Tensor    # [O]
    obs_point: torch.Tensor  # [O]
    obs_uv: torch.Tensor     # [O,4]
    obs_weight: torch.Tensor  # [O] 1.0 real / 0.0 padding
    cam_mask: torch.Tensor   # [C] 1.0 free / 0.0 held fixed
    point_mask: torch.Tensor  # [P] 1.0 real / 0.0 padding
    P_l: torch.Tensor        # [3,4]
    P_r: torch.Tensor        # [3,4]

    def to(self, device) -> "BAProblem":
        return BAProblem(*(t.to(device) for t in self))


def full_f32(fn):
    """Run `fn` with full float32 matrix products (TF32 off), restoring the
    caller's setting afterwards."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prec = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prec)

    return wrapper


class Segments(NamedTuple):
    """Rows grouped by segment id for _seg_sum: the stable order of the ids
    and each segment's offsets [num + 1] in that order (more when the rows
    left out form segments of their own after the last, which _seg_sum
    drops)."""

    order: torch.Tensor
    offsets: torch.Tensor


class SegmentPlan(NamedTuple):
    """The matrix-free path's reductions: observations grouped by camera
    and by point, computed once per problem."""

    cams: Segments
    points: Segments


# Rows of a left-out segment: the left-out rows are dealt round-robin over
# O // SPREAD_ROWS segments of their own, so none is longer than this.
SPREAD_ROWS = 64


def segments(ids, num: int, keep=None) -> Segments:
    """The grouping of `ids` [O] into segments 0..num-1. With `keep` [O]
    bool, the rows not kept (a padded problem's weight-0 rows, which carry
    segment id 0) go to segments of their own after the last, at most
    SPREAD_ROWS rows each (their number fixed by O, as a capture needs), so
    no real segment holds them and none is long: the card adds each
    segment's rows one after another in one thread, and one segment of
    every padded row made each sum as slow as that segment is long
    (PERF.md, PR 11)."""
    if keep is not None:
        spread = max(1, ids.shape[0] // SPREAD_ROWS)
        rows = torch.arange(ids.shape[0], dtype=ids.dtype, device=ids.device)
        ids = torch.where(keep, ids, num + rows % spread)
        num += spread
    order = torch.argsort(ids, stable=True)
    bounds = torch.arange(num + 1, dtype=ids.dtype, device=ids.device)
    return Segments(order, torch.searchsorted(ids[order], bounds))


def _seg_sum(x, ids, num, seg: Optional[Segments] = None, group=None):
    """Segment sum of rows x [O, ...] by ids [O] into [num, ...]. Each
    segment's rows are added one after another in index order, on every
    device, so the sums equal a CPU scatter-add's bit for bit and a solve
    on the card repeats exactly (`index_add_` on CUDA adds with float
    atomics in no fixed order). `seg` is `segments(ids, num)`, computed
    here when not given. With `group`, the local sums are then summed over
    its ranks (one all_reduce)."""
    if seg is None:
        seg = segments(ids, num)
    out = torch.segment_reduce(x[seg.order], "sum", offsets=seg.offsets, axis=0)
    return all_reduce(out[:num], group)


def _seg_sum_points(x, obs_point, num, dense_slots=None, seg=None, group=None):
    """Per-point reduction of per-observation rows x [O, ...]: a segmented
    sum, or with `dense_slots` (windowed path) a slot gather + sum over K;
    summed over `group`'s ranks when given."""
    if dense_slots is None:
        return _seg_sum(x, obs_point, num, seg, group)
    sto, _, smask = dense_slots
    F = math.prod(x.shape[1:])
    g = schur_dense.slot_gather(x.reshape(-1, F), sto, smask)
    return all_reduce(g.sum(dim=1).reshape((sto.shape[0],) + tuple(x.shape[1:]))[:num], group)


def _seg_sum_cams(x, obs_cam, num, cam_red=None, group=None):
    """Per-camera reduction of per-observation rows x [O, F].

    `cam_red` None or a SegmentPlan (matrix-free path): a segmented sum.
    Dense windowed path: `cam_red` is either the [C,O] f32 ONE-HOT of
    obs_cam (one matrix product, in x's dtype) or, past the one-hot's
    memory gate, a ([C,Kc] slot map, mask) tuple from
    build_cam_slots_device (gather + local sum). With `group`, the local
    sums are summed over its ranks.
    """
    if cam_red is None or isinstance(cam_red, SegmentPlan):
        return _seg_sum(x, obs_cam, num, _plan(cam_red).cams, group)
    if isinstance(cam_red, tuple):
        sto, mask = cam_red
        return all_reduce(schur_dense.slot_gather(x, sto, mask).sum(dim=1)[:num], group)
    return all_reduce(cam_red.to(x.dtype) @ x, group)


def _plan(cam_red) -> SegmentPlan:
    """The SegmentPlan in `cam_red`, or one that leaves the grouping to
    _seg_sum."""
    if isinstance(cam_red, SegmentPlan):
        return cam_red
    return SegmentPlan(None, None)


def build_cam_slots_device(obs_cam, obs_weight, n_cams: int, Kc: int):
    """Device-side camera-run slot maps: [C, Kc] indices into the
    point-sorted obs arrays grouping each camera's observations, plus the
    validity mask. obs_cam is not sorted in the point-sorted layout, so the
    runs come from a stable argsort; counts and starts from binary searches
    on the sorted keys. Padding rows (obs_weight == 0) sort after all real
    cameras. Only the Kc bucket (pow2 >= max observations per camera) is
    chosen on the host."""
    O = obs_cam.shape[0]
    dev = obs_cam.device
    key = torch.where(obs_weight > 0, obs_cam, n_cams)
    order = torch.argsort(key, stable=True)
    sorted_cam = key[order]
    cams = torch.arange(n_cams, dtype=key.dtype, device=dev)
    starts = torch.searchsorted(sorted_cam, cams, side="left")
    counts = torch.searchsorted(sorted_cam, cams, side="right") - starts
    k = torch.arange(Kc, device=dev)
    run = torch.minimum(k[None, :], torch.clamp(counts - 1, min=0)[:, None])
    sto = order[torch.clamp(starts[:, None] + run, max=max(O - 1, 0))]
    mask = (k[None, :] < counts[:, None]).float()
    return sto, mask


def build_normal_equations(prob: BAProblem, huber_delta: float,
                           dense_slots=None, cam_red=None, group=None,
                           point_sharded: bool = False):
    """Normal-equation blocks at the problem's parameters:
    (H_cc [C,6,6], H_pp [P,3,3], W [O,6,3], b_c [C,6], b_p [P,3], cost, Wg)
    with Wg the slot form [P,K,6,3] of W on the windowed path, else None.

    With `group`, prob's observations are this rank's shard: the camera
    blocks and the cost are summed over the ranks, and so are the point
    blocks unless `point_sharded` (the point-aligned layout, where every
    point's observations are on one rank, so they stay local). The sums
    are independent, so they go in ONE all_reduce (`all_reduce_many`)."""
    C = prob.pose6.shape[0]
    P = prob.points.shape[0]
    cam_rows, pt_rows, W, cost = res_mod.build_rows_soa(
        prob.pose6[prob.obs_cam], prob.points[prob.obs_point], prob.obs_uv,
        prob.obs_weight, prob.P_l, prob.P_r, huber_delta,
    )
    # Camera-side reductions fused into one row per observation.
    cam_sum = _seg_sum_cams(cam_rows, prob.obs_cam, C, cam_red)
    Wg = None
    if dense_slots is not None:
        # One slot gather for the whole point side: pt_rows (12 cols,
        # reduced over the K slot axis) and W (18 cols, kept in slot form
        # for the Schur assembly and the back-substitution).
        sto, _, smask = dense_slots
        fused = torch.cat([pt_rows, W.reshape(-1, 18)], dim=1)
        g = schur_dense.slot_gather(fused, sto, smask)   # [P,K,30]
        pt_red = g[..., :12].sum(dim=1)
        Wg = g[..., 12:].reshape(sto.shape[0], -1, 6, 3)
    else:
        pt_red = _seg_sum_points(pt_rows, prob.obs_point, P, seg=_plan(cam_red).points)
    if dense_slots is None and not point_sharded:
        cam_sum, pt_red, cost = all_reduce_many([cam_sum, pt_red, cost], group)
    else:
        cam_sum, cost = all_reduce_many([cam_sum, cost], group)
    H_cc = cam_sum[:, :36].reshape(-1, 6, 6)
    b_c = -cam_sum[:, 36:]
    H_pp = pt_red[:, :9].reshape(-1, 3, 3)
    b_p = pt_red[:, 9:]
    return H_cc, H_pp, W, b_c, b_p, cost, Wg


def _damp_blocks(H, lam, eps=1e-8):
    d = torch.diagonal(H, dim1=-2, dim2=-1)  # [N,k]
    return H + torch.diag_embed(lam * d + eps)


def _inv3(A):
    """Closed-form inverse of [N,3,3] blocks (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    rows = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return rows * inv_det[..., None, None]


def _inv6_gj(A, eps=1e-12):
    """Batched 6x6 inverse by fixed-step Gauss-Jordan (no pivoting; the
    blocks are damped SPD, so diagonal pivots are safe)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)
    for k in range(n):
        pivot = aug[..., k, k][..., None]
        pivot = torch.where(torch.abs(pivot) < eps, eps, pivot)
        row_k = aug[..., k, :] / pivot
        factors = aug[..., :, k][..., None]
        aug = aug - factors * row_k[..., None, :]
        aug[..., k, :] = row_k
    return aug[..., :, n:]


def _bmtv(A, x):
    """Batched transposed product [..., i, j]^T x [..., i] -> [..., j]."""
    return (A * x[..., :, None]).sum(dim=-2)


def schur_matvec(x, H_cc_l, Hpp_inv, W, obs_cam, obs_point, cam_mask,
                 plan: Optional[SegmentPlan] = None, group=None,
                 point_sharded: bool = False):
    """S @ x with S = H_cc_l - W H_pp_l^-1 W^T, matrix-free.

    x: [C,6]. Fixed cameras are pinned via cam_mask (identity rows).
    `Hpp_inv` is the precomputed [P,3,3] inverse of the damped point blocks.
    `plan` is the problem's SegmentPlan (the grouping is computed per call
    when None). With `group`, W and obs_* are this rank's shard and both
    segmented sums are summed over the ranks (the point one stays local
    when `point_sharded`).
    """
    plan = _plan(plan)
    xm = x * cam_mask[:, None]
    u = _bmtv(W, xm[obs_cam])                                    # [O,3] = W^T x
    z = _seg_sum(u, obs_point, Hpp_inv.shape[0], plan.points,
                 None if point_sharded else group)               # [P,3]
    w = bmv(Hpp_inv, z)                                          # [P,3]
    v = bmv(W, w[obs_point])                                     # [O,6] = W w
    out = bmv(H_cc_l, xm) - _seg_sum(v, obs_cam, x.shape[0], plan.cams, group)
    return out * cam_mask[:, None] + x * (1.0 - cam_mask[:, None])


class CGState(NamedTuple):
    """PCG's state, updated in place by `pcg_iteration`: the iterate x,
    the residual r, the direction p, r.z (0-d), the exit threshold
    tol * ||b|| (0-d) and whether the last iteration ran (0-d bool)."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    stop: torch.Tensor
    active: torch.Tensor


def pcg_start(b, M_inv_blocks, tol: float, out: Optional[CGState] = None) -> CGState:
    """PCG's start state for the system with right-hand side b, written
    into `out`'s tensors when given (a captured program's static state)."""
    z = bmv(M_inv_blocks, b)
    rz = torch.sum(b * z)
    stop = tol * torch.sqrt(torch.sum(b * b))
    if out is None:
        return CGState(torch.zeros_like(b), b.clone(), z, rz, stop,
                       torch.ones((), dtype=torch.bool, device=b.device))
    out.x.zero_()
    out.r.copy_(b)
    out.p.copy_(z)
    out.rz.copy_(rz)
    out.stop.copy_(stop)
    out.active.fill_(True)
    return out


def pcg_iteration(s: CGState, matvec, M_inv_blocks):
    """One masked PCG iteration, in place on s's tensors: it first tests
    ||r|| > tol * ||b|| on the device and keeps the old state where that
    fails, so one captured iteration serves every iteration of a solve."""
    torch.gt(torch.sqrt(torch.sum(s.r * s.r)), s.stop, out=s.active)
    Ap = matvec(s.p)
    alpha = s.rz / torch.clamp(torch.sum(s.p * Ap), min=1e-30)
    x_new = s.x + alpha * s.p
    r_new = s.r - alpha * Ap
    z = bmv(M_inv_blocks, r_new)
    rz_new = torch.sum(r_new * z)
    beta = rz_new / torch.clamp(s.rz, min=1e-30)
    p_new = z + beta * s.p
    torch.where(s.active, x_new, s.x, out=s.x)
    torch.where(s.active, r_new, s.r, out=s.r)
    torch.where(s.active, p_new, s.p, out=s.p)
    torch.where(s.active, rz_new, s.rz, out=s.rz)


def pcg(matvec, b, M_inv_blocks, iters: int, tol: float):
    """Block-Jacobi preconditioned CG on the reduced camera system.

    The JAX package exits its while_loop once ||r|| <= tol * ||b||. Here
    every one of `iters` iterations runs (`pcg_iteration`), and each one
    first tests that condition on the device and keeps the old state where
    it holds: once met it stays met (the state no longer changes), so the
    result is the early exit's, with no host sync.
    """
    s = pcg_start(b, M_inv_blocks, tol)
    for _ in range(iters):
        pcg_iteration(s, matvec, M_inv_blocks)
    return s.x


def _solve_lm(prob: BAProblem, H_cc, H_pp, W, b_c, b_p, lam, cfg: BAConfig,
              dense_slots=None, cam_red=None, Wg=None, band=None, group=None,
              point_sharded: bool = False, float64: bool = False):
    """Damp, marginalize points (Schur), solve the reduced camera system,
    back-substitute. Returns the PROPOSED (pose6, points) for this lambda.
    With `float64` the dense path does so in float64 (see the module's
    docstring).

    Two reduced-system solvers:
    - dense (windowed): IC-ordered S materialized (schur_dense, dense or
      banded assembly) + direct Cholesky; with `group`, only on the
      point-aligned layout: each rank assembles its points' share of S,
      one [6C, 6C] all_reduce, the Cholesky replicated;
    - matrix-free (global): block-Jacobi PCG with segmented-sum matvecs,
      summed over `group`'s ranks when given.
    """
    if dense_slots is not None and group is not None and not point_sharded:
        raise ValueError("the distributed dense path needs the point-aligned layout")
    if dense_slots is not None and float64:
        H_cc, H_pp, W, b_c, b_p, lam = (x.double() for x in (H_cc, H_pp, W, b_c, b_p, lam))
        Wg = None if Wg is None else Wg.double()
    H_cc_l = _damp_blocks(H_cc, lam)
    H_pp_l = _damp_blocks(H_pp, lam)
    # Guard padding points: identity blocks so the inverse stays finite.
    eye3 = torch.eye(3, dtype=H_pp_l.dtype, device=H_pp_l.device)
    H_pp_l = torch.where(prob.point_mask[:, None, None] > 0, H_pp_l, eye3)

    Hpp_inv = _inv3(H_pp_l)

    # rhs = b_c - W H_pp^-1 b_p
    hp_bp = bmv(Hpp_inv, b_p)
    rhs = b_c - _seg_sum_cams(bmv(W, hp_bp[prob.obs_point]), prob.obs_cam,
                              b_c.shape[0], cam_red, group)
    rhs = rhs * prob.cam_mask[:, None]

    eye6 = torch.eye(6, dtype=H_cc_l.dtype, device=H_cc_l.device)
    H_cc_safe = torch.where(prob.cam_mask[:, None, None] > 0, H_cc_l, eye6)

    if dense_slots is not None:
        if band is not None and Wg is not None and group is None:
            # Banded fast path (see schur_dense.band_plan): local-width
            # expansion per point chunk; feasibility proven on host.
            S = schur_dense.assemble_schur_banded(
                H_cc_safe, Hpp_inv, dense_slots[1], dense_slots[2],
                prob.cam_mask, Wg, band[0], band[1], band[2],
            )
        else:
            S = schur_dense.assemble_schur(
                H_cc_safe, W, Hpp_inv, dense_slots[0], dense_slots[1],
                dense_slots[2], prob.cam_mask, Wg=Wg, group=group,
            )
        dc = schur_dense.solve_reduced_chol(S, rhs, prob.cam_mask)
    else:
        # Preconditioner: inverse of damped camera diagonal blocks (fixed
        # cams get identity).
        M_inv = _inv6_gj(H_cc_safe + 1e-8 * eye6)

        def mv(x):
            return schur_matvec(x, H_cc_safe, Hpp_inv, W, prob.obs_cam,
                                prob.obs_point, prob.cam_mask, _plan(cam_red), group,
                                point_sharded)

        dc = pcg(mv, rhs, M_inv, cfg.cg_iterations, cfg.cg_tol)
    dc = dc * prob.cam_mask[:, None]

    # Back-substitute points: dp = H_pp^-1 (b_p - W^T dc)
    if dense_slots is not None and Wg is not None:
        # Slot form: z_p = sum_k Wg[p,k]^T dc[slot_cam[p,k]]; Wg's baked
        # slot mask zeroes padding slots (their slot_cam reads camera 0).
        dcg = dc[dense_slots[1]]                          # [P,K,6]
        z = torch.sum(Wg * dcg[:, :, :, None], dim=(1, 2))
    else:
        u = _bmtv(W, dc[prob.obs_cam])
        z = _seg_sum_points(u, prob.obs_point, b_p.shape[0], dense_slots,
                            _plan(cam_red).points, None if point_sharded else group)
    dp = bmv(Hpp_inv, b_p - z)
    dp = (dp * prob.point_mask[:, None]).to(prob.points.dtype)
    dc = dc.to(prob.pose6.dtype)

    pose6_new = prob.pose6 + dc
    points_new = torch.clamp(prob.points + dp, -cfg.point_bound, cfg.point_bound)
    return pose6_new, points_new


def _next_lambda(accept, lam, cfg: BAConfig):
    lam_new = torch.where(accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up)
    return torch.clamp(lam_new, cfg.lm_lambda_min, cfg.lm_lambda_max)


@full_f32
def lm_step(prob: BAProblem, lam, cfg: BAConfig, dense_slots=None, cam_red=None,
            group=None, point_sharded: bool = False):
    """One two-pass LM iteration: build, solve, evaluate the cost at the
    trial point, accept/reject. With `group`, prob holds this rank's shard
    (see build_normal_equations) and every reduction and cost is summed
    over the ranks.

    Returns (new_prob, new_lam, accepted, cost_before, cost_after).
    """
    H_cc, H_pp, W, b_c, b_p, cost0, Wg = build_normal_equations(
        prob, cfg.huber_delta, dense_slots, cam_red, group, point_sharded)
    pose6_new, points_new = _solve_lm(prob, H_cc, H_pp, W, b_c, b_p, lam, cfg,
                                      dense_slots, cam_red, Wg, None, group, point_sharded)
    cost1 = all_reduce(res_mod.robust_cost(
        pose6_new, points_new, prob.obs_cam, prob.obs_point, prob.obs_uv,
        prob.obs_weight, prob.P_l, prob.P_r, cfg.huber_delta,
    ), group)
    accept = cost1 < cost0
    new_prob = prob._replace(pose6=torch.where(accept, pose6_new, prob.pose6),
                             points=torch.where(accept, points_new, prob.points))
    return new_prob, _next_lambda(accept, lam, cfg), accept, cost0, cost1


class LMCarry(NamedTuple):
    """Evaluate-once LM state: the normal equations at the CURRENT params
    ride along, so each iteration runs exactly one residual/Jacobian pass
    (at the trial point — which doubles as the next iteration's build when
    the step is accepted; on rejection the cached blocks are reused with a
    larger lambda)."""

    prob: BAProblem
    lam: torch.Tensor
    cost: torch.Tensor
    H_cc: torch.Tensor
    H_pp: torch.Tensor
    W: torch.Tensor
    b_c: torch.Tensor
    b_p: torch.Tensor
    # Dense-path only: W in slot form [P,K,6,3] (None on the matrix-free path).
    Wg: Optional[torch.Tensor] = None


@full_f32
def lm_init(prob: BAProblem, cfg: BAConfig, dense_slots=None, cam_red=None, group=None,
            point_sharded: bool = False) -> LMCarry:
    H_cc, H_pp, W, b_c, b_p, cost, Wg = build_normal_equations(
        prob, cfg.huber_delta, dense_slots, cam_red, group, point_sharded)
    lam = torch.full((), cfg.lm_lambda_init, dtype=torch.float32, device=cost.device)
    return LMCarry(prob, lam, cost, H_cc, H_pp, W, b_c, b_p, Wg)


@full_f32
def lm_iteration(carry: LMCarry, cfg: BAConfig, dense_slots=None, cam_red=None,
                 band=None, active=None, group=None, point_sharded: bool = False,
                 float64: bool = False):
    """One evaluate-once LM iteration. Returns (new_carry, accepted,
    cost_before, cost_after). The accept decisions and damping schedule are
    lm_step's; the trial cost comes from the same whitened-residual pass
    that also produces the trial normal equations.

    `active` (a bool device tensor, default True): where False, the
    iteration is masked, and the carry comes back as it went in. `group`
    and `point_sharded` as in lm_step, `float64` as in _solve_lm."""
    prob = carry.prob
    pose6_new, points_new = _solve_lm(
        prob, carry.H_cc, carry.H_pp, carry.W, carry.b_c, carry.b_p, carry.lam,
        cfg, dense_slots, cam_red, carry.Wg, band, group, point_sharded, float64,
    )
    prob_try = prob._replace(pose6=pose6_new, points=points_new)
    H_cc2, H_pp2, W2, b_c2, b_p2, cost_try, Wg2 = build_normal_equations(
        prob_try, cfg.huber_delta, dense_slots, cam_red, group, point_sharded)

    # A NaN trial (a failed Cholesky) compares False: rejected.
    accept = cost_try < carry.cost
    lam = _next_lambda(accept, carry.lam, cfg)
    if active is not None:
        accept = accept & active
        lam = torch.where(active, lam, carry.lam)

    def sel(a, b):
        return torch.where(accept, a, b)

    new_carry = LMCarry(
        prob=prob._replace(pose6=sel(pose6_new, prob.pose6),
                           points=sel(points_new, prob.points)),
        lam=lam,
        cost=sel(cost_try, carry.cost),
        H_cc=sel(H_cc2, carry.H_cc), H_pp=sel(H_pp2, carry.H_pp),
        W=sel(W2, carry.W), b_c=sel(b_c2, carry.b_c), b_p=sel(b_p2, carry.b_p),
        Wg=None if Wg2 is None else sel(Wg2, carry.Wg),
    )
    return new_carry, accept, carry.cost, cost_try


def build_slots_device(obs_point, obs_cam, obs_weight, n_points_pad: int, K: int):
    """Device-side equivalent of schur_dense.group_slots: the [P,K] slot
    maps are pure functions of the sorted obs arrays already on the device,
    so only the K bucket is chosen on the host.

    REQUIRES obs_point sorted ascending with padding rows (obs_weight == 0)
    at the END of the array (the BundleAdjuster layout). The counts are an
    integer scatter-add, exact on every device.
    """
    dev = obs_point.device
    real = (obs_weight > 0).long()
    # Padding rows (obs_weight == 0, parked at obs_point=0) contribute 0.
    counts = torch.zeros(n_points_pad, dtype=torch.long, device=dev).index_add_(
        0, obs_point, real)
    n_obs = real.sum()
    starts = torch.cumsum(counts, 0) - counts
    k = torch.arange(K, device=dev)
    run = torch.minimum(k[None, :], torch.clamp(counts - 1, min=0)[:, None])
    sto = torch.minimum(starts[:, None] + run, torch.clamp(n_obs - 1, min=0))
    mask = (k[None, :] < counts[:, None]).float()
    scam = torch.where(mask > 0, obs_cam[sto], 0)
    return sto, scam, mask


def _cam_reduction(prob: BAProblem, dense_slots, cam_K, distributed: bool = False):
    """The reductions' plan. Dense path: the [C,O] one-hot when C*O <=
    2**26 (256 MB), else the camera-run slot maps when `cam_K` is given,
    else None (segmented sums). Matrix-free path, and every `distributed`
    solve (a process group, or the point-aligned layout even on one rank;
    as in the JAX package): the SegmentPlan."""
    if dense_slots is None or distributed:
        real = prob.obs_weight > 0
        return SegmentPlan(segments(prob.obs_cam, prob.pose6.shape[0], real),
                           segments(prob.obs_point, prob.points.shape[0], real))
    C = prob.pose6.shape[0]
    O = prob.obs_cam.shape[0]
    if C * O <= (1 << 26):
        cams = torch.arange(C, dtype=prob.obs_cam.dtype, device=prob.obs_cam.device)
        return (prob.obs_cam[None, :] == cams[:, None]).float()
    if cam_K is not None:
        return build_cam_slots_device(prob.obs_cam, prob.obs_weight, C, cam_K)
    return None


def _lm_loop(carry: LMCarry, max_iters: int, cfg: BAConfig, dense_slots, cam_red,
             band, group=None, point_sharded: bool = False):
    """Up to `max_iters` evaluate-once iterations with the reference's
    convergence exit (relative cost decrease < function_tolerance on an
    accepted step, the Ceres default semantics; ref
    `src/bundle_adjuster.cpp:13-36`).

    All `max_iters` iterations are launched as eager kernel streams; once
    the exit has fired, each later one is masked (the carry stays as it
    is), so the result is the early exit's and nothing is read back.
    Returns (carry, iterations_run, converged), the last two as device
    tensors (int64, bool). `LMProgram` replays the same iteration as one
    captured graph; this loop is its plain version and the distributed
    solves' loop."""
    dev = carry.cost.device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        active = ~done
        carry, accepted, c0, c1 = lm_iteration(carry, cfg, dense_slots, cam_red, band,
                                               active, group, point_sharded)
        iters = iters + active
        done = done | (accepted & (c0 > 0) & ((c0 - c1) < cfg.function_tolerance * c0))
    return carry, iters, done


def _band(band_bases, band_B, band_Pc):
    return None if band_bases is None or band_B is None else (band_bases, band_B, band_Pc)


@full_f32
def ba_solve(prob: BAProblem, max_iters: int, cfg: BAConfig, dense_slots=None,
             dense_K=None, cam_K=None, band_bases=None, band_B=None, band_Pc=None,
             group=None, point_sharded: bool = False):
    """Full LM solve: init + evaluate-once iterations until convergence or
    `max_iters`, as eager kernel streams. Returns (carry, iterations_run,
    cost_initial), the count a 0-d device tensor (no host sync). The
    plain version of `ba_solve_program`, which BundleAdjuster runs, and
    the distributed solves' entry point.

    `dense_slots` may be passed explicitly (precomputed host maps), or
    derived on device when `dense_K` is given. `cam_K` (pow2 >= max
    observations per camera) enables the camera-run slot maps for problems
    past the one-hot's C*O gate; without either, camera reductions are
    segmented sums. `band_bases` (host ints), `band_B`, `band_Pc` select the
    banded Schur assembly (schur_dense.band_plan).

    `group` (JAX's `axis_name`): prob holds this rank's shard of the
    observations (and, with `point_sharded`, of the points, whose slot maps
    `dense_K` then builds locally); every reduction is summed over the
    ranks, so all ranks take the same steps (parallel/dist_ba.py).
    """
    if dense_slots is None and dense_K is not None:
        dense_slots = build_slots_device(prob.obs_point, prob.obs_cam,
                                         prob.obs_weight, prob.points.shape[0], dense_K)
    cam_red = _cam_reduction(prob, dense_slots, cam_K, group is not None or point_sharded)
    carry = lm_init(prob, cfg, dense_slots, cam_red, group, point_sharded)
    cost_init = carry.cost
    carry, iters, _ = _lm_loop(carry, max_iters, cfg, dense_slots, cam_red,
                               _band(band_bases, band_B, band_Pc), group, point_sharded)
    return carry, iters, cost_init


@full_f32
def ba_resume(carry: LMCarry, max_iters: int, cfg: BAConfig, dense_slots=None,
              cam_red=None, band_bases=None, band_B=None, band_Pc=None, group=None,
              point_sharded: bool = False):
    """Continue an LM solve from an existing carry for up to `max_iters`
    more evaluate-once iterations (the loop of ba_solve). The chunked path
    of BundleAdjuster runs a large solve as bounded chunks of these, with
    the wall cap checked between them. Returns (carry, iterations_run,
    converged), the last two as device tensors."""
    return _lm_loop(carry, max_iters, cfg, dense_slots, cam_red,
                    _band(band_bases, band_B, band_Pc), group, point_sharded)


def _solve_plans(prob: BAProblem, dense_K, cam_K, chunked: bool, distributed: bool = False):
    """(dense_slots, cam_red) of a solve: as `ba_solve` derives them (with
    `distributed`, as it does for a group or the point-aligned layout), or
    (`chunked`) as BundleAdjuster's chunked path does (camera-run slot
    maps or segmented sums, never the one-hot)."""
    ds = None if dense_K is None else build_slots_device(
        prob.obs_point, prob.obs_cam, prob.obs_weight, prob.points.shape[0], dense_K)
    if not chunked:
        return ds, _cam_reduction(prob, ds, cam_K, distributed)
    if ds is None:
        return None, _cam_reduction(prob, None, None)
    return ds, (None if cam_K is None else build_cam_slots_device(
        prob.obs_cam, prob.obs_weight, prob.pose6.shape[0], cam_K))


def upload(a: np.ndarray, device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`torch.as_tensor(a, device=device)` (into `out` when given) with no
    stream sync: on the card the array is staged in pinned memory
    (PyTorch's caching host allocator, which keeps the block until the copy
    has run) and copied without blocking, so a solve's build queues behind
    the device's work instead of waiting for it. The same bytes arrive."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    if out is not None:
        return out.copy_(host, non_blocking=True)
    return host.to(device, non_blocking=True)


class LMProgram(programs.Program):
    """The LM solve (`lm_init`, then `_lm_loop`'s masked iterations) as a
    captured program for one padded problem shape and path: the problem,
    its reduction plans, the evaluate-once carry, the iteration count and
    the convergence flag in static tensors, and two bodies: `start` (the
    plans and lm_init) and `iteration` (one lm_iteration, masked once the
    exit has fired). A solve replays `iteration` max_iters times, so
    `iters` and `done` stay on the device as in the eager loop.

    A distributed solve's program (parallel/dist_ba.py) holds this rank's
    shard and sums over `group` (see ba_solve; `point_sharded` for the
    point-aligned layout); either takes ba_solve's distributed plan.
    `float64`: the iterations' dense solves in float64 (_solve_lm)."""

    def __init__(self, prob: BAProblem, cfg: BAConfig, dense_K, cam_K, band, chunked: bool,
                 group=None, point_sharded: bool = False, float64: bool = False):
        super().__init__(prob.pose6.device, group)
        self.cfg, self.dense_K, self.cam_K, self.chunked = cfg, dense_K, cam_K, chunked
        self.float64 = float64
        # The banded path's chunk bases are data, in a static tensor that
        # `set_band` fills for each solve; its chunk count, B and Pc are shape.
        self.band = None if band is None else (
            torch.empty(len(band[0]), dtype=torch.int64, device=prob.pose6.device),
            band[1], band[2])
        self.point_sharded = point_sharded
        self.distributed = group is not None or point_sharded
        dev = prob.pose6.device
        self.prob = BAProblem(*(torch.empty_like(t) for t in prob))
        # The plans' shapes, from one eager build; `start` rebuilds their
        # values for every problem.
        self.plans = _solve_plans(prob, dense_K, cam_K, chunked, self.distributed)
        C, P, O = prob.pose6.shape[0], prob.points.shape[0], prob.obs_cam.shape[0]

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        self.carry = LMCarry(self.prob, f32(), f32(), f32(C, 6, 6), f32(P, 3, 3), f32(O, 6, 3),
                             f32(C, 6), f32(P, 3), None if dense_K is None else f32(P, dense_K, 6, 3))
        self.cost_init = f32()
        self.iters = torch.empty((), dtype=torch.int64, device=dev)
        self.done = torch.empty((), dtype=torch.bool, device=dev)

    @staticmethod
    def key(prob: BAProblem, cfg: BAConfig, dense_K, cam_K, band, chunked: bool, group=None,
            point_sharded: bool = False, float64: bool = False):
        band_key = None if band is None else (len(band[0]), band[1], band[2])
        return (LMProgram, programs.tensor_key(*prob), cfg, dense_K, cam_K, band_key, chunked,
                group, point_sharded, float64)

    def load(self, prob: BAProblem):
        programs.copy_into(self.prob, prob)

    def set_band(self, band):
        """The banded path's chunk bases of the next solve (band_plan's)."""
        if band is not None:
            upload(np.asarray(band[0], np.int64), self.device, out=self.band[0])

    def start(self):
        programs.copy_into(self.plans, _solve_plans(self.prob, self.dense_K, self.cam_K,
                                                    self.chunked, self.distributed))
        carry = lm_init(self.prob, self.cfg, *self.plans, self.group, self.point_sharded)
        programs.copy_into(self.carry[1:], carry[1:])
        self.cost_init.copy_(carry.cost)
        self.iters.zero_()
        self.done.zero_()

    def iteration(self):
        active = ~self.done
        new, accepted, c0, c1 = lm_iteration(self.carry, self.cfg, *self.plans, self.band,
                                             active, self.group, self.point_sharded,
                                             self.float64)
        # c0 is the carry's cost tensor: the exit test reads it before the
        # carry is overwritten.
        converged = accepted & (c0 > 0) & ((c0 - c1) < self.cfg.function_tolerance * c0)
        self.prob.pose6.copy_(new.prob.pose6)
        self.prob.points.copy_(new.prob.points)
        programs.copy_into(self.carry[1:], new[1:])
        self.iters.add_(active)
        self.done.logical_or_(converged)

    def solve(self, prob: BAProblem, max_iters: int):
        """Load `prob`, run `start`, then `max_iters` iterations."""
        self.load(prob)
        self.run("start", self.start)
        self.iterate(max_iters)

    def iterate(self, k: int):
        for _ in range(k):
            self.run("iteration", self.iteration)


def lm_program(prob: BAProblem, cfg: BAConfig, dense_K=None, cam_K=None, band=None,
               chunked: bool = False,
               cache: Optional[programs.ProgramCache] = None, group=None,
               point_sharded: bool = False, float64: bool = False) -> LMProgram:
    """The cache's LMProgram for this problem's shapes, path, group and
    precision, its band's bases set to `band`'s."""
    cache = programs.PROGRAMS if cache is None else cache
    prog = cache.get(LMProgram.key(prob, cfg, dense_K, cam_K, band, chunked, group,
                                   point_sharded, float64),
                     lambda: LMProgram(prob, cfg, dense_K, cam_K, band, chunked, group,
                                       point_sharded, float64))
    prog.set_band(band)
    return prog


@full_f32
def ba_solve_program(prob: BAProblem, max_iters: int, cfg: BAConfig, dense_K=None, cam_K=None,
                     band_bases=None, band_B=None, band_Pc=None,
                     cache: Optional[programs.ProgramCache] = None, group=None,
                     point_sharded: bool = False):
    """`ba_solve` (slot maps derived on the device) through its captured
    program: on the card `start` and `iteration` are captured once per
    padded shape, path and group and a solve is 1 + max_iters graph
    replays; on the CPU the bodies run as they are. Equal to `ba_solve`
    with the same `group` and `point_sharded` bit for bit. Returns what
    `ba_solve` returns, as new tensors."""
    prog = lm_program(prob, cfg, dense_K, cam_K, _band(band_bases, band_B, band_Pc), False,
                      cache, group, point_sharded)
    prog.solve(prob, max_iters)
    return programs.clone(prog.carry), prog.iters.clone(), prog.cost_init.clone()


def lm_step_on_shard(prob: BAProblem, lam, cfg: BAConfig, dense_K=None, group=None,
                    point_sharded: bool = False):
    """One distributed LM step (lm_step) over this rank's shard with its
    plans: none on the "obs" layout (lm_step's own segmented sums); on the
    point-aligned layout the local slot maps (with `dense_K`) and the
    distributed plan. The eager body of `lm_step_program`."""
    ds = cam_red = None
    if point_sharded:
        ds = (build_slots_device(prob.obs_point, prob.obs_cam, prob.obs_weight,
                                 prob.points.shape[0], dense_K)
              if dense_K is not None else None)
        cam_red = _cam_reduction(prob, ds, None, distributed=True)
    return lm_step(prob, lam, cfg, ds, cam_red, group, point_sharded)


class LMStepProgram(programs.Program):
    """One `lm_step_on_shard` as a captured program, one body, for one shard
    shape, path and group: the problem and lambda in static tensors, the
    stepped pose6 and points, lambda, the accept flag and both costs out
    (the scaling harness's step)."""

    def __init__(self, prob: BAProblem, lam, cfg: BAConfig, dense_K, group=None,
                 point_sharded: bool = False):
        super().__init__(prob.pose6.device, group)
        self.cfg, self.dense_K, self.point_sharded = cfg, dense_K, point_sharded
        self.prob = BAProblem(*(torch.empty_like(t) for t in prob))
        self.lam = torch.empty_like(lam)
        self.out = (torch.empty_like(prob.pose6), torch.empty_like(prob.points),
                    torch.empty_like(lam),
                    torch.empty((), dtype=torch.bool, device=self.device),
                    torch.empty((), dtype=torch.float32, device=self.device),
                    torch.empty((), dtype=torch.float32, device=self.device))

    @staticmethod
    def key(prob: BAProblem, lam, cfg: BAConfig, dense_K, group=None,
            point_sharded: bool = False):
        return (LMStepProgram, programs.tensor_key(*prob, lam), cfg, dense_K, group,
                point_sharded)

    def step(self):
        new, lam, accepted, c0, c1 = lm_step_on_shard(self.prob, self.lam, self.cfg,
                                                      self.dense_K, self.group,
                                                      self.point_sharded)
        programs.copy_into(self.out, (new.pose6, new.points, lam, accepted, c0, c1))


def lm_step_program(prob: BAProblem, lam, cfg: BAConfig, dense_K=None, group=None,
                    point_sharded: bool = False,
                    cache: Optional[programs.ProgramCache] = None):
    """`lm_step_on_shard` through its captured program (one graph replay a
    step on the card; the body as it is on the CPU). Equal to the eager
    step bit for bit. Returns what lm_step returns, as new tensors."""
    cache = programs.PROGRAMS if cache is None else cache
    prog = cache.get(LMStepProgram.key(prob, lam, cfg, dense_K, group, point_sharded),
                     lambda: LMStepProgram(prob, lam, cfg, dense_K, group, point_sharded))
    programs.copy_into(prog.prob, prob)
    prog.lam.copy_(lam)
    prog.run("step", prog.step)
    pose6, points, lam_new, accepted, c0, c1 = programs.clone(prog.out)
    return prob._replace(pose6=pose6, points=points), lam_new, accepted, c0, c1


def _pad_to(n: int, mult: int = 256) -> int:
    """Pad to the next power of two (>= mult). The JAX package buckets
    shapes for its compile cache; the port keeps the buckets because the
    dense gate, `band_plan` and `_chunk_size` read the padded sizes, so the
    same problem takes the same path in both packages."""
    n = max(n, mult)
    return 1 << (n - 1).bit_length()


def _pad_to_fine(n: int, mult: int = 256) -> int:
    """Half-octave buckets (1x and 1.5x each power of two)."""
    n = max(n, mult)
    p = 1 << (n - 1).bit_length()
    if n <= (p >> 1) + (p >> 2):  # fits in 1.5 * p/2
        return (p >> 1) + (p >> 2)
    return p


def prepare_problem_arrays(problem: dict, sort_by_point: bool):
    """World->solver conversion: pose6 parameterization on the host,
    first-camera-fixed mask (ref bundle_adjuster.cpp:113), and optional
    point-sorted observation layout (the dense-Schur contract)."""
    pose6 = se3_np.matrix_to_pose6_np(
        se3_np.inverse_np(problem["cam_world"])
    ).astype(np.float32)
    obs_cam = np.asarray(problem["obs_cam"])
    obs_point = np.asarray(problem["obs_point"])
    obs_uv = np.asarray(problem["obs_uv"])
    if sort_by_point:
        order = np.argsort(obs_point, kind="stable")
        obs_cam = obs_cam[order]
        obs_point = obs_point[order]
        obs_uv = obs_uv[order]
    cam_mask = np.ones(len(problem["frame_ids"]), np.float32)
    cam_mask[0] = 0.0
    return pose6, obs_cam, obs_point, obs_uv, cam_mask


def _pack_ba_result(pose6, points, n_iters, cost_init, cost_final):
    """Flatten the solve outputs into one f32 buffer (single readback).
    `n_iters` is an int or a 0-d device tensor."""
    n = torch.as_tensor(n_iters, device=pose6.device).to(torch.float32)
    scalars = torch.stack([n, cost_init, cost_final])
    return torch.cat([pose6.reshape(-1), points.reshape(-1), scalars])


class BASetup(NamedTuple):
    """A window's solver input as BundleAdjuster.prepare builds it."""

    problem: dict          # world.ba_problem(...) (host)
    prob: BAProblem        # padded, point-sorted, on the adjuster's device
    num_cams: int
    num_points: int
    num_obs: int
    C_pad: int
    P_pad: int
    O_pad: int
    dense_K: Optional[int]
    cam_K: Optional[int]
    band: Optional[tuple]  # (bases as host ints, B, Pc) or None

    @property
    def path(self) -> str:
        """'dense', 'banded' or 'matrix-free': which reduced-system solve."""
        if self.dense_K is None:
            return "matrix-free"
        return "dense" if self.band is None else "banded"

    def band_kwargs(self) -> dict:
        """The ba_solve / ba_resume arguments that select the banded Schur
        assembly (all None off the banded path)."""
        bases, B, Pc = self.band if self.band is not None else (None, None, None)
        return dict(band_bases=bases, band_B=B, band_Pc=Pc)

    def solve_kwargs(self) -> dict:
        """The ba_solve arguments that select this setup's path."""
        return dict(dense_K=self.dense_K, cam_K=self.cam_K, **self.band_kwargs())


# Baselines (metres) under which the windowed solves run in float64
# (see the module's docstring): EuRoC's 0.110 m is under it, KITTI's
# 0.537 m over it.
FLOAT64_BELOW_BASELINE_M = 0.25


def marginalize_in_float64(rig) -> bool:
    """Whether BundleAdjuster's windowed solves on `rig` marginalize and
    solve in float64 (its baseline under FLOAT64_BELOW_BASELINE_M)."""
    return float(rig.baseline) < FLOAT64_BELOW_BASELINE_M


class BundleAdjuster:
    """Host orchestration: pad, run LM to convergence, write back.

    Mirrors BundleAdjuster::Optimize(start, end) (ref
    `src/bundle_adjuster.cpp:39-133`), called per-frame, sliding-window, and
    globally (ref `src/slam.cpp:123-129,156`). Runs on the rig's device.
    """

    def __init__(self, world, rig, cfg: Optional[BAConfig] = None):
        self.world = world
        self.cfg = cfg or BAConfig()
        self.P_l = rig.left.projection
        self.P_r = rig.right.projection
        self.device = rig.device
        self.float64 = marginalize_in_float64(rig)
        self.last_stats = {}

    def optimize(self, start_frame: int, end_frame: int,
                 max_iterations: Optional[int] = None,
                 max_seconds: Optional[float] = None) -> dict:
        fin = self.optimize_async(start_frame, end_frame, max_iterations, max_seconds)
        return fin() if fin is not None else {}

    def prepare(self, start_frame: int, end_frame: int) -> Optional[BASetup]:
        """Pad and upload the window [start, end) and choose its path, as
        the JAX package's BundleAdjuster does (same gates on the same padded
        sizes). None when there is nothing to solve."""
        world = self.world
        end_frame = min(end_frame, world.num_frames)
        if end_frame - start_frame < 1:
            return None
        problem = world.ba_problem(start_frame, end_frame)
        n_obs = len(problem["obs_cam"])
        if n_obs == 0:
            return None

        C = len(problem["frame_ids"])
        P_real = len(problem["point_ids"])
        P_pad = _pad_to_fine(P_real)
        O_pad = _pad_to(n_obs)
        # Padded cameras are held fixed (cam_mask 0, identity rows) and carry
        # no observations, so the solve is unchanged.
        C_pad = _pad_to_fine(C, mult=4)

        # Point-sorted layout: contiguous per-point runs make the dense-
        # Schur slot maps monotonic (schur_dense.group_slots).
        pose6, s_cam, s_point, s_uv, cam_mask = prepare_problem_arrays(
            problem, sort_by_point=True)
        if C_pad > C:
            pose6 = np.concatenate([pose6, np.zeros((C_pad - C, 6), np.float32)])
            cam_mask = np.concatenate([cam_mask, np.zeros(C_pad - C, np.float32)])
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

        prob = BAProblem(
            *(upload(a, self.device) for a in (
                pose6, points, obs_cam, obs_point, obs_uv, obs_w, cam_mask, point_mask)),
            P_l=self.P_l, P_r=self.P_r,
        )

        cfg = self.cfg
        # Dense-Schur path for windowed problems; matrix-free otherwise.
        # Only the K bucket (max observations per point, pow2) is chosen
        # on the host; the [P,K] slot maps are derived on the device.
        dense_K = cam_K = band = None
        if C_pad <= cfg.dense_schur_max_cams:
            kmax = int(np.bincount(obs_point[:n_obs], minlength=1).max(initial=2))
            K = 1 << (max(kmax, 2) - 1).bit_length()
            if P_pad * K <= cfg.dense_schur_max_slots:
                dense_K = K
                # Camera-run slot bucket, gated so a pathological skew (one
                # camera owning most observations) cannot blow the [C,Kc,F]
                # gather past ~4x the obs arrays.
                kcam = int(np.bincount(obs_cam[:n_obs], minlength=1).max(initial=2))
                Kc = 1 << (max(kcam, 2) - 1).bit_length()
                if C_pad * Kc <= 4 * O_pad:
                    cam_K = Kc
            if dense_K is not None and cfg.banded_schur:
                band = schur_dense.band_plan(s_point, s_cam, P_pad, n_obs, C_pad,
                                             K=dense_K, max_width=cfg.banded_max_width)
        return BASetup(problem, prob, C, P_real, n_obs, C_pad, P_pad, O_pad,
                       dense_K, cam_K, band)

    @full_f32
    def optimize_async(self, start_frame: int, end_frame: int,
                       max_iterations: Optional[int] = None,
                       max_seconds: Optional[float] = None):
        """Build and launch the solve on the device; return a finish()
        closure that does the single packed readback and applies the
        writeback. The solve is not waited for here: finish() is its first
        host read. Nothing touches the world between the two calls, so a
        caller may do other work before finish(). Big solves (see below) run
        whole inside finish(), in chunks. Returns None when there is nothing
        to solve. Both run the captured LM program (`lm_program`); while
        tracing is on, a device timer (`utils/profiling`) brackets the
        program of a solve that is not chunked, read in finish(): `dev.ba`
        for a window's solve, which has no wall cap, and `dev.ba.capped`
        for a capped one (a live closure's polish, the final BA).
        """
        setup = self.prepare(start_frame, end_frame)
        if setup is None:
            return None
        cfg = self.cfg
        prob = setup.prob
        iters = max_iterations or cfg.max_iterations

        # Per-call wall cap override (live loop-closure solves pass the
        # reference's 1 s Ceres budget, ref src/params.h:41); falls back to
        # the config default. A cap forces the chunked path even for
        # mid-size problems: the cap is checked between chunks.
        cap_seconds = max_seconds if max_seconds is not None else cfg.max_solve_seconds
        if setup.O_pad >= (1 << 19) or (cap_seconds > 0 and setup.O_pad >= (1 << 16)):
            # Big solves are CHUNKED regardless of path. The dense machinery
            # (device-derived slot maps + camera-run maps) threads through
            # the program's start and its iterations, as in the JAX
            # package. The program's state is shared by every solve of its
            # shapes, so the whole solve, lm_init included, runs in finish().
            @full_f32
            def finish_chunked() -> dict:
                chunk_max = max(1, (1 << 22) // setup.O_pad)
                prog = lm_program(prob, cfg, setup.dense_K, setup.cam_K, setup.band, True,
                                  float64=self.float64)
                prog.load(prob)
                prog.run("start", prog.start)
                # The cap covers the LM chunks, as when lm_init was launched
                # before finish().
                t0 = time.perf_counter()
                n_done = 0
                per_iter = None  # measured wall seconds per LM iteration
                while n_done < iters:
                    if cap_seconds > 0:
                        # The cap is enforced by sizing each chunk from the
                        # MEASURED per-iteration wall time; the first chunk
                        # is a 1-iteration probe that establishes the rate.
                        remaining = cap_seconds - (time.perf_counter() - t0)
                        if remaining <= 0:
                            # Reference parity: Ceres max_solver_time (1 s,
                            # ref src/params.h:41) returns best-so-far.
                            break
                        k = (1 if per_iter is None
                             else int(max(1, min(chunk_max, remaining / per_iter))))
                    else:
                        k = chunk_max
                    k = min(k, iters - n_done)
                    tc = time.perf_counter()
                    prog.iterate(k)
                    # The one host read per chunk (it also ends the chunk's
                    # timing): the running count and the exit flag.
                    total, conv = torch.stack([prog.iters, prog.done.long()]).tolist()
                    ran, n_done = total - n_done, total
                    if ran > 0:
                        per_iter = (time.perf_counter() - tc) / ran
                    if conv:
                        break
                flat = _pack_ba_result(prog.prob.pose6, prog.prob.points, n_done,
                                       prog.cost_init, prog.carry.cost)
                return self._apply_result(setup, flat.cpu().numpy(), chunked=True)

            return finish_chunked

        # The captured LM program; one consolidated readback, in finish(),
        # of a result packed into its own tensor (the program's state
        # belongs to the next solve of its shapes).
        prog = lm_program(prob, cfg, setup.dense_K, setup.cam_K, setup.band, False,
                          float64=self.float64)
        timer = TRACER.device_timer("dev.ba" if max_seconds is None else "dev.ba.capped",
                                    self.device)
        prog.solve(prob, iters)
        flat_dev = _pack_ba_result(prog.prob.pose6, prog.prob.points, prog.iters,
                                   prog.cost_init, prog.carry.cost)
        if timer is not None:
            timer.stop()

        def finish() -> dict:
            flat = flat_dev.cpu().numpy()
            if timer is not None:
                timer.read()   # the readback waited for the solve
            return self._apply_result(setup, flat, chunked=False)

        return finish

    def _apply_result(self, setup: BASetup, flat: np.ndarray, chunked: bool) -> dict:
        """Unpack the result buffer, convert pose6 (world->camera) to
        camera-to-world matrices on the host (geometry/se3_np.py), and write
        the world."""
        C, C_pad, P_pad = setup.num_cams, setup.C_pad, setup.P_pad
        pose6_new = flat[: C_pad * 6].reshape(C_pad, 6)[:C]
        points_new = flat[C_pad * 6: C_pad * 6 + P_pad * 3].reshape(P_pad, 3)
        n_it, c0, c1 = flat[-3:]
        cam_world_new = se3_np.inverse_np(se3_np.pose6_to_matrix_np(pose6_new))
        self.world.ba_writeback(setup.problem, cam_world_new,
                                points_new[: setup.num_points])
        self.last_stats = {
            "iterations": int(n_it),
            "cost_initial": float(c0),
            "cost_final": float(c1),
            "num_cams": C,
            "num_points": setup.num_points,
            "num_obs": setup.num_obs,
            "path": setup.path,
            "chunked": chunked,
        }
        return self.last_stats

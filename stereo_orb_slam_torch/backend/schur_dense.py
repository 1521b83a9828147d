"""Explicit (dense) reduced-camera-system assembly for windowed BA.

PyTorch counterpart of the JAX package's `backend/schur_dense.py`. Same
math as the matrix-free path in backend/ba.py (LM over the reference's
stereo reprojection cost, ref `src/bundle_adjuster.cpp:39-133`); only the
Schur solve differs. The reduced camera system

    S = H_cc_l - W H_pp_l^-1 W^T        (6C x 6C)

is MATERIALIZED once per LM step from batched matrix products and solved
by Cholesky, where the matrix-free path runs PCG with two segmented sums
and two gathers over all observations per CG iteration.

Layout contract: the BundleAdjuster sorts observations BY POINT on the
host, so each point's observations form a contiguous run. `group_slots`
(host) and `ba.build_slots_device` (device) then emit MONOTONIC [P, K]
slot->observation index maps (clamped run indices + validity mask), which
turn every point-side reduction into a gather + local sum over the K slot
axis, with no scatter.

Assembly: per point chunk, the slot W blocks are expanded into a dense
A = [3*Pc, 6C] via a one-hot product (slot camera id -> camera column
block), and  S -= A^T (blockdiag(Hpp_inv) A)  accumulates over chunks as
one [6C,3Pc]x[3Pc,6C] product. Memory peaks at O(P*K) + O((6C)^2), so
this path is gated to windowed problems (C <= BAConfig.dense_schur_max_cams,
P*K <= dense_schur_max_slots). The chunk loop runs on the host over chunk
counts known there, so it adds no device sync. S is assembled in the
dtype of its inputs: float32 products need full float32 (the BA entry
points turn TF32 off); on a short-baseline rig the BA hands float64
blocks (backend/ba.py).

Distributed (point-aligned layout, parallel/dist_ba.py): each rank
assembles the share of S of its own points, and one [6C, 6C] all_reduce
over `group` sums them before the camera blocks are added.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stereo_orb_slam_torch.parallel.mesh import all_reduce


def group_slots(obs_point, obs_cam, n_points_pad: int, n_obs: int):
    """Host-side slot maps for dense-Schur assembly.

    REQUIRES obs_point sorted ascending (the BundleAdjuster's layout).
    Returns (slot_to_obs [P,K] int32 — monotonic, clamped into each point's
    run; slot_cam [P,K] int32; slot_mask [P,K] float32; K) with K the max
    observations per point rounded up to a power of two (min 2).
    """
    obs_point = np.asarray(obs_point)
    obs_cam = np.asarray(obs_cam)
    if np.any(np.diff(obs_point) < 0):
        raise ValueError("observations must be point-sorted")
    counts = np.bincount(obs_point, minlength=n_points_pad)[:n_points_pad]
    kmax = max(int(counts.max(initial=0)), 2)
    K = 1 << (kmax - 1).bit_length()

    starts = np.zeros(n_points_pad, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    k = np.arange(K)
    # Clamp within each run (keeps the raster order monotonic; padding slots
    # re-read the run's last row and are zeroed by slot_mask).
    sto = starts[:, None] + np.minimum(k[None, :], np.maximum(counts - 1, 0)[:, None])
    sto = np.minimum(sto, max(n_obs - 1, 0)).astype(np.int32)
    mask = (k[None, :] < counts[:, None]).astype(np.float32)
    scam = np.where(mask > 0, obs_cam[sto] if n_obs else 0, 0).astype(np.int32)
    return sto, scam, mask, K


def slot_gather(x, slot_to_obs, slot_mask):
    """x [O, F] -> [P, K, F] via the slot map, padding slots zeroed."""
    return x[slot_to_obs] * slot_mask[..., None]


def _chunk_size(P: int, K: int, C: int) -> int:
    """Point-chunk size bounding the [Pc,K,C] one-hot and [3Pc,6C] dense A
    to ~96 MB each. Prefers a divisor of P (>= half the power-of-two
    budget) so the chunks need no zero padding."""
    budget = 96 * 1024 * 1024 // 4
    pc = min(budget // max(K * C, 1), budget // max(C * 18, 1))
    pc = max(256, 1 << max(int(pc).bit_length() - 1, 0))
    if P > pc and P % pc:
        for d in range(pc, pc // 2, -1):
            if P % d == 0:
                return d
    return min(P, pc)


def _pad_points(Wg, slot_cam, Hpp_inv, Pc: int):
    """Round P up to a multiple of Pc with zero contributions."""
    P, K = slot_cam.shape
    if P % Pc == 0:
        return Wg, slot_cam, Hpp_inv
    extra = Pc - P % Pc
    Wg = torch.cat([Wg, Wg.new_zeros((extra, K, 6, 3))])
    slot_cam = torch.cat([slot_cam, slot_cam.new_zeros((extra, K))])
    Hpp_inv = torch.cat([Hpp_inv, Hpp_inv.new_zeros((extra, 3, 3))])
    return Wg, slot_cam, Hpp_inv


def _chunk_product(cam_c, Wg_c, Minv_c, width: int):
    """One chunk's [6,width,6,width] contribution A^T (Hpp_inv A), with the
    chunk's slot cameras `cam_c` [Pc,K] already local to the band."""
    local = torch.arange(width, dtype=cam_c.dtype, device=cam_c.device)
    oh = (cam_c[..., None] == local).to(Wg_c.dtype)             # [Pc,K,w]
    A = torch.einsum("pkc,pkia->paic", oh, Wg_c)                # [Pc,3,6,w]
    T = torch.einsum("pab,pbic->paic", Minv_c, A)
    return torch.einsum("paic,pajd->icjd", A, T)                # [6,w,6,w]


def _finish_schur(S_sub, H_cc_safe, cam_mask):
    """S = -S_sub + blockdiag(H_cc) in IC order, fixed cameras pinned."""
    C = H_cc_safe.shape[0]
    dev = S_sub.device
    c = torch.arange(C, device=dev)[:, None, None]
    i = torch.arange(6, device=dev)
    S = -S_sub
    # The JAX package writes S.at[:, idx, :, idx].add(H_cc): two index
    # arrays split by a slice put the camera axis first, as in NumPy, so
    # it is S[i1, c, i2, c] += H_cc[c, i1, i2]. Spelled out here with
    # indices broadcast to H_cc's [C,6,6].
    S.index_put_((i[None, :, None], c, i[None, None, :], c), H_cc_safe, accumulate=True)
    S = S.reshape(6 * C, 6 * C)
    m = cam_mask.repeat(6)  # ic order: camera index minor
    return S * m[:, None] * m[None, :] + torch.diag(1.0 - m)


def assemble_schur(H_cc_safe, W, Hpp_inv, slot_to_obs, slot_cam, slot_mask,
                   cam_mask, Wg=None, group=None):
    """Materialize the reduced camera system S = H_cc_safe - W H_pp^-1 W^T
    as [6C, 6C] in IC ORDER: flat index q = i * C + c (parameter i of
    camera c), NOT the (c, i) order of the matrix-free path. Downstream
    consumers (solve_reduced_chol / ba._solve_lm) flatten rhs and unflatten
    the solution in the same order.

    W: [O,6,3] flat per-observation coupling blocks (J_c^T J_p);
    Hpp_inv: [P,3,3]; slot maps from `group_slots`. Fixed cameras get
    identity rows/cols (the pinning the matrix-free matvec applies).

    `group` (JAX's `axis_name`): the points are this rank's shard; the
    local contributions are summed over the ranks in one [6, C, 6, C]
    all_reduce. H_cc_safe must already be the global one.
    """
    C = H_cc_safe.shape[0]
    P, K = slot_to_obs.shape
    if Wg is None:
        # Standalone use; the LM loop passes Wg from the fused build gather
        # (ba.build_normal_equations) so W is gathered ONCE per iteration.
        Wg = slot_gather(W.reshape(-1, 18), slot_to_obs, slot_mask)
    Wg = Wg.reshape(P, K, 6, 3)
    Pc = _chunk_size(P, K, C)
    Wg, slot_cam, Hpp_inv = _pad_points(Wg, slot_cam, Hpp_inv, Pc)
    S_sub = torch.zeros((6, C, 6, C), dtype=H_cc_safe.dtype, device=H_cc_safe.device)
    for lo in range(0, slot_cam.shape[0], Pc):
        hi = lo + Pc
        S_sub += _chunk_product(slot_cam[lo:hi], Wg[lo:hi], Hpp_inv[lo:hi], C)
    return _finish_schur(all_reduce(S_sub, group), H_cc_safe, cam_mask)


def band_plan(obs_point, obs_cam, n_points_pad: int, n_obs: int, C: int,
              K: int, max_width: int = 128):
    """Host-side feasibility plan for the BANDED Schur assembly.

    Real SLAM points are observed by a NARROW CONTIGUOUS camera range (a
    track over consecutive frames), and point ids grow in frame order, so
    a point chunk's observations span a small camera window. The banded
    assembly exploits that: per chunk, expand into a LOCAL band
    [Pc,3,6,B] at the chunk's base camera instead of the full [Pc,3,6,C],
    which shrinks the reduced-system contraction by (B/C)^2 in flops.

    Returns (bases [G] int32, B, Pc) when every chunk's camera span fits a
    band of pow2 width B <= min(max_width, C/2); None otherwise (e.g.
    loop-closure points observed from distant cameras — those problems
    keep the dense expansion, which is always correct). The bases are
    clamped to C - B, so a band never runs past the last camera.

    REQUIRES obs_point sorted ascending (the BundleAdjuster layout). A copy
    of the JAX package's host planner, so both packages take the same path
    and the same chunking for the same problem.
    """
    obs_point = np.asarray(obs_point)
    obs_cam = np.asarray(obs_cam)
    if n_obs == 0:
        return None
    cmin = np.full(n_points_pad, np.iinfo(np.int32).max, np.int64)
    cmax = np.full(n_points_pad, -1, np.int64)
    np.minimum.at(cmin, obs_point[:n_obs], obs_cam[:n_obs])
    np.maximum.at(cmax, obs_point[:n_obs], obs_cam[:n_obs])
    span = int((cmax - np.where(cmax >= 0, cmin, 0)).max(initial=0)) + 1
    cap = min(max_width, max(C // 2, 1))

    def chunk_plan(B, Pc):
        G = (n_points_pad + Pc - 1) // Pc
        bases = np.zeros(G, np.int32)
        for g in range(G):
            lo, hi = g * Pc, min((g + 1) * Pc, n_points_pad)
            real = cmax[lo:hi] >= 0
            if not real.any():
                continue
            b0 = int(cmin[lo:hi][real].min())
            if int(cmax[lo:hi][real].max()) - b0 + 1 > B:
                return None
            bases[g] = b0
        return np.minimum(bases, max(C - B, 0)).astype(np.int32)

    # For each candidate band width take the LARGEST pow2 chunk whose
    # per-chunk camera span still fits (the [Pc,K,B] expansion memory
    # budget caps Pc from above), then pick the width minimizing the JAX
    # package's cost model: a fixed per-chunk step overhead plus the
    # (6B)^2 contraction flops.
    budget = 96 * 1024 * 1024 // 4
    B = 1 << (max(span, 2) - 1).bit_length()
    best = None
    best_score = float("inf")
    while B <= cap:
        pc_mem = max(256, 1 << max(int(budget // max(K * B, B * 18, 1)).bit_length() - 1, 0))
        Pc = min(1 << (n_points_pad - 1).bit_length(), pc_mem)
        while Pc >= 256:
            bases = chunk_plan(B, Pc)
            if bases is not None:
                G = len(bases)
                score = G * 40e-6 + (72 * n_points_pad * B * B) / 100e12
                if score < best_score:
                    best, best_score = (bases, B, Pc), score
                break
            Pc //= 2
        B *= 2
    return best


@functools.lru_cache(maxsize=None)
def _band_index(C: int, B: int, device) -> torch.Tensor:
    """The flat indices into a [6, C, 6, C] tensor of a [6, B, 6, B] band
    at base 0; the band at base b is at these + b (6C + 1). Made once per
    shape (in a program's eager run, before its capture), so a captured
    assembly computes only the shift."""
    a = torch.arange(6, device=device)
    col = torch.arange(B, device=device)
    return (((a[:, None, None, None] * C + col[:, None, None]) * 6 + a[:, None]) * C
            + col).reshape(-1)


def assemble_schur_banded(H_cc_safe, Hpp_inv, slot_cam, slot_mask, cam_mask,
                          Wg, bases, B: int, Pc: int):
    """Banded variant of assemble_schur: per point chunk, the one-hot
    expansion and the (p,a) contraction run at LOCAL band width B (camera
    columns [base, base+B) of that chunk) and the [6,B,6,B] band is added
    into S at the chunk's base offset. Identical math to the dense path
    whenever band_plan() declared feasibility (every slot's camera lies in
    its chunk's band); padding slots have Wg == 0 so their out-of-band
    local index contributes nothing either way.

    `bases` (band_plan's, already clamped to C - B, so no clamping here)
    are host integers, and each band is a plain slice; or a [G] integer
    tensor on the device, as a captured program holds them (LMProgram: one
    program serves every plan of its G, B and Pc). Then each band is added
    by one `index_add_` into S's flat view, at its entries' linear indices
    (`_band_index`'s, shifted by base * (6C + 1)). No index repeats within
    a chunk, so the sums are those of the slices.
    """
    C = H_cc_safe.shape[0]
    P, K = slot_cam.shape
    dev = H_cc_safe.device
    G = (P + Pc - 1) // Pc
    if G != len(bases):
        raise ValueError(f"band plan has {len(bases)} chunks, the problem {G}")
    Wg = Wg.reshape(P, K, 6, 3)
    Wg, slot_cam, Hpp_inv = _pad_points(Wg, slot_cam, Hpp_inv, Pc)
    S_sub = torch.zeros((6, C, 6, C), dtype=H_cc_safe.dtype, device=dev)
    if isinstance(bases, torch.Tensor):
        lin = _band_index(C, B, dev) + bases[:, None] * (6 * C + 1)
        flat = S_sub.view(-1)
        for g in range(G):
            lo, hi = g * Pc, (g + 1) * Pc
            band = _chunk_product(slot_cam[lo:hi] - bases[g], Wg[lo:hi], Hpp_inv[lo:hi], B)
            flat.index_add_(0, lin[g], band.reshape(-1))
    else:
        for g, base in enumerate(np.asarray(bases).tolist()):
            lo, hi = g * Pc, (g + 1) * Pc
            band = _chunk_product(slot_cam[lo:hi] - base, Wg[lo:hi], Hpp_inv[lo:hi], B)
            S_sub[:, base:base + B, :, base:base + B] += band
    return _finish_schur(S_sub, H_cc_safe, cam_mask)


def solve_reduced_chol(S_ic, b_c, cam_mask):
    """Direct solve of the IC-ordered reduced system by Cholesky.

    S is SPD by damping + identity rows for fixed cameras. Where it is not
    (the factorization fails), the solution is NaN, as JAX's Cholesky gives
    it: the trial cost is then NaN, `cost_try < cost` is false and the LM
    rejects the step and raises lambda. `cholesky_ex` reports the failure
    in a device tensor, so this neither raises nor syncs the host.

    b_c: [C,6] camera gradient. Returns dc [C,6].
    """
    C = b_c.shape[0]
    rhs = (b_c * cam_mask[:, None]).T.reshape(-1, 1)  # ic order
    L, info = torch.linalg.cholesky_ex(S_ic)
    x = torch.cholesky_solve(rhs, L)[:, 0]
    x = torch.where(info == 0, x, torch.nan)
    return x.reshape(6, C).T * cam_mask[:, None]

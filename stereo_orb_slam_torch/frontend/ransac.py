"""Batched RANSAC rigid-transform (stereo PnP) solver.

PyTorch counterpart of the JAX package's `frontend/ransac.py` (the
reference's absent `ransac_solver` submodule, call sites at ref
`src/visual_odometer.cpp:21-27,93-103,158-177`). It returns T with
X_prev = T @ X_curr, a per-pair inlier mask and per-pair losses.

All K hypotheses run at once as a batch dimension:
  1. K minimal sets of 3 pair indices come from a sampler, a callable
     valid -> [K, 3]; `gumbel_sampler` draws Gumbel top-3 from an explicit
     torch.Generator, as a `KeyedSampler` whose keys can be drawn apart
     from the selection (tests inject the JAX package's keys instead),
  2. Horn's quaternion alignment of each set ([K,4,4] by batched matmuls),
  3. every hypothesis scored against every pair by the max-abs stereo
     reprojection error,
  4. the most inliers win, ties broken by the smaller truncated loss; the
     first maximum wins, as `jnp.argmax` picks.

`solve` also takes S independent problems at once (the sequences of a
multi-sequence step, which the JAX package vmaps): every per-pair input
with a leading S axis and one sampler per sequence, so sequence s draws
from its own stream and gets the result it gets alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from stereo_orb_slam_torch.geometry import se3

Sampler = Callable[[torch.Tensor], torch.Tensor]


class RansacResult(NamedTuple):
    transform: torch.Tensor    # [4,4] T with X_prev = T @ X_curr
    inlier_mask: torch.Tensor  # [N] bool
    losses: torch.Tensor       # [N] float32 per-pair loss (px)
    num_inliers: torch.Tensor  # int32
    success: torch.Tensor      # bool


def kabsch(src, dst, weights=None):
    """Weighted rigid alignment, batched: T with dst ~ T @ src.

    src, dst: [..., M, 3]; weights: [..., M]. Returns [..., 4, 4]. Horn's
    method: the rotation quaternion is the top eigenvector of the symmetric
    4x4 N-matrix of the cross-covariance, found by 12 repeated squarings of
    the shifted, normalised matrix (an effective power of 4096).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    M = (sc * w[..., None]).transpose(-1, -2) @ dc  # [...,3,3] src x dst

    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)

    eye4 = torch.eye(4, dtype=N.dtype, device=N.device)
    fro = torch.sqrt(torch.sum(N * N, dim=(-2, -1), keepdim=True)) + 1e-12
    A = N / fro + 1.5 * eye4  # spectrum in (0.5, 2.5)
    for _ in range(12):
        A = A @ A
        A = A / (torch.sqrt(torch.sum(A * A, dim=(-2, -1), keepdim=True)) + 1e-20)
    # The column with the largest norm is parallel to the top eigenvector.
    col = torch.argmax(torch.sum(A * A, dim=-2), dim=-1)
    q = torch.gather(A, -1, col[..., None, None].expand(A.shape[:-1] + (1,)))[..., 0]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-20)
    R = se3.quat_to_rotmat(q)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return se3.rt_to_matrix(R, t)


def _project(ph, P):
    """Homogeneous points [S, ..., 4] through P: one [3, 4] for all, or
    [S, 3, 4], one per sequence (each sequence's rows in one product)."""
    if P.dim() == 2:
        return ph @ P.T
    S = ph.shape[0]
    return (ph.reshape(S, -1, 4) @ P.transpose(-1, -2)).reshape(ph.shape[:-1] + (3,))


def _stereo_residuals(T, pts_curr, obs_prev, P_l, P_r):
    """Predicted minus observed prev-frame stereo obs of curr-frame points
    under T: T [S, K, 4, 4], pts_curr [S, N, 3], obs_prev [S, N, 4]. Returns
    [S, K, N, 4]."""
    Xp = se3.transform_points(T, pts_curr[:, None])
    ph = torch.cat([Xp, torch.ones_like(Xp[..., :1])], dim=-1)
    uvw_l = _project(ph, P_l)
    uvw_r = _project(ph, P_r)
    wl = torch.where(torch.abs(uvw_l[..., 2:3]) < 1e-9, 1e-9, uvw_l[..., 2:3])
    wr = torch.where(torch.abs(uvw_r[..., 2:3]) < 1e-9, 1e-9, uvw_r[..., 2:3])
    pred = torch.cat([uvw_l[..., :2] / wl, uvw_r[..., :2] / wr], dim=-1)
    return pred - obs_prev[:, None]


def sets_from_keys(keys, valid):
    """[K, 3] distinct indices of the valid slots with the largest Gumbel
    keys [K, N] (`lax.top_k`'s order: ties, such as the -inf of invalid
    slots, to the lower index)."""
    g = torch.where(valid[None, :], keys, -torch.inf)
    return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :3]


class KeyedSampler:
    """A sampler whose randomness is a [K, N] array of Gumbel keys drawn
    apart from the slots: `keys(n, device)` draws them, and calling it on
    `valid` takes the top 3 of each row (`sets_from_keys`). A captured
    front-end step draws each frame's keys outside its graph into a static
    tensor and selects inside it, so its sets equal the eager call's bit
    for bit. `draw(n, device)` returns the keys; tests inject the JAX
    package's (`jax.random.gumbel` of the frame's key) this way."""

    def __init__(self, draw: Callable[[int, torch.device], torch.Tensor]):
        self.draw = draw

    def keys(self, n: int, device) -> torch.Tensor:
        return self.draw(n, torch.device(device))

    def __call__(self, valid):
        return sets_from_keys(self.keys(valid.shape[0], valid.device).to(valid.device), valid)


def gumbel_keys(generator: torch.Generator, num_hypotheses: int, n: int, device):
    """[K, n] standard Gumbel keys from `generator` (which lives on
    `device`): -log(-log(u)) of uniforms clamped away from 0."""
    u = torch.rand((num_hypotheses, n), generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def gumbel_sampler(generator: torch.Generator, num_hypotheses: int) -> KeyedSampler:
    """A sampler drawing [K, 3] distinct indices from the valid slots by
    Gumbel top-3 with `generator` (which lives on the slots' device). Ties,
    such as the -inf of invalid slots, go to the lower index."""
    return KeyedSampler(lambda n, device: gumbel_keys(generator, num_hypotheses, n, device))


def solve(
    sampler,
    pts_curr,
    pts_prev,
    obs_curr,
    obs_prev,
    valid,
    weights,
    P_l,
    P_r,
    inlier_threshold_px: float = 3.0,
    min_pairs: int = 10,
    min_inliers: int = 6,
    final_model_fitting: bool = False,
) -> RansacResult:
    """Batched RANSAC solve.

    Args:
      sampler: valid [N] bool -> [K, 3] indices of the minimal sets; for S
        problems, a sequence of S samplers (sequence s draws from its own).
      pts_curr: [N,3] triangulated points in the current camera frame.
      pts_prev: [N,3] the matched points in the previous camera frame.
      obs_curr/obs_prev: [N,4] stereo pixel observations (u_l,v_l,u_r,v_r).
      valid: [N] bool pair mask.
      weights: [N] per-pair weights (all ones in the reference, :175).
      P_l, P_r: [3,4] stereo projection matrices ([S, 3, 4] for one rig per
        sequence).

    With S problems every per-pair input has a leading S axis, and so has
    every field of the result.
    """
    if pts_curr.dim() == 2:
        out = _solve([sampler], pts_curr[None], pts_prev[None], obs_prev[None], valid[None],
                     weights[None], P_l, P_r, inlier_threshold_px, min_pairs, min_inliers,
                     final_model_fitting)
        return RansacResult(*(x[0] for x in out))
    return _solve(list(sampler), pts_curr, pts_prev, obs_prev, valid, weights, P_l, P_r,
                  inlier_threshold_px, min_pairs, min_inliers, final_model_fitting)


def _solve(samplers, pts_curr, pts_prev, obs_prev, valid, weights, P_l, P_r,
           inlier_threshold_px, min_pairs, min_inliers, final_model_fitting) -> RansacResult:
    """`solve` over S problems, every input with its leading S axis."""
    S = pts_curr.shape[0]
    if len(samplers) != S:
        raise ValueError(f"{len(samplers)} samplers for {S} problems")
    seq = torch.arange(S, device=pts_curr.device)
    n_valid = torch.sum(valid.to(torch.int32), dim=-1)
    sets = torch.stack([smp(v) for smp, v in zip(samplers, valid)]).long()  # [S,K,3]

    src = pts_curr[seq[:, None, None], sets]  # [S,K,3,3]
    Ts = kabsch(src, pts_prev[seq[:, None, None], sets])  # [S,K,4,4]
    # Degeneracy guard: collinear minimal sets give unstable rotations.
    areas = torch.linalg.vector_norm(
        torch.linalg.cross(src[..., 1, :] - src[..., 0, :], src[..., 2, :] - src[..., 0, :]),
        dim=-1)
    nondegenerate = areas > 1e-6

    def score(T):
        res = _stereo_residuals(T, pts_curr, obs_prev, P_l, P_r)
        err = torch.amax(torch.abs(res), dim=-1)
        inl = (err < inlier_threshold_px) & valid[:, None]
        loss = torch.where(valid[:, None],
                           torch.clamp(err, max=inlier_threshold_px) * weights[:, None], 0.0)
        return torch.sum(inl.to(torch.int32), dim=-1), torch.sum(loss, dim=-1), err, inl

    counts, losses_sum, errs, inls = score(Ts)
    counts = torch.where(nondegenerate, counts, -1)
    order_key = counts.to(torch.float32) - 1e-6 * losses_sum
    best = torch.argmax(order_key, dim=-1)

    T_best = Ts[seq, best]
    mask = inls[seq, best]
    err_best = errs[seq, best]
    num_inl = counts[seq, best]

    if final_model_fitting:
        w = mask.to(torch.float32) * weights
        T_refit = kabsch(pts_curr, pts_prev, w)
        cnt_r, _, err_r, inl_r = (x[:, 0] for x in score(T_refit[:, None]))
        # Keep the refit only if it does not lose inliers.
        better = cnt_r >= num_inl
        T_best = torch.where(better[:, None, None], T_refit, T_best)
        mask = torch.where(better[:, None], inl_r, mask)
        err_best = torch.where(better[:, None], err_r, err_best)
        num_inl = torch.maximum(num_inl, cnt_r)

    success = (n_valid >= min_pairs) & (num_inl >= min_inliers)
    eye = torch.eye(4, dtype=T_best.dtype, device=T_best.device)
    return RansacResult(
        transform=torch.where(success[:, None, None], T_best, eye),
        inlier_mask=mask & success[:, None],
        losses=torch.where(valid, err_best, 0.0),
        num_inliers=num_inl,
        success=success,
    )

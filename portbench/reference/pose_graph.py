"""The plain reference of a pose-graph solve, in float64.

The graph of the reference C++ (ref src/pose_graph_optimizer.cpp): a vertex
per frame (camera-to-world T), an edge (a, b) per odometry step and per loop
closure with the measurement Z (expected T_a^-1 T_b), the error of g2o's
EdgeSE3 ordered [translation, rotation] with the information I6 whose
translation block is 0.01 (ref :23-26), a Huber kernel of width 1, frame 0
held fixed (ref :61-65, 119-121), 10 iterations (ref :69).

Each edge's error is e = log(Z^-1 (T_a exp(d_a))^-1 (T_b exp(d_b))), the
SE(3) logarithm [rotation, translation] of the right increments d = [w, v]
(rotation first), reordered to [v, w]; its Jacobians come from forward-mode
differentiation of that expression, one edge at a time. The Huber kernel
weighs an edge by min(1, 1 / |e_w|) (e_w the whitened error: iteratively
reweighted least squares, as Ceres and g2o robustify), and a step solves
(J^T W J + damping I) d = -J^T W e over the free vertices, assembled
densely; each vertex then moves by T exp(d). The step's system is solved
either exactly (`linear="cholesky"`) or as the program's documentation
states its solve (`linear="pcg"`): conjugate gradients preconditioned by
the inverse of each vertex's 6 x 6 diagonal block, from zero, for
`cg_iterations` iterations or until |r| <= cg_tol |b|.

Departures from the reference C++, and why: Gauss-Newton with a fixed
damping, where the reference runs g2o's Levenberg; g2o's sparse Cholesky
becomes a dense one, or the program's truncated CG, whose 200 iterations
stop short of the exact step on a graph of thousands of vertices (the
benchmark's `correct` holds the program to the CG solve and reports its
distance from the exact one); the poses are not re-orthonormalised after a
step (float64 keeps them orthonormal to rounding; the program renormalises
in float32).

`dtype=torch.float32` computes the control: the same solve in float32.
Imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coefs(theta2):
    """sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3 of t^2 (Taylor near 0).
    Shapes keep a last axis: under forward mode, a 0-d float32 tensor and a
    Python number give a float64 tangent."""
    small = theta2 < 1e-6
    t = torch.sqrt(torch.where(small, 1.0, theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / torch.where(small, 1.0,
                                                                                   theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t * t * t))
    return a, b, c


def exp(xi):
    """SE(3) exponential of [w, v] (rotation first): R = exp(w), t = V v."""
    w, v = xi[..., :3], xi[..., 3:]
    a, b, c = (x[..., None] for x in _coefs((w * w).sum(-1, keepdim=True)))
    K = hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + a * K + b * (K @ K)
    t = ((eye + b * K + c * (K @ K)) @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], -1)
    return torch.cat([top, bottom], -2)


def log(T):
    """SE(3) logarithm [w, v] of rotations away from pi (the errors of a
    graph near its solution): w from the skew part through atan2, v = V^-1 t."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    s = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    cos = 0.5 * (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True) - 1.0)
    s2 = (s * s).sum(-1, keepdim=True)
    small = s2 < 1e-12
    sn = torch.sqrt(torch.where(small, 1.0, s2))
    scale = torch.where(small, 1.0 + s2 / 6.0, torch.atan2(sn, cos) / sn)
    w = s * scale
    theta2 = (w * w).sum(-1, keepdim=True)
    a, b, _ = _coefs(theta2)
    coef = torch.where(theta2 < 1e-6, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b)) / torch.where(theta2 < 1e-6, 1.0, theta2))
    K = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    v = ((eye - 0.5 * K + coef[..., None] * (K @ K)) @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ T[..., :3, 3:])], -1)
    return torch.cat([top, T[..., 3:, :]], -2)


def _edge_error(d, Ta, Tb, Z):
    """One edge's error [v, w] at the increments d = [d_a, d_b] (12)."""
    xi = log(inverse(Z) @ inverse(Ta @ exp(d[:6])) @ (Tb @ exp(d[6:])))
    return torch.cat([xi[3:], xi[:3]])


def terms(poses, a, b, Z, info_sqrt, huber):
    """Whitened, Huber-weighted errors [E, 6], Jacobians [E, 6, 12] and the
    robust cost 0.5 sum rho(|e_w|^2)."""
    Ta, Tb = poses[a], poses[b]
    zero = torch.zeros((len(a), 12), dtype=poses.dtype, device=poses.device)
    e = vmap(_edge_error)(zero, Ta, Tb, Z) * info_sqrt
    J = vmap(jacfwd(_edge_error))(zero, Ta, Tb, Z) * info_sqrt[:, None]
    s = (e * e).sum(-1)
    d2 = huber * huber
    root = torch.sqrt(torch.clamp(s, min=1e-300))
    rho = torch.where(s <= d2, s, 2.0 * huber * root - d2)
    weight = torch.sqrt(torch.where(s <= d2, 1.0, huber / root))
    return e * weight[:, None], J * weight[:, None, None], 0.5 * rho.sum()


def _cg(H, g, iterations: int, tol: float):
    """The solution of H d = g by conjugate gradients from zero,
    preconditioned by the inverse of H's 6 x 6 diagonal blocks: at most
    `iterations` steps, none once |r| <= tol |g|."""
    n = H.shape[0] // 6
    blocks = H.view(n, 6, n, 6).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    M = torch.linalg.inv(blocks)

    def precond(r):
        return (M @ r.view(n, 6, 1)).reshape(-1)

    x = torch.zeros_like(g)
    r = g.clone()
    z = precond(r)
    p, rz = z, r @ z
    stop = tol * torch.linalg.vector_norm(g)
    for _ in range(iterations):
        if torch.linalg.vector_norm(r) <= stop:
            break
        Hp = H @ p
        alpha = rz / torch.clamp(p @ Hp, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = r @ z
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
    return x


def solve(poses, edge_a, edge_b, edge_meas, iterations=10, info_translation=0.01,
          info_rotation=1.0, huber=1.0, damping=1e-6, fixed=(0,), dtype=torch.float64,
          linear="cholesky", cg_iterations=200, cg_tol=1e-8):
    """`iterations` damped Gauss-Newton steps over the graph (poses [n, 4, 4]
    camera-to-world, edges (a, b) with measurements [E, 4, 4]), the vertices
    in `fixed` held, each step's system solved by `linear` ("cholesky" or
    "pcg", see the module's docstring). Returns (poses [n, 4, 4] in
    `dtype`, the cost before the first step, before the last, and whether
    every factorisation succeeded)."""
    P = torch.as_tensor(poses).to(dtype)
    dev = P.device
    a = torch.as_tensor(edge_a, device=dev).long()
    b = torch.as_tensor(edge_b, device=dev).long()
    Z = torch.as_tensor(edge_meas).to(device=dev, dtype=dtype)
    n = P.shape[0]
    info_sqrt = torch.tensor([info_translation] * 3 + [info_rotation] * 3, dtype=dtype,
                             device=dev).sqrt()
    held = (torch.as_tensor(list(fixed), device=dev).long()[:, None] * 6
            + torch.arange(6, device=dev)).reshape(-1)
    costs, ok = [], True
    for _ in range(iterations):
        e, J, cost = terms(P, a, b, Z, info_sqrt, huber)
        costs.append(float(cost))
        # The dense system over all 6n unknowns: each edge's blocks at the
        # rows and columns of its two vertices; a held vertex's rows and
        # columns are the identity's, with no right-hand side.
        idx = torch.cat([a[:, None] * 6 + torch.arange(6, device=dev),
                         b[:, None] * 6 + torch.arange(6, device=dev)], 1)      # [E, 12]
        H = torch.zeros((6 * n, 6 * n), dtype=dtype, device=dev)
        H.index_put_((idx[:, :, None].expand(-1, -1, 12), idx[:, None, :].expand(-1, 12, -1)),
                     J.transpose(1, 2) @ J, accumulate=True)
        g = torch.zeros(6 * n, dtype=dtype, device=dev)
        g.index_put_((idx,), (J.transpose(1, 2) @ e[..., None])[..., 0], accumulate=True)
        H.diagonal().add_(damping)
        H[held] = 0.0
        H[:, held] = 0.0
        H[held, held] = 1.0
        g[held] = 0.0
        if linear == "pcg":
            d = _cg(H, -g, cg_iterations, cg_tol)
        else:
            L, info = torch.linalg.cholesky_ex(H)
            ok = ok and int(info) == 0
            d = torch.cholesky_solve(-g[:, None], L)[:, 0]
            del L
        del H
        P = P @ exp(d.view(n, 6))
    return P, costs[0], costs[-1], ok

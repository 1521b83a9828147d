"""Batched DLT triangulation without a host sync.

A hand kernel with no Pallas counterpart: the JAX package computes the
DLT (`geometry/camera.py::triangulate_dlt`) with `jnp.linalg.svd` inside
its jitted program. The plain version here is that body with
`torch.linalg.svd`, which on the card is cuSOLVER's batched SVD: it syncs
the host twice a call, and a sync is illegal in a captured CUDA graph. The
kernel, `stereo_orb_slam_torch/csrc/triangulate_dlt.cu`, takes the null
vector of each 4x4 system by a one-sided Jacobi SVD in float64, four lanes
per correspondence (one column each, the pairs of a round rotated at
once), and rounds the point once to float32.

`triangulate_dlt` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it raises for anything
else. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from stereo_orb_slam_torch.ops.kernels import _build

LAUNCHES = 0
_NAME = "triangulate_dlt"


def triangulate_dlt_plain(P1, P2, uv1, uv2):
    """The plain version: the 4x4 systems [..., N, 4, 4] of both views'
    rows (u P^3 - P^1, v P^3 - P^2), their right singular vectors of the
    smallest singular value by `torch.linalg.svd`, dehomogenised with
    |w| < 1e-12 taken as 1e-12. [..., N, 3]."""
    def rows(P, uv):
        r1 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r2 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r1, r2], dim=-2)  # [N,2,4]

    A = torch.cat([rows(P1, uv1), rows(P2, uv2)], dim=-2)  # [N,4,4]
    _, _, vt = torch.linalg.svd(A)
    Xh = vt[..., -1, :]
    w = Xh[..., 3:4]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / safe_w


_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,            # p1, p2, p_per_batch
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,     # uv1 and its strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,     # uv2 and its strides
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
)


def _problems(uv, lead, n):
    """uv [..., N, 2] as [B, N, 2] with its (batch, row) strides in floats,
    read in place (the innermost stride must be 1)."""
    if uv.stride(-1) != 1:
        raise ValueError("uv1 and uv2 need unit stride in their last axis")
    flat = uv.reshape(-1, n, 2) if len(lead) != 1 else uv
    if len(lead) > 1 and flat.data_ptr() != uv.data_ptr():
        raise ValueError("uv1 and uv2 must be viewable as [B, N, 2] in place")
    return flat, flat.stride(0), flat.stride(1)


def _per_batch(P, lead, n):
    """Whether P ([3, 4], or [..., 3, 4] broadcast against uv's [..., N])
    holds one projection per problem; raises for any other layout."""
    p_lead = tuple(P.shape[:-2])
    if all(d == 1 for d in p_lead):
        return False
    if len(p_lead) == len(lead) + 1 and p_lead[-1] == 1 and p_lead[:-1] == lead:
        return True
    raise ValueError(f"the kernel takes one projection per problem: P {tuple(P.shape)} "
                     f"against points {lead + (n,)}")


def _launch(P1, P2, uv1, uv2, work=False, source=None):
    global LAUNCHES
    lead, n = tuple(uv1.shape[:-2]), uv1.shape[-2]
    batch = math.prod(lead)
    per_batch = _per_batch(P1, lead, n)
    if _per_batch(P2, lead, n) != per_batch:
        raise ValueError("P1 and P2 must both be shared or both per problem")
    p1, p2 = (P.reshape(-1, 3, 4) for P in (P1, P2))
    if not (p1.is_contiguous() and p2.is_contiguous()):
        raise ValueError("P1 and P2 must be contiguous")
    a, s1b, s1n = _problems(uv1, lead, n)
    b, s2b, s2n = _problems(uv2, lead, n)
    dev = uv1.device
    out = torch.empty(lead + (n, 3), dtype=torch.float32, device=dev)
    counts = torch.zeros(lead + (n, 2), dtype=torch.int32, device=dev) if work else None
    if batch > 0 and n > 0:
        fn = _build.function(_NAME, "triangulate_dlt_launch", _ARGTYPES, source)
        err = fn(p1.data_ptr(), p2.data_ptr(), int(per_batch), a.data_ptr(), s1b, s1n,
                 b.data_ptr(), s2b, s2n, batch, n, out.data_ptr(),
                 None if counts is None else counts.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"triangulate_dlt kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    return out if counts is None else (out, counts)


def _check(P1, P2, uv1, uv2):
    """Checks; returns whether every tensor lies on the CPU."""
    for name, P in (("P1", P1), ("P2", P2)):
        if P.dim() < 2 or tuple(P.shape[-2:]) != (3, 4) or P.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 [..., 3, 4] tensor, got "
                             f"{P.dtype} {tuple(P.shape)}")
    for name, uv in (("uv1", uv1), ("uv2", uv2)):
        if uv.dim() < 2 or uv.shape[-1] != 2 or uv.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 [..., N, 2] tensor, got "
                             f"{uv.dtype} {tuple(uv.shape)}")
    if uv1.shape != uv2.shape:
        raise ValueError(f"uv1 {tuple(uv1.shape)} and uv2 {tuple(uv2.shape)} differ")
    devices = {x.device for x in (P1, P2, uv1, uv2)}
    if {d.type for d in devices} == {"cpu"}:
        return True
    if len(devices) != 1 or uv1.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    return False


def triangulate_dlt(P1, P2, uv1, uv2):
    """DLT triangulation of correspondences uv1, uv2 [..., N, 2] (float32)
    through projections P1, P2: [3, 4] shared by all, or [..., 1, 3, 4]
    with one per problem of uv's leading axes (a stacked rig's `P[:, None]`).
    Returns [..., N, 3] float32: on the CPU the plain version's points, on
    the card the kernel's (the float64 DLT rounded once), in one launch."""
    if _check(P1, P2, uv1, uv2):
        return triangulate_dlt_plain(P1, P2, uv1, uv2)
    return _launch(P1, P2, uv1, uv2)


def triangulate_dlt_work(P1, P2, uv1, uv2, work=True, source=None):
    """The kernel's launch of `triangulate_dlt` (CUDA tensors only), also
    returning each point's Jacobi sweeps and rotations, int32 [..., N, 2],
    unless `work` is false. `source` builds and launches another file with
    the kernel's C interface in place of csrc/triangulate_dlt.cu (an
    earlier design, to compare the two)."""
    if _check(P1, P2, uv1, uv2):
        raise ValueError("the sweep counts come from the kernel: CUDA tensors only")
    return _launch(P1, P2, uv1, uv2, work=work, source=source)

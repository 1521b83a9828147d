"""Fused Hamming distance + running top-2 over packed descriptors.

Hopper counterpart of the JAX package's TPU kernel
`ops/pallas/hamming.py::hamming_top2`; the CUDA source is
`stereo_orb_slam_torch/csrc/hamming_top2.cu`. Unlike the TPU kernel, which
takes +-1 bf16 sign matrices, this one takes the packed words themselves:
descriptors are int32 [N, 8] tensors holding the uint32 bit patterns
(bit j of word w = test 32w + j).

`hamming_top2` takes the plain version (`hamming_matrix` + `knn2`) for
tensors on the CPU and launches the kernel for tensors on a CUDA device; it
raises for anything else. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_orb_slam_torch.ops import orb
from stereo_orb_slam_torch.ops.kernels import _build

BITS = orb.N_TESTS  # 256
BIG = float(BITS + 1)
LAUNCHES = 0
_NAME = "hamming_top2"


def signs_from_packed(desc):
    """[N, 8] int32 words -> [N, 256] float32 in {-1, +1}."""
    return 2.0 * orb.unpack_bits(desc) - 1.0


def hamming_matrix(desc_q, desc_t, valid_q=None, valid_t=None):
    """[N, M] float32 Hamming distances, (256 - s_q . s_t) / 2 over the sign
    vectors; invalid rows or columns get 257. The float32 product of +-1
    values is exact: every partial sum is an integer below 2^24."""
    dot = signs_from_packed(desc_q) @ signs_from_packed(desc_t).T
    dist = 0.5 * (BITS - dot)
    if valid_q is not None:
        dist = torch.where(valid_q[:, None], dist, BIG)
    if valid_t is not None:
        dist = torch.where(valid_t[None, :], dist, BIG)
    return dist


def knn2(dist):
    """Per-row best and second best: (d1, idx1, d2), ties to the lower
    column index as `lax.top_k` resolves them (a stable ascending sort)."""
    vals, idx = torch.sort(dist, dim=1, stable=True)
    return vals[:, 0], idx[:, 0].to(torch.int32), vals[:, 1]


def hamming_top2_plain(desc_q, desc_t, valid_t):
    """The plain version: the full matrix, then a stable top-2."""
    return knn2(hamming_matrix(desc_q, desc_t, valid_t=valid_t))


def _launch(desc_q, desc_t, valid_t):
    global LAUNCHES
    n, m = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    d1 = torch.empty(n, dtype=torch.float32, device=dev)
    i1 = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return d1, i1, d2
    lib = _build.load(_NAME)
    fn = lib.hamming_top2_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(desc_q.data_ptr(), desc_t.data_ptr(), valid_t.data_ptr(), n, m,
             d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_top2 kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return d1, i1, d2


def hamming_top2(desc_q, desc_t, valid_t):
    """Top-2 Hamming match of every query row against the valid train rows.

    Args:
      desc_q: [N, 8] int32 packed query descriptors.
      desc_t: [M, 8] int32 packed train descriptors, M >= 2.
      valid_t: [M] bool; invalid train rows count as distance 257.

    Returns (d1 [N] float32, idx1 [N] int32, d2 [N] float32). Query-row
    validity is not applied here: the caller masks d1.
    """
    for name, d in (("desc_q", desc_q), ("desc_t", desc_t)):
        if d.dim() != 2 or d.shape[1] != 8 or d.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 [rows, 8] tensor, got "
                             f"{d.dtype} {tuple(d.shape)}")
    if valid_t.shape != (desc_t.shape[0],) or valid_t.dtype != torch.bool:
        raise ValueError("valid_t must be a bool [M] tensor")
    if desc_t.shape[0] < 2:
        raise ValueError("the train set needs at least two rows")
    devices = {desc_q.device, desc_t.device, valid_t.device}
    if {d.type for d in devices} == {"cpu"}:
        return hamming_top2_plain(desc_q, desc_t, valid_t)
    if len(devices) != 1 or desc_q.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    if not (desc_q.is_contiguous() and desc_t.is_contiguous() and valid_t.is_contiguous()):
        raise ValueError("desc_q, desc_t and valid_t must be contiguous")
    return _launch(desc_q, desc_t, valid_t)

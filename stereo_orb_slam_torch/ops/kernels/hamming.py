"""Fused Hamming distance + running top-2 over packed descriptors.

Hopper counterpart of the JAX package's TPU kernel
`ops/pallas/hamming.py::hamming_top2`; the CUDA source is
`stereo_orb_slam_torch/csrc/hamming_top2.cu`. Unlike the TPU kernel, which
takes +-1 bf16 sign matrices, this one takes the packed words themselves:
descriptors are int32 [N, 8] tensors holding the uint32 bit patterns
(bit j of word w = test 32w + j).

`hamming_top2` matches one query set against one train set,
`hamming_top2_pair` against two (a frame's stereo and temporal train sets
share the left descriptors as queries), both in one kernel launch. Both
also take a leading batch axis (B independent problems of one shape, the
sequences of a multi-sequence step) and then still launch once. They take
the plain version (`hamming_matrix` + `knn2`, batched the same way) for
tensors on the CPU and launch the kernel for tensors on a CUDA device;
they raise for anything else. `LAUNCHES` counts kernel launches.
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
    """[..., N, 8] int32 words -> [..., N, 256] float32 in {-1, +1}."""
    return 2.0 * orb.unpack_bits(desc) - 1.0


def hamming_matrix(desc_q, desc_t, valid_q=None, valid_t=None):
    """[..., N, M] float32 Hamming distances, (256 - s_q . s_t) / 2 over the
    sign vectors; invalid rows or columns get 257. The float32 product of
    +-1 values is exact: every partial sum is an integer below 2^24."""
    dot = signs_from_packed(desc_q) @ signs_from_packed(desc_t).transpose(-1, -2)
    dist = 0.5 * (BITS - dot)
    if valid_q is not None:
        dist = torch.where(valid_q[..., :, None], dist, BIG)
    if valid_t is not None:
        dist = torch.where(valid_t[..., None, :], dist, BIG)
    return dist


def knn2(dist):
    """Per-row best and second best: (d1, idx1, d2), ties to the lower
    column index as `lax.top_k` resolves them (a stable ascending sort)."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., 0], idx[..., 0].to(torch.int32), vals[..., 1]


def hamming_top2_plain(desc_q, desc_t, valid_t):
    """The plain version: the full matrix, then a stable top-2 (batched over
    any leading axes)."""
    return knn2(hamming_matrix(desc_q, desc_t, valid_t=valid_t))


_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,     # q, n, batch, sets
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,                # set 0
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,                # set 1
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs, stream
)


def _launch(desc_q, sets):
    """One kernel launch for the (desc_t, valid_t) pairs of `sets` (1 or 2)
    against desc_q, all [B, rows, ...]; returns one (d1, idx1, d2) triple of
    [B, N] tensors per set."""
    global LAUNCHES
    b, n, s = desc_q.shape[0], desc_q.shape[1], len(sets)
    dev = desc_q.device
    d1 = torch.empty((s, b, n), dtype=torch.float32, device=dev)
    i1 = torch.empty((s, b, n), dtype=torch.int32, device=dev)
    d2 = torch.empty((s, b, n), dtype=torch.float32, device=dev)
    if n > 0 and b > 0:
        (t0, v0), (t1, v1) = sets[0], sets[-1]
        fn = _build.function(_NAME, "hamming_top2_launch", _ARGTYPES)
        err = fn(desc_q.data_ptr(), n, b, s, t0.data_ptr(), v0.data_ptr(), t0.shape[1],
                 t1.data_ptr(), v1.data_ptr(), t1.shape[1], d1.data_ptr(), i1.data_ptr(),
                 d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"hamming_top2 kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    return list(zip(d1.unbind(), i1.unbind(), d2.unbind()))


def _check_desc(name, d, batched):
    if d.dim() != 2 + batched or d.shape[-1] != 8 or d.dtype != torch.int32:
        shape = "[B, rows, 8]" if batched else "[rows, 8]"
        raise ValueError(f"{name} must be an int32 {shape} tensor, got "
                         f"{d.dtype} {tuple(d.shape)}")


def _top2(desc_q, sets):
    """Checks, then the plain version (CPU tensors) or one launch (CUDA).
    A 2-D query set is one problem; a 3-D one a batch of them, with every
    train set and mask batched alike."""
    batched = desc_q.dim() == 3
    _check_desc("desc_q", desc_q, batched)
    for desc_t, valid_t in sets:
        _check_desc("desc_t", desc_t, batched)
        if valid_t.shape != desc_t.shape[:-1] or valid_t.dtype != torch.bool:
            raise ValueError("valid_t must be a bool tensor of desc_t's rows")
        if desc_t.shape[-2] < 2:
            raise ValueError("the train set needs at least two rows")
        if batched and desc_t.shape[0] != desc_q.shape[0]:
            raise ValueError("train sets and queries need the same batch size")
    tensors = [desc_q] + [x for pair in sets for x in pair]
    devices = {x.device for x in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return [hamming_top2_plain(desc_q, desc_t, valid_t) for desc_t, valid_t in sets]
    if len(devices) != 1 or desc_q.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("descriptors and validity masks must be contiguous")
    if batched:
        return _launch(desc_q, sets)
    out = _launch(desc_q[None], [(t[None], v[None]) for t, v in sets])
    return [tuple(x[0] for x in triple) for triple in out]


def hamming_top2(desc_q, desc_t, valid_t):
    """Top-2 Hamming match of every query row against the valid train rows.

    Args:
      desc_q: [N, 8] int32 packed query descriptors, or [B, N, 8] for a
        batch of B problems (one launch).
      desc_t: [M, 8] int32 packed train descriptors, M >= 2 ([B, M, 8]).
      valid_t: [M] bool ([B, M]); invalid train rows count as distance 257.

    Returns (d1 [N] float32, idx1 [N] int32, d2 [N] float32), each [B, N]
    when batched. Query-row validity is not applied here: the caller masks
    d1.
    """
    return _top2(desc_q, [(desc_t, valid_t)])[0]


def hamming_top2_pair(desc_q, desc_a, valid_a, desc_b, valid_b):
    """`hamming_top2` of one query set against two train sets, in one
    kernel launch on the card, batched or not as `hamming_top2`: returns
    ((d1, idx1, d2) against set a, (d1, idx1, d2) against set b). The plain
    version is two `hamming_top2_plain` calls."""
    return tuple(_top2(desc_q, [(desc_a, valid_a), (desc_b, valid_b)]))

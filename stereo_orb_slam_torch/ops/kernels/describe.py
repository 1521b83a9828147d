"""Upright ORB descriptors straight from the padded image, in one kernel.

Hopper counterpart of the JAX package's TPU kernel
`ops/pallas/patches.py::extract_patches_pallas` on the upright path,
fused with what `ops/orb.py` then does with the patches (the bf16 cast, the
[N, 1024] x [1024, 512] sampling product, the compare and the bit packing);
the CUDA source is `stereo_orb_slam_torch/csrc/orb_describe.cu`. The kernel
reads each of the 512 sample points' at most 4 bilinear taps from a compact
tap table (`tap_table`) instead of multiplying by the dense table.

`orb_describe` takes the plain version (the patch cut, the float32 product
with the dense table, the compare and `pack_bits`) for tensors on the CPU
and launches the kernel for tensors on a CUDA device; it raises for
anything else. It also takes a batch of images of one shape ([B, Hp, Wp]
with [B, N] corners) in one launch. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stereo_orb_slam_torch.ops import orb
from stereo_orb_slam_torch.ops.kernels import _build, patches

LAUNCHES = 0
TAPS = 4  # nonzero bilinear weights per sample point, at most
_NAME = "orb_describe"
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)
_taps: dict = {}


def tap_table(table):
    """The compact form of the upright table [1, P^2, 512]: (int16
    [512, TAPS] patch-pixel indices, float32 [512, TAPS] weights) on the
    table's device, row-major as the kernel reads them. Column s's nonzero
    entries come in ascending pixel index; unused taps are at weight 0 (on
    a pixel of weight 0). Weights are the table's own (bf16) values. Built
    once per table (the cache holds the table, so its id stays unique)."""
    entry = _taps.get(id(table))
    if entry is None:
        dense = table[0].float().cpu().numpy()
        nonzero = dense != 0
        if nonzero.sum(axis=0).max() > TAPS:
            raise ValueError(f"a sampling-table column has more than {TAPS} nonzero weights")
        idx = np.ascontiguousarray(np.argsort(~nonzero, axis=0, kind="stable")[:TAPS].T)
        weights = np.take_along_axis(dense.T, idx, axis=1)
        entry = (table, torch.from_numpy(idx.astype(np.int16)).to(table.device),
                 torch.from_numpy(np.ascontiguousarray(weights, np.float32)).to(table.device))
        _taps[id(table)] = entry
    return entry[1], entry[2]


def orb_describe_plain(padded, xy, valid, table):
    """The plain version: the bf16 patch cut at the rounded corners, the
    float32 product with the dense table, the compare and the packing, for
    one image or a batch ([B, Hp, Wp] with [B, N] corners, the rows of all
    images in one product)."""
    lead = xy.shape[:-1]
    flat = patches.extract_patches_plain(padded, *orb.window_starts(xy), orb.PATCH)
    vals = flat.reshape(-1, orb.PATCH * orb.PATCH).float() @ table[0].float()
    bits = (vals[:, :orb.N_TESTS] < vals[:, orb.N_TESTS:]).reshape(lead + (orb.N_TESTS,))
    return torch.where(valid[..., None], orb.pack_bits(bits), 0)


def _launch(padded, xy, valid, table):
    """One launch over the [B, Hp, Wp] images and their [B, N] corners."""
    global LAUNCHES
    b, n = valid.shape
    out = torch.empty((b, n, orb.N_WORDS), dtype=torch.int32, device=xy.device)
    if n == 0 or b == 0:
        return out
    idx, weights = tap_table(table)
    H, W = padded.shape[-2:]
    fn = _build.function(_NAME, "orb_describe_launch", _ARGTYPES)
    err = fn(padded.data_ptr(), b, H, W, xy.data_ptr(), valid.data_ptr(), n, idx.data_ptr(),
             weights.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(xy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_describe kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def orb_describe(padded, xy, valid, table):
    """Upright ORB descriptors at the corners.

    Args:
      padded: [H + 2 PATCH_R, W + 2 PATCH_R] float32 smoothed image padded
        by PATCH_R, or [B, ., .] for a batch of B images (one launch).
      xy: [N, 2] float32 corner coordinates (x, y) in the unpadded frame
        ([B, N, 2]); window starts are their round-half-to-even values.
      valid: [N] bool ([B, N]); invalid corners get 0 words.
      table: the upright bf16 sampling table [1, P^2, 512]
        (`orb.steer_table(False)`).

    Returns [N, 8] ([B, N, 8]) int32 packed descriptors (bit j of word w =
    test 32w + j).
    """
    P = orb.PATCH
    batched = padded.dim() == 3
    if padded.dim() not in (2, 3) or padded.dtype != torch.float32:
        raise ValueError(f"padded must be a [H, W] or [B, H, W] float32 tensor, got "
                         f"{padded.dtype} {tuple(padded.shape)}")
    if padded.shape[-2] < P or padded.shape[-1] < P:
        raise ValueError(f"image {tuple(padded.shape)} is smaller than a {P}x{P} patch")
    if xy.dim() != 2 + batched or xy.shape[-1] != 2 or xy.dtype != torch.float32:
        raise ValueError("xy must be a float32 [N, 2] tensor, [B, N, 2] for a batch")
    if batched and xy.shape[0] != padded.shape[0]:
        raise ValueError("xy needs one row of corners per image")
    if valid.shape != xy.shape[:-1] or valid.dtype != torch.bool:
        raise ValueError("valid must be a bool tensor of xy's corners")
    if table.shape != (1, P * P, 2 * orb.N_TESTS) or table.dtype != torch.bfloat16:
        raise ValueError(f"table must be the bf16 [1, {P * P}, {2 * orb.N_TESTS}] upright table")
    tensors = (padded, xy, valid, table)
    devices = {x.device for x in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return orb_describe_plain(padded, xy, valid, table)
    if len(devices) != 1 or xy.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("padded, xy, valid and table must be contiguous")
    if batched:
        return _launch(padded, xy, valid, table)
    return _launch(padded[None], xy[None], valid[None], table)[0]

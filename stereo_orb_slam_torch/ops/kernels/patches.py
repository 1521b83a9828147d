"""Batched patch cut at corner offsets, fused with the bf16 cast.

Hopper counterpart of the JAX package's TPU kernel
`ops/pallas/patches.py::extract_patches_pallas` plus the bf16 cast its
caller applies (`ops/orb.py:262`); the CUDA source is
`stereo_orb_slam_torch/csrc/extract_patches.cu`.

`extract_patches` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it raises for anything
else. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_orb_slam_torch.ops.kernels import _build

LAUNCHES = 0
_NAME = "extract_patches"


def extract_patches_plain(img, ys, xs, patch: int):
    """[N, patch, patch] bf16 windows of the f32 `img` with top-left corners
    (ys, xs). Starts are placed as lax.dynamic_slice places them: a negative
    start counts from the end, then the start is clamped into the image.
    An advanced-index gather and a cast."""
    H, W = img.shape
    ar = torch.arange(patch, device=img.device)
    ys, xs = ys.long(), xs.long()
    y0 = torch.clamp(torch.where(ys < 0, ys + H, ys), 0, H - patch)
    x0 = torch.clamp(torch.where(xs < 0, xs + W, xs), 0, W - patch)
    rows = (y0[:, None] + ar[None, :])[:, :, None]
    cols = (x0[:, None] + ar[None, :])[:, None, :]
    return img[rows, cols].to(torch.bfloat16)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)


def _launch(img, ys, xs, patch: int):
    global LAUNCHES
    n = ys.shape[0]
    H, W = img.shape
    out = torch.empty((n, patch, patch), dtype=torch.bfloat16, device=img.device)
    if n == 0:
        return out
    fn = _build.function(_NAME, "extract_patches_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = fn(img.data_ptr(), H, W, ys.data_ptr(), xs.data_ptr(), n, patch,
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"extract_patches kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def extract_patches(img, ys, xs, patch: int):
    """[N, patch, patch] bf16 patches of the f32 image `img` [H, W] with
    top-left corners (ys, xs) (int32 [N]), placed as lax.dynamic_slice
    places them (negative starts count from the end, then clamp)."""
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"img must be a 2-D float32 tensor, got {img.dtype} {tuple(img.shape)}")
    if ys.shape != xs.shape or ys.dim() != 1:
        raise ValueError("ys and xs must be 1-D tensors of one length")
    if ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise ValueError("ys and xs must be int32")
    if img.shape[0] < patch or img.shape[1] < patch:
        raise ValueError(f"image {tuple(img.shape)} is smaller than a {patch}x{patch} patch")
    devices = {img.device.type, ys.device.type, xs.device.type}
    if devices == {"cpu"}:
        return extract_patches_plain(img, ys, xs, patch)
    if devices != {"cuda"} or len({img.device, ys.device, xs.device}) != 1:
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    if not (img.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("img, ys and xs must be contiguous")
    return _launch(img, ys, xs, patch)

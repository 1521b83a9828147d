"""Batched patch cut at corner offsets, fused with the bf16 cast.

Hopper counterpart of the JAX package's TPU kernel
`ops/pallas/patches.py::extract_patches_pallas` plus the bf16 cast its
caller applies (`ops/orb.py:262`); the CUDA source is
`stereo_orb_slam_torch/csrc/extract_patches.cu`.

`extract_patches` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it raises for anything
else. It also takes a batch of images of one shape ([B, H, W] with [B, N]
starts) in one launch. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_orb_slam_torch.ops.kernels import _build

LAUNCHES = 0
_NAME = "extract_patches"


def extract_patches_plain(img, ys, xs, patch: int):
    """[..., N, patch, patch] bf16 windows of the f32 `img` [..., H, W] with
    top-left corners (ys, xs) [..., N]. Starts are placed as
    lax.dynamic_slice places them: a negative start counts from the end,
    then the start is clamped into the image. An advanced-index gather and
    a cast."""
    H, W = img.shape[-2:]
    ar = torch.arange(patch, device=img.device)
    ys, xs = ys.long(), xs.long()
    y0 = torch.clamp(torch.where(ys < 0, ys + H, ys), 0, H - patch)
    x0 = torch.clamp(torch.where(xs < 0, xs + W, xs), 0, W - patch)
    rows = (y0[..., None] + ar)[..., :, None]
    cols = (x0[..., None] + ar)[..., None, :]
    if img.dim() == 2:
        return img[rows, cols].to(torch.bfloat16)
    image = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[image, rows, cols].to(torch.bfloat16)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)


def _launch(img, ys, xs, patch: int):
    """One launch over the [B, H, W] images and their [B, N] starts."""
    global LAUNCHES
    b, n = ys.shape
    H, W = img.shape[-2:]
    out = torch.empty((b, n, patch, patch), dtype=torch.bfloat16, device=img.device)
    if n == 0 or b == 0:
        return out
    fn = _build.function(_NAME, "extract_patches_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = fn(img.data_ptr(), b, H, W, ys.data_ptr(), xs.data_ptr(), n, patch,
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"extract_patches kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def extract_patches(img, ys, xs, patch: int):
    """[N, patch, patch] bf16 patches of the f32 image `img` [H, W] with
    top-left corners (ys, xs) (int32 [N]), placed as lax.dynamic_slice
    places them (negative starts count from the end, then clamp). A batch
    of B images [B, H, W] with starts [B, N] gives [B, N, patch, patch], in
    one launch on the card."""
    batched = img.dim() == 3
    if img.dim() not in (2, 3) or img.dtype != torch.float32:
        raise ValueError(f"img must be a [H, W] or [B, H, W] float32 tensor, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if ys.shape != xs.shape or ys.dim() != 1 + batched:
        raise ValueError("ys and xs must be tensors of one shape, [N] or [B, N]")
    if batched and ys.shape[0] != img.shape[0]:
        raise ValueError("ys and xs need one row per image")
    if ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise ValueError("ys and xs must be int32")
    if img.shape[-2] < patch or img.shape[-1] < patch:
        raise ValueError(f"image {tuple(img.shape)} is smaller than a {patch}x{patch} patch")
    devices = {img.device.type, ys.device.type, xs.device.type}
    if devices == {"cpu"}:
        return extract_patches_plain(img, ys, xs, patch)
    if devices != {"cuda"} or len({img.device, ys.device, xs.device}) != 1:
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    if not (img.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("img, ys and xs must be contiguous")
    if batched:
        return _launch(img, ys, xs, patch)
    return _launch(img[None], ys[None], xs[None], patch)[0]

"""ORB descriptors straight from the padded image, each in one kernel.

Hopper counterparts of the JAX package's TPU kernel
`ops/pallas/patches.py::extract_patches_pallas` fused with what `ops/orb.py`
then does with the patches:

- upright (`orb_describe`, CUDA source
  `stereo_orb_slam_torch/csrc/orb_describe.cu`): the bf16 cast, the
  [N, 1024] x [1024, 512] sampling product, the compare and the bit
  packing;
- oriented (`orb_describe_oriented`, CUDA source
  `stereo_orb_slam_torch/csrc/orb_describe_oriented.cu`): the bf16 cast,
  the intensity-centroid angle, the soft-binned sampling through two of
  the 30 steered tables, the compare and the bit packing; it also returns
  the angle.

Both kernels read each of the 512 sample points' at most 4 bilinear taps
from a compact tap table (`tap_table`, `steered_tap_table`) instead of
multiplying by the dense table.

Each wrapper takes its plain version (the patch cut and the float32
products with the dense table, the compare and `pack_bits`) for tensors on
the CPU and launches its kernel for tensors on a CUDA device; it raises for
anything else. Both take a batch of images of one shape ([B, Hp, Wp] with
[B, N] corners) in one launch. `LAUNCHES` counts `orb_describe`'s kernel
launches, `ORIENTED_LAUNCHES` those of `orb_describe_oriented`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stereo_orb_slam_torch.ops import orb
from stereo_orb_slam_torch.ops.kernels import _build, patches

LAUNCHES = 0
ORIENTED_LAUNCHES = 0
TAPS = 4  # nonzero bilinear weights per sample point, at most
_NAME = "orb_describe"
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)
_ORIENTED_NAME = "orb_describe_oriented"
_ORIENTED_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p)
_taps: dict = {}


def _compact_taps(table, weight_dtype):
    """The compact form of a [K, P^2, 512] sampling table: (int16
    [K, 512, TAPS] patch-pixel indices, [K, 512, TAPS] weights) on the
    table's device, row-major as the kernels read them. Sample s's nonzero
    entries in bin k come in ascending pixel index; unused taps are at
    weight 0 (on a pixel of weight 0). Weights are the table's own (bf16)
    values. Built once per table and weight type (the cache holds the
    table, so its id stays unique)."""
    key = (id(table), weight_dtype)
    entry = _taps.get(key)
    if entry is None:
        dense = table.float().cpu().numpy().transpose(0, 2, 1)   # [K, 512, P^2]
        nonzero = dense != 0
        if nonzero.sum(axis=-1).max() > TAPS:
            raise ValueError(f"a sampling-table column has more than {TAPS} nonzero weights")
        idx = np.ascontiguousarray(np.argsort(~nonzero, axis=-1, kind="stable")[..., :TAPS])
        weights = np.ascontiguousarray(np.take_along_axis(dense, idx, axis=-1))
        entry = (table, torch.from_numpy(idx.astype(np.int16)).to(table.device),
                 torch.from_numpy(weights).to(device=table.device, dtype=weight_dtype))
        _taps[key] = entry
    return entry[1], entry[2]


def tap_table(table):
    """The compact form of the upright table [1, P^2, 512]: (int16
    [512, TAPS] patch-pixel indices, float32 [512, TAPS] weights), as
    `_compact_taps` builds them."""
    idx, weights = _compact_taps(table, torch.float32)
    return idx[0], weights[0]


def steered_tap_table(table):
    """The compact form of the steered table [K_BINS, P^2, 512]: (int16
    [K_BINS, 512, TAPS] patch-pixel indices, bf16 [K_BINS, 512, TAPS]
    weights), as `_compact_taps` builds them. bf16 holds the table's
    weights exactly, in 240 KB for both tensors."""
    return _compact_taps(table, torch.bfloat16)


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


def steered_words_from_patches(flat16, valid, table, orientation_radius: int = 15):
    """The oriented chain after the cut: flat16 [R, P^2] bf16 patches (the
    rows of every image), valid [...] with R corners in all. The angle from
    intensity-centroid moments over a disc, the two adjacent bins' weights,
    the 30 per-bin float32 products with the steered tables, the compare and
    the packing. Returns ([..., 8] int32 words, [...] float32 angles)."""
    lead = valid.shape
    k_bins = table.shape[0]
    n = flat16.shape[0]
    # Orientation from intensity-centroid moments over a disc; the moment
    # weights are small integers, exact in bf16.
    mom_k = orb._disc_masks(orientation_radius, flat16.device)
    moments = flat16.float() @ mom_k
    theta = torch.atan2(moments[:, 1], moments[:, 0])
    # Soft bin interpolation between the two adjacent steered tables.
    bin_f = theta * (k_bins / (2.0 * np.pi))
    k0f = torch.floor(bin_f)
    frac = bin_f - k0f
    k0 = torch.remainder(k0f.to(torch.int32), k_bins)
    k1 = torch.remainder(k0 + 1, k_bins)
    vals = torch.zeros((n, 2 * orb.N_TESTS), dtype=torch.float32, device=flat16.device)
    for k in range(k_bins):
        wk = (torch.where(k0 == k, 1.0 - frac, 0.0)
              + torch.where(k1 == k, frac, 0.0)).to(torch.bfloat16)
        vals = vals + (flat16 * wk[:, None]).float() @ table[k].float()

    bits = vals[:, :orb.N_TESTS] < vals[:, orb.N_TESTS:]
    desc = orb.pack_bits(bits).reshape(lead + (orb.N_WORDS,))
    return torch.where(valid[..., None], desc, 0), theta.reshape(lead)


def orb_describe_oriented_plain(padded, xy, valid, table, orientation_radius: int = 15):
    """The plain version: the bf16 patch cut at the rounded corners, then
    `steered_words_from_patches`, for one image or a batch ([B, Hp, Wp]
    with [B, N] corners, the rows of all images in each product)."""
    flat16 = patches.extract_patches_plain(padded, *orb.window_starts(xy), orb.PATCH)
    return steered_words_from_patches(flat16.reshape(-1, orb.PATCH * orb.PATCH), valid, table,
                                      orientation_radius)


def _launch_oriented(padded, xy, valid, table, orientation_radius):
    """One launch over the [B, Hp, Wp] images and their [B, N] corners."""
    global ORIENTED_LAUNCHES
    b, n = valid.shape
    out = torch.empty((b, n, orb.N_WORDS), dtype=torch.int32, device=xy.device)
    theta = torch.empty((b, n), dtype=torch.float32, device=xy.device)
    if n == 0 or b == 0:
        return out, theta
    idx, weights = steered_tap_table(table)
    H, W = padded.shape[-2:]
    radius2 = min(int(orientation_radius), 2 * orb.PATCH) ** 2  # past 2 P: the whole window
    fn = _build.function(_ORIENTED_NAME, "orb_describe_oriented_launch", _ORIENTED_ARGTYPES)
    err = fn(padded.data_ptr(), b, H, W, xy.data_ptr(), valid.data_ptr(), n, radius2,
             idx.data_ptr(), weights.data_ptr(), out.data_ptr(), theta.data_ptr(),
             torch.cuda.current_stream(xy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_describe_oriented kernel launch failed: cudaError {err}")
    ORIENTED_LAUNCHES += 1
    return out, theta


def orb_describe_oriented(padded, xy, valid, table, orientation_radius: int = 15):
    """Rotation-steered ORB descriptors at the corners, and their angles.

    Args:
      padded: [H + 2 PATCH_R, W + 2 PATCH_R] float32 smoothed image padded
        by PATCH_R, or [B, ., .] for a batch of B images (one launch).
      xy: [N, 2] float32 corner coordinates (x, y) in the unpadded frame
        ([B, N, 2]); window starts are their round-half-to-even values.
      valid: [N] bool ([B, N]); invalid corners get 0 words (and an angle).
      table: the steered bf16 sampling table [K_BINS, P^2, 512]
        (`orb.steer_table(True)`).
      orientation_radius: the radius of the moments' disc, centred at
        (PATCH_R, PATCH_R) of the window and cut to it.

    Returns ([N, 8] int32 packed descriptors (bit j of word w = test
    32w + j), [N] float32 angles in radians), with a leading [B] for a
    batch.
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
    if table.shape != (orb.K_BINS, P * P, 2 * orb.N_TESTS) or table.dtype != torch.bfloat16:
        raise ValueError(f"table must be the bf16 [{orb.K_BINS}, {P * P}, {2 * orb.N_TESTS}] "
                         f"steered table")
    if int(orientation_radius) != orientation_radius or orientation_radius < 0:
        raise ValueError(f"orientation_radius must be a whole number >= 0, got "
                         f"{orientation_radius}")
    tensors = (padded, xy, valid, table)
    devices = {x.device for x in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return orb_describe_oriented_plain(padded, xy, valid, table, orientation_radius)
    if len(devices) != 1 or xy.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("padded, xy, valid and table must be contiguous")
    if batched:
        return _launch_oriented(padded, xy, valid, table, orientation_radius)
    words, theta = _launch_oriented(padded[None], xy[None], valid[None], table,
                                    orientation_radius)
    return words[0], theta[0]

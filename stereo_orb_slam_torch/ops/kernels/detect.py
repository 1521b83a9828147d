"""Shi-Tomasi corner detection on the card: three kernels around one sort.

Hopper kernels for `ops/detect.py::detect_corners` (the JAX package's
`ops/detect.py::detect_corners`, XLA ops with no Pallas kernel); the CUDA
source is `stereo_orb_slam_torch/csrc/detect_corners.cu`. One call:

1. the response kernel: the raw min-eigenvalue response [S, H, W] and each
   block's maximum of it;
2. the NMS kernel: each image's peak from those, the jittered response's
   window maximum, the border, each tile's maximum and first argmax
   [S, n_tiles], and each block's largest kept raw response;
3. `torch.sort` of the tile maxima (stable, descending), as the plain
   version sorts them;
4. the refine kernel: one thread a slot, the slot's pixel, score, gates
   and subpixel offset (each image's largest kept raw response from the
   NMS blocks' maxima).

Every value equals the plain version's bit for bit (the same float32
operations in the same order). `detect_corners` takes the plain version,
`ops/detect.py::detect_corners_plain`, for tensors on the CPU and launches
the kernels for tensors on a CUDA device; it raises for anything else, and
for settings whose halo the kernels' shared memory does not hold
(`check_settings`). `LAUNCHES` counts kernel launches, 3 a call.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_orb_slam_torch.ops import detect
from stereo_orb_slam_torch.ops.kernels import _build

LAUNCHES = 0
_NAME = "detect_corners"
RESPONSE_TILE = 32        # the response kernel's output tile, as csrc/detect_corners.cu has it
NMS_SIDE = 32             # the NMS kernel's block side, cut down to a multiple of the tile
SHARED_BYTES = 48 * 1024 - 128  # without opt-in, less the static reduction buffer
_HASH_LIMIT = 2 ** 31     # the jitter's hash is int32 arithmetic
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RESPONSE_ARGTYPES = (_P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                      _P)
_REFINE_ARGTYPES = (_P, _I, _I, _I, _P, _P, _I, _P, _P, ctypes.c_longlong, _I, _P, _I, _I, _I,
                    _F, _I, _P, _P, _P, _P, _P)


def shared_bytes(block_size: int, min_distance: int):
    """(response kernel, NMS kernel) shared memory bytes a block."""
    r = block_size // 2
    n_in, n_p = RESPONSE_TILE + 2 * (r + 1), RESPONSE_TILE + 2 * r
    nr, tile = detect.nms_settings(min_distance)
    side = NMS_SIDE - NMS_SIDE % tile
    n_j = side + 2 * nr
    return (4 * (n_in * n_in + 3 * n_p * n_p + 3 * RESPONSE_TILE * n_p),
            4 * (n_j * n_j + side * n_j + side * side))


def check_settings(h: int, w: int, block_size: int, min_distance: int):
    """Raises ValueError for what the kernels do not take: a halo over the
    dynamic shared memory a block gets (block_size up to 13, an NMS
    radius, min_distance // 2, up to 29), an image too small for the
    filters (H and W above both halos, and at least 3), or one whose
    jitter hash overflows int32."""
    if block_size < 1:
        raise ValueError(f"block_size must be at least 1, got {block_size}")
    response, nms = shared_bytes(block_size, min_distance)
    if max(response, nms) > SHARED_BYTES:
        raise ValueError(
            f"block_size {block_size} and min_distance {min_distance} need {response} and "
            f"{nms} bytes of shared memory a block, over {SHARED_BYTES}: the kernels take "
            f"block_size <= 13 and an NMS radius (min_distance // 2) <= 29")
    halo = max(block_size // 2 + 1, detect.nms_settings(min_distance)[0])
    if min(h, w) < max(3, halo + 1):
        raise ValueError(f"image {h}x{w} is too small for halos of {halo} pixels")
    if (h - 1) * 7919 + (w - 1) * 104729 >= _HASH_LIMIT:
        raise ValueError(f"image {h}x{w} overflows the jitter's int32 hash")


def _launch(imgs, num_features, quality_level, block_size, min_distance, border,
            subpix) -> detect.Detection:
    global LAUNCHES
    S, H, W = imgs.shape
    dev = imgs.device
    nr, tile = detect.nms_settings(min_distance)
    side = NMS_SIDE - NMS_SIDE % tile
    n_th, n_tw = -(-H // tile), -(-W // tile)
    n_tiles = n_th * n_tw
    n_part = -(-H // side) * -(-W // side)   # the NMS kernel's blocks an image
    f32 = dict(dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    resp = torch.empty((S, H, W), **f32)
    part_r = torch.empty((S, -(-H // RESPONSE_TILE) * -(-W // RESPONSE_TILE)), **f32)
    peak = torch.empty((S,), **f32)
    part_n = torch.empty((S, n_part), **f32)
    tile_max = torch.empty((S, n_tiles), **f32)
    tile_arg = torch.empty((S, n_tiles), dtype=torch.int32, device=dev)
    fn = _build.function(_NAME, "detect_response_nms_launch", _RESPONSE_ARGTYPES)
    err = fn(imgs.data_ptr(), S, H, W, block_size // 2, 1.0 / float(block_size * block_size),
             nr, tile, side, border, resp.data_ptr(), part_r.data_ptr(), peak.data_ptr(),
             part_n.data_ptr(), tile_max.data_ptr(), tile_arg.data_ptr(), n_th, n_tw, stream)
    if err != 0:
        raise RuntimeError(f"detect_corners response/NMS launch failed: cudaError {err}")
    LAUNCHES += 2
    top_vals, top_idx = detect.top_k_stable(tile_max, num_features)
    n = top_vals.shape[-1]
    xy = torch.empty((S, n, 2), **f32)
    scores = torch.empty((S, n), **f32)
    valid = torch.empty((S, n), dtype=torch.bool, device=dev)
    max_resp = torch.empty((S,), **f32)
    fn = _build.function(_NAME, "detect_refine_launch", _REFINE_ARGTYPES)
    err = fn(resp.data_ptr(), S, H, W, peak.data_ptr(), part_n.data_ptr(), n_part,
             top_vals.data_ptr(), top_idx.data_ptr(), top_vals.stride(0), n,
             tile_arg.data_ptr(), tile, n_tiles, n_tw, quality_level, int(subpix),
             xy.data_ptr(), scores.data_ptr(), valid.data_ptr(), max_resp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"detect_corners refine launch failed: cudaError {err}")
    LAUNCHES += 1
    return detect.Detection(xy, scores, valid, resp, peak, tile_max, tile_arg, max_resp)


def detect_corners(imgs, num_features: int = 1024, quality_level: float = 0.01,
                   block_size: int = 5, min_distance: int = 10, border: int = 16,
                   subpix: bool = True) -> detect.Detection:
    """`ops/detect.py::detect_corners` of a batch of images [S, H, W]
    (float32) with its intermediates (`detect.Detection`): on the CPU the
    plain version, on the card the three kernels and the sort (`tile_arg`
    int32 there, int64 from the plain version's argmax)."""
    if imgs.dim() != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"imgs must be a [S, H, W] float32 tensor, got {imgs.dtype} "
                         f"{tuple(imgs.shape)}")
    args = (num_features, quality_level, block_size, min_distance, border, subpix)
    if imgs.device.type == "cpu":
        return detect.detect_corners_plain(imgs, *args)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    check_settings(imgs.shape[1], imgs.shape[2], block_size, min_distance)
    if imgs.shape[0] == 0:
        raise ValueError("imgs holds no image")
    return _launch(imgs, *args)

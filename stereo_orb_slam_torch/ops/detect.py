"""Shi-Tomasi corner detection, window NMS, top-K selection, subpixel refine.

PyTorch counterpart of the JAX package's `ops/detect.py` (the reference's
cv::goodFeaturesToTrack + cv::cornerSubPix, ref
`src/visual_odometer.cpp:232-242`). The filters are the same separable
shift-and-add passes with edge replication, in the same float32 order, so
the response map, and with it the corner slots, match the JAX package.

Slot order is part of the result (downstream code indexes by slot), so the
top-K keeps `lax.top_k`'s order: descending, ties to the lower index. A
stable descending sort gives exactly that; `torch.topk` does not promise it.

Every function takes one image [H, W] or a batch [S, H, W] of images of
one shape (the sequences of a multi-sequence step, where the JAX package
vmaps); each image's values are those it gets alone.

`detect_corners` runs `detect_corners_plain`, the shift-and-add passes
here, for tensors on the CPU, and three hand kernels around the same sort
for tensors on the card (`ops/kernels/detect.py`), with the same values bit
for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_orb_slam_torch.ops.kernels import detect as detect_kernel


class Detection(NamedTuple):
    """A batch's corners [S, ...] and the intermediates the card's kernels
    hand from one to the next."""
    xy: torch.Tensor        # [S, N, 2] float32 (x, y), 0 where invalid
    scores: torch.Tensor    # [S, N] raw response, 0 where invalid
    valid: torch.Tensor     # [S, N] bool
    response: torch.Tensor  # [S, H, W] raw response
    peak: torch.Tensor      # [S] its maximum
    tile_max: torch.Tensor  # [S, n_tiles] each tile's masked maximum, -inf where none
    tile_arg: torch.Tensor  # [S, n_tiles] its first argmax, row-major in the tile
    max_resp: torch.Tensor  # [S] largest kept raw response, at least 0


def _shift_y(img, d):
    """img shifted so out[y] = img[y+d], edge-replicated (rows are dim -2)."""
    if d == 0:
        return img
    if d > 0:
        edge = img[..., -1:, :].expand(img.shape[:-2] + (d, img.shape[-1]))
        return torch.cat([img[..., d:, :], edge], -2)
    edge = img[..., :1, :].expand(img.shape[:-2] + (-d, img.shape[-1]))
    return torch.cat([edge, img[..., :d, :]], -2)


def _shift_x(img, d):
    if d == 0:
        return img
    if d > 0:
        return torch.cat([img[..., d:], img[..., -1:].expand(img.shape[:-1] + (d,))], -1)
    return torch.cat([img[..., :1].expand(img.shape[:-1] + (-d,)), img[..., :d]], -1)


def sobel_gradients(img):
    """Sobel x/y gradients as separable shift-and-add passes."""
    sy = _shift_y(img, -1) + 2.0 * img + _shift_y(img, 1)
    ix = (_shift_x(sy, 1) - _shift_x(sy, -1)) * (0.5 / 4.0)
    sx = _shift_x(img, -1) + 2.0 * img + _shift_x(img, 1)
    iy = (_shift_y(sx, 1) - _shift_y(sx, -1)) * (0.5 / 4.0)
    return ix, iy


def _box_filter(img, k: int):
    """k x k box mean via two separable shift-add passes."""
    r = k // 2
    acc = img
    for d in range(1, r + 1):
        acc = acc + _shift_y(img, d) + _shift_y(img, -d)
    out = acc
    acc2 = out
    for d in range(1, r + 1):
        acc2 = acc2 + _shift_x(out, d) + _shift_x(out, -d)
    # XLA rewrites a division by a constant into a product with the float32
    # reciprocal; multiplying here rounds as the JAX package does.
    return acc2 * (1.0 / float(k * k))


def shi_tomasi_response(img, block_size: int = 5):
    """Min-eigenvalue corner response of the windowed structure tensor."""
    ix, iy = sobel_gradients(img)
    ixx = _box_filter(ix * ix, block_size)
    iyy = _box_filter(iy * iy, block_size)
    ixy = _box_filter(ix * iy, block_size)
    tr_half = 0.5 * (ixx + iyy)
    diff = ixx - iyy
    det_term = torch.sqrt(torch.clamp(0.25 * (diff * diff) + ixy * ixy, min=0.0))
    return tr_half - det_term


def _window_max_1d(x, radius: int, axis: int):
    """Running max over a (2r+1) window along an axis via doubling shifts."""
    shift = _shift_y if axis == 0 else _shift_x
    fwd = x
    span = 1
    while span <= radius:
        step = min(span, radius - span + 1)
        fwd = torch.maximum(fwd, shift(fwd, step))
        span += step
    bwd = x
    span = 1
    while span <= radius:
        step = min(span, radius - span + 1)
        bwd = torch.maximum(bwd, shift(bwd, -step))
        span += step
    return torch.maximum(fwd, bwd)


def nms(response, radius: int):
    """Keep pixels that are the max of their (2r+1)^2 neighbourhood."""
    pooled = _window_max_1d(response, radius, axis=0)
    pooled = _window_max_1d(pooled, radius, axis=1)
    return response >= pooled


def _gather2d(img, ys, xs):
    """img[..., ys, xs] per image: img [S, H, W], ys/xs [S, N] -> [S, N]."""
    W = img.shape[-1]
    return torch.gather(img.reshape(img.shape[0], -1), 1, ys * W + xs)


def subpixel_refine(response, ys, xs):
    """Quadratic-fit subpixel offset from the 3x3 response neighbourhood;
    the peak offset -H^-1 g is clamped to [-0.5, 0.5] per axis. response
    [S, H, W], ys/xs [S, N] (int64)."""
    H, W = response.shape[-2:]
    ys_c = torch.clamp(ys, 1, H - 2)
    xs_c = torch.clamp(xs, 1, W - 2)

    def at(dy, dx):
        return _gather2d(response, ys_c + dy, xs_c + dx)

    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    gxx = at(0, 1) - 2.0 * at(0, 0) + at(0, -1)
    gyy = at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)
    gxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = gxx * gyy - gxy * gxy
    safe_det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    dx = -(gyy * gx - gxy * gy) / safe_det
    dy = -(gxx * gy - gxy * gx) / safe_det
    ok = (torch.abs(det) > 1e-12) & (torch.abs(dx) <= 1.0) & (torch.abs(dy) <= 1.0)
    dx = torch.where(ok, torch.clamp(dx, -0.5, 0.5), 0.0)
    dy = torch.where(ok, torch.clamp(dy, -0.5, 0.5), 0.0)
    return dy, dx


def top_k_stable(values, k: int):
    """`lax.top_k` over the last axis: the k largest, descending, ties to
    the lower index."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_settings(min_distance: int):
    """(NMS radius, tile side) of `min_distance`: a tile narrower than the
    radius holds at most one NMS survivor."""
    nms_radius = max(1, min_distance // 2)
    return nms_radius, min(4, nms_radius)


def detect_corners(
    img,
    num_features: int = 1024,
    quality_level: float = 0.01,
    block_size: int = 5,
    min_distance: int = 10,
    border: int = 16,
    subpix: bool = True,
):
    """Detect up to `num_features` Shi-Tomasi corners.

    Args:
      img: [H, W] float32 grayscale, or [S, H, W] (each image on its own).
      border: exclusion margin so descriptor patches stay in bounds.

    Returns (with the leading S axis for a batch):
      xy:    [num_features, 2] float32 (x, y) subpixel coords.
      score: [num_features] response values.
      valid: [num_features] bool mask (score above quality gate).
    """
    batched = img.dim() == 3
    det = detect_kernel.detect_corners(img if batched else img[None], num_features,
                                       quality_level, block_size, min_distance, border, subpix)
    out = det.xy, det.scores, det.valid
    return out if batched else tuple(x[0] for x in out)


def detect_corners_plain(imgs, num_features: int, quality_level: float, block_size: int,
                         min_distance: int, border: int, subpix: bool) -> Detection:
    """`detect_corners` of [S, H, W] images in PyTorch ops, with its
    intermediates (a tile of 1 has the masked response as its maxima, at
    argmax 0)."""
    resp_raw = shi_tomasi_response(imgs, block_size)
    S, H, W = resp_raw.shape
    dev = imgs.device

    # Deterministic tie-breaking jitter for NMS and ordering only; the
    # scores and the quality gate use the raw response.
    yy = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    hash_pat = ((yy * 7919 + xx * 104729) % 65521).to(torch.float32) * (1.0 / 65521.0)
    peak = torch.amax(resp_raw, dim=(-2, -1), keepdim=True)
    resp = resp_raw + hash_pat * (1e-5 * torch.clamp(peak, min=1e-12))

    nms_radius, tile = nms_settings(min_distance)
    keep = nms(resp, nms_radius)
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    masked = torch.where(keep & in_border, resp, -torch.inf)

    # Hierarchical top-k: NMS survivors are more than nms_radius apart, so a
    # tile narrower than the radius holds at most one; sort the tile maxima.
    if tile > 1:
        Hp = -(-H // tile) * tile
        Wp = -(-W // tile) * tile
        padded = torch.nn.functional.pad(
            masked, (0, Wp - W, 0, Hp - H), value=-torch.inf
        )
        tiles = padded.reshape(S, Hp // tile, tile, Wp // tile, tile)
        tiles = tiles.permute(0, 1, 3, 2, 4).reshape(S, -1, tile * tile)
        tile_max = torch.amax(tiles, dim=-1)
        # argmax returns the first maximum, as jnp.argmax does.
        tile_arg = torch.argmax(tiles, dim=-1)
        top_vals, tidx = top_k_stable(tile_max, num_features)
        n_wt = Wp // tile
        ty = tidx // n_wt
        tx = tidx % n_wt
        within = torch.gather(tile_arg, 1, tidx)
        ys = ty * tile + within // tile
        xs = tx * tile + within % tile
    else:
        tile_max = masked.reshape(S, -1)
        tile_arg = torch.zeros_like(tile_max, dtype=torch.int64)
        top_vals, idx = top_k_stable(tile_max, num_features)
        ys = idx // W
        xs = idx % W
    scores = _gather2d(resp_raw, ys, xs)

    max_resp = torch.amax(torch.where(keep & in_border, resp_raw, 0.0), dim=(-2, -1))[:, None]
    valid = (
        torch.isfinite(top_vals)
        & (scores > quality_level * max_resp)
        & (scores > 1e-6)
        & (max_resp > 0)
    )

    if subpix:
        dy, dx = subpixel_refine(resp, ys, xs)
    else:
        dy = dx = torch.zeros_like(scores)

    xy = torch.stack([xs.to(torch.float32) + dx, ys.to(torch.float32) + dy], dim=-1)
    xy = torch.where(valid[..., None], xy, 0.0)
    return Detection(xy, torch.where(valid, scores, 0.0), valid, resp_raw, peak[:, 0, 0],
                     tile_max, tile_arg, max_resp[:, 0])

"""ORB (BRIEF) descriptor extraction on tensors.

PyTorch counterpart of the JAX package's `ops/orb.py` (the reference's
cv::ORB::compute on the detected corners, ref
`src/visual_odometer.cpp:256-259`):

- the image is smoothed with the separable binomial filter and padded by
  PATCH_R with edge replication,
- upright (the default): `kernels/describe.py::orb_describe` cuts a
  32 x 32 bf16 window around every corner, reads the 256 binary tests
  through the precomputed bilinear sampling table (built from the same
  seeded NumPy pattern) and packs the bits. On the card that is one CUDA
  kernel; on the CPU its plain version: the patch cut, one
  [N, P^2] @ [P^2, 512] product, the compare and `pack_bits`,
- oriented (`oriented=True`): `kernels/describe.py::orb_describe_oriented`
  cuts the same window, takes the intensity-centroid angle over a disc,
  soft-bins it between two of the K_BINS steered tables, reads the 256
  tests through those two bins' taps and packs the bits. On the card that
  is one CUDA kernel; on the CPU its plain version: the patch cut, the
  moments product, atan2 and 30 per-bin products with the dense steered
  tables, the compare and `pack_bits`,
- bits are packed into 8 words per descriptor (bit j of word w = test
  32w + j). torch's uint32 cannot shift, so the words are int32 tensors
  holding the uint32 bit patterns; `.view(np.uint32)` converts at the
  host boundary.

The sampling product runs in float32 on bf16 values upcast exactly (torch
returns bf16 for a bf16 product, and that rounding would flip bits). Every
product of two bf16 values is exact in float32 and in TF32 alike (a bf16
mantissa fits in both), so the descriptors do not depend on
`torch.backends.cuda.matmul.allow_tf32`; only the summation order can
differ from the JAX package's, in the last bit of near-tied sums. (The VO
app keeps TF32 off for the sake of RANSAC's products.)
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_orb_slam_torch.ops.detect import _shift_x, _shift_y
from stereo_orb_slam_torch.ops.kernels import describe as describe_kernel
from stereo_orb_slam_torch.ops.kernels import patches as patch_kernel

N_TESTS = 256
N_WORDS = N_TESTS // 32
PATTERN_RADIUS = 13   # max test-point radius (a disc, so rotation keeps it)
PATCH_R = 15          # covers rotated tests (+-14) and the orientation disc
PATCH = 2 * PATCH_R + 2  # 32
K_BINS = 30           # orientation bins of the steered tables (12 degrees)


def _binomial_kernel(ksize: int) -> np.ndarray:
    k = np.array([1.0], np.float32)
    for _ in range(ksize - 1):
        k = np.convolve(k, [0.5, 0.5])
    return k.astype(np.float32)


def make_test_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 2, 2] float32: (pair, point{a,b}, (dx, dy)) BRIEF test offsets,
    Gaussian (sigma = 31/5) and clipped to a disc of radius PATTERN_RADIUS."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(N_TESTS, 2, 2)).astype(np.float32)
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, PATTERN_RADIUS / np.maximum(norm, 1e-6))
    return pts * scale


def _make_steer_tables(k_bins: int = K_BINS) -> np.ndarray:
    """[k_bins, PATCH*PATCH, 512] float32 bilinear-weight selection matrices.
    Columns [0, 256) sample point "a" of each test, [256, 512) point "b"."""
    pat = make_test_pattern()
    G = np.zeros((k_bins, PATCH * PATCH, 2 * N_TESTS), np.float32)
    for k in range(k_bins):
        th = 2.0 * np.pi * k / k_bins
        c, s = np.cos(th), np.sin(th)
        for point in range(2):
            dx = pat[:, point, 0]
            dy = pat[:, point, 1]
            x = np.clip(PATCH_R + c * dx - s * dy, 0, PATCH - 1.001)
            y = np.clip(PATCH_R + s * dx + c * dy, 0, PATCH - 1.001)
            x0 = np.floor(x).astype(np.int64)
            y0 = np.floor(y).astype(np.int64)
            ax = x - x0
            ay = y - y0
            cols = np.arange(N_TESTS) + point * N_TESTS
            for (yy, xx, w) in (
                (y0, x0, (1 - ay) * (1 - ax)),
                (y0, np.minimum(x0 + 1, PATCH - 1), (1 - ay) * ax),
                (np.minimum(y0 + 1, PATCH - 1), x0, ay * (1 - ax)),
                (np.minimum(y0 + 1, PATCH - 1),
                 np.minimum(x0 + 1, PATCH - 1), ay * ax),
            ):
                np.add.at(G[k], (yy * PATCH + xx, cols), w)
    return G


_tables: dict = {}


def steer_table(oriented: bool, device="cuda"):
    """The bf16 sampling table on `device`: [1, P^2, 512] upright, or
    [K_BINS, P^2, 512] steered (about 30 MB, built on first request)."""
    key = (bool(oriented), torch.device(device))
    if key not in _tables:
        G = _make_steer_tables(K_BINS if oriented else 1)
        _tables[key] = torch.from_numpy(G).to(device=device, dtype=torch.bfloat16)
    return _tables[key]


def smooth_image(img, ksize: int = 7):
    """Separable binomial (~Gaussian) smoothing, edge-replicated."""
    k = _binomial_kernel(ksize)
    r = ksize // 2
    out_y = float(k[r]) * img
    for d in range(1, r + 1):
        out_y = out_y + float(k[r + d]) * _shift_y(img, d)
        out_y = out_y + float(k[r - d]) * _shift_y(img, -d)
    out = float(k[r]) * out_y
    for d in range(1, r + 1):
        out = out + float(k[r + d]) * _shift_x(out_y, d)
        out = out + float(k[r - d]) * _shift_x(out_y, -d)
    return out


_masks: dict = {}


def _disc_masks(radius: int, device):
    """Moment kernels over the patch grid, centred at (PATCH_R, PATCH_R):
    [P^2, 2] float32 (dx and dy inside the disc, 0 outside), built once per
    radius and device (so that no host copy runs inside a CUDA graph)."""
    key = (int(radius), torch.device(device))
    if key not in _masks:
        ys, xs = np.mgrid[0:PATCH, 0:PATCH]
        ys = ys - PATCH_R
        xs = xs - PATCH_R
        disc = (xs * xs + ys * ys) <= radius * radius
        mom = np.stack([(xs * disc).reshape(-1), (ys * disc).reshape(-1)], axis=1)
        _masks[key] = torch.from_numpy(mom.astype(np.float32)).to(device)
    return _masks[key]


def pad_edge(img, r: int = PATCH_R):
    """Pad a [..., H, W] image (or batch of images) by r on every side,
    replicating the edge."""
    H, W = img.shape[-2:]
    flat = img.reshape(-1, 1, H, W)
    out = torch.nn.functional.pad(flat, (r, r, r, r), mode="replicate")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def window_starts(xy):
    """(ys, xs) int32 top-left corners, in the image padded by PATCH_R, of
    the windows centred on the corners xy [..., N, 2] (original image
    frame): the coordinates rounded half to even, as `jnp.round` rounds."""
    return torch.round(xy[..., 1]).to(torch.int32), torch.round(xy[..., 0]).to(torch.int32)


def extract_patches(smoothed_padded, xy):
    """[..., N, PATCH, PATCH] bf16 patches at the rounded corner positions.

    `smoothed_padded` is the float32 smoothed image padded by PATCH_R (or a
    batch of them); xy are coordinates in the original image frame.
    """
    return patch_kernel.extract_patches(smoothed_padded, *window_starts(xy), PATCH)


def pack_bits(bits):
    """[..., 256] bool -> [..., 8] int32 words holding the uint32 bit
    patterns (bit j of word w = test 32w + j). Built in int64, so bit 31
    cannot overflow, then narrowed to the same 32-bit pattern."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(bits.shape[:-1] + (N_WORDS, 32)).to(torch.int64) * weights,
                      dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(words):
    """[..., 8] int32 words -> [..., 256] {0,1} float32. Arithmetic shifts
    keep bit 31's value, so the int32 view of a uint32 word unpacks to its
    bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (N_TESTS,)).to(torch.float32)


def compute_descriptors(img, xy, valid, smoothing_ksize: int = 7,
                        orientation_radius: int = 15, steer=None):
    """ORB descriptors at the given corners, of one image or a batch of
    images of one shape (a leading axis on every argument); a batch takes
    one describe launch on the card.

    Args:
      img:   [H, W] float32 grayscale, or [S, H, W].
      xy:    [N, 2] float32 corner coords (x, y), or [S, N, 2].
      valid: [N] bool, or [S, N].
      steer: the sampling table of `steer_table` (upright when None); a
        one-bin table takes the fused upright describe, the steered table
        the fused oriented describe.

    Returns:
      desc:  [..., N, 8] int32 packed 256-bit descriptors (0 where invalid).
      angle: [..., N] float32 orientation (radians; 0 when upright).
    """
    if steer is None:
        steer = steer_table(False, img.device)
    padded = pad_edge(smooth_image(img, smoothing_ksize))
    if steer.shape[0] == 1:
        theta = torch.zeros(xy.shape[:-1], dtype=torch.float32, device=img.device)
        return describe_kernel.orb_describe(padded, xy, valid, steer), theta
    return describe_kernel.orb_describe_oriented(padded, xy, valid, steer, orientation_radius)

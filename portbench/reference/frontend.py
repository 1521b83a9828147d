"""The plain reference of one stereo frame of visual odometry.

A frozen copy, in plain PyTorch, of the semantics of the port's per-frame
front end (`VisualOdometer.track`): Shi-Tomasi corners with window NMS,
the stable top-K and the quadratic subpixel fit; upright ORB (BRIEF)
descriptors from the binomially smoothed image through the bilinear
sampling table of the seeded test pattern; brute-force Hamming top-2 with
the distance and ratio gates; triangulation (the rectified closed form, or
undistortion and the DLT in float64); the temporal match against the
previous frame's slots; RANSAC over the frame's Gumbel keys with Horn's
alignment. It imports nothing of the program and takes nothing the program
made: the sampling table, the projections and the RANSAC keys are worked out
here from the configuration and the seed.

`precision="low"` computes the control: every stage one step below the
precision the configuration states (bfloat16 for the elementwise float32
stages, the describe's sampling product rounded to bfloat16, the DLT in
float32 for float64, the Horn products in TF32).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

N_TESTS = 256
N_WORDS = 8
PATTERN_RADIUS = 13
PATCH_R = 15
PATCH = 2 * PATCH_R + 2
BITS = 256
BIG = float(BITS + 1)


# ------------------------------------------------------------------ corners
def _shift_y(img, d):
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


def _response(img, block_size):
    """Min-eigenvalue response of the box-windowed structure tensor of the
    Sobel gradients (edges replicated)."""
    sy = _shift_y(img, -1) + 2.0 * img + _shift_y(img, 1)
    ix = (_shift_x(sy, 1) - _shift_x(sy, -1)) * (0.5 / 4.0)
    sx = _shift_x(img, -1) + 2.0 * img + _shift_x(img, 1)
    iy = (_shift_y(sx, 1) - _shift_y(sx, -1)) * (0.5 / 4.0)

    def box(a):
        r = block_size // 2
        acc = a
        for d in range(1, r + 1):
            acc = acc + _shift_y(a, d) + _shift_y(a, -d)
        out = acc
        acc2 = out
        for d in range(1, r + 1):
            acc2 = acc2 + _shift_x(out, d) + _shift_x(out, -d)
        return acc2 * (1.0 / float(block_size * block_size))

    ixx, iyy, ixy = box(ix * ix), box(iy * iy), box(ix * iy)
    tr_half = 0.5 * (ixx + iyy)
    diff = ixx - iyy
    return tr_half - torch.sqrt(torch.clamp(0.25 * (diff * diff) + ixy * ixy, min=0.0))


def _window_max(x, radius, shift):
    out = []
    for sign in (1, -1):
        acc, span = x, 1
        while span <= radius:
            step = min(span, radius - span + 1)
            acc = torch.maximum(acc, shift(acc, sign * step))
            span += step
        out.append(acc)
    return torch.maximum(*out)


def _gather(img, ys, xs):
    return img.reshape(-1)[ys * img.shape[-1] + xs]


def _subpixel(resp, ys, xs):
    H, W = resp.shape
    ys_c = torch.clamp(ys, 1, H - 2)
    xs_c = torch.clamp(xs, 1, W - 2)

    def at(dy, dx):
        return _gather(resp, ys_c + dy, xs_c + dx)

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


def detect(img, num_features, quality_level, block_size, min_distance, border=16):
    """Up to `num_features` corners of one image [H, W] (float32, or
    bfloat16 for the control): (xy [N, 2] float32, valid [N]). Slots in
    descending response, ties to the lower index; NMS survivors are more
    than the radius apart, so each tile of side min(4, radius) holds at most
    one and the tile maxima are ranked."""
    resp_raw = _response(img, block_size)
    H, W = resp_raw.shape
    dev = img.device
    yy = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    hash_pat = ((yy * 7919 + xx * 104729) % 65521).to(torch.float32) * (1.0 / 65521.0)
    peak = torch.amax(resp_raw)
    resp = resp_raw + hash_pat.to(resp_raw.dtype) * (1e-5 * torch.clamp(peak, min=1e-12))
    radius = max(1, min_distance // 2)
    keep = resp >= _window_max(_window_max(resp, radius, _shift_y), radius, _shift_x)
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    masked = torch.where(keep & in_border, resp, -torch.inf)
    tile = min(4, radius)
    Hp, Wp = -(-H // tile) * tile, -(-W // tile) * tile
    padded = torch.nn.functional.pad(masked[None], (0, Wp - W, 0, Hp - H),
                                     value=-torch.inf)[0]
    tiles = padded.reshape(Hp // tile, tile, Wp // tile, tile).permute(0, 2, 1, 3)
    tiles = tiles.reshape(-1, tile * tile)
    tile_max = torch.amax(tiles, dim=-1)
    tile_arg = torch.argmax(tiles, dim=-1)
    vals, tidx = torch.sort(tile_max, descending=True, stable=True)
    top_vals, tidx = vals[:num_features], tidx[:num_features]
    n_wt = Wp // tile
    within = tile_arg[tidx]
    ys = (tidx // n_wt) * tile + within // tile
    xs = (tidx % n_wt) * tile + within % tile
    scores = _gather(resp_raw, ys, xs)
    max_resp = torch.amax(torch.where(keep & in_border, resp_raw, 0.0))
    valid = (torch.isfinite(top_vals) & (scores > quality_level * max_resp)
             & (scores > 1e-6) & (max_resp > 0))
    dy, dx = _subpixel(resp, ys, xs)
    xy = torch.stack([xs.to(torch.float32) + dx.float(), ys.to(torch.float32) + dy.float()], -1)
    return torch.where(valid[:, None], xy, 0.0), valid


# -------------------------------------------------------------- descriptors
def _pattern(seed=1234):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(N_TESTS, 2, 2)).astype(np.float32)
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    return pts * np.minimum(1.0, PATTERN_RADIUS / np.maximum(norm, 1e-6))


def sampling_table(device):
    """[P^2, 512] bfloat16 bilinear weights of the upright test points
    (columns [0, 256) point a of each test, [256, 512) point b)."""
    pat = _pattern()
    G = np.zeros((PATCH * PATCH, 2 * N_TESTS), np.float32)
    for point in range(2):
        x = np.clip(PATCH_R + pat[:, point, 0], 0, PATCH - 1.001)
        y = np.clip(PATCH_R + pat[:, point, 1], 0, PATCH - 1.001)
        x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
        ax, ay = x - x0, y - y0
        cols = np.arange(N_TESTS) + point * N_TESTS
        x1, y1 = np.minimum(x0 + 1, PATCH - 1), np.minimum(y0 + 1, PATCH - 1)
        for yy, xx, w in ((y0, x0, (1 - ay) * (1 - ax)), (y0, x1, (1 - ay) * ax),
                          (y1, x0, ay * (1 - ax)), (y1, x1, ay * ax)):
            np.add.at(G, (yy * PATCH + xx, cols), w)
    return torch.from_numpy(G).to(device=device, dtype=torch.bfloat16)


def _smooth(img, ksize):
    k = np.array([1.0], np.float32)
    for _ in range(ksize - 1):
        k = np.convolve(k, [0.5, 0.5])
    k = k.astype(np.float32)
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


def pack_bits(bits):
    """[..., 256] bool -> [..., 8] int32 words (bit j of word w = test 32w + j)."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(bits.shape[:-1] + (N_WORDS, 32)).to(torch.int64) * weights,
                      dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(words):
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (N_TESTS,))


def describe(img, xy, valid, table, ksize, low=False):
    """[N, 8] int32 descriptors at corners xy of image img [H, W]: the 32 x
    32 bfloat16 window of the smoothed, edge-padded image at the rounded
    corner, its float32 product with the table, a < b per test."""
    sm = _smooth(img, ksize)
    H, W = sm.shape
    padded = torch.nn.functional.pad(sm[None, None], (PATCH_R,) * 4, mode="replicate")[0, 0]
    Hp, Wp = padded.shape
    ys = torch.round(xy[:, 1]).to(torch.int64)
    xs = torch.round(xy[:, 0]).to(torch.int64)
    y0 = torch.clamp(torch.where(ys < 0, ys + Hp, ys), 0, Hp - PATCH)
    x0 = torch.clamp(torch.where(xs < 0, xs + Wp, xs), 0, Wp - PATCH)
    ar = torch.arange(PATCH, device=img.device)
    flat = padded[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]
    flat = flat.to(torch.bfloat16).reshape(-1, PATCH * PATCH)
    if low:
        vals = flat @ table
    else:
        vals = flat.float() @ table.float()
    bits = vals[:, :N_TESTS] < vals[:, N_TESTS:]
    return torch.where(valid[:, None], pack_bits(bits), 0)


# ----------------------------------------------------------------- matching
def top2(desc_q, desc_t, valid_t):
    """(d1, idx1, d2): each query row's best and second-best Hamming
    distance over the valid train rows (257 elsewhere), ties to the lower
    index."""
    sq = 2.0 * unpack_bits(desc_q).float() - 1.0
    st = 2.0 * unpack_bits(desc_t).float() - 1.0
    dist = 0.5 * (BITS - sq @ st.T)
    dist = torch.where(valid_t[None, :], dist, BIG)
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[:, 0], idx[:, 0], vals[:, 1]


def gate(top, valid_q, max_distance, ratio):
    d1, idx1, d2 = top
    d1 = torch.where(valid_q, d1, BIG)
    ok = (d1 < max_distance) & (d1 / torch.clamp(d2, min=1e-6) < ratio) & valid_q & (d1 <= BITS)
    return idx1, ok


# ------------------------------------------------------------ triangulation
def undistort(uv, fx, fy, cx, cy, dist, iterations=8):
    """Fixed-point inversion of the radial-tangential model in float32."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=uv.device)  # noqa: E731
    fx, fy, cx, cy = f32(fx), f32(fy), f32(cx), f32(cy)
    k1, k2, p1, p2, k3 = (f32(v) for v in dist)
    x0 = (uv[:, 0] - cx) / fx
    y0 = (uv[:, 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def triangulate_rectified(uv_l, uv_r, fx, cx, cy, cx_r, baseline, max_depth, low=False):
    dt = torch.bfloat16 if low else torch.float32
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=uv_l.device).to(dt)  # noqa: E731
    fx, cx, cy, cx_r, b = t(fx), t(cx), t(cy), t(cx_r), t(baseline)
    uv_l, uv_r = uv_l.to(dt), uv_r.to(dt)
    u, v = uv_l[:, 0], uv_l[:, 1]
    dd = uv_l[:, 0] - uv_r[:, 0] - (cx - cx_r)
    safe_dd = torch.where(torch.abs(dd) < 1e-6, 1e-6, dd)
    z = fx * b / safe_dd
    pts = torch.stack([(u - cx) * z / fx, (v - cy) * z / fx, z], dim=-1).float()
    return pts, (pts[:, 2] > 0.0) & (pts[:, 2] < max_depth)


def triangulate_dlt(P1, P2, uv1, uv2, max_depth, low=False):
    """The DLT's null vector by SVD in float64 (float32 for the control),
    rounded once to float32; valid where 0 < z < max_depth (the left camera
    is the rig's origin)."""
    dt = torch.float32 if low else torch.float64
    P1, P2, uv1, uv2 = (x.to(dt) for x in (P1, P2, uv1, uv2))
    A = torch.stack([uv1[:, :1] * P1[2] - P1[0], uv1[:, 1:] * P1[2] - P1[1],
                     uv2[:, :1] * P2[2] - P2[0], uv2[:, 1:] * P2[2] - P2[1]], dim=1)
    Xh = torch.linalg.svd(A)[2][:, -1, :]
    w = Xh[:, 3:]
    pts = (Xh[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)).float()
    return pts, (pts[:, 2] > 0.0) & (pts[:, 2] < max_depth)


# ------------------------------------------------------------------- RANSAC
def frame_seed(seed: int, frame: int) -> int:
    """The RANSAC seed of frame `frame` of a stream seeded with `seed`."""
    return (seed * 0x9E3779B1 + frame) % (1 << 63)


def gumbel_keys(seed: int, frame: int, num_hypotheses: int, n: int, device):
    """[K, n] standard Gumbel keys of the frame, drawn on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(frame_seed(seed, frame))
    u = torch.rand((num_hypotheses, n), generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def _quat_to_rotmat(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def _rt(R, t):
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def horn(src, dst, weights=None):
    """T with dst ~ T @ src, batched over leading axes: the top eigenvector
    of Horn's 4 x 4 matrix by 12 normalised squarings of its shifted form."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    M = ((src - mu_s[..., None, :]) * w[..., None]).transpose(-1, -2) @ (dst - mu_d[..., None, :])
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    eye4 = torch.eye(4, dtype=N.dtype, device=N.device)
    A = N / (torch.sqrt(torch.sum(N * N, dim=(-2, -1), keepdim=True)) + 1e-12) + 1.5 * eye4
    for _ in range(12):
        A = A @ A
        A = A / (torch.sqrt(torch.sum(A * A, dim=(-2, -1), keepdim=True)) + 1e-20)
    col = torch.argmax(torch.sum(A * A, dim=-2), dim=-1)
    q = torch.gather(A, -1, col[..., None, None].expand(A.shape[:-1] + (1,)))[..., 0]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-20)
    R = _quat_to_rotmat(q)
    return _rt(R, mu_d - (R @ mu_s[..., None])[..., 0])


def _transform(T, pts):
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3][..., None, :]


def ransac(keys, pts_curr, pts_prev, obs_prev, valid, P_l, P_r, threshold, min_pairs,
           min_inliers):
    """Gumbel top-3 minimal sets from `keys` [K, N], Horn on each, every
    hypothesis scored by the max-abs stereo reprojection error; the most
    inliers win, ties to the smaller truncated loss, then the first. Returns
    (T [4, 4], inlier mask [N], success)."""
    pts_curr, pts_prev, obs_prev, valid = (x[None] for x in (pts_curr, pts_prev, obs_prev,
                                                               valid))
    g = torch.where(valid[0][None, :], keys, -torch.inf)
    sets = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :3][None]
    seq = torch.zeros(1, dtype=torch.int64, device=keys.device)
    src = pts_curr[seq[:, None, None], sets]
    Ts = horn(src, pts_prev[seq[:, None, None], sets])
    areas = torch.linalg.vector_norm(
        torch.linalg.cross(src[..., 1, :] - src[..., 0, :], src[..., 2, :] - src[..., 0, :]),
        dim=-1)
    weights = torch.ones(valid.shape, dtype=torch.float32, device=keys.device)

    def score(T):
        Xp = _transform(T, pts_curr[:, None])
        ph = torch.cat([Xp, torch.ones_like(Xp[..., :1])], dim=-1)
        uvw_l, uvw_r = ph @ P_l.T, ph @ P_r.T
        wl = torch.where(torch.abs(uvw_l[..., 2:3]) < 1e-9, 1e-9, uvw_l[..., 2:3])
        wr = torch.where(torch.abs(uvw_r[..., 2:3]) < 1e-9, 1e-9, uvw_r[..., 2:3])
        res = torch.cat([uvw_l[..., :2] / wl, uvw_r[..., :2] / wr], dim=-1) - obs_prev[:, None]
        err = torch.amax(torch.abs(res), dim=-1)
        inl = (err < threshold) & valid[:, None]
        loss = torch.where(valid[:, None], torch.clamp(err, max=threshold) * weights[:, None],
                           0.0)
        return torch.sum(inl.to(torch.int32), dim=-1), torch.sum(loss, dim=-1), inl

    counts, losses, inls = score(Ts)
    counts = torch.where(areas > 1e-6, counts, -1)
    best = torch.argmax(counts.to(torch.float32) - 1e-6 * losses, dim=-1)
    T_best, mask, num = Ts[seq, best], inls[seq, best], counts[seq, best]
    success = (torch.sum(valid.to(torch.int32), dim=-1) >= min_pairs) & (num >= min_inliers)
    eye = torch.eye(4, dtype=T_best.dtype, device=T_best.device)
    T = torch.where(success[:, None, None], T_best, eye)
    return T[0], (mask & success[:, None])[0], bool(success[0])


# -------------------------------------------------------------------- frame
def empty_slots(n: int, device) -> dict:
    """The slots of no frame: nothing valid (the start of a stream)."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"kp_l": z(n, 2), "kp_r": z(n, 2), "desc": z(n, N_WORDS, dtype=torch.int32),
            "pts": z(n, 3), "valid": z(n, dtype=torch.bool)}


class Rig:
    """The stereo rig as the configuration states it, with the projections
    worked out here: left camera at the origin, right one at x = baseline."""

    def __init__(self, cfg, device):
        self.fx, self.fy, self.cx, self.cy = (float(cfg[k]) for k in ("fx", "fy", "cx", "cy"))
        self.baseline = float(cfg["baseline_m"])
        self.rectified = bool(cfg["rectified"])
        self.dist = [float(v) for v in cfg.get("dist", [0.0] * 5)]
        self.max_depth = np.float32(self.fx) * np.float32(self.baseline)
        K34 = np.array([[self.fx, 0.0, self.cx, 0.0], [0.0, self.fy, self.cy, 0.0],
                        [0.0, 0.0, 1.0, 0.0]], np.float32)
        pose_r = np.eye(4, dtype=np.float32)
        pose_r[0, 3] = self.baseline
        self.P_l = torch.from_numpy(K34).to(device)
        self.P_r = torch.from_numpy(K34 @ np.linalg.inv(pose_r)).to(device)


def frame(img_l, img_r, prev, keys, rig: Rig, fe: dict, rc: dict, table, low=False):
    """One frame of the front end from the raw uint8 pair [H, W] (tensors on
    the device), the previous frame's slots `prev` (dict: kp_l, kp_r, pts,
    desc, valid) and the frame's RANSAC keys [K, N]. Returns a dict of the
    frame's slots (kp_l, kp_r, desc, pts, valid), its temporal match
    (prev_idx, t_ok, tracked), the pose T [4, 4], success and num_stereo."""
    dt = torch.bfloat16 if low else torch.float32
    nf, q, bs, md = fe["num_features"], fe["quality_level"], fe["block_size"], fe["min_distance"]
    ks = fe["smoothing_ksize"]
    sides = []
    for img in (img_l, img_r):
        xy, v = detect(img.to(dt), nf, q, bs, md)
        sides.append((xy, v, describe(img.to(dt), xy, v, table, ks, low)))
    (xy_l, v_l, d_l), (xy_r, v_r, d_r) = sides
    r_idx, s_ok = gate(top2(d_l, d_r, v_r), v_l, fe["match_max_distance"], fe["match_ratio"])
    kp_r = xy_r[r_idx]
    kp_l = xy_l
    if rig.rectified:
        pts, tri_ok = triangulate_rectified(kp_l, kp_r, rig.fx, rig.cx, rig.cy, rig.cx,
                                            rig.baseline, rig.max_depth, low)
    else:
        kp_l = undistort(kp_l, rig.fx, rig.fy, rig.cx, rig.cy, rig.dist)
        kp_r = undistort(kp_r, rig.fx, rig.fy, rig.cx, rig.cy, rig.dist)
        pts, tri_ok = triangulate_dlt(rig.P_l, rig.P_r, kp_l, kp_r, rig.max_depth, low)
    depth_ok = torch.abs(pts[:, 2]) < rig.max_depth
    valid = v_l & s_ok & tri_ok & depth_ok
    pts = torch.where(valid[:, None], pts, 0.0)
    num_stereo = int(valid.sum())

    prev_idx, t_ok = gate(top2(d_l, prev["desc"], prev["valid"]), valid,
                          fe["match_max_distance"], fe["match_ratio"])
    pi = prev_idx.long()
    obs_prev = torch.cat([prev["kp_l"], prev["kp_r"]], dim=-1)[pi]
    tf32 = _tf32() if low else contextlib.nullcontext()
    with tf32:
        T, inl, success = ransac(keys, pts, prev["pts"][pi], obs_prev, t_ok, rig.P_l, rig.P_r,
                                 rc["inlier_threshold_px"], rc["min_pairs"],
                                 rc["min_inliers"])
    if num_stereo < fe["min_stereo_matches"]:
        T, success = torch.eye(4, device=T.device), False
    return {"kp_l": kp_l, "kp_r": kp_r, "desc": d_l, "pts": pts, "valid": valid,
            "prev_idx": prev_idx, "t_ok": t_ok, "tracked": inl & t_ok, "T": T,
            "success": success, "num_stereo": num_stereo}


@contextlib.contextmanager
def _tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old

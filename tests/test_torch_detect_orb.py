"""Port parity: ops/detect.py, the patch cut and ops/orb.py against the JAX
package, on PlaneScene frames at 240x320 with 256 features.

Tolerances:
- detection: `valid` identical and `xy` in the same slot order, within one
  float32 ulp of the coordinate (at most 3.1e-5 px at these widths). The
  filters are the same float32 passes, but XLA's CPU backend contracts
  some `a*b + c` into fused multiply-adds, so some response values differ
  in the last bit; that moves a subpixel offset by less than the
  coordinate's own float32 resolution, and the sum lands on the same or
  the neighbouring float. A 1e-5 px bound would be finer than a float32
  coordinate above 128 px can resolve.
- the patch cut: bit for bit (a copy and a round-to-nearest-even cast).
- descriptors: packed words identical on these frames (exact bf16 products,
  float32 sums in another order, no near-tie flips a bit here).
- sampling tables: bit for bit, and the compact tap table of the fused
  upright describe, scattered back to dense, bit for bit too.
- the fused describe's arithmetic, modelled here in its order (each
  sample's <= 4 exact bf16 products added in float32 in ascending pixel
  index, from 0): packed words identical to the plain chain (the dense
  float32 product) on these frames and on random images.
- the detector's three kernels (csrc/detect_corners.cu), modelled here in
  their order in NumPy float32 (clamped coordinates in place of shifted
  copies, clipped-window maxima in place of doubling shifts, the jitter
  recomputed per pixel, the first argmax per tile, the refine per slot):
  every output and intermediate bit for bit equal to the plain
  shift-and-add version, on these frames and on random images with flat
  patches and lattice textures (NMS ties, all -inf tiles and ties in the
  sort all occur).
The kernel-against-plain comparisons are in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402
from synth_detect import detect_images  # noqa: E402

from stereo_orb_slam_tpu.ops import detect as rdet, orb as rorb  # noqa: E402
from stereo_orb_slam_tpu.ops.pallas.patches import extract_patches_pallas  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.ops import detect as pdet, orb as porb  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import describe as dk, patches as pk  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import detect as detk  # noqa: E402

torch.set_num_threads(1)
N_FEAT = 256


@pytest.fixture(scope="module")
def frames():
    scene = PlaneScene(np.random.default_rng(7))
    return [scene.render(0.0), scene.render(0.0, right=True), scene.render(0.35)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_detect_corners_matches_reference(frames, k):
    img = frames[k]
    xy_r, s_r, v_r = rdet.detect_corners(jnp.asarray(img), num_features=N_FEAT)
    xy_p, s_p, v_p = pdet.detect_corners(_t(img), num_features=N_FEAT)
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    assert v_p.sum() > 100
    np.testing.assert_array_max_ulp(xy_p.numpy(), np.asarray(xy_r), maxulp=1)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-5)


def test_top_k_stable_ties_to_lower_index():
    vals = torch.tensor([1.0, 3.0, 3.0, -torch.inf, 3.0, 2.0, -torch.inf])
    v, i = pdet.top_k_stable(vals, 6)
    assert i.tolist() == [1, 2, 4, 5, 0, 3]


def _alignment_cases(rng):
    H, W = 96, 512
    ys, xs = [], []
    for dy in (0, 1, 7, 8, 15):
        for dx in (0, 1, 127, 128, 129, 255):
            ys.append(16 + dy)
            xs.append(min(dx, W - 32))
    while len(ys) % 8:
        ys.append(0)
        xs.append(0)
    img = rng.normal(size=(H, W)).astype(np.float32)
    return img, np.asarray(ys, np.int32), np.asarray(xs, np.int32)


def test_patch_cut_plain_matches_pallas_and_reference(rng):
    img, ys, xs = _alignment_cases(rng)
    pallas = np.asarray(extract_patches_pallas(jnp.asarray(img), jnp.asarray(ys),
                                               jnp.asarray(xs), 32, interpret=True))
    port = pk.extract_patches(_t(img), _t(ys), _t(xs), 32)
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(jnp.asarray(pallas).astype(jnp.bfloat16),
                                             np.float32))
    # The reference's plain cut takes rounded (x, y) and the bf16 image.
    xy = np.stack([xs, ys], 1).astype(np.float32)
    ref = rorb.extract_patches(jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(xy))
    np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref, np.float32))
    via_orb = porb.extract_patches(_t(img), _t(xy))
    assert torch.equal(via_orb, port)


def test_patch_cut_clamps_like_dynamic_slice(rng):
    img = rng.normal(size=(40, 50)).astype(np.float32)
    ys = np.array([-5, 0, 8, 30, 100], np.int32)
    xs = np.array([-1, 18, 3, 40, 7], np.int32)
    ref = np.stack([np.asarray(jax.lax.dynamic_slice(jnp.asarray(img), (y, x), (32, 32)))
                    for y, x in zip(ys, xs)])
    port = pk.extract_patches(_t(img), _t(ys), _t(xs), 32)
    np.testing.assert_array_equal(port.float().numpy(),
                                  ref.astype(jnp.bfloat16).astype(np.float32))
    with pytest.raises(ValueError):
        pk.extract_patches(_t(img[:20]), _t(ys), _t(xs), 32)


def test_sampling_tables_match_reference():
    np.testing.assert_array_equal(porb.make_test_pattern(), rorb.make_test_pattern())
    up = porb.steer_table(False, "cpu")
    assert up.dtype == torch.bfloat16 and up.shape == (1, 32 * 32, 512)
    np.testing.assert_array_equal(up.float().numpy(), np.asarray(rorb._UPRIGHT, np.float32))
    steered = porb.steer_table(True, "cpu")
    np.testing.assert_array_equal(steered.float().numpy(),
                                  np.asarray(rorb.steer_table(True), np.float32))
    assert torch.equal(convert.table_from_numpy(np.asarray(rorb._UPRIGHT), "cpu"), up)


def test_pack_unpack_bits(rng):
    bits = rng.random((16, 256)) < 0.5
    bits[:, 31::32] = True  # bit 31 of every word: the int32 sign bit
    ref = np.asarray(rorb.pack_bits(jnp.asarray(bits)))
    port = porb.pack_bits(_t(bits))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(porb.unpack_bits(port).numpy(),
                                  np.asarray(rorb.unpack_bits(jnp.asarray(ref))))
    assert torch.equal(convert.desc_to_tensor(ref, "cpu"), port)


@pytest.mark.parametrize("oriented", [False, True])
def test_descriptors_match_reference(frames, oriented):
    img = frames[2]
    xy, _, v = rdet.detect_corners(jnp.asarray(img), num_features=N_FEAT)
    d_ref, th_ref = rorb.compute_descriptors(jnp.asarray(img), xy, v,
                                             steer=rorb.steer_table(oriented))
    d_port, th_port = porb.compute_descriptors(_t(img), _t(xy), _t(v),
                                               steer=porb.steer_table(oriented, "cpu"))
    np.testing.assert_array_equal(d_port.numpy().view(np.uint32), np.asarray(d_ref))
    np.testing.assert_allclose(th_port.numpy(), np.asarray(th_ref), atol=1e-4)


def test_compact_taps_scatter_back_to_the_upright_table():
    table = porb.steer_table(False, "cpu")
    idx, w = dk.tap_table(table)
    assert idx.dtype == torch.int16 and w.dtype == torch.float32
    assert idx.shape == w.shape == (2 * porb.N_TESTS, dk.TAPS)
    assert idx.is_contiguous() and w.is_contiguous()  # the kernel reads row-major
    dense = torch.zeros(porb.PATCH * porb.PATCH, 2 * porb.N_TESTS)
    cols = torch.arange(2 * porb.N_TESTS)[:, None].expand(-1, dk.TAPS)
    dense.index_put_((idx.long(), cols), w, accumulate=True)
    assert torch.equal(dense.to(torch.bfloat16), table[0])
    assert torch.equal(dense, table[0].float())
    # Nonzero taps first, in ascending pixel index; padding at weight 0.
    nz = w != 0
    assert torch.all(nz[:, :-1] | ~nz[:, 1:])
    assert torch.all((idx[:, 1:] > idx[:, :-1]) | ~nz[:, 1:])
    assert int(nz.sum(1).min()) >= 1


def _tap_sum_model(padded, xy, valid):
    """The fused kernel's arithmetic in its order: bf16 window values times
    the tap weights (exact in float32), added from 0 in ascending pixel
    index, one rounding per add (what fmaf gives for an exact product)."""
    n = xy.shape[0]
    idx, w = dk.tap_table(porb.steer_table(False, "cpu"))
    xi = torch.round(xy[:, 0]).to(torch.int32)
    yi = torch.round(xy[:, 1]).to(torch.int32)
    flat = pk.extract_patches_plain(padded, yi, xi, porb.PATCH).reshape(n, -1).float()
    acc = torch.zeros(n, 2 * porb.N_TESTS)
    for k in range(dk.TAPS):
        acc = acc + flat[:, idx[:, k].long()] * w[:, k]
    bits = acc[:, :porb.N_TESTS] < acc[:, porb.N_TESTS:]
    return torch.where(valid[:, None], porb.pack_bits(bits), 0)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_tap_sum_model_matches_plain_chain_on_frames(frames, k):
    img = _t(frames[k])
    xy, _, v = pdet.detect_corners(img, num_features=N_FEAT)
    padded = porb.pad_edge(porb.smooth_image(img))
    want = dk.orb_describe_plain(padded, xy, v, porb.steer_table(False, "cpu"))
    assert torch.equal(_tap_sum_model(padded, xy, v), want)
    # compute_descriptors takes the same plain chain for CPU tensors.
    d, theta = porb.compute_descriptors(img, xy, v)
    assert torch.equal(d, want) and not torch.any(theta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tap_sum_model_matches_plain_chain_on_random_images(seed):
    rng = np.random.default_rng(seed)
    n, H, W = 512, 120, 200
    padded = torch.from_numpy(rng.uniform(0, 255, (H + 30, W + 30)).astype(np.float32))
    xy = np.stack([rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)], 1).astype(np.float32)
    xy[::5] = np.floor(xy[::5]) + 0.5  # ties: round half to even
    valid = torch.from_numpy(rng.random(n) < 0.75)
    xy = torch.from_numpy(xy)
    want = dk.orb_describe_plain(padded, xy, valid, porb.steer_table(False, "cpu"))
    assert torch.equal(_tap_sum_model(padded, xy, valid), want)
    assert torch.all(want[~valid] == 0) and torch.any(want[valid] != 0)


F32 = np.float32


def _clip(a, n):
    return np.clip(a, 0, n - 1)


def _detect_model(imgs, num_features, quality_level=0.01, block_size=5, min_distance=10,
                  border=16, subpix=True):
    """The detector's three kernels in their order, NumPy float32 (one
    rounding an operation), around the stable descending sort. Returns the
    fields of `detect.Detection` as arrays and (jittered response, keep)."""
    imgs = np.asarray(imgs, F32)
    S, H, W = imgs.shape
    ys, xs = np.arange(H), np.arange(W)
    # The response kernel: every neighbour read at the clamped coordinate.
    up, dn, lf, rt = _clip(ys - 1, H), _clip(ys + 1, H), _clip(xs - 1, W), _clip(xs + 1, W)
    sy = (imgs[:, up] + F32(2) * imgs) + imgs[:, dn]
    sx = (imgs[:, :, lf] + F32(2) * imgs) + imgs[:, :, rt]
    ix = (sy[:, :, rt] - sy[:, :, lf]) * F32(0.125)
    iy = (sx[:, dn] - sx[:, up]) * F32(0.125)
    r = block_size // 2
    boxed = []
    for p in (ix * ix, iy * iy, ix * iy):
        col = p
        for d in range(1, r + 1):
            col = (col + p[:, _clip(ys + d, H)]) + p[:, _clip(ys - d, H)]
        acc = col
        for d in range(1, r + 1):
            acc = (acc + col[:, :, _clip(xs + d, W)]) + col[:, :, _clip(xs - d, W)]
        boxed.append(acc * F32(1.0 / (block_size * block_size)))
    ixx, iyy, ixy = boxed
    diff = ixx - iyy
    # The square root is torch.sqrt's: PyTorch's vectorised CPU sqrt (Sleef's
    # on AVX512) does not always round correctly (numpy's differs in 516 of a
    # frame's 76,800 values); on the card torch.sqrt and the kernel's
    # __fsqrt_rn both round correctly, which the card test holds.
    disc = np.maximum(F32(0.25) * (diff * diff) + ixy * ixy, F32(0))
    raw = F32(0.5) * (ixx + iyy) - torch.sqrt(torch.from_numpy(disc)).numpy()
    peak = raw.max(axis=(1, 2))
    scale = F32(1e-5) * np.maximum(peak, F32(1e-12))

    def jittered(s, y, x):
        h = ((y * 7919 + x * 104729) % 65521).astype(F32) * F32(1.0 / 65521.0)
        return raw[s, y, x] + h * scale[s]

    img_idx = np.arange(S)[:, None, None]
    resp = jittered(img_idx, ys[None, :, None], xs[None, None, :])
    # The NMS kernel: the window maximum clipped to the image.
    nr, tile = max(1, min_distance // 2), min(4, max(1, min_distance // 2))
    pooled = resp
    for d in range(1, nr + 1):
        pooled = np.maximum(pooled, np.maximum(resp[:, _clip(ys + d, H)],
                                               resp[:, _clip(ys - d, H)]))
    rows = pooled
    for d in range(1, nr + 1):
        pooled = np.maximum(pooled, np.maximum(rows[:, :, _clip(xs + d, W)],
                                               rows[:, :, _clip(xs - d, W)]))
    inb = ((ys[:, None] >= border) & (ys[:, None] < H - border)
           & (xs[None, :] >= border) & (xs[None, :] < W - border))
    kept = (resp >= pooled) & inb
    masked = np.where(kept, resp, F32(-np.inf))
    max_resp = np.array([max(F32(0), raw[s][kept[s]].max(initial=F32(0))) for s in range(S)],
                        F32)
    n_th, n_tw = -(-H // tile), -(-W // tile)
    padded = np.full((S, n_th * tile, n_tw * tile), -np.inf, F32)
    padded[:, :H, :W] = masked
    blocks = padded.reshape(S, n_th, tile, n_tw, tile).transpose(0, 1, 3, 2, 4)
    blocks = blocks.reshape(S, n_th * n_tw, tile * tile)
    tile_max, tile_arg = blocks[..., 0], np.zeros(blocks.shape[:2], np.int64)
    for k in range(1, tile * tile):  # first argmax: strictly greater replaces
        more = blocks[..., k] > tile_max
        tile_max, tile_arg = np.where(more, blocks[..., k], tile_max), np.where(more, k, tile_arg)
    # The sort, then the refine kernel: one slot at a time, vectorised.
    order = np.argsort(-tile_max, axis=1, kind="stable")[:, :num_features]
    top = np.take_along_axis(tile_max, order, 1)
    within = np.take_along_axis(tile_arg, order, 1)
    ty, tx = (order // n_tw) * tile + within // tile, (order % n_tw) * tile + within % tile
    s_idx = np.arange(S)[:, None]
    score = raw[s_idx, ty, tx]
    m = max_resp[:, None]
    valid = (np.isfinite(top) & (score > F32(quality_level) * m) & (score > F32(1e-6))
             & (m > 0))
    dx = dy = np.zeros_like(score)
    if subpix:
        yc, xc = np.clip(ty, 1, H - 2), np.clip(tx, 1, W - 2)

        def at(a, b):
            return jittered(s_idx, yc + a, xc + b)

        gx = F32(0.5) * (at(0, 1) - at(0, -1))
        gy = F32(0.5) * (at(1, 0) - at(-1, 0))
        gxx = (at(0, 1) - F32(2) * at(0, 0)) + at(0, -1)
        gyy = (at(1, 0) - F32(2) * at(0, 0)) + at(-1, 0)
        gxy = F32(0.25) * (((at(1, 1) - at(1, -1)) - at(-1, 1)) + at(-1, -1))
        det = gxx * gyy - gxy * gxy
        safe = np.where(np.abs(det) < F32(1e-12), F32(1e-12), det)
        with np.errstate(over="ignore", invalid="ignore"):
            ox = -(gyy * gx - gxy * gy) / safe
            oy = -(gxx * gy - gxy * gx) / safe
        ok = (np.abs(det) > F32(1e-12)) & (np.abs(ox) <= 1) & (np.abs(oy) <= 1)
        dx = np.where(ok, np.clip(ox, F32(-0.5), F32(0.5)), F32(0))
        dy = np.where(ok, np.clip(oy, F32(-0.5), F32(0.5)), F32(0))
    xy = np.stack([tx.astype(F32) + dx, ty.astype(F32) + dy], -1)
    fields = dict(xy=np.where(valid[..., None], xy, F32(0)), scores=np.where(valid, score, F32(0)),
                  valid=valid, response=raw, peak=peak, tile_max=tile_max, tile_arg=tile_arg,
                  max_resp=max_resp)
    return fields, (resp, kept)


def _assert_detection_bits(got, want):
    for name in want:
        g = getattr(got, name).numpy()
        w = want[name]
        assert g.shape == w.shape, name
        if g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_detect_kernel_model_matches_plain_on_frames(frames, k):
    img = frames[k][None].astype(F32)
    want, _ = _detect_model(img, N_FEAT)
    got = pdet.detect_corners_plain(_t(img), N_FEAT, 0.01, 5, 10, 16, True)
    _assert_detection_bits(got, want)
    assert got.valid.sum() > 100


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("min_distance", [2, 6, 10])
@pytest.mark.parametrize("block_size", [3, 5, 7])
def test_detect_kernel_model_matches_plain_on_random_images(block_size, min_distance, S):
    """61 x 83 images (no multiple of a tile of 2, 3 or 4); the batch
    holds the three kinds, S = 1 the flat patches alone."""
    rng = np.random.default_rng(100 * block_size + min_distance)
    imgs = detect_images(rng, ["flat", "lattice", "constant"][:S], 61, 83)
    want, _ = _detect_model(imgs, 128, block_size=block_size, min_distance=min_distance)
    got = pdet.detect_corners_plain(_t(imgs), 128, 0.01, block_size, min_distance, 16, True)
    _assert_detection_bits(got, want)
    assert got.valid[0].any() and not (S == 3 and got.valid[2].any())
    # Each image of a batch is the one it is alone.
    alone = pdet.detect_corners(_t(imgs[-1]), num_features=128, block_size=block_size,
                                min_distance=min_distance)
    for g, a in zip((got.xy[-1], got.scores[-1], got.valid[-1]), alone):
        assert torch.equal(g, a)


def test_detect_kernel_model_without_subpix():
    imgs = detect_images(np.random.default_rng(5), ["flat", "lattice"], 61, 83)
    want, _ = _detect_model(imgs, 128, subpix=False)
    got = pdet.detect_corners_plain(_t(imgs), 128, 0.01, 5, 10, 16, False)
    _assert_detection_bits(got, want)
    assert np.all(want["xy"][want["valid"]] == np.round(want["xy"][want["valid"]]))


def test_detect_cases_meet_nms_and_sort_ties():
    """The lattice image meets what the kernels must order as the plain
    version does: kept pixels tied with a neighbour in their window, equal
    finite tile maxima in the sorted slots, and all -inf tiles."""
    imgs = detect_images(np.random.default_rng(1010), ["lattice"], 61, 83)
    want, (resp, kept) = _detect_model(imgs, 128)
    nr = 5
    ties = 0
    for y, x in zip(*np.nonzero(kept[0])):
        win = resp[0, max(y - nr, 0):y + nr + 1, max(x - nr, 0):x + nr + 1]
        ties += int((win == resp[0, y, x]).sum()) - 1
    assert ties > 0
    top = np.sort(want["tile_max"][0])[::-1][:128]
    finite = top[np.isfinite(top)]
    assert len(np.unique(finite)) < len(finite)
    assert np.isneginf(want["tile_max"]).sum() > 0 and np.isneginf(top).any()


def test_detect_wrapper_checks_settings():
    detk.check_settings(480, 752, 5, 10)
    detk.check_settings(376, 1241, 13, 59)
    for h, w, bs, md in ((480, 752, 15, 10), (480, 752, 5, 60), (5, 752, 5, 10),
                         (480, 30000, 5, 10)):
        with pytest.raises(ValueError):
            detk.check_settings(h, w, bs, md)
    with pytest.raises(ValueError):
        detk.detect_corners(torch.zeros(4, 4))
    # The CPU takes the plain version, whatever the settings.
    img = _t(detect_images(np.random.default_rng(2), ["flat"], 61, 83))
    det = detk.detect_corners(img, 64, block_size=15)
    want = pdet.detect_corners_plain(img, 64, 0.01, 15, 10, 16, True)
    assert all(torch.equal(a, b) for a, b in zip(det, want))

"""Port parity: the oriented (rotation-steered) ORB describe.

`ops/orb.compute_descriptors` with the steered table goes through
`ops/kernels/describe.py::orb_describe_oriented`, one CUDA kernel on the
card (`csrc/orb_describe_oriented.cu`) and its plain version, the dense
per-bin chain, on the CPU. Here, on the CPU:

- the compact steered tap table scatters back to the dense steered table
  bin by bin, bit for bit, and is int16, row-major and contiguous;
- a model of the kernel's arithmetic in its order (each lane's column of
  moment products added down the rows, the lanes added by a xor
  butterfly, the bin arithmetic without contraction, bf16(p * w) times
  each tap added from 0 in ascending pixel index, the two bins added last)
  against the plain chain: at most 1e-4 of the bits differ (0 expected:
  a flip needs a pair tied to the last bit). The model's angle is held to
  the angle of the float64 moments of the same bf16 window within the
  float32 error bound of the kernel's order (`_f64_theta`). On smoothed
  images, the describe's real input, it is also within 1e-5 rad of the
  plain chain's (identical on these: the smoothed bf16 values are coarse
  enough that every moment sum is exact in any order). On raw uniform
  noise, dark pixels' bf16 values are finer than the sums' ulp, so both
  orders round; where the resultant moment is small the plain chain's
  float32 product strays further from the float64 angle than 1e-5 rad
  (and further than the kernel's order), so there the angle is held to
  the float64 one only;
- the port's oriented descriptors against the JAX package's, one image and
  a batch of three: bits identical, angles within 1e-4 rad;
- steered descriptors survive a 30 degree rotation in both packages;
- the wrapper's input checks, and that compute_descriptors goes through it.
The kernel against its plain version on the card is in
test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402

from stereo_orb_slam_tpu.ops import detect as rdet, match as rmatch, orb as rorb  # noqa: E402
from stereo_orb_slam_torch.ops import detect as pdet, orb as porb  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import describe as dk, patches as pk  # noqa: E402

torch.set_num_threads(1)
N_FEAT = 256
BIT_SHARE = 1e-4      # differing bits allowed, kernel order against the plain chain
THETA_ATOL = 1e-5     # rad, kernel order against the plain chain (smoothed input)
SUM_ROUNDINGS = 32 + 5  # roundings a moment term passes in the kernel: its column, the butterfly
REF_THETA_ATOL = 1e-4  # rad, port against the JAX package


@pytest.fixture(scope="module")
def frames():
    scene = PlaneScene(np.random.default_rng(7))
    return [scene.render(0.0), scene.render(0.0, right=True), scene.render(0.35)]


@pytest.fixture(scope="module")
def steered():
    return porb.steer_table(True, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_steered_taps_scatter_back_to_the_steered_table(steered):
    idx, w = dk.steered_tap_table(steered)
    K, S = porb.K_BINS, 2 * porb.N_TESTS
    assert idx.dtype == torch.int16 and w.dtype == torch.bfloat16
    assert idx.shape == w.shape == (K, S, dk.TAPS)
    # The kernel reads [K, 512, 4] row-major: bin, sample, tap.
    assert idx.is_contiguous() and w.is_contiguous()
    assert idx.stride() == w.stride() == (S * dk.TAPS, dk.TAPS, 1)
    cols = torch.arange(S)[:, None].expand(-1, dk.TAPS)
    for k in range(K):
        dense = torch.zeros(porb.PATCH * porb.PATCH, S)
        dense.index_put_((idx[k].long(), cols), w[k].float(), accumulate=True)
        assert torch.equal(dense.to(torch.bfloat16), steered[k]), k
        assert torch.equal(dense, steered[k].float()), k
    # Nonzero taps first, in ascending pixel index; padding at weight 0.
    nz = w != 0
    assert torch.all(nz[..., :-1] | ~nz[..., 1:])
    assert torch.all((idx[..., 1:] > idx[..., :-1]) | ~nz[..., 1:])
    assert int(nz.sum(-1).min()) >= 1
    # The upright table's compact form comes from the same function, in float32.
    up_idx, up_w = dk.tap_table(porb.steer_table(False, "cpu"))
    assert up_idx.shape == (S, dk.TAPS) and up_w.dtype == torch.float32


def _kernel_order_model(padded, xy, valid, table, radius=15):
    """csrc/orb_describe_oriented.cu's arithmetic in its order, for one
    image: returns ([N, 8] int32 words, [N] float32 angles)."""
    n, P, R = xy.shape[0], porb.PATCH, porb.PATCH_R
    win = pk.extract_patches_plain(padded, *porb.window_starts(xy), P).float()  # [n, P, P]
    # Moments: lane x adds its column down the rows (exact products, one
    # rounding per add), then the xor butterfly over offsets 16 .. 1.
    d = torch.arange(P) - R
    disc = d[:, None] ** 2 + d[None, :] ** 2 <= radius * radius   # [row, col]
    w10 = torch.where(disc, d[None, :].float(), 0.0)
    w01 = torch.where(disc, d[:, None].float(), 0.0)
    m10 = torch.zeros(n, P)
    m01 = torch.zeros(n, P)
    for r in range(P):
        m10 = m10 + win[:, r, :] * w10[r]
        m01 = m01 + win[:, r, :] * w01[r]
    for off in (16, 8, 4, 2, 1):
        perm = torch.arange(P) ^ off
        m10 = m10 + m10[:, perm]
        m01 = m01 + m01[:, perm]
    assert torch.equal(m10, m10[:, :1].expand(-1, P))  # every lane holds the same sum
    theta = torch.atan2(m01[:, 0], m10[:, 0])
    # The bins: f32(30 / 2 pi), floor, mod onto [0, 30), bf16 weights.
    bin_f = theta * torch.tensor(porb.K_BINS / (2.0 * np.pi), dtype=torch.float32)
    k0f = torch.floor(bin_f)
    frac = bin_f - k0f
    k0 = torch.remainder(k0f.long(), porb.K_BINS)
    k1 = torch.remainder(k0 + 1, porb.K_BINS)
    w0 = (1.0 - frac).to(torch.bfloat16).float()
    w1 = frac.to(torch.bfloat16).float()
    idx, tw = dk.steered_tap_table(table)
    flat = win.reshape(n, P * P)

    def bin_samples(k, wb):
        acc = torch.zeros(n, 2 * porb.N_TESTS)
        for t in range(dk.TAPS):
            pix = flat.gather(1, idx[k, :, t].long())
            q = (pix * wb[:, None]).to(torch.bfloat16).float()   # bf16(p * w), p * w exact
            acc = acc + q * tw[k, :, t].float()                  # exact product, one rounding
        return acc

    vals = bin_samples(k0, w0) + bin_samples(k1, w1)
    bits = vals[:, :porb.N_TESTS] < vals[:, porb.N_TESTS:]
    return torch.where(valid[:, None], porb.pack_bits(bits), 0), theta


def _f64_theta(padded, xy, radius):
    """The angle of the float64 moments of the bf16 windows (exact sums),
    and the kernel order's float32 error bound for it: 1e-6 rad (atan2 and
    rounding) + SUM_ROUNDINGS * 2^-24 * S / |m|, with S the sum of the
    moment terms' magnitudes and |m| the resultant moment (each term passes
    at most SUM_ROUNDINGS roundings)."""
    win = pk.extract_patches_plain(padded, *porb.window_starts(xy), porb.PATCH)
    win = win.double().reshape(xy.shape[0], -1)
    masks = porb._disc_masks(radius, "cpu").double()
    mom = win @ masks
    size = win.abs() @ masks.abs().sum(1)
    spread = torch.where(size > 0, size / mom.norm(dim=1), 0.0)   # inf where m = 0 alone
    bound = 1e-6 + SUM_ROUNDINGS * 2.0 ** -24 * spread
    return torch.atan2(mom[:, 1], mom[:, 0]), bound


def _assert_close_to_plain(padded, xy, valid, table, radius=15, smoothed=True):
    words, theta = _kernel_order_model(padded, xy, valid, table, radius)
    want, want_theta = dk.orb_describe_oriented_plain(padded, xy, valid, table, radius)
    flips = int((porb.unpack_bits(words) != porb.unpack_bits(want)).sum())
    assert flips <= BIT_SHARE * xy.shape[0] * porb.N_TESTS
    exact, bound = _f64_theta(padded, xy, radius)
    assert torch.all((theta.double() - exact).abs() <= bound)
    if smoothed:
        assert float((theta - want_theta).abs().max()) <= THETA_ATOL
    assert torch.all(want[~valid] == 0)
    return flips


@pytest.mark.parametrize("k", [0, 1, 2])
def test_kernel_order_model_matches_plain_chain_on_frames(frames, steered, k):
    img = _t(frames[k])
    xy, _, v = pdet.detect_corners(img, num_features=N_FEAT)
    padded = porb.pad_edge(porb.smooth_image(img))
    assert _assert_close_to_plain(padded, xy, v, steered) == 0


@pytest.mark.parametrize("seed,radius,smoothed", [(0, 15, True), (1, 15, False), (2, 7, True),
                                                  (3, 15, False)])
def test_kernel_order_model_matches_plain_chain_on_random_images(steered, seed, radius,
                                                                 smoothed):
    rng = np.random.default_rng(seed)
    n, H, W = 512, 120, 200
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    img[:25, :25] = 17.0   # flat windows: the moments cancel to 0, theta 0
    padded = porb.pad_edge(porb.smooth_image(img) if smoothed else img)
    xy = np.stack([rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)], 1).astype(np.float32)
    xy[::5] = np.floor(xy[::5]) + 0.5  # ties: round half to even
    xy[:4] = [[2.0, 3.0], [0.0, 0.0], [5.0, 1.0], [1.5, 2.5]]
    valid = torch.from_numpy(rng.random(n) < 0.75)
    xy = torch.from_numpy(xy)
    _assert_close_to_plain(padded, xy, valid, steered, radius, smoothed)
    _, theta = dk.orb_describe_oriented_plain(padded, xy, valid, steered, radius)
    assert torch.all(theta[:4] == 0)
    # Negative bins occur, and the wrap pair k0 = 29, k1 = 0 too.
    bins = torch.floor(theta * (porb.K_BINS / (2.0 * np.pi)))
    assert bool((bins < 0).any()) and bool((bins == -1).any())


@pytest.mark.parametrize("k", [0, 2])
def test_oriented_descriptors_match_reference(frames, k):
    img = frames[k]
    xy, _, v = rdet.detect_corners(jnp.asarray(img), num_features=N_FEAT)
    d_ref, th_ref = rorb.compute_descriptors(jnp.asarray(img), xy, v,
                                             steer=rorb.steer_table(True))
    d_port, th_port = porb.compute_descriptors(_t(img), _t(xy), _t(v),
                                               steer=porb.steer_table(True, "cpu"))
    np.testing.assert_array_equal(d_port.numpy().view(np.uint32), np.asarray(d_ref))
    np.testing.assert_allclose(th_port.numpy(), np.asarray(th_ref), atol=REF_THETA_ATOL)


def test_batched_oriented_descriptors_match_reference(frames):
    """[S, H, W] with S = 3 in one call (one launch on the card) against
    JAX image by image."""
    steer_ref = rorb.steer_table(True)
    per = [rdet.detect_corners(jnp.asarray(f), num_features=N_FEAT) for f in frames]
    imgs = torch.stack([_t(f) for f in frames])
    xy = torch.stack([_t(p[0]) for p in per])
    v = torch.stack([_t(p[2]) for p in per])
    d_port, th_port = porb.compute_descriptors(imgs, xy, v, steer=porb.steer_table(True, "cpu"))
    assert d_port.shape == (3, N_FEAT, porb.N_WORDS) and th_port.shape == (3, N_FEAT)
    for s, f in enumerate(frames):
        d_ref, th_ref = rorb.compute_descriptors(jnp.asarray(f), per[s][0], per[s][2],
                                                 steer=steer_ref)
        np.testing.assert_array_equal(d_port[s].numpy().view(np.uint32), np.asarray(d_ref))
        np.testing.assert_allclose(th_port[s].numpy(), np.asarray(th_ref), atol=REF_THETA_ATOL)


def _random_texture(rng, h, w):
    img = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    return img + rng.normal(0, 2.0, (h, w)).astype(np.float32)


def test_steered_descriptors_survive_rotation(rng):
    """tests/test_orb_match.py::test_descriptor_rotation_invariance on the
    port, beside the JAX package's figure on the same corners."""
    import scipy.ndimage as ndi

    base = _random_texture(rng, 320, 320)
    ang = 30.0
    rot = ndi.rotate(base, ang, reshape=False, order=1, mode="nearest")
    xy1, _, v1 = rdet.detect_corners(jnp.asarray(base), num_features=128, border=60)
    c = (np.array(base.shape[::-1], np.float32) - 1) / 2
    th = np.deg2rad(ang)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    xy2 = ((np.asarray(xy1) - c) @ R + c).astype(np.float32)
    in_b = ((xy2[:, 0] > 60) & (xy2[:, 0] < 260) & (xy2[:, 1] > 60) & (xy2[:, 1] < 260))
    v2 = np.asarray(v1) & in_b
    both = np.asarray(v1) & v2
    assert both.sum() > 20

    steer = porb.steer_table(True, "cpu")
    d1, _ = porb.compute_descriptors(_t(base), _t(xy1), _t(v1), steer=steer)
    d2, _ = porb.compute_descriptors(_t(rot), _t(xy2), _t(v2), steer=steer)
    diag = np.unpackbits((d1.numpy() ^ d2.numpy()).view(np.uint8), axis=-1).sum(-1)[both]
    r1, _ = rorb.compute_descriptors(jnp.asarray(base), xy1, v1, steer=rorb.steer_table(True))
    r2, _ = rorb.compute_descriptors(jnp.asarray(rot), jnp.asarray(xy2), jnp.asarray(v2),
                                     steer=rorb.steer_table(True))
    ref = np.diag(np.asarray(rmatch.hamming_matrix(r1, r2, v1, jnp.asarray(v2))))[both]
    assert np.median(diag) < 60  # well under the ~128 chance level
    assert np.median(ref) < 60
    np.testing.assert_array_equal(diag, ref)  # the same bits, so the same figure


def test_oriented_wrapper_rejects_bad_input(steered):
    img = torch.zeros((40, 50))
    xy = torch.zeros((3, 2))
    ok = torch.ones(3, dtype=torch.bool)
    words, theta = dk.orb_describe_oriented(img, xy, ok, steered, 15)
    assert words.shape == (3, 8) and theta.shape == (3,)
    bad = [
        (img[:20], xy, ok, steered, 15),                       # smaller than a patch
        (img.double(), xy, ok, steered, 15),                   # dtype
        (img[None].expand(2, -1, -1), xy, ok, steered, 15),    # batch without corners' batch
        (img, xy.double(), ok, steered, 15),
        (img, xy[:, :1], ok[:], steered, 15),                  # xy shape
        (img, xy, ok[:2], steered, 15),                        # valid shape
        (img, xy, ok.to(torch.uint8), steered, 15),
        (img, xy, ok, porb.steer_table(False, "cpu"), 15),     # upright table
        (img, xy, ok, steered.float(), 15),                    # table dtype
        (img, xy, ok, steered[:29], 15),                       # bins
        (img, xy, ok, steered, -1),                            # radius
        (img, xy, ok, steered, 2.5),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            dk.orb_describe_oriented(*args)
    with pytest.raises(ValueError):   # upright describe refuses the steered table
        dk.orb_describe(img, xy, ok, steered)
    # Mixed devices raise before anything launches (a "meta" tensor is no
    # CPU tensor, so the plain version is not taken).
    before = dk.ORIENTED_LAUNCHES
    with pytest.raises(ValueError):
        dk.orb_describe_oriented(img.to("meta"), xy, ok, steered, 15)
    with pytest.raises(ValueError):
        dk.orb_describe_oriented(img, xy, ok.to("meta"), steered, 15)
    assert dk.ORIENTED_LAUNCHES == before


def test_batched_oriented_wrapper_checks_its_batch(steered):
    img = torch.zeros((2, 40, 50))
    xy = torch.zeros((2, 3, 2))
    ok = torch.ones((2, 3), dtype=torch.bool)
    words, theta = dk.orb_describe_oriented(img, xy, ok, steered)
    assert words.shape == (2, 3, 8) and theta.shape == (2, 3)
    with pytest.raises(ValueError):
        dk.orb_describe_oriented(img, xy[:1], ok[:1], steered)
    with pytest.raises(ValueError):
        dk.orb_describe_oriented(img, xy[0], ok[0], steered)


def test_compute_descriptors_goes_through_the_oriented_wrapper(frames, steered, monkeypatch):
    img = _t(frames[2])
    xy, _, v = pdet.detect_corners(img, num_features=N_FEAT)
    calls = []
    wrapper = dk.orb_describe_oriented

    def spy(*args):
        calls.append(args)
        return wrapper(*args)

    def no_cut(*args, **kwargs):
        raise AssertionError("the oriented path no longer calls the patch-cut wrapper")

    monkeypatch.setattr(dk, "orb_describe_oriented", spy)
    monkeypatch.setattr(pk, "extract_patches", no_cut)
    before = (dk.LAUNCHES, dk.ORIENTED_LAUNCHES, pk.LAUNCHES)
    d, theta = porb.compute_descriptors(img, xy, v, orientation_radius=12, steer=steered)
    assert len(calls) == 1 and calls[0][3] is steered and calls[0][4] == 12
    # CPU tensors take the plain version: nothing launched.
    assert (dk.LAUNCHES, dk.ORIENTED_LAUNCHES, pk.LAUNCHES) == before
    padded = porb.pad_edge(porb.smooth_image(img))
    want = dk.orb_describe_oriented_plain(padded, xy, v, steered, 12)
    assert torch.equal(d, want[0]) and torch.equal(theta, want[1])

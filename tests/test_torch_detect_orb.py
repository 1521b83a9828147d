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
The kernel-against-plain comparison is in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402

from stereo_orb_slam_tpu.ops import detect as rdet, orb as rorb  # noqa: E402
from stereo_orb_slam_tpu.ops.pallas.patches import extract_patches_pallas  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.ops import detect as pdet, orb as porb  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import describe as dk, patches as pk  # noqa: E402

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

"""The port's CUDA kernels against their plain PyTorch versions.

Tolerance: bit for bit for the Hamming search (integer distances and
indices) and the patch cut (a copy and a round-to-nearest-even cast); for
the fused upright describe at most 1e-4 of the bits may differ (0
expected): it adds each sample's <= 4 exact products in ascending pixel
index, cuBLAS in its own order, so only a pair tied to the last bit could
flip; the same for the fused oriented describe, whose angle is held
within 1e-5 rad of the plain chain's on its real input, a smoothed image
(see tests/test_torch_orb_oriented.py), and to the float64 moments'
angle within the float32 error bound of the kernel's order. The Shi-Tomasi
detector's three kernels match their plain version bit for bit in every
output and intermediate (the same float32 operations in the same order).
The comparisons need a CUDA device and skip without one; on the card, run
them with

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest` because the suite's conftest.py imports JAX, which the card
machine does not need). The wrappers' input checks run everywhere.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.ops import detect as pdet, orb  # noqa: E402
from synth_detect import detect_images  # noqa: E402
from synth_distorted import EUROC, dlt_float64  # noqa: E402

from stereo_orb_slam_torch.ops.kernels import (  # noqa: E402
    describe as dk, detect as ck, dlt as tk, hamming as hk, patches as pk,
)

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _hamming_case(rng, n, m, kind):
    q = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    t = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    vt = rng.random(m) >= 0.25
    if kind == "all_invalid":
        vt[:] = False
    elif kind == "ties":
        for i in range(min(n, m // 4)):
            rows = rng.choice(m, 3, replace=False)
            t[rows] = q[i]
            vt[rows[0]] = False
        t[m // 2:] = t[: m - m // 2]
    return q, t, vt


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["masked", "all_invalid", "ties"])
@pytest.mark.parametrize("n,m", [(1024, 1024), (1000, 777), (1, 2), (33, 300)])
def test_hamming_kernel_matches_plain(rng, cuda, kind, n, m):
    q, t, vt = _hamming_case(rng, n, m, kind)
    args = [(convert.desc_to_tensor(q, d), convert.desc_to_tensor(t, d),
             torch.as_tensor(vt, device=d)) for d in ("cpu", cuda)]
    before = hk.LAUNCHES
    got = hk.hamming_top2(*args[1])
    torch.cuda.synchronize()
    assert hk.LAUNCHES == before + 1
    for g, w in zip(got, hk.hamming_top2(*args[0])):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got, hk.hamming_top2_plain(*args[1])):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["masked", "all_invalid", "ties"])
@pytest.mark.parametrize("n,ma,mb", [(1024, 1024, 1024), (1000, 777, 1500), (1, 2, 3),
                                     (33, 300, 8)])
def test_hamming_pair_kernel_matches_plain(rng, cuda, kind, n, ma, mb):
    q, ta, va = _hamming_case(rng, n, ma, kind)
    _, tb, vb = _hamming_case(rng, n, mb, kind)
    qd = convert.desc_to_tensor(q, cuda)
    sets = [(convert.desc_to_tensor(t, cuda), torch.as_tensor(v, device=cuda))
            for t, v in ((ta, va), (tb, vb))]
    before = hk.LAUNCHES
    got = hk.hamming_top2_pair(qd, *sets[0], *sets[1])
    torch.cuda.synchronize()
    assert hk.LAUNCHES == before + 1
    for g_set, (t, v) in zip(got, sets):
        for g, w in zip(g_set, hk.hamming_top2_plain(qd, t, v)):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1, 37])
def test_describe_kernel_matches_plain(rng, cuda, n):
    H, W = 406, 1271
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(cuda)
    xy = np.stack([rng.uniform(-3, W - 28, n), rng.uniform(-3, H - 28, n)], 1)
    xy[::3] = np.floor(xy[::3]) + 0.5
    xy = torch.from_numpy(xy.astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random(n) >= 0.25).to(cuda)
    table = orb.steer_table(False, cuda)
    before = dk.LAUNCHES
    got = dk.orb_describe(img, xy, valid, table)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == before + 1
    want = dk.orb_describe_plain(img, xy, valid, table)
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    flips = int((orb.unpack_bits(got) != orb.unpack_bits(want)).sum())
    assert flips <= 1e-4 * n * 256
    assert torch.all(got[~valid] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1, 37])
def test_patch_kernel_matches_plain(rng, cuda, n):
    img = torch.from_numpy(rng.normal(size=(406, 1271)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(-400, 420, n).astype(np.int32))
    xs = torch.from_numpy(rng.integers(-1300, 1300, n).astype(np.int32))
    before = pk.LAUNCHES
    got = pk.extract_patches(img.to(cuda), ys.to(cuda), xs.to(cuda), 32)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, 32, 32)
    assert torch.equal(got.cpu(), pk.extract_patches(img, ys, xs, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,ma,mb", [(3, 1024, 1024, 1024), (2, 37, 300, 8), (5, 1, 2, 3)])
def test_batched_hamming_kernel_matches_plain_and_slices(rng, cuda, B, n, ma, mb):
    """One launch for B problems: bit for bit against the batched plain
    version and against a B = 1 launch on each slice."""
    q = convert.desc_to_tensor(rng.integers(0, 2 ** 32, (B, n, 8), dtype=np.uint32), cuda)
    sets = []
    for m in (ma, mb):
        t = convert.desc_to_tensor(rng.integers(0, 2 ** 32, (B, m, 8), dtype=np.uint32), cuda)
        sets.append((t, torch.from_numpy(rng.random((B, m)) >= 0.25).to(cuda)))
    before = hk.LAUNCHES
    got = hk.hamming_top2_pair(q, *sets[0], *sets[1])
    torch.cuda.synchronize()
    assert hk.LAUNCHES == before + 1
    for g_set, (t, v) in zip(got, sets):
        for g, w in zip(g_set, hk.hamming_top2_plain(q, t, v)):
            assert g.shape == (B, n) and torch.equal(g, w)
    for b in range(B):
        one = hk.hamming_top2_pair(q[b], sets[0][0][b], sets[0][1][b], sets[1][0][b],
                                   sets[1][1][b])
        for g_set, o_set in zip(got, one):
            for g, o in zip(g_set, o_set):
                assert torch.equal(g[b], o)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(3, 1024), (2, 37)])
def test_batched_describe_and_patch_kernels_match_plain_and_slices(rng, cuda, B, n):
    """One launch for B images: bit for bit against the batched plain
    versions (the patch cut always; the describe at most 1e-4 of the bits,
    as the unbatched test) and against a B = 1 launch on each image."""
    H, W = 406, 1271
    img = torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)).to(cuda)
    xy = np.stack([rng.uniform(-3, W - 28, (B, n)), rng.uniform(-3, H - 28, (B, n))], -1)
    xy = torch.from_numpy(xy.astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((B, n)) >= 0.25).to(cuda)
    table = orb.steer_table(False, cuda)
    ys, xs = orb.window_starts(xy)
    before = (dk.LAUNCHES, pk.LAUNCHES)
    words = dk.orb_describe(img, xy, valid, table)
    cut = pk.extract_patches(img, ys, xs, 32)
    torch.cuda.synchronize()
    assert (dk.LAUNCHES, pk.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(cut, pk.extract_patches_plain(img, ys, xs, 32))
    want = dk.orb_describe_plain(img, xy, valid, table)
    assert int((orb.unpack_bits(words) != orb.unpack_bits(want)).sum()) <= 1e-4 * B * n * 256
    for b in range(B):
        assert torch.equal(words[b], dk.orb_describe(img[b], xy[b], valid[b], table))
        assert torch.equal(cut[b], pk.extract_patches(img[b], ys[b], xs[b], 32))


def _oriented_case(rng, device, B, n, H=376, W=1241):
    """B smoothed, padded random images (the describe's own input) with n
    corners each, a quarter invalid, some at .5 and some at negative
    starts."""
    img = torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)).to(device)
    padded = orb.pad_edge(orb.smooth_image(img)).contiguous()
    xy = np.stack([rng.uniform(-3, W + 2, (B, n)), rng.uniform(-3, H + 2, (B, n))], -1)
    xy[:, ::3] = np.floor(xy[:, ::3]) + 0.5
    xy = torch.from_numpy(xy.astype(np.float32)).to(device)
    valid = torch.from_numpy(rng.random((B, n)) >= 0.25).to(device)
    return padded, xy, valid


def _assert_oriented_close(padded, xy, valid, table, words, theta):
    want, want_theta = dk.orb_describe_oriented_plain(padded, xy, valid, table)
    assert words.dtype == torch.int32 and words.shape == want.shape
    assert theta.dtype == torch.float32 and theta.shape == want_theta.shape
    flips = int((orb.unpack_bits(words) != orb.unpack_bits(want)).sum())
    assert flips <= 1e-4 * valid.numel() * 256
    assert torch.all(words[~valid] == 0)
    if theta.numel():
        assert float((theta - want_theta).abs().max()) <= 1e-5
        win = pk.extract_patches_plain(padded, *orb.window_starts(xy), 32).double()
        win = win.reshape(-1, 32 * 32)
        masks = orb._disc_masks(15, xy.device).double()
        mom = win @ masks
        exact = torch.atan2(mom[:, 1], mom[:, 0]).reshape(theta.shape)
        # 1e-6 rad for atan2f and rounding, plus (32 + 5) roundings of each
        # moment term, relative to the resultant moment.
        size = win.abs() @ masks.abs().sum(1)
        spread = torch.where(size > 0, size / mom.norm(dim=1), 0.0).reshape(theta.shape)
        assert torch.all((theta.double() - exact).abs() <= 1e-6 + 37 * 2.0 ** -24 * spread)


@pytest.mark.cuda
@pytest.mark.parametrize("n,kind", [(1024, "masked"), (37, "masked"), (1, "masked"),
                                    (0, "masked"), (300, "all_invalid")])
def test_oriented_describe_kernel_matches_plain(rng, cuda, n, kind):
    padded, xy, valid = (x[0] for x in _oriented_case(rng, cuda, 1, n))
    if kind == "all_invalid":
        valid[:] = False
    table = orb.steer_table(True, cuda)
    before = dk.ORIENTED_LAUNCHES
    words, theta = dk.orb_describe_oriented(padded, xy, valid, table)
    torch.cuda.synchronize()
    assert dk.ORIENTED_LAUNCHES == before + (n > 0)
    assert words.shape == (n, 8) and theta.shape == (n,)
    _assert_oriented_close(padded, xy, valid, table, words, theta)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(3, 1024), (2, 37)])
def test_batched_oriented_describe_kernel_matches_plain_and_slices(rng, cuda, B, n):
    """One launch for B images: against the batched plain version (at most
    1e-4 of the bits, angles within 1e-5 rad) and bit for bit against a
    B = 1 launch on each image."""
    padded, xy, valid = _oriented_case(rng, cuda, B, n)
    table = orb.steer_table(True, cuda)
    before = dk.ORIENTED_LAUNCHES
    words, theta = dk.orb_describe_oriented(padded, xy, valid, table)
    torch.cuda.synchronize()
    assert dk.ORIENTED_LAUNCHES == before + 1
    assert words.shape == (B, n, 8) and theta.shape == (B, n)
    _assert_oriented_close(padded, xy, valid, table, words, theta)
    for b in range(B):
        one_words, one_theta = dk.orb_describe_oriented(padded[b], xy[b], valid[b], table)
        assert torch.equal(words[b], one_words) and torch.equal(theta[b], one_theta)


# The batched DLT: the points of valid slots 1.5-5 m deep within
# DLT_PLAIN_ATOL of the plain version (the float32 SVD's own error there is
# about 1e-5 m: chip_smoke.py's card-against-CPU bound for the front end's
# points, 1e-4 m), every valid point within DLT_F64_RTOL of a float64 DLT
# relative to its depth (the kernel is that DLT rounded once to float32),
# also 45-100 m deep, and invalid slots (zero pixels) finite.
DLT_PLAIN_ATOL = 1e-4
DLT_F64_RTOL = 2e-6


def _euroc_projections(baseline):
    K = np.array([[EUROC["fx"], 0, EUROC["cx"]], [0, EUROC["fx"], EUROC["cy"]], [0, 0, 1.0]])
    t = np.array([[-baseline], [0.0], [0.0]])
    return ((K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32),
            (K @ np.hstack([np.eye(3), t])).astype(np.float32))


def _dlt_problem(rng, P1, P2, n):
    """[n, 2] pixel pairs: the first half 1.5-5 m deep, the rest 45-100 m, a
    quarter of the slots zero (invalid); returns (uv1, uv2, near, valid)."""
    z = np.where(np.arange(n) < n // 2, rng.uniform(1.5, 5.0, n), rng.uniform(45.0, 100.0, n))
    X = np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.5, 0.5, n) * z, z], 1)

    def pix(P):
        x = X @ P[:, :3].T.astype(np.float64) + P[:, 3]
        return (x[:, :2] / x[:, 2:]).astype(np.float32)

    uv1 = pix(P1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2 = pix(P2)
    valid = rng.random(n) >= 0.25
    uv1[~valid] = 0.0
    uv2[~valid] = 0.0
    return uv1, uv2, np.arange(n) < n // 2, valid


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "stacked", "edges", "edges_64"])
def test_dlt_kernel_matches_plain_and_float64(rng, cuda, layout):
    """S = 1 ([1, N, 2] with one rig, as the front end's step passes it),
    S = 2 with a stacked rig of two baselines (P [2, 1, 3, 4]) and E = 5
    and E_pad = 64 loop edges' column slices of [E, N, 4] banks, at N =
    1024: one launch each."""
    n = 1024
    rigs = [_euroc_projections(EUROC["baseline"])]
    if layout == "stacked":
        rigs.append(_euroc_projections(0.2))
    B = {"shared": 1, "stacked": 2, "edges": 5, "edges_64": 64}[layout]
    cases = [_dlt_problem(rng, *rigs[b % len(rigs)], n) for b in range(B)]
    uv1, uv2 = (torch.from_numpy(np.stack([c[i] for c in cases])).to(cuda) for i in (0, 1))
    if layout == "stacked":
        P1, P2 = (torch.from_numpy(np.stack([r[i] for r in rigs])).to(cuda)[:, None]
                  for i in (0, 1))
    else:
        P1, P2 = (torch.from_numpy(rigs[0][i]).to(cuda) for i in (0, 1))
    if layout.startswith("edges"):
        bank = torch.cat([uv1, uv2], dim=-1)
        uv1, uv2 = bank[..., :2], bank[..., 2:]
        assert not uv1.is_contiguous()
    before = tk.LAUNCHES
    got = tk.triangulate_dlt(P1, P2, uv1, uv2)
    plain = tk.triangulate_dlt_plain(P1, P2, uv1, uv2)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1 and got.shape == (B, n, 3)
    got, plain = got.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(got).all()
    for b, (u1, u2, near, valid) in enumerate(cases):
        Q1, Q2 = rigs[b % len(rigs)]
        x64 = dlt_float64(Q1, Q2, u1[valid], u2[valid])
        gap = np.abs(got[b][valid] - x64).max(1) / np.abs(x64[:, 2])
        assert gap.max() <= DLT_F64_RTOL, gap.max()
        np.testing.assert_allclose(got[b][near & valid], plain[b][near & valid], rtol=0,
                                   atol=DLT_PLAIN_ATOL)
    if B > 1:   # [B, 3, 4] is not the stacked rig's [B, 1, 3, 4]
        with pytest.raises(ValueError, match="one projection per problem"):
            tk.triangulate_dlt(P1.reshape(-1, 3, 4)[:1].expand(B, 3, 4).contiguous(),
                               P2.reshape(-1, 3, 4)[:1].expand(B, 3, 4).contiguous(), uv1,
                               uv2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["zero", "duplicated", "half"])
def test_dlt_kernel_on_degenerate_rows(rng, cuda, rows):
    """Systems with no unique null vector at N = 1024: all-zero rows (zero
    projections), duplicated rows (one view twice) and a zero second view,
    beside points 45-100 m deep: every output finite, every point stopped
    before the 16-sweep cap, one launch; the well-posed far points of the
    same launch (a stacked pair) within DLT_F64_RTOL of a float64 DLT."""
    n = 1024
    P1, P2 = _euroc_projections(EUROC["baseline"])
    uv1, uv2, _, valid = _dlt_problem(rng, P1, P2, n)
    zeros = np.zeros((3, 4), np.float32)
    Pa, Pb = {"zero": (zeros, zeros), "duplicated": (P1, P1), "half": (P1, zeros)}[rows]
    p1 = torch.from_numpy(np.stack([Pa, P1]))[:, None].to(cuda)
    p2 = torch.from_numpy(np.stack([Pb, P2]))[:, None].to(cuda)
    u1 = torch.from_numpy(np.stack([uv1, uv1])).to(cuda)
    u2 = torch.from_numpy(np.stack([uv1, uv2])).to(cuda)
    before = tk.LAUNCHES
    got, work = tk.triangulate_dlt_work(p1, p2, u1, u2)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    got, work = got.cpu().numpy(), work.cpu().numpy()
    assert np.isfinite(got).all()
    assert work[..., 0].min() >= 1 and work[..., 0].max() < 16
    if rows == "zero":
        assert (work[0] == [1, 0]).all()
    x64 = dlt_float64(P1, P2, uv1[valid], uv2[valid])
    assert (np.abs(got[1][valid] - x64).max(1) / np.abs(x64[:, 2])).max() <= DLT_F64_RTOL


def test_batched_wrappers_check_their_batch():
    d = torch.zeros((2, 4, 8), dtype=torch.int32)
    v = torch.ones((2, 4), dtype=torch.bool)
    d1, i1, d2 = hk.hamming_top2(d, d, v)
    assert d1.shape == i1.shape == d2.shape == (2, 4)
    with pytest.raises(ValueError):
        hk.hamming_top2(d, d[:1], v[:1])          # batch sizes differ
    with pytest.raises(ValueError):
        hk.hamming_top2(d, d[0], v[0])            # batched query, unbatched train
    img = torch.zeros((2, 40, 50))
    xy = torch.zeros((2, 3, 2))
    ok = torch.ones((2, 3), dtype=torch.bool)
    table = orb.steer_table(False, "cpu")
    assert dk.orb_describe(img, xy, ok, table).shape == (2, 3, 8)
    with pytest.raises(ValueError):
        dk.orb_describe(img, xy[:1], ok[:1], table)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    assert pk.extract_patches(img, idx, idx, 32).shape == (2, 3, 32, 32)
    with pytest.raises(ValueError):
        pk.extract_patches(img, idx[:1], idx[:1], 32)


def test_wrappers_reject_bad_input():
    d = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        hk.hamming_top2(d.to(torch.int64), d, v)
    with pytest.raises(ValueError):
        hk.hamming_top2(d, d[:1], v[:1])
    with pytest.raises(ValueError):
        hk.hamming_top2(d, d, v[:3])
    with pytest.raises(ValueError):
        hk.hamming_top2(d, d.t().contiguous().t(), v.to(torch.uint8))
    img = torch.zeros((40, 50))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.extract_patches(img[:20], idx, idx, 32)
    with pytest.raises(ValueError):
        pk.extract_patches(img.double(), idx, idx, 32)
    with pytest.raises(ValueError):
        pk.extract_patches(img, idx.long(), idx, 32)
    with pytest.raises(ValueError):
        pk.extract_patches(img, idx, idx[:2], 32)


def test_pair_and_describe_wrappers_reject_bad_input():
    d = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        hk.hamming_top2_pair(d, d, v, d[:1], v[:1])
    with pytest.raises(ValueError):
        hk.hamming_top2_pair(d, d, v, d.to(torch.int64), v)
    with pytest.raises(ValueError):
        hk.hamming_top2_pair(d[:, :4], d, v, d, v)
    with pytest.raises(ValueError):
        hk.hamming_top2_pair(d, d, v, d, v[:3])
    img = torch.zeros((40, 50))
    xy = torch.zeros((3, 2))
    ok = torch.ones(3, dtype=torch.bool)
    table = orb.steer_table(False, "cpu")
    with pytest.raises(ValueError):
        dk.orb_describe(img[:20], xy, ok, table)
    with pytest.raises(ValueError):
        dk.orb_describe(img.double(), xy, ok, table)
    with pytest.raises(ValueError):
        dk.orb_describe(img, xy.double(), ok, table)
    with pytest.raises(ValueError):
        dk.orb_describe(img, xy, ok[:2], table)
    with pytest.raises(ValueError):
        dk.orb_describe(img, xy, ok, table.float())
    with pytest.raises(ValueError):
        dk.orb_describe(img, xy, ok, orb.steer_table(True, "cpu"))


def test_cpu_tensors_take_the_plain_version():
    d = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    before = (hk.LAUNCHES, pk.LAUNCHES, dk.LAUNCHES, tk.LAUNCHES, ck.LAUNCHES)
    hk.hamming_top2(d, d, v)
    hk.hamming_top2_pair(d, d, v, d, v)
    pk.extract_patches(torch.zeros((40, 50)), torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), 32)
    dk.orb_describe(torch.zeros((40, 50)), torch.zeros((2, 2)), torch.ones(2, dtype=torch.bool),
                    orb.steer_table(False, "cpu"))
    tk.triangulate_dlt(torch.eye(3, 4), torch.eye(3, 4), torch.zeros(2, 2), torch.zeros(2, 2))
    detected = ck.detect_corners(torch.zeros((1, 40, 50)), 16)
    assert (hk.LAUNCHES, pk.LAUNCHES, dk.LAUNCHES, tk.LAUNCHES, ck.LAUNCHES) == before
    assert not detected.valid.any()


def assert_detection_equal(got, want):
    """Every field of two `detect.Detection`s bit for bit (tile_arg by value:
    int32 from the kernel, int64 from the plain version's argmax)."""
    for name, g, w in zip(pdet.Detection._fields, got, want):
        assert g.shape == w.shape, name
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
        else:
            assert torch.equal(g.long(), w.long()), name


@pytest.mark.cuda
@pytest.mark.parametrize("block_size,min_distance,subpix", [(5, 10, True), (3, 2, True),
                                                           (7, 6, False)])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("H,W", [(480, 752), (376, 1241)])
def test_detect_kernels_match_plain(rng, cuda, H, W, S, block_size, min_distance, subpix):
    """The three kernels and the sort against the plain version on the card,
    at the EuRoC and KITTI shapes, 1,024 features; a batch of 3 adds the
    lattice (NMS ties) and a constant image (every slot invalid)."""
    kinds = ["flat", "lattice", "constant"][:S]
    imgs = torch.from_numpy(detect_images(rng, kinds, H, W)).to(cuda)
    args = (1024, 0.01, block_size, min_distance, 16, subpix)
    before = ck.LAUNCHES
    got = ck.detect_corners(imgs, *args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 3
    want = pdet.detect_corners_plain(imgs, *args)
    assert_detection_equal(got, want)
    assert got.valid[0].sum() > 100 and not (S == 3 and got.valid[2].any())
    # The public function goes through the kernels, one image or a batch.
    out = pdet.detect_corners(imgs[0], *args)
    assert ck.LAUNCHES == before + 6
    for o, w in zip(out, (want.xy[0], want.scores[0], want.valid[0])):
        assert torch.equal(o, w)

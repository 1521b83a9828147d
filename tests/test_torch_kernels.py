"""The port's CUDA kernels against their plain PyTorch versions.

Tolerance: bit for bit (integer distances and indices; a copy and a
round-to-nearest-even cast). The comparisons need a CUDA device and skip
without one; on the card, run them with

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest` because the suite's conftest.py imports JAX, which the card
machine does not need). The wrappers' input checks run everywhere.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import hamming as hk, patches as pk  # noqa: E402

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


def test_cpu_tensors_take_the_plain_version():
    d = torch.zeros((4, 8), dtype=torch.int32)
    before = (hk.LAUNCHES, pk.LAUNCHES)
    hk.hamming_top2(d, d, torch.ones(4, dtype=torch.bool))
    pk.extract_patches(torch.zeros((40, 50)), torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), 32)
    assert (hk.LAUNCHES, pk.LAUNCHES) == before

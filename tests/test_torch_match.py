"""Port parity: the Hamming top-2 search (one train set, and the pair of
train sets that one launch serves) and ops/match.py against the JAX
package.

Tolerance: bit-exact. Distances and indices are integers, computed exactly
by both packages. `match_descriptors` is compared on every row for `ok` and
`d1`, and on valid query rows for `idx`: the JAX package's XLA path masks
invalid query rows whole (idx 0 there) while its fused kernel path, and the
port, mask only d1 (idx is the real argmin); every consumer masks idx.
The kernel-against-plain comparison is in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereo_orb_slam_tpu.ops import match as rmatch  # noqa: E402
from stereo_orb_slam_tpu.ops.pallas.hamming import hamming_top2 as pallas_top2  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.ops import match as pmatch  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import hamming as hk  # noqa: E402

torch.set_num_threads(1)


def _case(rng, n, m, kind, q=None):
    """Packed uint32 query/train words and train validity for one case
    (against the given query words `q`, when given)."""
    if q is None:
        q = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    t = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    vt = np.ones(m, bool)
    if kind == "masked":
        vt[rng.random(m) < 0.3] = False
    elif kind == "all_invalid":
        vt[:] = False
    elif kind == "ties":
        # Each query's best distance is reached by several train rows,
        # some of them masked, so the lowest valid index must win.
        for i in range(min(n, m // 4)):
            rows = rng.choice(m, 3, replace=False)
            t[rows] = q[i]
            vt[rows[0]] = False
        t[m // 2:] = t[: m - m // 2]  # repeated rows: equal best and second
    return q, t, vt


def _ref_top2(q, t, vt):
    dist = rmatch.hamming_matrix(jnp.asarray(q), jnp.asarray(t), valid_t=jnp.asarray(vt))
    return tuple(np.asarray(x) for x in rmatch.knn2(dist))


def _port_top2(q, t, vt):
    out = hk.hamming_top2(convert.desc_to_tensor(q, "cpu"), convert.desc_to_tensor(t, "cpu"),
                          torch.as_tensor(vt))
    return tuple(x.numpy() for x in out)


KINDS = ["random", "masked", "all_invalid", "ties"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m", [(128, 256), (100, 77), (3, 2)])
def test_plain_top2_matches_reference(rng, kind, n, m):
    q, t, vt = _case(rng, n, m, kind)
    ref = _ref_top2(q, t, vt)
    port = _port_top2(q, t, vt)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, r)
    if kind == "all_invalid":
        assert np.all(port[0] == 257) and np.all(port[1] == 0) and np.all(port[2] == 257)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_top2_matches_pallas_kernel(rng, kind):
    q, t, vt = _case(rng, 128, 256, kind)
    ref = pallas_top2(rmatch.signs_from_packed(jnp.asarray(q)),
                      rmatch.signs_from_packed(jnp.asarray(t)),
                      jnp.asarray(vt), interpret=True)
    for r, p in zip(ref, _port_top2(q, t, vt)):
        np.testing.assert_array_equal(p, np.asarray(r))


def _pair_case(rng, n, ma, mb, kind):
    """One query set and two train sets; with kind "ties" both train sets
    hold planted copies of the same query rows."""
    q, ta, va = _case(rng, n, ma, kind)
    _, tb, vb = _case(rng, n, mb, kind, q=q)
    return q, (ta, va), (tb, vb)


def _port_pair(q, a, b):
    t = [(convert.desc_to_tensor(x, "cpu"), torch.as_tensor(v)) for x, v in (a, b)]
    out = hk.hamming_top2_pair(convert.desc_to_tensor(q, "cpu"), *t[0], *t[1])
    assert len(out) == 2
    return [tuple(x.numpy() for x in r) for r in out]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,ma,mb", [(128, 256, 200), (100, 77, 130), (3, 2, 5), (17, 9, 2)])
def test_pair_top2_equals_two_single_calls_and_reference(rng, kind, n, ma, mb):
    q, a, b = _pair_case(rng, n, ma, mb, kind)
    for got, (t, vt) in zip(_port_pair(q, a, b), (a, b)):
        for g, single, ref in zip(got, _port_top2(q, t, vt), _ref_top2(q, t, vt)):
            assert g.dtype == single.dtype
            np.testing.assert_array_equal(g, single)
            np.testing.assert_array_equal(g, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_pair_top2_matches_pallas_kernel(rng, kind):
    q, a, b = _pair_case(rng, 128, 256, 384, kind)
    signs_q = rmatch.signs_from_packed(jnp.asarray(q))
    for got, (t, vt) in zip(_port_pair(q, a, b), (a, b)):
        ref = pallas_top2(signs_q, rmatch.signs_from_packed(jnp.asarray(t)),
                          jnp.asarray(vt), interpret=True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("kind", ["random", "masked", "all_invalid", "ties"])
def test_gate_matches_reproduces_match_descriptors(rng, kind):
    n = 200
    q, t, vt = _case(rng, n, 150, kind)
    t[: n // 4] = q[: n // 4]  # some exact matches, so the gates pass rows
    vq = rng.random(n) < 0.8
    args = [convert.desc_to_tensor(q, "cpu"), convert.desc_to_tensor(t, "cpu"),
            torch.from_numpy(vq), torch.from_numpy(vt)]
    want = pmatch.match_descriptors(*args, 30.0, 0.5)
    got = pmatch.gate_matches(pmatch.hamming_top2(args[0], args[1], args[3]), args[2],
                              30.0, 0.5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    if kind != "all_invalid":
        assert want[1].sum() > 10


def test_hamming_matrix_and_signs(rng):
    q, t, vt = _case(rng, 40, 50, "masked")
    vq = rng.random(40) < 0.8
    ref = rmatch.hamming_matrix(jnp.asarray(q), jnp.asarray(t), jnp.asarray(vq), jnp.asarray(vt))
    port = pmatch.hamming_matrix(convert.desc_to_tensor(q, "cpu"), convert.desc_to_tensor(t, "cpu"),
                                 torch.from_numpy(vq), torch.from_numpy(vt))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        pmatch.signs_from_packed(convert.desc_to_tensor(q, "cpu")).numpy(),
        np.asarray(rmatch.signs_from_packed(jnp.asarray(q)), np.float32))


@pytest.mark.parametrize("kind", ["random", "masked", "ties"])
def test_match_descriptors_matches_reference(rng, kind):
    n = 256
    q, _, vt = _case(rng, n, n, kind)
    t = q.copy()
    t[::2] = rng.integers(0, 2 ** 32, (n // 2, 8), dtype=np.uint32)
    flip = rng.integers(0, 256, (n, 3))  # a few flipped bits on the copies
    for i in range(1, n, 2):
        for b in flip[i]:
            t[i, b // 32] ^= np.uint32(1 << (b % 32))
    vq = rng.random(n) < 0.9
    idx_r, ok_r, d1_r = (np.asarray(x) for x in rmatch.match_descriptors(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(vq), jnp.asarray(vt), 30.0, 0.5,
        use_pallas=False))
    idx_p, ok_p, d1_p = (x.numpy() for x in pmatch.match_descriptors(
        convert.desc_to_tensor(q, "cpu"), convert.desc_to_tensor(t, "cpu"),
        torch.from_numpy(vq), torch.from_numpy(vt), 30.0, 0.5))
    np.testing.assert_array_equal(ok_p, ok_r)
    np.testing.assert_array_equal(d1_p, d1_r)
    np.testing.assert_array_equal(idx_p[vq], idx_r[vq])
    assert ok_p.sum() > 20

    mut_r = rmatch.mutual_filter(jnp.asarray(idx_r), jnp.asarray(ok_r), jnp.asarray(idx_r))
    mut_p = pmatch.mutual_filter(torch.from_numpy(idx_p), torch.from_numpy(ok_p),
                                 torch.from_numpy(idx_p))
    np.testing.assert_array_equal(mut_p.numpy()[vq], np.asarray(mut_r)[vq])

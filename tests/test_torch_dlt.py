"""The batched DLT kernel's method, and its wrapper on the CPU.

`csrc/triangulate_dlt.cu` cannot run here, so its arithmetic is held
through a NumPy float64 mirror of it: the same system, the same round-robin
pair order, rotation formula, stopping rules (relative 1e-15, absolute
1e-30 |A|_F^2, 16 sweeps) and column choice. Against `numpy.linalg.svd`
(LAPACK, another algorithm) the mirror's null vector agrees within 1e-12
of its unit norm, up to sign, on random rigs, EuRoC's 0.11 m baseline with
far points at 45-100 m and near-parallel rays (a few hundredths of a pixel
of disparity). The dehomogenised points agree to first order in that gap:
|dX| <= 1e-12 (1 + |X|) / |w|, the conditioning of the division by w.
Degenerate systems (all-zero rows, duplicated rows) have no unique null
vector; there the mirror's vector solves A v = 0 and the point is finite
under the |w| < 1e-12 guard. The sign of a null vector cancels in the
division. The float64 points lie within 3e-4 m of the JAX package's
float32 DLT at the test scene's depths (the bound of
tests/test_torch_general_stereo.py's DLT_F64_ATOL).

On the CPU the wrapper takes the plain version (`torch.linalg.svd`), so
`camera.triangulate_dlt` gives the points it gave before the kernel, bit
for bit. The kernel itself is held against the plain version and a
float64 DLT on the card (tests/test_torch_kernels.py, marker `cuda`).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth_distorted import EUROC, dlt_float64  # noqa: E402

from stereo_orb_slam_tpu.geometry import camera as rcam  # noqa: E402
from stereo_orb_slam_torch.geometry import camera as pcam  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import dlt  # noqa: E402

torch.set_num_threads(1)
# Round m of a sweep pairs lane (column) g with g ^ m; the lower plays P.
ROUNDS = {m: tuple((g, g ^ m) for g in range(4) if g < g ^ m) for m in (1, 2, 3)}
REL_TOL, ABS_TOL, MAX_SWEEPS = 1e-15, 1e-30, 16
# The relative error of the kernel's rsqrt seed, as its note documents it.
SEED_ERR = 2.0 ** -22
VEC_ATOL = 1e-12
JAX_F32_ATOL = 3e-4


def build_systems(P1, P2, uv1, uv2):
    """The kernel's A [N, 4, 4] in float64 from float32 inputs."""
    P1, P2 = np.asarray(P1, np.float64), np.asarray(P2, np.float64)
    uv1, uv2 = np.asarray(uv1, np.float64), np.asarray(uv2, np.float64)
    return np.stack([uv1[:, :1] * P1[2] - P1[0], uv1[:, 1:] * P1[2] - P1[1],
                     uv2[:, :1] * P2[2] - P2[0], uv2[:, 1:] * P2[2] - P2[1]], axis=1)


def dot4(x, y):
    """x . y over [N, 4] columns, as the kernel sums: two products pairwise."""
    return (x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1]) + (x[:, 2] * y[:, 2] + x[:, 3] * y[:, 3])


def scaled_systems(A):
    """A scaled by the kernel's power of two, 2^-floor(e / 2) with e the
    frexp exponent of |A|_F^2 (summed as the lanes sum it), and the scaled
    |A|_F^2, in [0.5, 4) (0 for A = 0)."""
    a = np.array(A, np.float64)
    n = [dot4(a[:, :, c], a[:, :, c]) for c in range(4)]
    frob = (n[0] + n[1]) + (n[2] + n[3])
    scale = np.ldexp(1.0, -(np.frexp(frob)[1] >> 1))
    return a * scale[:, None, None], frob * scale * scale


def rsqrt_seed(x):
    """The kernel's seed of 1/sqrt(x) (MUFU.RSQ64H), modelled at its worst
    documented error, SEED_ERR low on every call."""
    with np.errstate(divide="ignore"):
        return (1.0 / np.sqrt(x)) * (1.0 - SEED_ERR)


def refine(x, e, add):
    """The kernel's `refine`: x (1 + e / 2 + 3 e^2 / 8) + add, x (a multiple
    of a seeded root) corrected to second order in the seed's error (e = 1
    - (1 + delta)^2), left 2.5 delta^3 off (3e-20 at SEED_ERR); one Newton
    step would leave it 1.5 delta^2 low (8.5e-14)."""
    return x * e * (0.375 * e + 0.5) + add


def rotate(a, v, p, q, active, abs_tol):
    """The kernel's rotation of columns p < q of a and v where the pair
    passes the test (and the point is active); returns where it did. With
    d = beta - alpha and num = sign(d) 2 gamma: den = |d| + sqrt(d^2 +
    num^2) and c, s = (den, num) / sqrt(den^2 + num^2): den's root from the
    seed and one Newton step, the common factor's from the seed corrected
    to second order in c and s; no division."""
    ap, aq = a[:, :, p], a[:, :, q]
    alpha, beta, gamma = dot4(ap, ap), dot4(aq, aq), dot4(ap, aq)
    g2 = gamma * gamma
    do = active & (g2 > REL_TOL * REL_TOL * alpha * beta) & (np.abs(gamma) > abs_tol)
    d = beta - alpha
    with np.errstate(invalid="ignore", over="ignore"):
        root2 = 4.0 * g2 + d * d
        y = rsqrt_seed(root2)
        h = root2 * y
        den = 0.5 * h * (1.0 - h * y) + (h + np.abs(d))
        z = den * den + 4.0 * g2
        r = rsqrt_seed(z)
        e = 1.0 - z * r * r
        num = gamma * np.where(d < 0.0, -2.0, 2.0)
        c, s = (np.where(do, refine(x, e, x), 0.0)[:, None] for x in (den * r, num * r))
    for m in (a, v):
        mp, mq = m[:, :, p].copy(), m[:, :, q].copy()
        m[:, :, p] = np.where(do[:, None], c * mp - s * mq, mp)
        m[:, :, q] = np.where(do[:, None], s * mp + c * mq, mq)
    return do


def jacobi(A, swap=False):
    """The kernel's one-sided Jacobi on each A's columns, vectorised over
    the batch, round by round (the two rotations of a round in the order
    of ROUNDS, or the other with `swap`): returns (the scaled A's rotated
    columns [N, 4, 4], V [N, 4, 4], sweeps [N], rotations [N])."""
    a, frob = scaled_systems(A)
    n = a.shape[0]
    v = np.tile(np.eye(4), (n, 1, 1))
    abs_tol = ABS_TOL * frob
    active = np.ones(n, bool)
    sweeps, rotations = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for _ in range(MAX_SWEEPS):
        if not active.any():
            break
        sweeps += active
        rotated = np.zeros(n, bool)
        for pairs in ROUNDS.values():
            for p, q in (pairs[::-1] if swap else pairs):
                do = rotate(a, v, p, q, active, abs_tol)
                rotated |= do
                rotations += do
        active &= rotated
    return a, v, sweeps, rotations


def jacobi_null_vectors(A, swap=False):
    """`jacobi`'s null vectors [N, 4] (V's column of the smallest column
    norm of the rotated A, the first on a tie, as the kernel), sweeps [N]
    and rotations [N]."""
    a, v, sweeps, rotations = jacobi(A, swap)
    norms = np.stack([dot4(a[:, :, c], a[:, :, c]) for c in range(4)], axis=1)
    col = np.argmin(norms, axis=1)
    return v[np.arange(len(a)), :, col], sweeps, rotations


def dehomogenise(X):
    w = X[:, 3:]
    return X[:, :3] / np.where(np.abs(w) < 1e-12, 1e-12, w)


def _projection(K, R, t):
    return (K @ np.hstack([R, t[:, None]])).astype(np.float32)


def _rotation(rng, scale):
    w = rng.normal(0, scale, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _pixels(P, X):
    x = X @ np.asarray(P, np.float64)[:, :3].T + np.asarray(P, np.float64)[:, 3]
    return (x[:, :2] / x[:, 2:]).astype(np.float32)


def _euroc(baseline=EUROC["baseline"]):
    K = np.array([[EUROC["fx"], 0, EUROC["cx"]], [0, EUROC["fx"], EUROC["cy"]], [0, 0, 1.0]])
    return (_projection(K, np.eye(3), np.zeros(3)),
            _projection(K, np.eye(3), np.array([-baseline, 0.0, 0.0])))


def _points(rng, n, zlo, zhi):
    z = rng.uniform(zlo, zhi, n)
    return np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.5, 0.5, n) * z, z], 1)


def _case(name, rng, n=512):
    """(P1, P2, uv1, uv2) float32 for one of the well-posed cases."""
    if name == "random_rigs":
        K = np.array([[rng.uniform(200, 900), 0, rng.uniform(150, 600)],
                      [0, rng.uniform(200, 900), rng.uniform(100, 400)], [0, 0, 1.0]])
        P1 = _projection(K, _rotation(rng, 0.05), rng.normal(0, 0.1, 3))
        P2 = _projection(K, _rotation(rng, 0.1), rng.normal(0, 0.5, 3))
        X = _points(rng, n, 2.0, 30.0)
        noise = 0.5
    else:
        P1, P2 = _euroc()
        X = _points(rng, n, *{"euroc_far": (45.0, 100.0),
                              "near_parallel": (2e3, 2e4)}[name])
        noise = 0.3 if name == "euroc_far" else 0.0
    uv1 = _pixels(P1, X) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    return P1, P2, uv1, _pixels(P2, X)


def _aligned(v, ref):
    return v * np.where((v * ref).sum(1) < 0, -1.0, 1.0)[:, None]


@pytest.mark.parametrize("name", ["random_rigs", "euroc_far", "near_parallel"])
def test_mirror_matches_numpy_svd_null_vector(name):
    A = build_systems(*_case(name, np.random.default_rng(1)))
    v, sweeps, rotations = jacobi_null_vectors(A)
    ref = np.linalg.svd(A)[2][:, -1]
    np.testing.assert_allclose(_aligned(v, ref), ref, rtol=0, atol=VEC_ATOL)
    w = np.abs(ref[:, 3])
    bound = VEC_ATOL * (1.0 + np.linalg.norm(dehomogenise(ref), axis=1)) / w
    gap = np.abs(dehomogenise(v) - dehomogenise(ref)).max(1)
    assert (gap <= bound).all(), float((gap / bound).max())
    # Every point converged well before the cap; the operation count of the
    # roofline bound (chip_smoke.py) rests on these counts.
    assert sweeps.max() <= 8 and rotations.max() <= 6 * sweeps.max()


def test_mirror_on_degenerate_systems_is_finite():
    """All-zero rows (an invalid slot's zeros through zero projections) and
    duplicated rows (one view twice): no unique null vector, A v = 0 within
    float64 rounding, finite points under the |w| guard, and the rank-
    deficient pairs stop rotating (the absolute test) before the cap."""
    rng = np.random.default_rng(2)
    P1, _ = _euroc()
    uv = _pixels(P1, _points(rng, 64, 1.0, 10.0))
    zero = build_systems(np.zeros((3, 4)), np.zeros((3, 4)), uv, uv)
    dup = build_systems(P1, P1, uv, uv)
    half = build_systems(P1, np.zeros((3, 4)), uv, uv)
    for A in (zero, dup, half):
        v, sweeps, _ = jacobi_null_vectors(A)
        scale = np.sqrt((A * A).sum((1, 2)))[:, None]
        assert (np.abs(np.einsum("nij,nj->ni", A, v)) <= 1e-12 * np.maximum(scale, 1.0)).all()
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=0, atol=1e-14)
        assert np.isfinite(dehomogenise(v).astype(np.float32)).all()
        assert sweeps.max() < MAX_SWEEPS
    assert (jacobi_null_vectors(zero)[1] == 1).all()
    # The plain version (the wrapper's CPU path) is finite there too.
    zeros = np.zeros((3, 4), np.float32)
    for Pa, Pb in ((zeros, zeros), (P1, P1), (P1, zeros)):
        out = dlt.triangulate_dlt(torch.from_numpy(Pa), torch.from_numpy(Pb),
                                  torch.from_numpy(uv), torch.from_numpy(uv))
        assert torch.isfinite(out).all()


def _systems(name, seed):
    """A [N, 4, 4] of a well-posed case (`_case`), of degenerate systems
    (all-zero rows through zero projections, duplicated rows from one view
    twice, half zero), or of the smoke's kind of frame: invalid slots' zero
    pixels among points 1.5-5 m and 45-100 m deep."""
    rng = np.random.default_rng(seed)
    if name in ("random_rigs", "euroc_far", "near_parallel"):
        return build_systems(*_case(name, rng))
    P1, P2 = _euroc()
    if name == "invalid_slots":
        X = np.concatenate([_points(rng, 256, 1.5, 5.0), _points(rng, 256, 45.0, 100.0)])
        uv1 = _pixels(P1, X) + rng.normal(0, 0.3, (512, 2)).astype(np.float32)
        uv2 = _pixels(P2, X)
        invalid = rng.random(512) < 0.25
        uv1[invalid] = uv2[invalid] = 0.0
        return build_systems(P1, P2, uv1, uv2)
    uv = _pixels(P1, _points(rng, 64, 1.0, 10.0))
    zeros = np.zeros((3, 4))
    Pa, Pb = {"zero": (zeros, zeros), "duplicated": (P1, P1), "half": (P1, zeros)}[name]
    return build_systems(Pa, Pb, uv, uv)


SYSTEMS = ["random_rigs", "euroc_far", "near_parallel", "invalid_slots", "zero",
           "duplicated", "half"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", SYSTEMS)
def test_mirror_converges_within_the_cap(name, seed):
    """Every point of every seeded case stops on a sweep with no rotation
    before the 16-sweep cap, so the cap never decides a result; a warp's
    points sweep together, so its time is its slowest point's sweeps."""
    _, sweeps, rotations = jacobi_null_vectors(_systems(name, seed))
    assert sweeps.min() >= 1 and sweeps.max() < MAX_SWEEPS
    assert (rotations <= 6 * (sweeps - 1)).all()


@pytest.mark.parametrize("name", SYSTEMS)
def test_rotations_of_a_round_commute(name):
    """The two rotations of a round act on disjoint columns: the mirror's
    vectors and counts are the same bit for bit whichever runs first, so
    the kernel may run them at once on four lanes."""
    A = _systems(name, 3)
    for got, want in zip(jacobi_null_vectors(A, swap=True), jacobi_null_vectors(A)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SYSTEMS)
def test_rotations_keep_v_orthonormal(name):
    """The seed of 1 / sqrt(den^2 + num^2) (modelled at its worst,
    SEED_ERR), a common factor of c and s, is corrected to second order,
    which keeps every rotation orthogonal to float64 rounding,
    so V stays orthonormal over its 20-odd rotations (V^T V within 1e-13
    of I). One Newton step would leave each rotation's c^2 + s^2 short of 1
    by 3 SEED_ERR^2 (1.7e-13), and a seed left unrefined would drift by
    about 1e-6 a rotation. A V is the rotated A."""
    A = _systems(name, 5)
    a, v, _, _ = jacobi(A)
    gram = np.einsum("nri,nrj->nij", v, v)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape), rtol=0,
                               atol=1e-13)
    scaled, _ = scaled_systems(A)
    scale = np.sqrt((scaled * scaled).sum((1, 2)))[:, None, None]
    assert (np.abs(np.einsum("nrc,nck->nrk", scaled, v) - a) <= 1e-14 * scale).all()


def test_scaling_leaves_the_result_as_it_is():
    """The kernel scales A by a power of two before the sweeps: the mirror
    on 2^k A gives the same vectors and counts bit for bit, for k = -40 and
    40, and keeps |A|_F^2 in [0.5, 4)."""
    A = _systems("random_rigs", 4)
    want = jacobi_null_vectors(A)
    for k in (-40, 40):
        for got, ref in zip(jacobi_null_vectors(np.ldexp(A, k)), want):
            np.testing.assert_array_equal(got, ref)
    _, frob = scaled_systems(np.concatenate([A, np.ldexp(A, -300), np.ldexp(A, 300)]))
    assert ((frob >= 0.5) & (frob < 4.0)).all()


def test_sign_of_the_null_vector_cancels():
    """LAPACK's vectors and the mirror's differ in sign on some points; the
    points agree there, and -v dehomogenises to exactly v's point."""
    A = build_systems(*_case("random_rigs", np.random.default_rng(3)))
    v, _, _ = jacobi_null_vectors(A)
    ref = np.linalg.svd(A)[2][:, -1]
    flipped = (v * ref).sum(1) < 0
    assert flipped.any() and (~flipped).any()
    np.testing.assert_array_equal(dehomogenise(-v), dehomogenise(v))
    np.testing.assert_allclose(dehomogenise(v)[flipped], dehomogenise(ref)[flipped],
                               rtol=1e-9, atol=0)


def test_mirror_is_the_float64_dlt_and_near_the_reference():
    """The mirror's points are the float64 DLT's (tests/synth_distorted.py)
    and lie within JAX_F32_ATOL of the JAX package's float32 DLT, on the
    general-stereo test scene's rig (fx 220, baseline 0.4 m) at its depths
    (2-15 m)."""
    rng = np.random.default_rng(4)
    K = np.array([[220.0, 0, 160.0], [0, 220.0, 120.0], [0, 0, 1.0]])
    P1 = _projection(K, np.eye(3), np.zeros(3))
    P2 = _projection(K, np.eye(3), np.array([-0.4, 0.0, 0.0]))
    X = _points(rng, 512, 2.0, 15.0)
    uv1 = _pixels(P1, X) + rng.normal(0, 0.5, (512, 2)).astype(np.float32)
    uv2 = _pixels(P2, X)
    x = dehomogenise(jacobi_null_vectors(build_systems(P1, P2, uv1, uv2))[0])
    np.testing.assert_allclose(x, dlt_float64(P1, P2, uv1, uv2), rtol=1e-9, atol=0)
    ref = np.asarray(rcam.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv1),
                                          jnp.asarray(uv2)))
    np.testing.assert_allclose(ref, x, rtol=0, atol=JAX_F32_ATOL)


def _bank(rng, shape, P1, P2):
    """Correspondences of shape + (N,) points 1.5-10 m deep."""
    n = int(np.prod(shape))
    X = _points(rng, n, 1.5, 10.0)
    return (_pixels(P1, X).reshape(shape + (2,)), _pixels(P2, X).reshape(shape + (2,)))


@pytest.mark.parametrize("layout", ["shared", "stacked", "edges", "edges_64"])
def test_cpu_wrapper_is_the_plain_version(layout):
    """camera.triangulate_dlt on CPU tensors is the plain version bit for
    bit, for a shared rig ([N, 2]), a stacked rig (P [S, 1, 3, 4] with [S,
    N, 2], as triangulate_ideal passes it) and the loop edges' column
    slices of [E, N, 4] banks (E = 3, and E_pad = 64 of 1024 slots)."""
    rng = np.random.default_rng(5)
    P1, P2 = _euroc()
    if layout == "shared":
        uv1, uv2 = (torch.from_numpy(x) for x in _bank(rng, (300,), P1, P2))
        p1, p2 = torch.from_numpy(P1), torch.from_numpy(P2)
    elif layout == "stacked":
        Q1, Q2 = _euroc(baseline=0.2)
        uv1, uv2 = (torch.from_numpy(x) for x in _bank(rng, (2, 300), P1, P2))
        p1 = torch.from_numpy(np.stack([P1, Q1]))[:, None]
        p2 = torch.from_numpy(np.stack([P2, Q2]))[:, None]
    else:
        shape = (3, 300) if layout == "edges" else (64, 1024)
        uv = torch.from_numpy(np.concatenate(_bank(rng, shape, P1, P2), axis=-1))
        uv1, uv2 = uv[..., :2], uv[..., 2:]
        p1, p2 = torch.from_numpy(P1), torch.from_numpy(P2)
    got = pcam.triangulate_dlt(p1, p2, uv1, uv2)
    want = dlt.triangulate_dlt_plain(p1, p2, uv1, uv2)
    assert got.shape == uv1.shape[:-1] + (3,) and torch.equal(got, want)


def test_kernel_layout_of_the_inputs():
    """The launch's view of its inputs, computed on the CPU: projections
    shared or one per problem, correspondences as [B, N, 2] with their
    strides (column slices read in place)."""
    P = torch.zeros(3, 4)
    assert dlt._per_batch(P, (), 7) is False
    assert dlt._per_batch(P[None, None], (5,), 7) is False
    assert dlt._per_batch(torch.zeros(5, 1, 3, 4), (5,), 7) is True
    for bad in (torch.zeros(5, 3, 4), torch.zeros(5, 7, 3, 4), torch.zeros(4, 1, 3, 4)):
        with pytest.raises(ValueError, match="one projection per problem"):
            dlt._per_batch(bad, (5,), 7)
    bank = torch.zeros(3, 7, 4)
    flat, sb, sn = dlt._problems(bank[..., 2:], (3,), 7)
    assert (tuple(flat.shape), sb, sn) == ((3, 7, 2), 28, 4)
    assert flat.data_ptr() == bank[..., 2:].data_ptr()
    bank = torch.zeros(64, 1024, 4)
    flat, sb, sn = dlt._problems(bank[..., :2], (64,), 1024)
    assert (tuple(flat.shape), sb, sn) == ((64, 1024, 2), 4096, 4)
    flat, sb, sn = dlt._problems(torch.zeros(7, 2), (), 7)
    assert (tuple(flat.shape), sb, sn) == ((1, 7, 2), 14, 2)
    flat, sb, sn = dlt._problems(torch.zeros(2, 3, 7, 2), (2, 3), 7)
    assert (tuple(flat.shape), sb, sn) == ((6, 7, 2), 14, 2)
    with pytest.raises(ValueError, match="unit stride"):
        dlt._problems(torch.zeros(7, 2).t().contiguous().t(), (), 7)


def test_wrapper_rejects_bad_input():
    P, uv = torch.zeros(3, 4), torch.zeros(5, 2)
    with pytest.raises(ValueError, match="P1"):
        dlt.triangulate_dlt(P.double(), P, uv, uv)
    with pytest.raises(ValueError, match="P2"):
        dlt.triangulate_dlt(P, torch.zeros(4, 4), uv, uv)
    with pytest.raises(ValueError, match="uv1"):
        dlt.triangulate_dlt(P, P, torch.zeros(5, 3), uv)
    with pytest.raises(ValueError, match="differ"):
        dlt.triangulate_dlt(P, P, uv, torch.zeros(6, 2))
    with pytest.raises(ValueError, match="unsupported devices"):
        dlt.triangulate_dlt(P, P, uv, uv.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dlt.triangulate_dlt_work(P, P, uv, uv)

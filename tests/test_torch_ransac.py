"""Port parity: frontend/ransac.py against the JAX package, with the minimal
sets injected: the port's sampler returns the sets that the reference's
`_sample_minimal_sets` draws from the same key.

Tolerances: `transform` within 1e-5 (the same Horn iteration in float32;
sums run in another order), `inlier_mask` and `num_inliers` identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereo_orb_slam_tpu.frontend import ransac as rransac  # noqa: E402
from stereo_orb_slam_tpu.geometry import se3 as rse3  # noqa: E402
from stereo_orb_slam_torch.frontend import ransac as pransac  # noqa: E402

torch.set_num_threads(1)
K = 64
FX, CX, CY, B = 200.0, 160.0, 120.0, 0.5


def _proj():
    P_l = np.array([[FX, 0, CX, 0], [0, FX, CY, 0], [0, 0, 1, 0]], np.float32)
    P_r = P_l.copy()
    P_r[0, 3] = -FX * B
    return P_l, P_r


def _problem(rng, n=256, outliers=0.25, n_valid=200):
    """Stereo pairs under a known motion, with outliers and invalid slots."""
    T = np.asarray(rse3.pose6_to_matrix(jnp.asarray(
        np.array([0.02, -0.05, 0.01, 0.3, -0.1, 0.4], np.float32))))
    Xc = np.stack([rng.uniform(-6, 6, n), rng.uniform(-3, 3, n),
                   rng.uniform(4, 30, n)], 1).astype(np.float32)
    Xp = Xc @ T[:3, :3].T + T[:3, 3]
    bad = rng.random(n) < outliers
    Xp[bad] += rng.normal(0, 2.0, (bad.sum(), 3)).astype(np.float32)
    P_l, P_r = _proj()

    def obs(X):
        h = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
        l, r = h @ P_l.T, h @ P_r.T
        return np.concatenate([l[:, :2] / l[:, 2:], r[:, :2] / r[:, 2:]], 1)

    obs_p = (obs(Xp) + rng.normal(0, 0.3, (n, 4))).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    return Xc, Xp.astype(np.float32), obs(Xc).astype(np.float32), obs_p, valid, P_l, P_r


def _run_both(rng, key_seed, final_fit, **kw):
    Xc, Xp, oc, op, valid, P_l, P_r = _problem(rng, **kw)
    key = jax.random.key(key_seed)
    ref = rransac.solve(key, jnp.asarray(Xc), jnp.asarray(Xp), jnp.asarray(oc),
                        jnp.asarray(op), jnp.asarray(valid), jnp.ones(len(valid)),
                        jnp.asarray(P_l), jnp.asarray(P_r), num_hypotheses=K,
                        final_model_fitting=final_fit)

    def sampler(v):
        sets = rransac._sample_minimal_sets(key, jnp.asarray(v.numpy()), K)
        return torch.from_numpy(np.array(sets))

    t = torch.from_numpy
    port = pransac.solve(sampler, t(Xc), t(Xp), t(oc), t(op), t(valid),
                         torch.ones(len(valid)), t(P_l), t(P_r),
                         final_model_fitting=final_fit)
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("final_fit", [False, True])
def test_solve_matches_reference_with_injected_sets(rng, seed, final_fit):
    ref, port = _run_both(rng, seed, final_fit)
    assert bool(port.success) and bool(ref.success)
    np.testing.assert_allclose(port.transform.numpy(), np.asarray(ref.transform), atol=1e-5)
    np.testing.assert_array_equal(port.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    assert int(port.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(port.losses.numpy(), np.asarray(ref.losses), atol=1e-3)


def test_solve_fails_like_reference_with_too_few_pairs(rng):
    ref, port = _run_both(rng, 4, False, n_valid=6)
    assert not bool(port.success) and not bool(ref.success)
    np.testing.assert_array_equal(port.transform.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(port.inlier_mask.numpy(), np.asarray(ref.inlier_mask))


def test_kabsch_batched_matches_reference(rng):
    src = rng.normal(size=(16, 3, 3)).astype(np.float32) * 5
    T = np.asarray(rse3.se3_exp(jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))))
    dst = np.einsum("kij,kpj->kpi", T[:, :3, :3], src) + T[:, None, :3, 3]
    ref = np.stack([np.asarray(rransac.kabsch(jnp.asarray(s), jnp.asarray(d)))
                    for s, d in zip(src, dst)])
    port = pransac.kabsch(torch.from_numpy(src), torch.from_numpy(dst.astype(np.float32)))
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), T, atol=1e-4)


def test_gumbel_sampler_draws_distinct_valid_indices():
    valid = torch.zeros(100, dtype=torch.bool)
    valid[::3] = True
    gen = torch.Generator().manual_seed(5)
    sets = pransac.gumbel_sampler(gen, 32)(valid)
    assert sets.shape == (32, 3)
    assert bool(valid[sets].all())
    assert all(len(set(row.tolist())) == 3 for row in sets)
    again = pransac.gumbel_sampler(torch.Generator().manual_seed(5), 32)(valid)
    assert torch.equal(sets, again)

"""The port's BA residuals against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages'
functions; the JAX side runs op by op (not under `jax.jit`), so XLA's
fused multiply-adds do not enter. The two sides sum the small matrix
products in other orders (the port's `build_rows_soa` is batched where the
JAX package's is unrolled over scalar components). Tolerance: rtol 1e-5,
with an absolute floor of 1e-5 times the largest magnitude of the array
compared. The floor is there because the Jacobian products and the J^T J
sums cancel: an entry near zero carries the rounding of its largest
terms, a few float32 ulps of the array's scale, in both packages. The closed-form Jacobians are also held against
`torch.func.jacfwd` of the port's own residual, at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

torch = pytest.importorskip("torch")

from stereo_orb_slam_tpu.backend import residuals as jres  # noqa: E402
from stereo_orb_slam_tpu.geometry import se3 as jse3  # noqa: E402
from stereo_orb_slam_torch.backend import residuals as tres  # noqa: E402
from stereo_orb_slam_torch.geometry import se3 as tse3  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-5
FX, CX, CY, B = 718.856, 607.1928, 185.2157, 0.5371657


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _rig():
    P_l = np.array([[FX, 0, CX, 0], [0, FX, CY, 0], [0, 0, 1, 0]], np.float32)
    P_r = P_l.copy()
    P_r[0, 3] = -FX * B
    return P_l, P_r


def _observations(rng, rot, n=256):
    """Poses (rotation scale `rot` rad) and points 3-40 m in front of each
    pose's rig, pixel observations with 0.7 px noise and every tenth row
    an outlier (Huber's other branch), a tenth of the rows weighted 0
    (padding)."""
    P_l, P_r = _rig()
    pose6 = np.concatenate([rng.normal(0, rot, (n, 3)), rng.normal(0, 0.5, (n, 3))],
                           1).astype(np.float32)
    Y = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                  rng.uniform(3, 40, n)], 1)
    R = Rotation.from_rotvec(pose6[:, :3].astype(np.float64)).as_matrix()
    pts = np.einsum("nji,nj->ni", R, Y - pose6[:, 3:]).astype(np.float32)
    Yh = np.concatenate([Y, np.ones((n, 1))], 1)
    uv = np.concatenate([(Yh @ P.T)[:, :2] / Y[:, 2:] for P in (P_l, P_r)], 1)
    uv = uv + rng.normal(0, 0.7, uv.shape)
    uv[::10] += rng.normal(0, 30, uv[::10].shape)
    w = (rng.random(n) > 0.1).astype(np.float32)
    return pose6, pts, uv.astype(np.float32), w, P_l, P_r


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rot", [0.5, 0.01])
def test_build_rows_soa_matches_jax(rng, rot):
    args = _observations(rng, rot)
    want = jres.build_rows_soa(*map(jnp.asarray, args), 1.0)
    got = tres.build_rows_soa(*_t(*args), 1.0)
    assert [tuple(g.shape) for g in got] == [tuple(np.shape(w)) for w in want]
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("rot", [0.5, 0.01])
def test_jacobians_closed_match_jax_and_jacfwd(rng, rot):
    pose6, pts, uv, _, P_l, P_r = _observations(rng, rot)
    want = jres.jacobians_closed(jnp.asarray(pose6), jnp.asarray(pts), P_l, P_r)
    tp6, tpts, tuv, tPl, tPr = _t(pose6, pts, uv, P_l, P_r)
    got = tres.jacobians_closed(tp6, tpts, tPl, tPr)
    jac = torch.func.vmap(torch.func.jacfwd(tres.residual_one, argnums=(0, 1)),
                          in_dims=(0, 0, 0, None, None))(tp6, tpts, tuv, tPl, tPr)
    for g, w, a in zip(got, want, jac):
        close(g, w)
        close(g, a)


def test_robust_cost_and_residuals_match_jax(rng):
    pose6, pts, uv, w, P_l, P_r = _observations(rng, 0.3, n=128)
    # A problem with shared cameras and points: gather by index.
    C, P, O = 8, 40, 128
    cams, points = pose6[:C], pts[:P]
    oc = rng.integers(0, C, O).astype(np.int32)
    op = rng.integers(0, P, O).astype(np.int32)
    want = jres.robust_cost(*map(jnp.asarray, (cams, points, oc, op, uv, w, P_l, P_r)), 1.0)
    tc, tpt, tuv, tw, tPl, tPr = _t(cams, points, uv, w, P_l, P_r)
    toc, top = torch.from_numpy(oc).long(), torch.from_numpy(op).long()
    close(tres.robust_cost(tc, tpt, toc, top, tuv, tw, tPl, tPr, 1.0), want)
    close(tres.robust_cost_gathered(tc[toc], tpt[top], tuv, tw, tPl, tPr, 1.0), want)

    want = jres.residuals_and_jacobians(
        *map(jnp.asarray, (cams, points, oc, op, uv, w, P_l, P_r)), 1.0)
    got = tres.residuals_and_jacobians(tc, tpt, toc, top, tuv, tw, tPl, tPr, 1.0)
    for g, wv in zip(got, want):
        close(g, wv)


def test_right_jacobian_rotation_and_small_products(rng):
    # Angles across the Taylor switch (theta^2 < 1e-8) and up to 2 rad.
    w = np.concatenate([rng.normal(0, 1e-5, (16, 3)), rng.normal(0, 1.0, (48, 3))])
    w = w.astype(np.float32)
    tw = torch.from_numpy(w)
    Jr = tres.right_jacobian_so3(tw)
    close(Jr, jres.right_jacobian_so3(jnp.asarray(w)))
    R = tres._so3_exp(tw)
    close(R, tse3.so3_exp(tw))
    close(R, jse3.so3_exp(jnp.asarray(w)))
    close(tres.bmm(R, Jr), R @ Jr)
    close(tres.bmm(R[:, :2], Jr), R[:, :2] @ Jr)
    close(tres.bmv(R, tw), (R @ tw[:, :, None])[..., 0])


def test_project_rig_guards_the_plane_at_zero_depth():
    P_l, _ = _rig()
    X = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, 5.0], [0.0, 0.0, -1e-12]], np.float32)
    close(tres.project_rig(torch.from_numpy(P_l), torch.from_numpy(X)),
          jres.project_rig(jnp.asarray(P_l), jnp.asarray(X)))

"""Port parity: geometry/se3.py and geometry/camera.py against the JAX package.

Tolerances: atol 1e-5 in float32 (the same formulas; only reduction order
and library transcendental functions differ in the last bits), and 1e-4 for
the DLT triangulation, which goes through two different SVD routines.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereo_orb_slam_tpu.geometry import camera as rcam, se3 as rse3  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.geometry import camera as pcam, se3 as pse3  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


def _rand_w(rng, n, scale):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


def _rand_T(rng, n):
    w = _rand_w(rng, n, 1.0)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.asarray(rse3.pose6_to_matrix(jnp.asarray(np.concatenate([w, t], 1))))


def _cmp(ref, port, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 3.0])
def test_so3_se3_exp_log(rng, scale):
    w = _rand_w(rng, 64, scale)
    xi = np.concatenate([w, rng.normal(size=(64, 3)).astype(np.float32)], 1)
    _cmp(rse3.hat(jnp.asarray(w)), pse3.hat(torch.from_numpy(w)))
    _cmp(rse3.so3_exp(jnp.asarray(w)), pse3.so3_exp(torch.from_numpy(w)))
    _cmp(rse3.se3_exp(jnp.asarray(xi)), pse3.se3_exp(torch.from_numpy(xi)))
    R = np.asarray(rse3.so3_exp(jnp.asarray(w)))
    _cmp(rse3.so3_log(jnp.asarray(R)), pse3.so3_log(torch.from_numpy(R)))
    T = np.asarray(rse3.se3_exp(jnp.asarray(xi)))
    # se3_log against its float64 evaluation: the JAX package's loses
    # accuracy between rotations of 1e-4 and 0.1 (test_se3_log_small_angles).
    _cmp(pse3.se3_log(torch.from_numpy(T).double()), pse3.se3_log(torch.from_numpy(T)))
    if scale != 1e-2:
        _cmp(rse3.se3_log(jnp.asarray(T)), pse3.se3_log(torch.from_numpy(T)))
    _cmp(rse3.pose6_to_matrix(jnp.asarray(xi)), pse3.pose6_to_matrix(torch.from_numpy(xi)))
    _cmp(rse3.matrix_to_pose6(jnp.asarray(T)), pse3.matrix_to_pose6(torch.from_numpy(T)))


@pytest.mark.parametrize("scale", [2e-4, 1e-3, 1e-2])
def test_se3_log_small_angles(rng, scale):
    """Rotations between 1e-4 (the Taylor branch's edge) and 0.1: the JAX
    package's se3_log takes (1 - cos t) / t^2, which float32 rounds to 0 up
    to t of about 3.4e-4 (v NaN) and to a few ulps above, so its V^-1
    coefficient is off by up to about 1e-7 / t^4. The port takes
    2 sin^2(t/2) / t^2 and stays within 1e-5 of the float64 evaluation."""
    w = _rand_w(rng, 64, scale)
    xi = np.concatenate([w, rng.normal(size=(64, 3)).astype(np.float32)], 1)
    T = np.asarray(rse3.se3_exp(jnp.asarray(xi)))
    truth = pse3.se3_log(torch.from_numpy(T).double()).numpy()
    port = pse3.se3_log(torch.from_numpy(T)).numpy()
    ref = np.asarray(rse3.se3_log(jnp.asarray(T)), np.float64)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, truth, rtol=0, atol=1e-5)
    # The reference's error at these angles (recorded in ROADMAP queue 3).
    assert not (np.abs(ref - truth) <= 1e-4).all()


def test_log_near_pi(rng):
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = (axis * (np.pi - 1e-3)).astype(np.float32)
    R = np.asarray(rse3.so3_exp(jnp.asarray(w)))
    _cmp(rse3.so3_log(jnp.asarray(R)), pse3.so3_log(torch.from_numpy(R)), atol=1e-4)


def test_rigid_helpers(rng):
    T = _rand_T(rng, 32)
    pts = rng.normal(size=(32, 10, 3)).astype(np.float32)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    jT, tT = jnp.asarray(T), torch.from_numpy(T)
    _cmp(rse3.inverse(jT), pse3.inverse(tT))
    _cmp(rse3.transform_points(jT, jnp.asarray(pts)),
         pse3.transform_points(tT, torch.from_numpy(pts)))
    _cmp(rse3.rotmat_to_quat(jT[:, :3, :3]), pse3.rotmat_to_quat(tT[:, :3, :3]))
    _cmp(rse3.quat_to_rotmat(jnp.asarray(q)), pse3.quat_to_rotmat(torch.from_numpy(q)))
    noisy = T + rng.normal(size=T.shape).astype(np.float32) * 1e-3
    _cmp(rse3.normalize_pose(jnp.asarray(noisy)), pse3.normalize_pose(torch.from_numpy(noisy)))
    _cmp(rse3.rt_to_matrix(jT[:, :3, :3], jT[:, :3, 3]),
         pse3.rt_to_matrix(tT[:, :3, :3], tT[:, :3, 3]))


def _rigs(rectified):
    dist = None if rectified else [0.05, -0.01, 1e-3, -5e-4, 1e-3]
    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = 0.5
    ref_l = rcam.Pinhole.create(200.0, 200.0, 160.0, 120.0, dist=dist)
    ref_r = rcam.Pinhole.create(200.0, 201.0, 158.0, 120.0, dist=dist, pose=pose_r)
    ref = rcam.StereoRig.create(ref_l, ref_r, rectified=rectified)
    port_l = pcam.Pinhole.create(200.0, 200.0, 160.0, 120.0, dist=dist, device="cpu")
    port_r = pcam.Pinhole.create(200.0, 201.0, 158.0, 120.0, dist=dist, pose=pose_r,
                                 device="cpu")
    port = pcam.StereoRig.create(port_l, port_r, rectified=rectified)
    return ref, port


def _stereo_obs(rng, n=64):
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(2, 40, n)], 1).astype(np.float32)
    uv_l = X[:, :2] / X[:, 2:] * 200.0 + [160.0, 120.0]
    uv_r = (X[:, :2] - [0.5, 0.0]) / X[:, 2:] * 200.0 + [158.0, 120.0]
    return uv_l.astype(np.float32), uv_r.astype(np.float32), X


@pytest.mark.parametrize("rectified", [True, False])
def test_camera_models(rng, rectified):
    ref, port = _rigs(rectified)
    for field in rcam.Pinhole._fields:
        _cmp(getattr(ref.left, field), getattr(port.left, field))
        _cmp(getattr(ref.right, field), getattr(port.right, field))
    _cmp(ref.baseline, port.baseline)
    _cmp(ref.left.K, port.left.K)
    _cmp(ref.max_sensible_distance(), port.max_sensible_distance(), atol=1e-4)
    # The converted rig equals the one built by the port itself.
    conv = convert.rig_from_numpy(
        {"left": {f: np.asarray(getattr(ref.left, f)) for f in rcam.Pinhole._fields},
         "right": {f: np.asarray(getattr(ref.right, f)) for f in rcam.Pinhole._fields},
         "rectified": ref.rectified, "baseline": np.asarray(ref.baseline)}, "cpu")
    for a, b in zip(conv.left + conv.right, port.left + port.right):
        assert torch.equal(a, b)

    uv_l, uv_r, X = _stereo_obs(rng)
    _cmp(rcam.project(ref.left.projection, jnp.asarray(X)),
         pcam.project(port.left.projection, torch.from_numpy(X)), atol=1e-3)
    _cmp(rcam.undistort_points(ref.right, jnp.asarray(uv_r)),
         pcam.undistort_points(port.right, torch.from_numpy(uv_r)), atol=1e-3)


def test_triangulation(rng):
    uv_l, uv_r, _ = _stereo_obs(rng)
    uv_r[:4, 0] = uv_l[:4, 0] + 3.0  # negative disparity: invalid
    ref, port = _rigs(True)
    jl, jr = jnp.asarray(uv_l), jnp.asarray(uv_r)
    tl, tr = torch.from_numpy(uv_l), torch.from_numpy(uv_r)
    p_ref, v_ref = rcam.triangulate_rectified(ref, jl, jr)
    p_port, v_port = pcam.triangulate_rectified(port, tl, tr)
    np.testing.assert_array_equal(v_port.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(p_port.numpy(), np.asarray(p_ref), rtol=1e-6, atol=ATOL)
    p_ideal, v_ideal = pcam.triangulate_ideal(port, tl, tr, rectified=True)
    assert torch.equal(p_ideal, p_port) and torch.equal(v_ideal, v_port)
    # The host mirror repeats the device arithmetic exactly.
    p_np = pcam.triangulate_rectified_np(200.0, 160.0, 120.0, 158.0, 0.5, uv_l, uv_r)
    np.testing.assert_array_equal(p_np, p_port.numpy())

    gen_ref, gen_port = _rigs(False)
    d_ref = rcam.triangulate_dlt(gen_ref.left.projection, gen_ref.right.projection, jl, jr)
    d_port = pcam.triangulate_dlt(gen_port.left.projection, gen_port.right.projection, tl, tr)
    ok = np.asarray(v_ref)
    np.testing.assert_allclose(d_port.numpy()[ok], np.asarray(d_ref)[ok], rtol=1e-4, atol=1e-4)
    g_ref, gv_ref = rcam.triangulate_ideal(gen_ref, jl, jr, rectified=False)
    g_port, gv_port = pcam.triangulate_ideal(gen_port, tl, tr, rectified=False)
    np.testing.assert_array_equal(gv_port.numpy(), np.asarray(gv_ref))
    np.testing.assert_allclose(g_port.numpy()[ok], np.asarray(g_ref)[ok], rtol=1e-4, atol=1e-4)

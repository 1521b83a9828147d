"""The benchmark's scenes against the repository's NumPy scenes: the same
textures and poses give the same pixels, and the trajectories are the
drive's."""

import os
import sys

import numpy as np
import pytest
import torch

from portbench.scene import canyon, plane

TESTS = os.path.join(os.path.dirname(__file__), "..", "..", "tests")


@pytest.fixture(scope="module")
def synth():
    sys.path.insert(0, os.path.abspath(TESTS))
    try:
        import synth
        import synth_distorted
    finally:
        sys.path.pop(0)
    return synth, synth_distorted


@pytest.mark.parametrize("frame,right", [(0, False), (0, True), (37, False), (60, True),
                                         (120, False), (199, True)])
def test_canyon_matches_numpy_scene(synth, frame, right):
    """A 60 x 160 frame of the canyon drive's circuit from CanyonScene's own
    textures: every pixel within 1e-3 grey levels (float32 rounding of the
    bilinear read; the NumPy scene's wrap has period n - 1 and so has the
    copy)."""
    np_scene = synth[0].CanyonScene(np.random.default_rng(3), fx=100.0, cx=80.0, cy=30.0,
                                    baseline=0.54, h=60, w=160)
    tex = torch.from_numpy(np.stack([p[4] for p in np_scene.planes]))
    scene = canyon.CanyonScene(tex, 100.0, 80.0, 30.0, 0.54, 60, 160)
    T = canyon.loop_trajectory(200, side=3.0)[frame]
    want = np_scene.render_pose(T, right)
    got = scene.render_pose(T, right).numpy()
    assert np.abs(got - want).max() < 1e-3


def test_canyon_depth_matches_numpy_scene(synth):
    np_scene = synth[0].CanyonScene(np.random.default_rng(4), fx=100.0, cx=80.0, cy=30.0,
                                    h=60, w=160)
    tex = torch.from_numpy(np.stack([p[4] for p in np_scene.planes]))
    scene = canyon.CanyonScene(tex, 100.0, 80.0, 30.0, 0.54, 60, 160)
    T = canyon.loop_trajectory(200, side=3.0)[75]
    uv = np.stack([np.linspace(0, 159, 40), np.linspace(0, 59, 40)], 1)
    want = np_scene._trace(T, False, uv[:, 0], uv[:, 1])[1]
    np.testing.assert_allclose(scene.depth(T, uv).numpy(), want, rtol=1e-12)


def test_noise_is_drawn_from_the_generator():
    tex = canyon.make_textures(torch.Generator().manual_seed(1), tex_hw=64)
    scene = canyon.CanyonScene(tex, 40.0, 32.0, 16.0, 0.54, 32, 64, noise_sigma=1.0)
    traj = canyon.loop_trajectory(8, side=1.0)[:2]
    a = scene.render_pairs(traj, torch.Generator().manual_seed(5))
    b = scene.render_pairs(traj, torch.Generator().manual_seed(5))
    c = scene.render_pairs(traj, torch.Generator().manual_seed(6))
    assert a.dtype == torch.uint8 and torch.equal(a, b) and not torch.equal(a, c)
    assert 0.3 < float((a.float() - c.float()).abs().mean()) < 1.5


def test_plane_matches_numpy_scene(synth):
    """EuRoC cam0's distorted plane at 120 x 188 from DistortedPlaneScene's
    own texture: within 1e-3 grey levels."""
    sd = synth[1]
    e = dict(sd.EUROC, h=120, w=188, cx=94.0, cy=60.0, fx=115.0)
    np_scene = sd.DistortedPlaneScene(np.random.default_rng(0), fx=e["fx"], cx=e["cx"],
                                      cy=e["cy"], baseline=e["baseline"], depth=2.5, h=e["h"],
                                      w=e["w"], k1=e["k1"], k2=e["k2"])
    scene = plane.DistortedPlaneScene(torch.from_numpy(np_scene.tex), e["fx"], e["cx"],
                                      e["cy"], e["baseline"], 2.5, e["h"], e["w"],
                                      [e["k1"], e["k2"], 0.0, 0.0, 0.0])
    for x, right in ((0.0, False), (0.044, True), (1.3, False)):
        want = np_scene.render(x, right)
        assert np.abs(scene.render(x, right).numpy() - want).max() < 1e-3


def test_trajectories_are_the_drives(synth):
    np.testing.assert_array_equal(canyon.loop_trajectory(200, side=3.0),
                                  synth[0].loop_trajectory(200, side=3.0))
    sys.path.insert(0, os.path.abspath(TESTS))
    try:
        import synth_canyon
    finally:
        sys.path.pop(0)
    np.testing.assert_array_equal(canyon.two_episode_trajectory(1216, 3.0, 2.0),
                                  synth_canyon.two_episode_trajectory(1216, 3.0, 2.0))


def test_circuit_closes_in_one_step():
    """Handed over in a cycle, the drive's circuit moves the camera from its
    last pose to its first by one frame's step: 60 mm, and the corner's
    7.5 degrees of yaw at most."""
    traj = canyon.loop_trajectory(200, side=3.0).astype(np.float64)
    for a, b in zip(range(200), list(range(1, 200)) + [0]):
        step = np.linalg.norm(traj[b, :3, 3] - traj[a, :3, 3])
        assert abs(step - 0.06) < 1e-5
        cos = (np.trace(traj[a, :3, :3].T @ traj[b, :3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 7.5 + 1e-4


def test_plane_inverts_its_distortion():
    """With fy and the tangential terms of EuRoC cam0, a distorted pixel's
    ideal coordinates distort back to the pixel."""
    dist = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
    scene = plane.DistortedPlaneScene(torch.zeros(8, 8), 458.654, 367.215, 248.375, 0.11,
                                      2.5, 480, 752, dist, fy=457.296)
    uu = torch.linspace(0.0, 751.0, 64, dtype=torch.float64)
    vv = torch.linspace(0.0, 479.0, 64, dtype=torch.float64)
    x, y = scene._ideal(uu, vv)
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    assert float((xd * 458.654 + 367.215 - uu).abs().max()) < 0.05
    assert float((yd * 457.296 + 248.375 - vv).abs().max()) < 0.05

"""The EuRoC layout through both packages' CLIs, on the CPU: a distorted,
non-rectified synthetic sequence written as a EuRoC `mav0` tree with the
reference's key=value camera file (distortion and extrinsics), the recipe
of tests/test_euroc_e2e.py (8 frames of `DistortedPlaneScene`, 0.05 m per
frame), written with PIL from tests/synth_distorted.py.

- The JAX package's VO CLI and the port's (`--device cpu`), the port's
  RANSAC sets injected from the JAX package's per-frame keys (its
  `VisualOdometer` default seed 0): `trajectory_vo.txt`, `poses.txt`,
  `constraints.txt` and `waypoints_vo.ply` exist in both output folders;
  the same frame count, the same constraint rows (frame and point ids) and
  PLY header; trajectories, poses and points within
  test_torch_general_stereo.DLT_PAIR_ATOL (the float32 DLT of the two
  packages, see there) plus the exports' 6-significant-digit print (1e-4 m
  at 10 m), pixels within 2e-3 (the print at hundreds of pixels).
- The port alone, with its own sampler, passes the JAX test's own gates:
  x within 0.08 m of the truth, x motion monotonic, |y|, |z| < 0.25 m.
- The port's SLAM CLI with `--dataset EuRoc` on the same tree: every frame
  tracked, the same gates, its artifacts written.
"""

import functools
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL.Image")

from synth_distorted import (  # noqa: E402
    DistortedPlaneScene, write_camera_file, write_euroc_tree, write_gt,
)
from test_torch_general_stereo import DLT_PAIR_ATOL, keyed_sampler  # noqa: E402

from stereo_orb_slam_tpu.apps import visual_odometry as jvo_app  # noqa: E402
from stereo_orb_slam_torch.apps import slam as slam_app, visual_odometry  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer  # noqa: E402
from stereo_orb_slam_torch.io import calib, export  # noqa: E402

torch.set_num_threads(1)
STEP, N_FRAMES = 0.05, 8
PRINT_ATOL = 1e-4       # 6 significant digits of coordinates up to 10 m
UV_ATOL = 2e-3          # 6 significant digits of pixels in the hundreds
VO_FILES = ("trajectory_vo.txt", "poses.txt", "points.txt", "constraints.txt",
            "waypoints_vo.ply")


@pytest.fixture(scope="module")
def euroc(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    scene = DistortedPlaneScene(np.random.default_rng(0))
    xs = [i * STEP for i in range(N_FRAMES)]
    write_euroc_tree(str(root), scene, xs)
    write_camera_file(str(root / "camera.txt"), scene)
    write_gt(str(root / "gt.txt"), xs)
    return root, xs


def _args(root, out, suffix="vo"):
    return ["--dataset", "EuRoc", "--folder", str(root), "--camera", str(root / "camera.txt"),
            "--output_dir", str(out), "--output_suffix", suffix, "--gt", str(root / "gt.txt")]


def _assert_reference_gates(traj, xs):
    """tests/test_euroc_e2e.py's gates on a [frames, 3, 4] trajectory."""
    assert len(traj) == len(xs)
    est_x = traj[:, 0, 3]
    np.testing.assert_allclose(est_x, xs, atol=0.08)
    assert np.all(np.diff(est_x) > 0), "x motion must be monotonic"
    assert np.abs(traj[:, 1, 3]).max() < 0.25
    assert np.abs(traj[:, 2, 3]).max() < 0.25


def test_camera_file_gives_the_general_rig(euroc):
    root, _ = euroc
    rig = calib.load_camera(str(root / "camera.txt"), device="cpu")
    assert rig.rectified is False
    assert abs(float(rig.baseline) - 0.4) < 1e-6
    np.testing.assert_allclose(rig.left.dist.numpy(), [-0.15, 0.03, 0, 0, 0], atol=1e-7)
    np.testing.assert_allclose(rig.right.pose.numpy()[0, 3], 0.4, atol=1e-7)


def test_vo_cli_matches_reference_on_euroc(euroc, tmp_path, monkeypatch):
    root, xs = euroc
    ref_out, port_out = tmp_path / "ref", tmp_path / "port"
    os.makedirs(ref_out)
    jvo_app.main(_args(root, ref_out))

    base = jax.random.key(0)  # the JAX package's VisualOdometer default seed
    monkeypatch.setattr(visual_odometry, "VisualOdometer", functools.partial(
        VisualOdometer, sampler_for_frame=lambda i: keyed_sampler(jax.random.fold_in(base, i))))
    summary = visual_odometry.main(_args(root, port_out) + ["--device", "cpu"])
    assert summary["frames"] == N_FRAMES
    for name in VO_FILES:
        assert (ref_out / name).exists() and (port_out / name).exists(), name

    traj = [np.loadtxt(out / "trajectory_vo.txt").reshape(-1, 3, 4)
            for out in (port_out, ref_out)]
    assert traj[0].shape == traj[1].shape == (N_FRAMES, 3, 4)
    atol = DLT_PAIR_ATOL + PRINT_ATOL
    np.testing.assert_allclose(traj[0], traj[1], rtol=0, atol=atol)
    np.testing.assert_allclose(export.read_poses_txt(str(port_out / "poses.txt")),
                               export.read_poses_txt(str(ref_out / "poses.txt")), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(export.read_points_txt(str(port_out / "points.txt")),
                               export.read_points_txt(str(ref_out / "points.txt")), rtol=0,
                               atol=atol)
    got = export.read_constraints_txt(str(port_out / "constraints.txt"))
    want = export.read_constraints_txt(str(ref_out / "constraints.txt"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=UV_ATOL)
    np.testing.assert_array_equal(got[3], want[3])
    heads = [open(out / "waypoints_vo.ply").read().split("end_header")[0]
             for out in (port_out, ref_out)]
    assert heads[0] == heads[1] and f"element vertex {N_FRAMES}" in heads[0]
    _assert_reference_gates(traj[1], xs)


def test_port_vo_cli_passes_the_reference_gates(euroc, tmp_path):
    """The port with its own seeded Gumbel sampler, no injected sets."""
    root, xs = euroc
    summary = visual_odometry.main(_args(root, tmp_path) + ["--device", "cpu"])
    assert summary["ate_m"] < 0.08
    for name in VO_FILES:
        assert (tmp_path / name).exists(), name
    _assert_reference_gates(np.loadtxt(tmp_path / "trajectory_vo.txt").reshape(-1, 3, 4), xs)


def test_port_slam_cli_on_euroc(euroc, tmp_path):
    """`apps.slam` with --dataset EuRoc on the distorted tree: per-frame
    and window BA on the general rig's projections, every frame kept (the
    vocabulary trains at frame 12, so 8 frames write no loop files)."""
    root, xs = euroc
    summary = slam_app.main(_args(root, tmp_path, "slam")
                            + ["--refine_interval", "4", "--device", "cpu"])
    world = summary["system"].world
    assert summary["frames"] == world.num_frames == N_FRAMES
    assert summary["ate_m"] < 0.08
    for name in ("trajectory_slam.txt", "poses.txt", "points.txt", "constraints.txt",
                 "waypoints_slam.ply", "map_slam.ply", "pose_graph_slam.ply"):
        assert (tmp_path / name).exists(), name
    _assert_reference_gates(np.loadtxt(tmp_path / "trajectory_slam.txt").reshape(-1, 3, 4), xs)

"""The port's VO app end to end on the synthetic-KITTI recipe of
.claude/skills/verify/SKILL.md (12 PlaneScene frames, +0.2 m/frame in x).

Checks: ATE < 0.01 m with --device cpu, and the app's poses.txt,
points.txt, constraints.txt, waypoints and trajectory files byte-identical
to what the JAX package's io.export writes from the port's WorldMap.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from synth import PlaneScene  # noqa: E402

from stereo_orb_slam_tpu.io import export as rexport  # noqa: E402
from stereo_orb_slam_torch.apps import visual_odometry  # noqa: E402

torch.set_num_threads(1)


def _write_sequence(root, n=12, step=0.2):
    seq = os.path.join(root, "sequences", "03")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, cam))
    scene = PlaneScene(np.random.default_rng(42))
    gt = []
    for i in range(n):
        for cam, right in (("image_0", False), ("image_1", True)):
            img = scene.render(i * step, right=right).clip(0, 255).astype(np.uint8)
            Image.fromarray(img, "L").save(os.path.join(seq, cam, f"{i:06d}.png"))
        T = np.eye(4)
        T[0, 3] = i * step
        gt.append(" ".join(f"{v:.6f}" for v in T[:3, :].reshape(12)))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {scene.fx} 0 {scene.cx} 0 0 {scene.fx} {scene.cy} 0 0 0 1 0\n"
                f"P1: {scene.fx} 0 {scene.cx} {-scene.fx * scene.baseline} 0 "
                f"{scene.fx} {scene.cy} 0 0 0 1 0\n")
    gt_path = os.path.join(root, "gt_03.txt")
    with open(gt_path, "w") as f:
        f.write("\n".join(gt) + "\n")
    return seq, gt_path


def test_vo_app_on_cpu_reaches_ate_and_writes_reference_files(tmp_path):
    seq, gt = _write_sequence(str(tmp_path))
    out = str(tmp_path / "vo_out")
    summary = visual_odometry.main([
        "--dataset", "kitti", "--folder", seq, "--camera", os.path.join(seq, "calib.txt"),
        "--output_dir", out, "--gt", gt, "--device", "cpu",
    ])
    assert summary["frames"] == 12
    assert summary["ate_m"] < 0.01
    world = summary["world"]
    assert world.num_frames == 12 and world.num_points > 100

    ref_dir = str(tmp_path / "ref_out")
    n = world.num_frames
    rexport.dump_world(ref_dir, world)
    rexport.save_poses_ply(os.path.join(ref_dir, "waypoints_vo.ply"), world.pose_global[:n])
    rexport.save_kitti_trajectory(os.path.join(ref_dir, "trajectory_vo.txt"),
                                  world.pose_global[:n])
    for name in ("poses.txt", "points.txt", "constraints.txt", "waypoints_vo.ply",
                 "trajectory_vo.txt"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(ref_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_vo_app_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    seq, _ = _write_sequence(str(tmp_path), n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visual_odometry.main(["--dataset", "kitti", "--folder", seq,
                              "--camera", os.path.join(seq, "calib.txt"),
                              "--output_dir", str(tmp_path / "o")])

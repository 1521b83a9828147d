"""The general path's VO accuracy in both packages, on the CPU.

Renders the distorted EuRoC tree of `chip_smoke.py`'s `general` phase
(`chip_smoke._render_general`: EuRoC MAV cam0, 752x480, a plane at 2.52 m,
60 whole 8 px steps) and runs the JAX package's VO CLI and the port's
(`--device cpu`) on it, each as its own process with its own RANSAC
draws, and the port's VO app once more in this process with the JAX
package's draws (its `VisualOdometer` default key, folded with the frame
index, as tests/test_torch_euroc_app.py injects them). It prints one JSON
line with each run's ATE (`utils.evaluate.ate_rmse` of its
`trajectory_vo.txt` against the tree's ground truth), its largest x error
and the largest gap of each port run's trajectory to the JAX package's.
It is the witness for the smoke's VO gate (`chip_smoke.GENERAL_VO_ATE_M`):
the error the port reaches on the card is of the size the reference
reaches on the same frames.

    python tests/general_vo_witness.py [--frames 60] [--out DIR]

It is a script, not a test: one run takes minutes on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_vo(package, g, out_dir, extra=()):
    """The VO CLI of `package` on the tree `g`; returns its [frames, 3, 4]
    trajectory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", f"{package}.apps.visual_odometry", "--dataset", "EuRoc",
           "--folder", g["vo"], "--camera", g["camera"], "--output_dir", out_dir,
           "--gt", os.path.join(g["vo"], "gt.txt"), *extra]
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)
    return np.loadtxt(os.path.join(out_dir, "trajectory_vo.txt")).reshape(-1, 3, 4)


def run_port_with_jax_draws(g, out_dir):
    """The port's VO app (`--device cpu`) in this process, its RANSAC sets
    drawn as the JAX package's VisualOdometer draws them."""
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from stereo_orb_slam_tpu.frontend import ransac as jransac
    from stereo_orb_slam_torch.apps import visual_odometry
    from stereo_orb_slam_torch.config import RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer

    base, k = jax.random.key(0), RansacConfig().num_hypotheses

    def sampler_for_frame(i):
        key = jax.random.fold_in(base, i)
        return lambda valid: torch.from_numpy(np.array(jransac._sample_minimal_sets(
            key, jnp.asarray(valid.cpu().numpy()), k)))

    visual_odometry.VisualOdometer = functools.partial(VisualOdometer,
                                                       sampler_for_frame=sampler_for_frame)
    visual_odometry.main(["--dataset", "EuRoc", "--folder", g["vo"], "--camera", g["camera"],
                          "--output_dir", out_dir, "--gt", os.path.join(g["vo"], "gt.txt"),
                          "--device", "cpu"])
    return np.loadtxt(os.path.join(out_dir, "trajectory_vo.txt")).reshape(-1, 3, 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=None, help="folder for the tree and the exports "
                    "(a temporary one by default)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import chip_smoke
    from stereo_orb_slam_torch.utils import evaluate

    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        os.makedirs(root, exist_ok=True)
        g = chip_smoke._render_general(root, frames=args.frames)
        gt = np.loadtxt(os.path.join(g["vo"], "gt.txt")).reshape(-1, 3, 4)
        traj = {"jax": run_vo("stereo_orb_slam_tpu", g, os.path.join(root, "jax_out")),
                "port": run_vo("stereo_orb_slam_torch", g, os.path.join(root, "port_out"),
                               ("--device", "cpu")),
                "port_jax_draws": run_port_with_jax_draws(
                    g, os.path.join(root, "port_jax_draws_out"))}
        rec = {"frames": args.frames, "size": list(g["size"]), "depth_m": g["depth_m"],
               "step_m": g["step_m"],
               "ate_m": {k: evaluate.ate_rmse(t, gt) for k, t in traj.items()},
               "x_err_max_m": {k: float(np.abs(t[:, 0, 3] - gt[:, 0, 3]).max())
                               for k, t in traj.items()},
               "trajectory_gap_to_jax_max_m": {
                   k: float(np.abs(traj["jax"] - traj[k]).max())
                   for k in ("port", "port_jax_draws")}}
    print(json.dumps({"general_vo_witness": rec}))
    return rec


if __name__ == "__main__":
    main()

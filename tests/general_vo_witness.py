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

With `--float64-dlt` it also runs the port's VO app (its own draws and
the JAX package's) with the DLT replaced by a float64 DLT rounded once to
float32, the function of the card's DLT kernel (csrc/triangulate_dlt.cu),
and compares frame 1 of the tree (`frontend_step` on frames 0 and 1 with
the smoke's CPU samplers, `chip_smoke._edge_sampler`) under both DLTs:
the counts, slot validity and the largest point and transform gaps, what
the smoke's card-against-CPU check of that frame then sees.

    python tests/general_vo_witness.py [--frames 60] [--out DIR] [--float64-dlt]

It is a script, not a test: one run takes minutes on a CPU.
"""

from __future__ import annotations

import argparse
import contextlib
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


def jax_sampler_for_frame():
    """sampler_for_frame drawing the RANSAC sets as the JAX package's
    VisualOdometer draws them (its default key folded with the frame)."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from stereo_orb_slam_tpu.frontend import ransac as jransac
    from stereo_orb_slam_torch.config import RansacConfig

    base, k = jax.random.key(0), RansacConfig().num_hypotheses

    def sampler_for_frame(i):
        key = jax.random.fold_in(base, i)
        return lambda valid: torch.from_numpy(np.array(jransac._sample_minimal_sets(
            key, jnp.asarray(valid.cpu().numpy()), k)))
    return sampler_for_frame


def run_port_with_jax_draws(g, out_dir):
    """The port's VO app (`--device cpu`) in this process, its RANSAC sets
    drawn as the JAX package's VisualOdometer draws them."""
    return run_port_in_process(g, out_dir, jax_sampler_for_frame())


def dlt_float64_rounded(P1, P2, uv1, uv2):
    """The DLT of the plain version in float64 (the system built from the
    float32 inputs, torch.linalg.svd, the same |w| guard), rounded once to
    float32."""
    from stereo_orb_slam_torch.ops.kernels import dlt

    return dlt.triangulate_dlt_plain(*(x.double() for x in (P1, P2, uv1, uv2))).float()


@contextlib.contextmanager
def float64_dlt():
    """While inside, the port's front end triangulates with
    `dlt_float64_rounded` (camera.triangulate_ideal's DLT)."""
    from stereo_orb_slam_torch.geometry import camera

    plain = camera.triangulate_dlt
    camera.triangulate_dlt = dlt_float64_rounded
    try:
        yield
    finally:
        camera.triangulate_dlt = plain


def run_port_in_process(g, out_dir, sampler_for_frame=None):
    """The port's VO app (`--device cpu`) in this process, with its own
    RANSAC draws or `sampler_for_frame`'s."""
    import functools

    from stereo_orb_slam_torch.apps import visual_odometry
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer

    visual_odometry.VisualOdometer = (
        VisualOdometer if sampler_for_frame is None
        else functools.partial(VisualOdometer, sampler_for_frame=sampler_for_frame))
    try:
        visual_odometry.main(["--dataset", "EuRoc", "--folder", g["vo"], "--camera",
                              g["camera"], "--output_dir", out_dir, "--gt",
                              os.path.join(g["vo"], "gt.txt"), "--device", "cpu"])
    finally:
        visual_odometry.VisualOdometer = VisualOdometer
    return np.loadtxt(os.path.join(out_dir, "trajectory_vo.txt")).reshape(-1, 3, 4)


def frame1_gap(g, frame=1):
    """Frame `frame` of the tree through `frontend_step` with the plain DLT
    and with `dlt_float64_rounded` (the same RANSAC sets): whether the
    counts and slot validity agree, and the largest gaps of valid points
    and of the transform."""
    import chip_smoke
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import _to_host, empty_slots, frontend_step
    from stereo_orb_slam_torch.io import calib, datasets

    fe, rc = FrontendConfig(), RansacConfig()
    rig = calib.load_camera(g["camera"], device="cpu")
    pairs = datasets.load_dataset("EuRoc", g["vo"])[: frame + 1]
    out = {}
    for name, ctx in (("float32", contextlib.nullcontext), ("float64", float64_dlt)):
        with ctx():
            prev, usable = empty_slots(fe.num_features, "cpu"), False
            for j, (a, b) in enumerate(pairs):
                res = frontend_step(
                    torch.from_numpy(datasets.read_grayscale(a)),
                    torch.from_numpy(datasets.read_grayscale(b)), prev, torch.tensor(usable),
                    chip_smoke._edge_sampler(j, rc.num_hypotheses), rig,
                    rig.max_sensible_distance(), fe, rc, rectified=False)
                prev, usable = res.slots, True
        out[name] = _to_host(res)
    a, b = out["float32"], out["float64"]
    keys = ("num_stereo", "num_temporal", "num_inliers", "ransac_success")
    valid = a.slots.valid
    return {"same_counts": all(int(getattr(a, k)) == int(getattr(b, k)) for k in keys),
            "same_validity": bool(np.array_equal(valid, b.slots.valid)),
            "points_max_gap_m": float(np.abs(a.slots.pts - b.slots.pts)[valid].max()),
            "transform_max_gap": float(np.abs(a.transform - b.transform).max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=None, help="folder for the tree and the exports "
                    "(a temporary one by default)")
    ap.add_argument("--float64-dlt", action="store_true",
                    help="also run the port with a float64 DLT (the card kernel's function)")
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
        if args.float64_dlt:
            with float64_dlt():
                traj["port_float64_dlt"] = run_port_in_process(
                    g, os.path.join(root, "port_f64_out"))
                traj["port_jax_draws_float64_dlt"] = run_port_in_process(
                    g, os.path.join(root, "port_jax_draws_f64_out"), jax_sampler_for_frame())
        rec = {"frames": args.frames, "size": list(g["size"]), "depth_m": g["depth_m"],
               "step_m": g["step_m"],
               "ate_m": {k: evaluate.ate_rmse(t, gt) for k, t in traj.items()},
               "x_err_max_m": {k: float(np.abs(t[:, 0, 3] - gt[:, 0, 3]).max())
                               for k, t in traj.items()},
               "trajectory_gap_to_jax_max_m": {
                   k: float(np.abs(traj["jax"] - traj[k]).max())
                   for k in ("port", "port_jax_draws")}}
        if args.float64_dlt:
            rec["frame1_float32_vs_float64_dlt"] = frame1_gap(g)
    print(json.dumps({"general_vo_witness": rec}))
    return rec


if __name__ == "__main__":
    main()

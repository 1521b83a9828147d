"""The canyon drive's SLAM accuracy in the JAX package, on the CPU.

Renders the KITTI tree of `chip_smoke.py`'s canyon phase
(`synth_canyon.render_tree`: a 376x1241 `CanyonScene`, sensor noise sigma
1, seed 7, 192 frames of one circuit of a 3 m square and its revisit) and
runs the JAX package's SLAM CLI on it with the canyon drive's flags
(`synth_canyon.CANYON_FLAGS`, those of benchmarks/canyon_drive.py), as its
own process on the CPU. With `--port` it also runs the port's SLAM CLI
(`--device cpu`) on the same tree, with its own RANSAC draws. It prints one
JSON line per run: the live and final ATE (`utils.evaluate.ate_rmse` of
the CLI's poses against the tree's ground truth, as the CLI prints them),
the loop events of its `loop_matches.txt` (`synth_canyon.loop_events`:
episodes counted as the drive counts them, loop exits, i.e. live
closures, and the loop probability's largest value and its smallest after
the first entry), and the wall seconds.

It is the witness for the smoke's canyon gate (`chip_smoke.CANYON_SLAM_ATE_M`
= 1.5 x the JAX package's ATE + 0.01 m): the error the port reaches on the
card is held to the size the reference reaches on the same frames.

    python tests/canyon_witness.py [--out DIR] [--frames 192] [--port]
        [--finish_seconds S] [--no_render]
    python tests/canyon_witness.py --vo 60 [--seeds 4]
    python tests/canyon_witness.py --out DIR --trajectories T [T ...]

With `--trajectories T...` it runs nothing and reads KITTI trajectories
(the CLIs' trajectory_slam.txt) against the tree's ground truth
(`--out DIR`'s, or `--gt`): per trajectory the ATE over the frames before
each of `--bounds` and over all, and the frames with the largest
per-frame relative translation errors.

`--finish_seconds S` replaces the drive's 150 s finish budget (0: no
budget, every solve to its iteration cap). Each run's JSON line carries
`finish_s`, the StageTimers totals of its pose graph (with the global BA
it triggers) and its final BA: on the CPU the budget can cut them, which
makes the JAX package's ATE worse (at --frames 1216 it did, 138.95 s of
150; PERF.md), so the long drive's witness is the run with
--finish_seconds 0. `--no_render` reuses the tree a run with the same
--out rendered.

With `--vo N` it runs, instead, the first N frames through both packages'
VisualOdometer on the CPU, with the shipped RansacConfig() and with
final_model_fitting=True (the JAX package at seed 0, the port at seeds 0
to --seeds - 1), printing ATE and RPE per run and, for the port's seed 0,
the median per-frame errors of frames with fewer and with at least 150
stereo matches: the CPU side of the smoke's fractional-pixel measurement.

It is a script, not a test: on an 8-core CPU the render takes about 30 s,
the JAX package's run about 4 minutes and the port's about 8.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import synth_canyon  # noqa: E402


def run_slam(package, folder, gt, out_dir, extra=()):
    """The SLAM CLI of `package` over the tree; returns its summary."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", f"{package}.apps.slam", "--dataset", "kitti",
           "--folder", folder, "--camera", os.path.join(folder, "calib.txt"),
           "--output_dir", out_dir, "--gt", gt, *synth_canyon.CANYON_FLAGS, *extra]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, check=True, cwd=ROOT, env=env, capture_output=True,
                         text=True).stdout
    seconds = time.perf_counter() - t0

    def grab(pattern):
        m = re.search(pattern, out, re.M)
        return float(m.group(1)) if m else None

    def timer_s(name):  # a StageTimers report line's total seconds
        return grab(rf"^{re.escape(name)}\s+\d+ calls .* ([\d.]+) s total$")

    events = synth_canyon.loop_events(os.path.join(out_dir, "loop_matches.txt"))
    return {"package": package, "ate_live_m": grab(r"live ATE RMSE: ([\d.]+) m"),
            "ate_m": grab(r"(?<!live )ATE RMSE: ([\d.]+) m"),
            "rpe_m": grab(r"RPE: ([\d.]+) m"), "loop_events": events, "seconds": seconds,
            "finish_s": {"pose_graph": timer_s("pose_graph.final"),
                         "final_ba": timer_s("ba.final")}}


def _relative_errors(poses, gt):
    """Per-frame translation error (m) and rotation error (degrees) of each
    relative pose against the ground truth's."""
    def h(T):  # [3, 4] or [4, 4] -> [4, 4]
        return np.vstack([np.asarray(T, np.float64)[:3], [0.0, 0.0, 0.0, 1.0]])

    poses, gt = [h(T) for T in poses], [h(T) for T in gt]
    out = []
    for i in range(1, len(poses)):
        d = np.linalg.inv(np.linalg.inv(gt[i - 1]) @ gt[i]) @ (
            np.linalg.inv(poses[i - 1]) @ poses[i])
        out.append((float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(
            np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))))))
    return out


def run_vo(folder, gt_path, frames, seeds):
    """The first `frames` frames through each package's VisualOdometer (the
    JAX package with seed 0, the port on the CPU with each of `seeds`), with
    the shipped RansacConfig() and with final_model_fitting=True: ATE and
    RPE per run; for the port's first seed with the shipped config, the
    median per-frame errors of frames with fewer and with at least
    150 stereo matches."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from stereo_orb_slam_tpu.config import RansacConfig as JRC
    from stereo_orb_slam_tpu.frontend.odometer import VisualOdometer as JVO
    from stereo_orb_slam_tpu.io import calib as jcalib
    from stereo_orb_slam_tpu.worldmap import WorldMap as JWorld
    from stereo_orb_slam_torch.config import RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", folder)[:frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    gt = evaluate.load_kitti_gt(gt_path)[:frames]
    camera = os.path.join(folder, "calib.txt")
    runs = [("stereo_orb_slam_tpu", 0)] + [("stereo_orb_slam_torch", s) for s in seeds]
    for package, seed in runs:
        rec = {"package": package, "seed": seed, "frames": frames}
        for name, refit in (("shipped", False), ("refit", True)):
            if package == "stereo_orb_slam_tpu":
                world = JWorld()
                vo = JVO(world, jcalib.load_camera(camera),
                         rc=JRC(final_model_fitting=refit), seed=seed)
            else:
                world = WorldMap()
                vo = VisualOdometer(world, calib.load_camera(camera, device="cpu"),
                                    rc=RansacConfig(final_model_fitting=refit), seed=seed)
            stereo = []
            for il, ir in imgs:
                vo.track(il, ir)
                stereo.append(int(vo.last_result.num_stereo))
            poses = world.pose_global[: world.num_frames]
            t_rpe, r_rpe = evaluate.rpe(poses, gt)
            rec[name] = {"ate_m": evaluate.ate_rmse(poses, gt), "rpe_m": t_rpe,
                         "rpe_rad": r_rpe}
            if package == "stereo_orb_slam_torch" and seed == seeds[0] and not refit:
                err = np.asarray(_relative_errors(poses, gt))
                many = np.asarray(stereo[1:]) >= 150
                rec["per_frame"] = {
                    key: {"frames": int(sel.sum()),
                          "median_m": float(np.median(err[sel, 0])),
                          "median_deg": float(np.median(err[sel, 1])),
                          "median_stereo": float(np.median(np.asarray(stereo[1:])[sel]))}
                    for key, sel in (("stereo_below_150", ~many), ("stereo_150_up", many))}
        print(json.dumps({"vo": rec}), flush=True)


def _homogeneous(poses):
    out = np.tile(np.eye(4), (len(poses), 1, 1))
    out[:, :3, :] = np.asarray(poses, np.float64).reshape(-1, 3, 4)[:, :3, :]
    return out


def compare_trajectories(paths, gt_path, bounds, worst=8):
    """Per trajectory: ATE (utils.evaluate.ate_rmse, aligned on the frames
    it covers) over frames [0, b) for each bound b and over all frames,
    and the `worst` frames by relative translation error (m)."""
    from stereo_orb_slam_torch.utils import evaluate

    gt = _homogeneous(evaluate.load_kitti_gt(gt_path))
    rel_gt = np.linalg.inv(gt[:-1]) @ gt[1:]
    for path in paths:
        P = _homogeneous(np.loadtxt(path))
        n = len(P)
        ate = {f"0-{b}": evaluate.ate_rmse(P[:b], gt[:b]) for b in bounds if b < n}
        ate[f"0-{n}"] = evaluate.ate_rmse(P, gt[:n])
        err = np.linalg.norm((np.linalg.inv(P[:-1]) @ P[1:])[:, :3, 3] - rel_gt[: n - 1, :3, 3],
                             axis=1)
        top = sorted(int(i) + 1 for i in np.argsort(-err)[:worst])
        print(json.dumps({"trajectory": path, "ate_m": ate,
                          "worst_frames_m": {f: float(err[f - 1]) for f in top}}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=synth_canyon.CANYON["frames"])
    ap.add_argument("--out", default=None, help="a folder for the tree and the outputs "
                                                "(default: a temporary one)")
    ap.add_argument("--workers", type=int, default=0, help="render processes (0 = CPUs)")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's SLAM CLI on the CPU")
    ap.add_argument("--vo", type=int, default=0, metavar="N",
                    help="instead of the SLAM runs: the first N frames through both "
                         "packages' VisualOdometer, shipped RANSAC and with the refit")
    ap.add_argument("--seeds", type=int, default=4, help="port seeds of --vo")
    ap.add_argument("--finish_seconds", type=float, default=None,
                    help="the SLAM runs' finish budget (default: the drive's, 150)")
    ap.add_argument("--no_render", action="store_true",
                    help="reuse the tree under --out instead of rendering it")
    ap.add_argument("--trajectories", nargs="+", default=None, metavar="T",
                    help="instead of the runs: these KITTI trajectories against the "
                         "ground truth")
    ap.add_argument("--gt", default=None, help="ground truth of --trajectories (default: "
                                                "--out's tree)")
    ap.add_argument("--bounds", type=int, nargs="*", default=[256, 512, 800],
                    help="frame bounds of --trajectories' prefix ATEs")
    args = ap.parse_args(argv)
    if args.trajectories:
        if not (args.gt or args.out):
            ap.error("--trajectories needs --gt or the --out of an earlier run")
        compare_trajectories(args.trajectories,
                             args.gt or os.path.join(args.out, "canyon", "gt.txt"),
                             args.bounds)
        return
    if args.no_render and not args.out:
        ap.error("--no_render needs the --out of an earlier run")
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        folder = os.path.join(root, "canyon")
        t0 = time.perf_counter()
        if args.no_render:
            gt = os.path.join(folder, "gt.txt")
            traj = np.loadtxt(gt).reshape(-1, 3, 4)
        else:
            _, traj, gt = synth_canyon.render_tree(folder, args.frames,
                                                   workers=args.workers or None)
        tree = {"frames": len(traj), "path_m": synth_canyon.path_length(traj),
                "render_seconds": time.perf_counter() - t0}
        print(json.dumps({"tree": tree}), flush=True)
        if args.vo:
            run_vo(folder, gt, args.vo, list(range(args.seeds)))
            return
        finish = () if args.finish_seconds is None else ("--finish_seconds",
                                                          str(args.finish_seconds))
        runs = [("stereo_orb_slam_tpu", finish)]
        if args.port:
            runs.append(("stereo_orb_slam_torch", ("--device", "cpu", *finish)))
        for package, extra in runs:
            rec = run_slam(package, folder, gt, os.path.join(root, f"out_{package}"), extra)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

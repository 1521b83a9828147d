"""Visual-odometry-only CLI (no BA / loop closure / pose graph).

PyTorch counterpart of the JAX package's `apps/visual_odometry.py` (the
reference `visual_odometry` executable, ref
`src/visual_odometry.cpp:33-123`): per-frame tracking, pose integration with
renormalization, txt + PLY export. Same flags and output files, plus
`--device` (default `cuda`; `cpu` runs the plain versions of the kernels).

    python -m stereo_orb_slam_torch.apps.visual_odometry --dataset kitti \
        --folder SEQ --camera SEQ/calib.txt --output_dir OUT [--gt GT]
    python -m stereo_orb_slam_torch.apps.visual_odometry --dataset EuRoc \
        --folder ROOT --camera camera.txt --output_dir OUT [--debug_viz DIR]

With `--dataset EuRoc`, ROOT holds `mav0/cam{0,1}/data.csv`, and the
reference's key=value camera file carries the distortion and extrinsics:
`type=Stereo` selects the general rig (undistortion + DLT triangulation).
`--debug_viz DIR` writes the reference's Stereo/Temporal/Tracking views as
PNGs every `--debug_viz_every` frames (utils/viz.save_frame_debug).

The process keeps TF32 off for float32 matrix products
(`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's default, set
explicitly): the ORB sampling product would be exact in TF32, but RANSAC's
Horn iterations and reprojections need full float32.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
from stereo_orb_slam_torch.io import calib, datasets, export
from stereo_orb_slam_torch.utils import evaluate, logging as slog, viz
from stereo_orb_slam_torch.worldmap import WorldMap


def main(argv=None) -> dict:
    """Run the CLI; returns a summary: frames, fps, median_ms, frame_ms,
    ate_m (None without --gt) and the WorldMap."""
    ap = argparse.ArgumentParser(description="Stereo visual odometry (PyTorch)")
    ap.add_argument("--dataset", required=True, help="kitti | EuRoc | other")
    ap.add_argument("--folder", required=True)
    ap.add_argument("--camera", required=True)
    ap.add_argument("--output_dir", default=".")
    ap.add_argument("--output_suffix", default="vo")
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--debug_viz", default=None, metavar="DIR",
                    help="write Stereo/Temporal/Tracking debug PNGs "
                         "(the reference's three imshow windows, "
                         "ref visual_odometer.cpp:31-33)")
    ap.add_argument("--debug_viz_every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False

    pairs = datasets.load_dataset(args.dataset, args.folder)
    if args.max_frames:
        pairs = pairs[: args.max_frames]
    rig = calib.load_camera(args.camera, device=args.device)
    world = WorldMap()
    vo = VisualOdometer(world, rig)

    reader = datasets.PrefetchingReader(pairs)
    t_start = time.perf_counter()
    times = []
    prev_img, prev_slots = None, None
    for i, (img_l, img_r) in enumerate(reader):
        if args.debug_viz:
            prev_slots = vo.prev  # the matching state before this frame's swap
        t0 = time.perf_counter()
        vo.track(img_l, img_r)
        dt = time.perf_counter() - t0
        times.append(dt)
        slog.info(f"frame #{i}: {dt * 1e3:.1f} ms")
        if args.debug_viz and i % max(1, args.debug_viz_every) == 0:
            viz.save_frame_debug(args.debug_viz, i, img_l, img_r, vo.last_result,
                                 prev_img=prev_img, prev_slots=prev_slots)
        if args.debug_viz and vo.success:
            prev_img = img_l  # the temporal view matches against the swapped frame
    total = time.perf_counter() - t_start

    n = world.num_frames
    export.dump_world(args.output_dir, world)
    export.save_poses_ply(
        f"{args.output_dir}/waypoints_{args.output_suffix}.ply",
        world.pose_global[:n],
    )
    export.save_kitti_trajectory(
        f"{args.output_dir}/trajectory_{args.output_suffix}.txt",
        world.pose_global[:n],
    )
    fps = len(pairs) / total
    med_ms = float(np.median(times) * 1e3) if times else 0.0
    slog.info(f"{len(pairs)} frames, {fps:.2f} fps, median {med_ms:.1f} ms/frame")
    summary = {"frames": len(pairs), "fps": fps, "median_ms": med_ms,
               "frame_ms": [t * 1e3 for t in times], "ate_m": None, "world": world}

    if args.gt:
        gt = evaluate.load_kitti_gt(args.gt)
        ate = evaluate.ate_rmse(world.pose_global[:n], gt)
        t_rpe, r_rpe = evaluate.rpe(world.pose_global[:n], gt)
        print(f"ATE RMSE: {ate:.3f} m   RPE: {t_rpe:.4f} m / {r_rpe:.5f} rad")
        summary["ate_m"] = ate
    return summary


def cli():
    """Entry point with reference-style [FAIL] messages instead of
    tracebacks for predictable operator errors (ref slam.cpp:45-71)."""
    import sys

    try:
        main()
    except FileNotFoundError as e:
        slog.fail(f"{e.filename or e}: file not found")
        sys.exit(1)
    except ValueError as e:
        slog.fail(str(e))
        sys.exit(1)


if __name__ == "__main__":
    cli()

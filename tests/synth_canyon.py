"""The canyon drive's scene, trajectory and KITTI tree, free of JAX.

`benchmarks/canyon_drive.py` drives the JAX package's SLAM CLI over a
376x1241 `CanyonScene` (tests/synth.py) with loop revisits. It imports the
JAX package at its top, so neither the PyTorch port nor `chip_smoke.py` may
import it. This module holds copies of its `two_episode_trajectory` and
`write_kitti` and the drive's scene settings (`CANYON`), and builds the
port's rig from a scene's fields (`make_rig`; `CanyonScene.make_rig`
imports the JAX package). `render_tree` writes the drive's KITTI tree with
a pool of processes, pixel for pixel what `scene.render_sequence` then
`write_kitti` write; `loop_events` counts loop episodes in a
`loop_matches.txt` trace as the drive counts them, and the loop exits (the
live closures) the trace implies.

    python tests/synth_canyon.py --out DIR [--frames 192] [--workers 8]

writes the tree of `chip_smoke.py`'s canyon phase (and of
tests/canyon_witness.py) to DIR and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from synth import CanyonScene, illum_gain_bias, loop_trajectory  # noqa: E402

# The drive's production scene (benchmarks/canyon_drive.py defaults): KITTI
# frame size, the 320x480 canyon's field of view (fx scaled by w / 480),
# sensor noise sigma 1 grey level, scene seed 7, 192 frames of one circuit
# of a 3 m square and its revisit.
CANYON = dict(h=376, w=1241, fx=300.0 * (1241 / 480.0), cx=1241 / 2.0, cy=376 / 2.0,
              baseline=0.54, noise_sigma=1.0, seed=7, frames=192, side_a=3.0, side_b=2.0)
# The drive's SLAM CLI flags (benchmarks/canyon_drive.py:162-173), less the
# paths and --gt.
CANYON_FLAGS = ("--batch_frames", "32", "--num_features", "1024", "--loop_query_size", "8",
                "--ransac_refit", "--live_ba_iterations", "20", "--finish_seconds", "150",
                "--preload_device")


def two_episode_trajectory(frames: int, side_a: float, side_b: float):
    """[N,4,4] poses: A, A, B, A, B, A — sustained revisit phases separated
    by novel-territory circuits. Six segments keep the per-frame step near
    60 mm. Below 900 frames: one circuit of A and its revisit."""
    if frames >= 900:
        seg = max(16, frames // 6 // 4 * 4)
        tA = loop_trajectory(seg, side=side_a)
        tB = loop_trajectory(seg, side=side_b)
        traj = np.concatenate([tA, tA, tB, tA, tB, tA])
    else:
        # Small/smoke scale: six segments would leave too few frames per
        # leg (degenerate per-frame yaw). One circuit + one revisit.
        seg = max(16, frames // 2 // 4 * 4)
        tA = loop_trajectory(seg, side=side_a)
        traj = np.concatenate([tA, tA])
    return traj[:frames]


def write_kitti(folder: str, frames, traj, fx, cx, cy, baseline):
    """Write uint8 stereo `frames` as a KITTI sequence folder (image_0,
    image_1, calib.txt) and `traj` as gt.txt; returns gt.txt's path."""
    from PIL import Image

    os.makedirs(folder + "/image_0", exist_ok=True)
    os.makedirs(folder + "/image_1", exist_ok=True)
    for i, (l, r) in enumerate(frames):
        Image.fromarray(l, "L").save(f"{folder}/image_0/{i:06d}.png")
        Image.fromarray(r, "L").save(f"{folder}/image_1/{i:06d}.png")
    write_calib(folder, fx, cx, cy, baseline)
    return write_gt(folder, traj)


def write_calib(folder, fx, cx, cy, baseline):
    with open(folder + "/calib.txt", "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * baseline} 0 {fx} {cy} 0 0 0 1 0\n")


def write_gt(folder, traj):
    gt_path = folder + "/gt.txt"
    with open(gt_path, "w") as f:
        for T in traj:
            f.write(" ".join(f"{v:.6f}" for v in np.asarray(T)[:3, :].reshape(12)) + "\n")
    return gt_path


def make_scene(h=CANYON["h"], w=CANYON["w"], fx=CANYON["fx"], cx=CANYON["cx"],
               cy=CANYON["cy"], baseline=CANYON["baseline"],
               noise_sigma=CANYON["noise_sigma"], seed=CANYON["seed"], **kw):
    """The drive's CanyonScene (its rng seeded with `seed`)."""
    return CanyonScene(np.random.default_rng(seed), fx=fx, cx=cx, cy=cy, baseline=baseline,
                       h=h, w=w, noise_sigma=noise_sigma, **kw)


def make_rig(scene, device="cuda"):
    """The port's rectified rig for `scene` (the fields CanyonScene.make_rig
    and CloudScene.make_rig read)."""
    from stereo_orb_slam_torch.geometry import camera

    left = camera.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, device=device)
    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = scene.baseline
    right = camera.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, pose=pose_r,
                                  device=device)
    return camera.StereoRig.create(left, right, rectified=True, baseline=scene.baseline)


# The scene a pool process renders, built from the parent's settings.
_WORKER = {}


def _init_worker(scene_kw):
    _WORKER["scene"] = make_scene(**scene_kw)


def _render_pair(job):
    """Frame f's left and right images as `CanyonScene.render_sequence`
    renders them: the noise drawn from the scene rng's state as it stood
    before frame f (`state`), left image first. Writes the two PNGs."""
    from PIL import Image

    folder, f, T, state = job
    scene = _WORKER["scene"]
    noise = np.random.Generator(np.random.PCG64())
    noise.bit_generator.state = state
    g, b = illum_gain_bias(f, scene.illum_drift)
    for eye, right in (("image_0", False), ("image_1", True)):
        img = scene.render_pose(T, right, noise_rng=noise, gain=g, bias=b)
        Image.fromarray(img.astype(np.uint8), "L").save(f"{folder}/{eye}/{f:06d}.png")
    return f


def render_tree(folder, frames=CANYON["frames"], workers=None, scene_kw=None):
    """Render the canyon drive's KITTI tree into `folder` with `workers`
    processes (None: the CPU count; 1: in this process). The images are
    those `write_kitti(folder, scene.render_sequence(traj), ...)` writes:
    the parent draws each frame's sensor noise state in order from the scene
    rng, so frames rendered out of order get the sequential noise. Returns
    (scene, trajectory [N, 4, 4], gt path)."""
    kw = dict(CANYON, **(scene_kw or {}))
    traj = two_episode_trajectory(frames, kw.pop("side_a"), kw.pop("side_b"))
    kw.pop("frames")
    scene = make_scene(**kw)
    states = []
    for _ in traj:
        states.append(scene.rng.bit_generator.state)
        if scene.noise_sigma > 0:
            for _eye in range(2):
                scene.rng.normal(0, scene.noise_sigma, (scene.h, scene.w))
    os.makedirs(folder + "/image_0", exist_ok=True)
    os.makedirs(folder + "/image_1", exist_ok=True)
    jobs = [(folder, f, T, st) for f, (T, st) in enumerate(zip(traj, states))]
    workers = min(workers or os.cpu_count() or 1, len(jobs))
    if workers <= 1:
        _WORKER["scene"] = scene
        for job in jobs:
            _render_pair(job)
    else:
        # spawn: the caller may hold threads (JAX, a device runtime) that a
        # fork would copy mid-flight; each process rebuilds the scene from
        # the seed.
        with multiprocessing.get_context("spawn").Pool(
                workers, initializer=_init_worker, initargs=(kw,)) as pool:
            pool.map(_render_pair, jobs, chunksize=1)
    write_calib(folder, scene.fx, scene.cx, scene.cy, scene.baseline)
    return scene, traj, write_gt(folder, traj)


def loop_events(trace_path, is_loop_thresh=0.9, not_loop_thresh=0.1):
    """The loop events of a loop_matches.txt trace (LoopConfig's default
    thresholds): `episodes`, upward crossings of is_loop_thresh in the
    per-frame Bayes probability, a crossing at the first entry included
    (benchmarks/canyon_drive.py's count); `exits`, the times the filter,
    once in a loop (above is_loop_thresh), fell below not_loop_thresh: each
    is a live pose-graph closure (loop/detector.py), and `exit_frames`, the
    trace line (the query's frame) of each; the largest probability, and the
    smallest after the first entry."""
    probs = []
    if os.path.exists(trace_path):
        probs = [float(m.group(1)) for m in re.finditer(r"probability = ([\d.eE+-]+)",
                                                         open(trace_path).read())]
    out = {"episodes": 0, "exits": 0, "exit_frames": [],
           "max_probability": max(probs, default=0.0), "min_after_entry": None}
    if not probs:
        return out
    above = np.asarray(probs) > is_loop_thresh
    out["episodes"] = int(np.sum(above[1:] & ~above[:-1]) + (1 if above[:1].any() else 0))
    in_loop = False
    for i, p in enumerate(probs):
        if p > is_loop_thresh:
            in_loop = True
        if p < not_loop_thresh and in_loop:
            out["exits"] += 1
            out["exit_frames"].append(i)
            in_loop = False
    if above.any():
        out["min_after_entry"] = float(min(probs[int(np.argmax(above)):]))
    return out


def path_length(traj):
    return float(np.sum(np.linalg.norm(np.diff(np.asarray(traj)[:, :3, 3], axis=0), axis=1)))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Render the canyon drive's KITTI tree")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=CANYON["frames"])
    ap.add_argument("--workers", type=int, default=0, help="0 = the CPU count")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    _, traj, gt = render_tree(args.out, args.frames, workers=args.workers or None)
    print(json.dumps({"folder": args.out, "frames": len(traj), "gt": gt,
                      "path_m": path_length(traj),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()

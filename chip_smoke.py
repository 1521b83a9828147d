"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     no CUDA device means exit 1 with no result;
  2. build: both CUDA kernels of stereo_orb_slam_torch/csrc, compiled by
     nvcc for sm_90a in parallel;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (hamming_top2 at N = M = 1024 with masked columns, an all-invalid
     train and planted ties; the patch cut at N = 1024 on a 406 x 1271
     image), bit for bit, with CUDA-event timings; then the CUDA path against
     the CPU path on one full-size frame (corners and descriptors);
  4. the main path at full width: 60 synthetic KITTI-sized stereo frames
     (376 x 1241, KITTI 00-02 intrinsics) through
     `stereo_orb_slam_torch.apps.visual_odometry.main` on the card with the
     default configs (1024 features, 128 RANSAC hypotheses). It needs
     ATE < 0.01 m and exactly 2 launches of each kernel per frame.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
INT8_TENSOR_OPS_PER_S = 1.979e15
N_FRAMES = 60
KITTI = dict(fx=718.856, cx=607.19, cy=185.22, baseline=0.537, h=376, w=1241)


def log(msg):
    print(msg, flush=True)


def time_device(fn, reps=50, rounds=10):
    """Median device milliseconds of one fn() call: `reps` calls captured in
    a CUDA graph, replayed `rounds` times between CUDA events. Host-side
    Python and launch costs are left out."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def time_call(fn, iters=200):
    """Median wall milliseconds of one fn() call issued back to back (the
    host's Python and launch cost included), by CUDA events over the run."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def phase_card():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build():
    from stereo_orb_slam_torch.ops.kernels import _build

    secs = _build.build()
    for name in _build.KERNEL_SOURCES:
        ptxas = [line.strip() for line in
                 _build.library_path(name).with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "spill" in line]
        log(f"build {name}: {' | '.join(ptxas)}")
    log(f"build: {secs:.1f} s for {len(_build.KERNEL_SOURCES)} kernels (nvcc in parallel)")


def _hamming_case(rng, kind, n=1024, m=1024):
    q = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    t = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    vt = rng.random(m) >= 0.25  # masked columns
    if kind == "all_invalid":
        vt[:] = False
    elif kind == "ties":
        for i in range(256):
            rows = rng.choice(m, 3, replace=False)
            t[rows] = q[i]
            vt[rows[0]] = False
        t[m // 2:] = t[: m - m // 2]
    return q, t, vt


def phase_kernels(rng):
    """Each kernel against its plain version, bit for bit, and timed."""
    import torch

    from stereo_orb_slam_torch import convert
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import hamming, patches

    dev = torch.device("cuda")
    records = []

    # hamming_top2 at the matching stages' shape.
    err = 0.0
    for kind in ("masked", "all_invalid", "ties"):
        q, t, vt = _hamming_case(rng, kind)
        args = (convert.desc_to_tensor(q, dev), convert.desc_to_tensor(t, dev),
                torch.as_tensor(vt, device=dev))
        got = hamming.hamming_top2(*args)
        want = hamming.hamming_top2_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"hamming_top2 differs from its plain version ({kind})")
            err = max(err, float((g.double() - w.double()).abs().max()))
    ms = time_device(lambda: hamming.hamming_top2(*args))
    call_ms = time_call(lambda: hamming.hamming_top2(*args))
    plain_ms = time_device(lambda: hamming.hamming_top2_plain(*args))
    n, m = 1024, 1024
    bytes_ = n * 32 + m * 32 + m + n * 12
    ops = 2 * n * m * 256  # the +-1 product of depth 256, at the int8 tensor rate
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / INT8_TENSOR_OPS_PER_S * 1e3
    records.append(dict(
        name="hamming_top2", route="cuda",
        source="stereo_orb_slam_torch/csrc/hamming_top2.cu",
        replaces="stereo_orb_slam_tpu/ops/pallas/hamming.py:74",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations",
        library_ms=None, match=True, call_ms=call_ms, shape=f"N={n} M={m}"))

    # The patch cut at the describer's shape: 1024 corners, KITTI image padded.
    H, W = KITTI["h"] + 2 * orb.PATCH_R, KITTI["w"] + 2 * orb.PATCH_R
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, KITTI["h"], 1024).astype(np.int32)).to(dev)
    xs = torch.from_numpy(rng.integers(0, KITTI["w"], 1024).astype(np.int32)).to(dev)
    got = patches.extract_patches(img, ys, xs, orb.PATCH)
    want = patches.extract_patches_plain(img, ys, xs, orb.PATCH)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("extract_patches differs from its plain version")
    err = float((got.float() - want.float()).abs().max())
    ar = torch.arange(orb.PATCH, device=dev)
    rows = (ys.long()[:, None] + ar)[:, :, None]
    cols = (xs.long()[:, None] + ar)[:, None, :]
    ms = time_device(lambda: patches.extract_patches(img, ys, xs, orb.PATCH))
    call_ms = time_call(lambda: patches.extract_patches(img, ys, xs, orb.PATCH))
    plain_ms = time_device(lambda: patches.extract_patches_plain(img, ys, xs, orb.PATCH))
    library_ms = time_device(lambda: img[rows, cols])
    bytes_ = H * W * 4 + 2 * 1024 * 4 + 1024 * orb.PATCH * orb.PATCH * 2
    records.append(dict(
        name="extract_patches", route="cuda",
        source="stereo_orb_slam_torch/csrc/extract_patches.cu",
        replaces="stereo_orb_slam_tpu/ops/pallas/patches.py:63",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms, match=True, call_ms=call_ms, shape=f"N=1024 img={H}x{W}",
        library_call="one advanced-index gather img[rows, cols] (float32 out)"))
    for r in records:
        log(f"kernel {r['name']}: match {r['match']}, device {r['ms'] * 1e3:.2f} us "
            f"(bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), per call "
            f"{r['call_ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {r['library_ms']}")
    return records


def _render_sequence(root, n):
    """KITTI-layout folder of n synthetic stereo PNG pairs + calib + GT.

    A textured fronto-parallel plane under sideways motion, at KITTI's size
    and intrinsics. Its depth makes the disparity 38 px and the step 14 px
    per frame, whole pixels as in the repository's synthetic-KITTI recipe
    (10 px and 4 px there), so the front end can recover the motion
    exactly. At fractional pixel motion on a single plane, translation and
    rotation nearly trade off, and the minimal-set RANSAC without a refit
    (the default config) leaves centimetres of error per frame in both
    packages alike.
    """
    from PIL import Image

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import PlaneScene

    seq = os.path.join(root, "sequences", "00")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, cam))
    k = KITTI
    depth = k["fx"] * k["baseline"] / 38.0
    step = 14.0 * depth / k["fx"]
    scene = PlaneScene(np.random.default_rng(42), fx=k["fx"], cx=k["cx"], cy=k["cy"],
                       baseline=k["baseline"], depth=depth, h=k["h"], w=k["w"])
    gt = []
    for i in range(n):
        for cam, right in (("image_0", False), ("image_1", True)):
            img = scene.render(i * step, right=right).clip(0, 255).astype(np.uint8)
            Image.fromarray(img, "L").save(os.path.join(seq, cam, f"{i:06d}.png"))
        T = np.eye(4)
        T[0, 3] = i * step
        gt.append(" ".join(f"{v:.6f}" for v in T[:3, :].reshape(12)))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {k['fx']} 0 {k['cx']} 0 0 {k['fx']} {k['cy']} 0 0 0 1 0\n"
                f"P1: {k['fx']} 0 {k['cx']} {-k['fx'] * k['baseline']} 0 {k['fx']} "
                f"{k['cy']} 0 0 0 1 0\n")
    gt_path = os.path.join(root, "gt_00.txt")
    with open(gt_path, "w") as f:
        f.write("\n".join(gt) + "\n")
    return seq, gt_path


def phase_cuda_vs_cpu(seq):
    """One full-size frame through detection and description on the card
    and on the CPU: the same corners, and descriptor bits that agree."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig
    from stereo_orb_slam_torch.frontend.odometer import detect_and_describe
    from stereo_orb_slam_torch.io.datasets import read_grayscale

    img = read_grayscale(os.path.join(seq, "image_0", "000003.png"))
    fe = FrontendConfig()
    out = {}
    for dev in ("cpu", "cuda"):
        xy, v, d = detect_and_describe(torch.from_numpy(img).to(dev), fe)
        out[dev] = (xy.cpu().numpy(), v.cpu().numpy(), d.cpu().numpy().view(np.uint32))
    (xy_c, v_c, d_c), (xy_g, v_g, d_g) = out["cpu"], out["cuda"]
    if not np.array_equal(v_c, v_g):
        raise AssertionError("corner validity differs between the card and the CPU")
    xy_err = float(np.abs(xy_c - xy_g).max())
    flips = int(np.unpackbits((d_c ^ d_g).view(np.uint8)).sum())
    bits = int(v_c.sum()) * 256
    log(f"cuda vs cpu, one 376x1241 frame: {int(v_c.sum())} corners, xy max diff "
        f"{xy_err:.3g} px, descriptor bits differing {flips} of {bits}")
    if xy_err > 1e-3 or flips > bits * 1e-4:
        raise AssertionError("the card and the CPU disagree beyond the stated bounds")


def phase_main_path(seq, gt, out_dir):
    import torch

    from stereo_orb_slam_torch.apps import visual_odometry
    from stereo_orb_slam_torch.ops.kernels import hamming, patches

    hamming.LAUNCHES = 0
    patches.LAUNCHES = 0
    summary = visual_odometry.main([
        "--dataset", "kitti", "--folder", seq, "--camera", os.path.join(seq, "calib.txt"),
        "--output_dir", out_dir, "--gt", gt, "--device", "cuda",
    ])
    launches = {"hamming_top2": hamming.LAUNCHES, "extract_patches": patches.LAUNCHES}
    torch.cuda.synchronize()
    world = summary["world"]
    n = summary["frames"]
    poses = world.pose_global[: world.num_frames]
    log(f"main path: {n} frames at {KITTI['h']}x{KITTI['w']}, "
        f"{summary['fps']:.2f} frames/s, median {summary['median_ms']:.2f} ms/frame, "
        f"ATE {summary['ate_m']:.5f} m, {world.num_points} points, launches {launches}")
    if not (np.isfinite(poses).all() and poses.shape == (n, 4, 4)):
        raise AssertionError("poses are not finite [frames, 4, 4]")
    if not summary["ate_m"] < 0.01:
        raise AssertionError(f"ATE {summary['ate_m']} m is not below 0.01 m")
    for name, count in launches.items():
        if count != 2 * n:
            raise AssertionError(f"{name} launched {count} times for {n} frames, not 2 per frame")
    return summary, launches


def phase_profile(seq, path, frames=20, warm=5):
    """Where a frame's time goes: `frames` track() calls on the card under
    torch.profiler, after `warm` calls off the record. Writes the breakdown
    to `path` as JSON and prints a summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", seq)[: warm + frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    vo = VisualOdometer(WorldMap(), calib.load_camera(os.path.join(seq, "calib.txt")))
    for il, ir in imgs[:warm]:
        vo.track(il, ir)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for il, ir in imgs[warm:]:
            vo.track(il, ir)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    report = {
        "frames": frames, "wall_ms_per_frame": wall_ms / frames,
        "device_busy_ms_per_frame": busy_ms / frames,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_frame": sum(e.count for e in kernels) / frames,
        "top_kernels": [{"name": e.key[:120], "count_per_frame": e.count / frames,
                         "device_us_per_frame": e.self_device_time_total / frames}
                        for e in top[:25]],
    }
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    log(f"profile: {report['wall_ms_per_frame']:.2f} ms/frame wall, device busy "
        f"{report['device_busy_ms_per_frame']:.3f} ms/frame (idle share "
        f"{report['device_idle_share']:.3f}), {report['device_launches_per_frame']:.0f} "
        f"device launches/frame; breakdown in {path}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also profile 20 frames of the main path; write the breakdown here")
    args = ap.parse_args(argv)
    phase_card()
    import torch

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    phase_build()
    records = phase_kernels(rng)
    with tempfile.TemporaryDirectory() as tmp:
        seq, gt = _render_sequence(tmp, N_FRAMES)
        phase_cuda_vs_cpu(seq)
        summary, launches = phase_main_path(seq, gt, os.path.join(tmp, "vo_out"))
        if args.profile:
            phase_profile(seq, args.profile)
    for r in records:
        r["launches"] = launches[r["name"]]
    log(json.dumps({"main_path": {k: summary[k] for k in ("frames", "fps", "median_ms",
                                                          "ate_m")}}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

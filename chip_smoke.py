"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which fails the run when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     no CUDA device means exit 1 with no result;
  2. build: the three CUDA kernels of stereo_orb_slam_torch/csrc, compiled
     by nvcc for sm_90a in parallel;
  3. the launch floor (a one-element in-place add), then each kernel
     against its plain PyTorch version at the main path's shapes, with
     CUDA-event timings: hamming_top2 with one query set against two train
     sets of 1024 (one launch; masked columns, an all-invalid train, planted
     ties) and against one, bit for bit; the patch cut at N = 1024 on a
     406 x 1271 image, bit for bit; the fused upright describe
     (orb_describe) at N = 1024 on that image with a quarter of the corners
     invalid, at most 1e-4 of the bits differing; then the CUDA path against
     the CPU path on one full-size frame (corners and descriptors);
  4. the main path at full width: 60 synthetic KITTI-sized stereo frames
     (376 x 1241, KITTI 00-02 intrinsics) through
     `stereo_orb_slam_torch.apps.visual_odometry.main` on the card with the
     default configs (1024 features, upright descriptors, 128 RANSAC
     hypotheses). It needs ATE < 0.01 m and exactly 1 hamming_top2, 2
     orb_describe and 0 extract_patches launches per frame;
  5. the oriented describe, the patch cut's path: 10 of those frames through
     `VisualOdometer` with `FrontendConfig(oriented=True)`; finite poses and
     exactly 2 extract_patches and 1 hamming_top2 launches per frame (ATE
     printed);
  6. with --profile PATH: a torch.profiler breakdown of 20 main-path frames.
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
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores
N_FRAMES = 60
ORIENTED_FRAMES = 10
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


def _check_equal(name, got, want):
    """Bit-for-bit equality of result tuples; returns the max abs error (0)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name} differs from its plain version")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def _record(name, source, replaces, path, **numbers):
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=None,
                path=path, **numbers)


def phase_kernels(rng):
    """Each kernel against its plain version and timed; the launch floor."""
    import torch

    from stereo_orb_slam_torch import convert
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import describe, hamming, patches

    dev = torch.device("cuda")
    records = []

    # The least device time of any launch: a one-element in-place add.
    one = torch.zeros(1, device=dev)
    floor_ms = time_device(lambda: one.add_(1.0))
    log(f"launch floor: {floor_ms * 1e3:.2f} us device (one-element in-place add)")

    # hamming_top2 at the matching stages' shape: one query set against the
    # right image's and the previous frame's train sets, one launch.
    err = 0.0
    for kind in ("masked", "all_invalid", "ties"):
        q, ta, va = _hamming_case(rng, kind)
        _, tb, vb = _hamming_case(rng, kind)
        qd, tad, tbd = (convert.desc_to_tensor(x, dev) for x in (q, ta, tb))
        vad, vbd = torch.as_tensor(va, device=dev), torch.as_tensor(vb, device=dev)
        pair = hamming.hamming_top2_pair(qd, tad, vad, tbd, vbd)
        single = hamming.hamming_top2(qd, tbd, vbd)
        plain = (hamming.hamming_top2_plain(qd, tad, vad),
                 hamming.hamming_top2_plain(qd, tbd, vbd))
        torch.cuda.synchronize()
        err = max(err, _check_equal(f"hamming_top2_pair ({kind}, set a)", pair[0], plain[0]),
                  _check_equal(f"hamming_top2_pair ({kind}, set b)", pair[1], plain[1]),
                  _check_equal(f"hamming_top2 ({kind})", single, plain[1]))
    args = (qd, tad, vad, tbd, vbd)
    ms = time_device(lambda: hamming.hamming_top2_pair(*args))
    single_ms = time_device(lambda: hamming.hamming_top2(qd, tad, vad))
    call_ms = time_call(lambda: hamming.hamming_top2_pair(*args))
    plain_ms = time_device(lambda: (hamming.hamming_top2_plain(qd, tad, vad),
                                    hamming.hamming_top2_plain(qd, tbd, vbd)))
    n, m = 1024, 1024
    bytes_ = n * 32 + 2 * (m * 32 + m + n * 12)
    ops = 2 * 2 * n * m * 256  # two sets, the +-1 product of depth 256, int8 rate
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / INT8_TENSOR_OPS_PER_S * 1e3
    records.append(_record(
        "hamming_top2", "stereo_orb_slam_torch/csrc/hamming_top2.cu",
        "stereo_orb_slam_tpu/ops/pallas/hamming.py:74", "main",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=None,
        match=True, call_ms=call_ms, single_set_ms=single_ms,
        shape=f"N={n}, two train sets of M={m} (one launch)"))

    # The patch cut at the describer's shape: 1024 corners, KITTI image padded.
    H, W = KITTI["h"] + 2 * orb.PATCH_R, KITTI["w"] + 2 * orb.PATCH_R
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, KITTI["h"], 1024).astype(np.int32)).to(dev)
    xs = torch.from_numpy(rng.integers(0, KITTI["w"], 1024).astype(np.int32)).to(dev)
    got = patches.extract_patches(img, ys, xs, orb.PATCH)
    want = patches.extract_patches_plain(img, ys, xs, orb.PATCH)
    torch.cuda.synchronize()
    err = _check_equal("extract_patches", (got,), (want,))
    # The library call gathers the same windows: starts clamped as the kernel
    # clamps them (a start of 375 in 406 rows is cut at 374).
    ar = torch.arange(orb.PATCH, device=dev)
    rows = (ys.long().clamp(max=H - orb.PATCH)[:, None] + ar)[:, :, None]
    cols = (xs.long().clamp(max=W - orb.PATCH)[:, None] + ar)[:, None, :]
    ms = time_device(lambda: patches.extract_patches(img, ys, xs, orb.PATCH))
    call_ms = time_call(lambda: patches.extract_patches(img, ys, xs, orb.PATCH))
    plain_ms = time_device(lambda: patches.extract_patches_plain(img, ys, xs, orb.PATCH))
    library_ms = time_device(lambda: img[rows, cols])
    bytes_ = H * W * 4 + 2 * 1024 * 4 + 1024 * orb.PATCH * orb.PATCH * 2
    records.append(_record(
        "extract_patches", "stereo_orb_slam_torch/csrc/extract_patches.cu",
        "stereo_orb_slam_tpu/ops/pallas/patches.py:63", "oriented",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms, match=True, call_ms=call_ms, shape=f"N=1024 img={H}x{W}",
        library_call="one advanced-index gather img[rows, cols] (float32 out)"))

    # The fused upright describe at the same shape, a quarter of the corners
    # invalid, fractional positions (some exactly at .5, rounded half to even).
    # Tolerance: the kernel adds each sample's <= 4 exact products in
    # ascending pixel index, cuBLAS in its own order, so a near-tied pair can
    # flip; at most 1e-4 of the bits may differ (0 expected).
    xy = np.stack([rng.uniform(0, KITTI["w"] - 1, 1024),
                   rng.uniform(0, KITTI["h"] - 1, 1024)], 1).astype(np.float32)
    xy[::7] = np.floor(xy[::7]) + 0.5
    xy = torch.from_numpy(xy).to(dev)
    valid = torch.from_numpy(rng.random(1024) >= 0.25).to(dev)
    table = orb.steer_table(False, dev)
    got = describe.orb_describe(img, xy, valid, table)
    want = describe.orb_describe_plain(img, xy, valid, table)
    torch.cuda.synchronize()
    diff = (orb.unpack_bits(got) - orb.unpack_bits(want)).abs()
    flips, bits = int(diff.sum()), got.shape[0] * orb.N_TESTS
    log(f"orb_describe: {flips} of {bits} bits differ from the plain version")
    if got.shape != want.shape or flips > bits * 1e-4:
        raise AssertionError(f"orb_describe differs from its plain version in {flips} bits")
    ms = time_device(lambda: describe.orb_describe(img, xy, valid, table))
    call_ms = time_call(lambda: describe.orb_describe(img, xy, valid, table))
    plain_ms = time_device(lambda: describe.orb_describe_plain(img, xy, valid, table))
    bytes_ = H * W * 4 + 1024 * (8 + 1) + 1024 * 32
    fmas = 1024 * 2 * orb.N_TESTS * describe.TAPS
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, 2 * fmas / F32_OPS_PER_S * 1e3
    records.append(_record(
        "orb_describe", "stereo_orb_slam_torch/csrc/orb_describe.cu",
        "stereo_orb_slam_tpu/ops/pallas/patches.py:63", "main",
        max_abs_err=float(diff.max()), ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations",
        library_ms=None, match=flips == 0, bits_differing=flips, call_ms=call_ms,
        shape=f"N=1024 (256 invalid) img={H}x{W}",
        replaces_note="the patch cut on the upright path, fused with its caller's "
                      "bf16 cast, sampling product, compare and bit packing"))
    for r in records:
        log(f"kernel {r['name']}: match {r['match']}, device {r['ms'] * 1e3:.2f} us "
            f"(bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), per call "
            f"{r['call_ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {r['library_ms']}")
    return records, floor_ms


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


def _reset_launches():
    from stereo_orb_slam_torch.ops.kernels import describe, hamming, patches

    for mod in (hamming, patches, describe):
        mod.LAUNCHES = 0


def _read_launches():
    from stereo_orb_slam_torch.ops.kernels import describe, hamming, patches

    return {"hamming_top2": hamming.LAUNCHES, "extract_patches": patches.LAUNCHES,
            "orb_describe": describe.LAUNCHES}


def _check_launches(path, launches, per_frame, frames):
    for name, k in per_frame.items():
        if launches[name] != k * frames:
            raise AssertionError(f"{path}: {name} launched {launches[name]} times for "
                                 f"{frames} frames, not {k} per frame")


def phase_main_path(seq, gt, out_dir):
    import torch

    from stereo_orb_slam_torch.apps import visual_odometry

    _reset_launches()
    summary = visual_odometry.main([
        "--dataset", "kitti", "--folder", seq, "--camera", os.path.join(seq, "calib.txt"),
        "--output_dir", out_dir, "--gt", gt, "--device", "cuda",
    ])
    launches = _read_launches()
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
    _check_launches("main path", launches,
                    {"hamming_top2": 1, "orb_describe": 2, "extract_patches": 0}, n)
    return summary, launches


def phase_oriented(seq, gt, frames=ORIENTED_FRAMES):
    """The oriented describe (`FrontendConfig(oriented=True)`): the patch cut
    kernel's own path. `frames` frames through `VisualOdometer.track`."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", seq)[:frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    world = WorldMap()
    vo = VisualOdometer(world, calib.load_camera(os.path.join(seq, "calib.txt")),
                        fe=FrontendConfig(oriented=True))
    _reset_launches()
    for il, ir in imgs:
        vo.track(il, ir)
    launches = _read_launches()
    torch.cuda.synchronize()
    poses = world.pose_global[: world.num_frames]
    if not (np.isfinite(poses).all() and poses.shape == (frames, 4, 4)):
        raise AssertionError("oriented path: poses are not finite [frames, 4, 4]")
    ate = evaluate.ate_rmse(poses, evaluate.load_kitti_gt(gt)[:frames])
    log(f"oriented path: {frames} frames, ATE {ate:.5f} m, {world.num_points} points, "
        f"launches {launches}")
    _check_launches("oriented path", launches,
                    {"hamming_top2": 1, "orb_describe": 0, "extract_patches": 2}, frames)
    return launches


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
        "kernels": [{"name": e.key[:120], "count_per_frame": e.count / frames,
                     "device_us_per_frame": e.self_device_time_total / frames}
                    for e in top],
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
    records, floor_ms = phase_kernels(rng)
    with tempfile.TemporaryDirectory() as tmp:
        seq, gt = _render_sequence(tmp, N_FRAMES)
        phase_cuda_vs_cpu(seq)
        summary, launches = phase_main_path(seq, gt, os.path.join(tmp, "vo_out"))
        oriented = phase_oriented(seq, gt)
        if args.profile:
            phase_profile(seq, args.profile)
    paths = {"main": launches, "oriented": oriented}
    for r in records:
        r["launches"] = paths[r["path"]][r["name"]]
    log(json.dumps({"main_path": {k: summary[k] for k in ("frames", "fps", "median_ms",
                                                          "ate_m")},
                    "launch_floor_ms": floor_ms}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

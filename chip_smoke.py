"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile PATH] [--out DIR]

Phases, each of which fails the run when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     no CUDA device means exit 1 with no result;
  2. build: the four CUDA kernels of stereo_orb_slam_torch/csrc, compiled
     by nvcc for sm_90a in parallel;
  3. the launch floor (a one-element in-place add), then each kernel
     against its plain PyTorch version at the main path's shapes, with
     CUDA-event timings: hamming_top2 with one query set against two train
     sets of 1024 (one launch; masked columns, an all-invalid train, planted
     ties) and against one, bit for bit; the patch cut at N = 1024 on a
     406 x 1271 image, bit for bit; the fused upright describe
     (orb_describe) at N = 1024 on that image with a quarter of the corners
     invalid, at most 1e-4 of the bits differing; the fused oriented
     describe (orb_describe_oriented) at N = 1024 on a smoothed, padded
     406 x 1271 image, a quarter invalid and some corners at .5: at most
     1e-4 of the bits differing from its plain chain, every angle within
     ORIENTED_THETA_ATOL of the chain's and within its order's float32
     bound of the float64 moments' angle, timed beside its bound, the plain
     chain and the chain the oriented path ran before (the cut kernel and
     the products); and on the unsmoothed noise, bits against the plain
     chain and angles within that float64 bound (the plain chain's distance
     recorded beside); the batched DLT (triangulate_dlt, a hand kernel with
     no Pallas counterpart: a float64 Jacobi SVD in place of cuSOLVER's,
     which syncs the host) at N = 1024 on EuRoC cam0's rig, points 1.5-5 m
     and 45-100 m deep, a quarter of the slots zero: within DLT_PLAIN_ATOL
     of its plain version (the near points), within DLT_F64_RTOL of a
     float64 DLT relative to the depth, finite everywhere, timed beside
     torch.linalg.svd, with its bound from the run's Jacobi sweeps;
     then the CUDA path against the CPU path on one full-size frame
     (corners and descriptors);
  4. the main path at full width: 60 synthetic KITTI-sized stereo frames
     (376 x 1241, KITTI 00-02 intrinsics) through
     `stereo_orb_slam_torch.apps.visual_odometry.main` on the card with the
     default configs (1024 features, upright descriptors, 128 RANSAC
     hypotheses). It needs ATE < 0.01 m and exactly 1 hamming_top2, 2
     orb_describe and 0 orb_describe_oriented and extract_patches launches
     per frame (UPRIGHT_PER_FRAME);
  5. the oriented describe: frame 0 on the card against the CPU path (bits,
     angles), then 10 of those frames through `VisualOdometer` with
     `FrontendConfig(oriented=True)`; finite poses and exactly 1
     hamming_top2, 2 orb_describe_oriented and 0 orb_describe and
     extract_patches launches per frame (ORIENTED_PER_FRAME; ATE printed),
     and its ms per frame beside upright VO on the same frames;
  6. windowed bundle adjustment (`stereo_orb_slam_torch.backend.ba`, torch
     ops, no kernel of its own):
     a. the 60 frames through `VisualOdometer` + `BundleAdjuster(BAConfig())`
        with the live loop's cadence (a per-frame solve after each frame, a
        20-frame window every 10): ATE < 0.01 m, finite poses, exactly 1
        hamming_top2 and 2 orb_describe launches per frame; per solve kind
        the wall ms, LM iterations, sizes and path;
     b. the card against the CPU on the last window problem (50 LM
        iterations) and on the reference's banded problem (4 LM iterations
        on each path): the first step's H_cc within BA_DEVICE_HESSIAN_RTOL,
        the same iteration count, pose6, points and cost within their
        bounds; each also run with TF32 left on, the control, whose H_cc
        must break the bound on the paths with cuBLAS products;
     c. `apps.refine` over a dump of the tracked world (50 iterations):
        cost not above its initial value, ATE < 0.01 m;
     d. global BA from that world perturbed by 2 cm / 0.2 degrees per pose
        and 5 cm per point: cost below 1e-2 of its initial value, ATE <
        0.01 m;
     e. the banded and the dense Schur assembly on a 64-camera, 8192-point
        track-local problem: ms per LM iteration, pose6 within 5e-5;
     f. the matrix-free path at map size (1000 cameras, 100,000 points,
        200,000 observations, 6 LM iterations): ms per LM iteration, peak
        device memory, the final cost within BA_MAP_COST_RTOL of the CPU
        path's (and the same with TF32 left on);
  7. the SLAM app (`stereo_orb_slam_torch.apps.slam.main`, the shipped
     SlamConfig: 1024 features, a 1024-word vocabulary trained at frame 12,
     query_size 4, distant_frame_thresh 50, refine_interval 10, live BA 12
     LM iterations) over 172 frames of the same scene on an out-and-back
     trajectory (SLAM_STEPS), with --batch_frames 1 and 4: the loop
     probability past is_loop_thresh, loop edges measured at a live closure
     (pose graph + deferred polish) and at finish, merged landmarks, ATE <
     0.01 m for both and within 1e-3 m of each other, and exact launches
     (hamming_top2 one per frame, per BoW scoring batch, per vocabulary
     assignment and per loop-edge batch; orb_describe 2 per frame;
     extract_patches 0). Then the path's pieces, the card against the CPU
     (SLAM_* bounds): the vocabulary assignment bit for bit,
     batch_score_update, the loop-edge batch with the same RANSAC sets and
     pg_solve on the final graph, the last two with a TF32-on control, the
     loop-edge batch's ms and hamming_top2 launches (one) at E = 1, 8 and
     all of the final graph's committed edges, and the time of the first
     forward-mode use in a process;
  8. multi-sequence tracking (BASELINE.json config 4): first the
     four kernels at batch 3 in one launch each, bit for bit against B = 1
     launches and against their batched plain versions (the oriented
     describe within its phase 3 bounds);
     then `MultiSequenceSLAM` over S = 3 rendered sequences of 60 frames
     at 376 x 1241 (MULTI_SEQ), against each sequence tracked alone by
     `VisualOdometer` on the card: poses within MULTI_SEQ_POSE_ATOL, ATE
     < 0.01 m per sequence, 1 hamming_top2, 2 orb_describe and 0
     extract_patches launches per step; steps/s beside single-sequence
     VO (after phase 5);
  9. distribution (BASELINE.json config 5; after phase 7):
     `DistributedBundleAdjuster` (both layouts) on the tracked world,
     the point-aligned solve of the map problem (DIST_LM_ITERATIONS LM
     iterations each) and `dist_pose_graph.solve` on phase 7's final
     graph: at 1 NCCL rank in this process, bit for bit against the same
     code with no process group and with the same device syncs; at 2 and
     4 gloo ranks spawned on the card (the pose graph at 4), within the
     DIST_* bounds of the single-process card solves, every rank's
     replica the same; ms, all_reduces and bytes per LM iteration and
     peak memory per rank. Then `apps.refine --distributed` under
     torchrun (1 NCCL rank) and `apps.scaling_bench` at 1 NCCL rank;
  10. with --profile PATH: a torch.profiler breakdown of 20 main-path
     frames (to PATH), of 20 frames of the general rig (_general), of 10
     oriented frames with the fused kernel and with
     the chain it replaced swapped in (_oriented), of 3 LM iterations of the last window and of the
     map problem with device syncs counted (to PATH with _ba before the
     extension), of 20 SLAM frames and one pose-graph solve (_slam), of 20
     multi-sequence steps (_multi_seq) and of the distributed map solve
     at 1 NCCL rank (_dist);
  11. the general rig (run after phase 5; captured, as the rectified
     rig, since the DLT became a kernel): EuRoC MAV's cam0 model (752 x
     480, fx = fy = 458.654, radial k1, k2; baseline 0.110 m,
     non-rectified) through a textured plane at 2.52 m (20 px of
     disparity), whole 8 px steps in undistorted coordinates, written as a
     EuRoC mav0 tree with the reference's camera file: 60 frames through
     `apps.visual_odometry.main --dataset EuRoc` (ATE < GENERAL_VO_ATE_M,
     exactly GENERAL_PER_FRAME launches per frame, one triangulate_dlt
     among them, ms per frame beside the rectified main path's); frame 1
     on the card against the CPU (GENERAL_* bounds, orb_describe's words
     and the temporal matches included, no non-finite DLT point; the
     cuSOLVER SVD's time and syncs for the record, and the syncs of a
     distorted and a rectified VO frame, equal); `apps.slam.main
     --dataset EuRoc` at K = 1 over 119 frames out and back (ATE <
     GENERAL_SLAM_ATE_M, a loop edge measured, exact launches: one DLT
     per frame and two per loop-edge batch);
     `MultiSequenceSLAM` over 2 distorted sequences of GENERAL_MULTI_STEPS
     steps with stacked rigs (each bit for bit its own VisualOdometer
     run, exact launches per step); then hamming_top2 and orb_describe at
     this path's shapes (510 x 782 padded images) and triangulate_dlt on
     frame 1's correspondences alone and stacked (S = 2, one projection
     pair per problem) on its own inputs, held against their plain
     versions and timed (records with path "general");
  12. the canyon (after phase 7): benchmarks/canyon_drive.py's production
     drive in the port, its tree written by tests/synth_canyon.py (a
     376 x 1241 CanyonScene: continuous multi-plane texture, sensor noise
     sigma 1, sub-pixel motion; 192 frames of one circuit of a 3 m square
     and its revisit) through `apps.slam.main` with the drive's flags
     (--batch_frames 32, 1024 features, --loop_query_size 8,
     --ransac_refit, --live_ba_iterations 20, --finish_seconds 150,
     --preload_device): the loop probability past is_loop_thresh, a live
     closure with loop edges for every loop exit (the trajectory ends in
     its revisit, so there is none here, nor in the JAX package's run) and
     loop edges at finish, ATE < CANYON_SLAM_ATE_M (1.5 x the JAX
     package's ATE on the same tree, tests/canyon_witness.py, + 0.01 m),
     exact launches (loop edges one hamming_top2 per batch); live fps,
     median ms per frame, closure stalls, finish seconds, loop episodes and
     exits and edges per closure recorded. Frame 1 on the card against the CPU
     (counts, slot validity, orb_describe's words within CANYON_DESC_FLIPS
     of the bits, the temporal matches); 60 frames through VisualOdometer
     with RansacConfig() and with final_model_fitting=True (both ATEs); and
     hamming_top2 and orb_describe on frame 1's own inputs against their
     plain versions and timed (records with path "canyon").
  13. the captured programs (stereo_orb_slam_torch/utils/programs.py,
     through which every phase above runs its pose-graph
     solves, LM solves and front-end steps on both rigs): each held bit for
     bit against its eager function on the card (pg_solve on phase 7's
     final graph; ba_solve on phase 6's last window and on the map
     problem; 60 VO frames of `track` against one eager frontend_chain;
     frontend_chain_program against frontend_chain at K = 4 and 32; the
     multi-sequence step at S = 3 over 20 steps; on the general rig 60
     `track` frames against one eager frontend_chain, K = 4 chains with
     BoW against frontend_chain_bow and phase 11's S = 2 x 20 steps), with
     wall ms, kernels,
     graph replays, kernels per body, capture ms and the map problem's
     peak memory eager, at the capture and at a replay; then the main
     path, the SLAM app at K = 1 and 4, the canyon drive, 30
     multi-sequence steps and phase 11's general VO, SLAM and
     multi-sequence runs again with every program run eagerly
     (`_eager_programs`), their gates holding there too, for the figures
     eager against captured; with --profile, 20 VO frames, a pose-graph
     solve and 3 window LM iterations under torch.profiler, captured and
     eager (_programs). The program cache's captures and replays per body
     are printed at the end.
  14. the canyon drive at its full length (after phase 13): the tree of
     benchmarks/canyon_drive.py's default --frames 1216 (six 200-frame
     circuits A A B A B A: 1200 frames, 63.94 m), rendered by
     tests/synth_canyon.py in a background child process from the start of
     the run (all but two CPUs, lowest priority), through `apps.slam.main`
     with phase 12's flags: every frame tracked, ATE < CANYON_LONG_ATE_M
     (1.5 x the JAX package's ATE on the same tree, tests/canyon_witness.py
     --frames 1216, + 0.01 m), a live closure where the JAX trace has loop
     exits, one live closure per exit of the port's own trace with a loop
     edge measured each, edges at finish, exact launches, the BoW batches
     the trajectory gives (the 16-frame remainder runs frame by frame) and
     no program built again after an eviction (each loop-edge bucket
     captured once); live fps, median ms, finish split, exit frames beside
     JAX's, each closure's stall split (pg_solve, the loop-edge batch with
     E and E_pad, the rest), points, peak memory. Then the loop-edge batch
     captured (`apps.slam.EdgeProgram`, one replay at E_pad) against eager
     at E on the largest recorded batch of each bucket reached, bit for
     bit and timed, and from device rings before and after they are
     replaced by grown copies; the CG iterations that run in every
     Gauss-Newton step of the drive's pose-graph solves (an eager count;
     with --out DIR the graphs go to DIR/canyon_long_graphs.npz for
     tests/pg_cg_witness.py); hamming_top2 at the largest batch's shape
     (B = E_pad) against its plain version (record path "canyon_long").
     The front end's kernels at this path's frame 1 are phase 12's: the
     same scene, rig, image size and configs.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import shutil
import dataclasses
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
F64_OPS_PER_S = F32_OPS_PER_S / 2   # float64 outside the tensor cores (data sheet: 34e12)
N_FRAMES = 60
ORIENTED_FRAMES = 10
# Kernel launches per frame (per step of the multi-sequence phase).
UPRIGHT_PER_FRAME = {"hamming_top2": 1, "orb_describe": 2, "orb_describe_oriented": 0,
                     "extract_patches": 0, "triangulate_dlt": 0}
ORIENTED_PER_FRAME = {"hamming_top2": 1, "orb_describe": 0, "orb_describe_oriented": 2,
                      "extract_patches": 0, "triangulate_dlt": 0}
# The general (non-rectified) rig: the upright path and one DLT launch.
GENERAL_PER_FRAME = {**UPRIGHT_PER_FRAME, "triangulate_dlt": 1}
EXTRACT_PATCHES_NOTE = ("launched by no path: both describes fuse the cut; kept as the direct "
                        "port of the TPU kernel")
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
        library_call="one advanced-index gather img[rows, cols] (float32 out)",
        note=EXTRACT_PATCHES_NOTE))

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

    # The fused oriented describe at the same shape, on the describe's own
    # input (a random image smoothed and padded as compute_descriptors does),
    # a quarter of the corners invalid, some exactly at .5.
    raw = torch.from_numpy(rng.uniform(0, 255, (KITTI["h"], KITTI["w"])).astype(np.float32))
    smooth = orb.pad_edge(orb.smooth_image(raw.to(dev))).contiguous()
    records.append(_oriented_record("orb_describe_oriented", smooth, xy, valid))
    records[-1].update(_raw_noise_angles(img, xy, valid))
    for r in records:
        log(f"kernel {r['name']}: match {r['match']}, device {r['ms'] * 1e3:.2f} us "
            f"(bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), per call "
            f"{r['call_ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {r['library_ms']}")

    # The batched DLT at the general path's N = 1024 on EuRoC cam0's rig:
    # half the points 1.5-5 m deep, half 45-100 m, a quarter of the slots
    # zero (invalid). Phase 11 holds it on that path's own inputs.
    P1, P2, uv1, uv2, valid, near = _dlt_case(rng, 1024)
    # The plain version's float32 SVD is held to the kernel on the near half
    # only: at 45-100 m its own error passes DLT_PLAIN_ATOL.
    records.append(_dlt_record(
        "triangulate_dlt", "general", *(torch.from_numpy(x).to(dev) for x in (P1, P2, uv1, uv2)),
        valid, "N=1024 (a quarter invalid), EuRoC cam0 rig, depth 1.5-5 m and 45-100 m, S = 1",
        plain_valid=valid & near))
    return records, floor_ms


def _dlt_case(rng, n):
    """EuRoC cam0's projections (baseline 0.110 m) and [1, n, 2] pixel pairs
    of points half 1.5-5 m deep, half 45-100 m, with pixel noise on the
    left and a quarter of the slots zero; returns (P1, P2, uv1, uv2, valid,
    near) with valid and near [1, n]."""
    from synth_distorted import EUROC

    K = np.array([[EUROC["fx"], 0, EUROC["cx"]], [0, EUROC["fx"], EUROC["cy"]], [0, 0, 1.0]])
    P1 = (K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32)
    P2 = (K @ np.hstack([np.eye(3), [[-EUROC["baseline"]], [0.0], [0.0]]])).astype(np.float32)
    near = np.arange(n) < n // 2
    z = np.where(near, rng.uniform(1.5, 5.0, n), rng.uniform(45.0, 100.0, n))
    X = np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.5, 0.5, n) * z, z], 1)

    def pix(P):
        x = X @ P[:, :3].T.astype(np.float64) + P[:, 3]
        return (x[:, :2] / x[:, 2:]).astype(np.float32)

    uv1 = pix(P1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2 = pix(P2)
    valid = rng.random(n) >= 0.25
    uv1[~valid] = 0.0
    uv2[~valid] = 0.0
    return P1, P2, uv1[None], uv2[None], valid[None], near[None]


# The fused oriented describe against its plain chain: at most 1e-4 of the
# bits may differ (0 expected: each sample's <= 4 exact products are added in
# ascending pixel index, the dense products in their own order), and every
# corner's angle within ORIENTED_THETA_ATOL of the plain chain's on smoothed
# images (there every moment sum is exact in any order). Against the float64
# moments' angle, every corner within the float32 error bound of the kernel's
# order (`_f64_angles`): each moment term passes at most 32 + 5 roundings.
ORIENTED_THETA_ATOL = 1e-5
ORIENTED_SUM_ROUNDINGS = 32 + 5


def _oriented_bound(padded, valid, theta, radius=15):
    """The least time of the oriented describe on these inputs (ms, bound
    by): the padded images read once, the tap records (an int16 index and a
    bf16 weight per tap) of the bins that the valid corners use, 9 bytes in
    and 36 out per corner, against float32 operations: 4 per disc pixel per
    corner for the two moments and 3 per tap (the bin weight's product, the
    fma) for the valid corners' two bins."""
    import torch

    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import describe

    k0 = torch.remainder(torch.floor(theta * (orb.K_BINS / (2.0 * np.pi))).long(), orb.K_BINS)
    k0 = k0[valid]
    bins = int(torch.unique(torch.cat([k0, (k0 + 1) % orb.K_BINS])).numel())
    n, n_valid = valid.numel(), int(valid.sum())
    d = np.arange(orb.PATCH) - orb.PATCH_R
    disc = int((d[:, None] ** 2 + d[None, :] ** 2 <= radius * radius).sum())
    bytes_ = (padded.numel() * 4 + bins * 2 * orb.N_TESTS * describe.TAPS * (2 + 2)
              + n * (8 + 1) + n * (32 + 4))
    ops = n * 4 * disc + n_valid * 2 * orb.N_TESTS * 2 * describe.TAPS * 3
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), bins


def _f64_angles(padded, xy, radius=15):
    """The angles of the float64 moments of the bf16 windows (exact sums),
    and the float32 error bound of the kernel's order for them: 1e-6 rad
    (atan2f and rounding) + ORIENTED_SUM_ROUNDINGS * 2^-24 * S / |m|, with S
    the sum of the moment terms' magnitudes and |m| the resultant moment."""
    import torch

    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import patches

    win = patches.extract_patches_plain(padded, *orb.window_starts(xy), orb.PATCH).double()
    win = win.reshape(-1, orb.PATCH * orb.PATCH)
    masks = orb._disc_masks(radius, padded.device).double()
    mom = win @ masks
    size = win.abs() @ masks.abs().sum(1)
    spread = torch.where(size > 0, size / mom.norm(dim=1), 0.0)
    bound = 1e-6 + ORIENTED_SUM_ROUNDINGS * 2.0 ** -24 * spread
    return (torch.atan2(mom[:, 1], mom[:, 0]).reshape(xy.shape[:-1]),
            bound.reshape(xy.shape[:-1]))


def _f64_gap(theta, exact, bound):
    """(largest distance from the float64 angle, largest share of its bound)."""
    gap = (theta.double() - exact).abs()
    return float(gap.max()), float((gap / bound).max())


def _raw_noise_angles(padded, xy, valid):
    """The oriented describe on unsmoothed uniform noise, harsher than its
    real input: dark pixels' bf16 values are finer than the moment sums'
    ulp, so the order of the sums shows. Bits against the plain chain (at
    most 1e-4 differing), and each angle's distance from the float64
    moments' angle: the kernel's held to its order's bound, the plain
    chain's recorded beside it."""
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import describe

    table = orb.steer_table(True, padded.device)
    words, theta = describe.orb_describe_oriented(padded, xy, valid, table)
    want, plain = describe.orb_describe_oriented_plain(padded, xy, valid, table)
    exact, bound = _f64_angles(padded, xy)
    flips = int((orb.unpack_bits(words) != orb.unpack_bits(want)).sum())
    kernel_err, kernel_share = _f64_gap(theta, exact, bound)
    plain_err, plain_share = _f64_gap(plain, exact, bound)
    log(f"orb_describe_oriented on raw noise: {flips} bits differ from the plain chain; "
        f"angles within {kernel_err:.3g} rad of the float64 moments' angle ({kernel_share:.3g}"
        f" of the bound), the plain chain's within {plain_err:.3g} rad ({plain_share:.3g})")
    if flips > valid.numel() * orb.N_TESTS * 1e-4 or kernel_share > 1.0:
        raise AssertionError(f"orb_describe_oriented on raw noise: {flips} bits differ, "
                             f"angles at {kernel_share} of their float64 bound")
    return {"raw_noise_bits_differing": flips, "raw_noise_theta_f64_err_rad": kernel_err,
            "raw_noise_plain_theta_f64_err_rad": plain_err}


def _oriented_record(name, padded, xy, valid):
    """orb_describe_oriented on [.., Hp, Wp] images against its plain chain
    (and, for a batch, bit for bit against B = 1 launches), timed beside its
    bound, the plain chain and the chain the oriented path ran before it
    (the patch-cut kernel, then the same moments, per-bin products, compare
    and pack)."""
    import torch

    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import describe, patches

    table = orb.steer_table(True, padded.device)
    words, theta = describe.orb_describe_oriented(padded, xy, valid, table)
    want, want_theta = describe.orb_describe_oriented_plain(padded, xy, valid, table)
    exact, bound = _f64_angles(padded, xy)
    torch.cuda.synchronize()
    diff = (orb.unpack_bits(words) - orb.unpack_bits(want)).abs()
    flips, bits = int(diff.sum()), valid.numel() * orb.N_TESTS
    theta_err = float((theta - want_theta).abs().max())
    theta_f64_err, theta_f64_share = _f64_gap(theta, exact, bound)
    log(f"{name}: {flips} of {bits} bits differ from the plain chain; angle within "
        f"{theta_err:.3g} rad of it and {theta_f64_err:.3g} rad of the float64 moments' angle "
        f"({theta_f64_share:.3g} of its bound)")
    if words.shape != want.shape or flips > bits * 1e-4:
        raise AssertionError(f"{name} differs from its plain chain in {flips} bits")
    if theta_err > ORIENTED_THETA_ATOL or theta_f64_share > 1.0:
        raise AssertionError(f"{name}: angles off by {theta_err} rad (plain chain), "
                             f"{theta_f64_err} rad (float64, {theta_f64_share} of the bound)")
    if torch.any(words[~valid] != 0):
        raise AssertionError(f"{name}: an invalid corner got a descriptor")
    if padded.dim() == 3:
        for b in range(padded.shape[0]):
            _check_equal(f"{name} (image {b}) against B = 1", (words[b], theta[b]),
                         describe.orb_describe_oriented(padded[b], xy[b], valid[b], table))

    def parent_chain():
        cut = patches.extract_patches(padded, *orb.window_starts(xy), orb.PATCH)
        return describe.steered_words_from_patches(cut.reshape(-1, orb.PATCH * orb.PATCH),
                                                   valid, table)

    ms = time_device(lambda: describe.orb_describe_oriented(padded, xy, valid, table))
    call_ms = time_call(lambda: describe.orb_describe_oriented(padded, xy, valid, table))
    plain_ms = time_device(
        lambda: describe.orb_describe_oriented_plain(padded, xy, valid, table), reps=10)
    parent_ms = time_device(parent_chain, reps=10)
    bound_ms, bound_by, bins = _oriented_bound(padded, valid, want_theta)
    B = padded.shape[0] if padded.dim() == 3 else 1
    H, W = padded.shape[-2:]
    return _record(
        name, "stereo_orb_slam_torch/csrc/orb_describe_oriented.cu",
        "stereo_orb_slam_tpu/ops/pallas/patches.py:63", "oriented",
        max_abs_err=float(diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, match=flips == 0, bits_differing=flips,
        theta_max_err_rad=theta_err, theta_f64_max_err_rad=theta_f64_err,
        theta_f64_share_of_bound=theta_f64_share, call_ms=call_ms,
        parent_chain_ms=parent_ms, bins_used=bins, batch=B,
        shape=f"B={B} smoothed images of {H}x{W}, N={xy.shape[-2]} each "
              f"({int((~valid).sum())} invalid in all), one launch",
        replaces_note="the patch cut on the oriented path, fused with its caller's bf16 "
                      "cast, moments, atan2, 30 per-bin sampling products, compare and "
                      "bit packing",
        plain_note="parent_chain_ms: the patch-cut kernel and the same products, the "
                   "oriented path before the fused kernel")


def _render_sequence(root, n, steps=None):
    """KITTI-layout folder of n synthetic stereo PNG pairs + calib + GT
    (frame i at x = steps[i] whole steps; steps defaults to 0..n-1).

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
    for i, s in enumerate(range(n) if steps is None else steps):
        for cam, right in (("image_0", False), ("image_1", True)):
            img = scene.render(s * step, right=right).clip(0, 255).astype(np.uint8)
            Image.fromarray(img, "L").save(os.path.join(seq, cam, f"{i:06d}.png"))
        T = np.eye(4)
        T[0, 3] = s * step
        gt.append(" ".join(f"{v:.6f}" for v in T[:3, :].reshape(12)))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {k['fx']} 0 {k['cx']} 0 0 {k['fx']} {k['cy']} 0 0 0 1 0\n"
                f"P1: {k['fx']} 0 {k['cx']} {-k['fx'] * k['baseline']} 0 {k['fx']} "
                f"{k['cy']} 0 0 0 1 0\n")
    gt_path = os.path.join(root, "gt_00.txt")
    with open(gt_path, "w") as f:
        f.write("\n".join(gt) + "\n")
    return seq, gt_path


def phase_cuda_vs_cpu(seq, oriented=False, frame=3):
    """One full-size frame through detection and description on the card
    and on the CPU: the same corners, and descriptor bits that agree; with
    `oriented`, the steered describe, and the angles of the CPU's corners
    on both devices within ORIENTED_THETA_ATOL."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig
    from stereo_orb_slam_torch.frontend.odometer import detect_and_describe
    from stereo_orb_slam_torch.io.datasets import read_grayscale
    from stereo_orb_slam_torch.ops import orb

    img = read_grayscale(os.path.join(seq, "image_0", f"{frame:06d}.png"))
    fe = FrontendConfig(oriented=oriented)
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
    theta_err = 0.0
    if oriented:
        theta = {}
        for dev in ("cpu", "cuda"):
            _, t = orb.compute_descriptors(
                torch.from_numpy(img).to(dev), torch.from_numpy(xy_c).to(dev),
                torch.from_numpy(v_c).to(dev), fe.smoothing_ksize, fe.orientation_radius,
                orb.steer_table(True, dev))
            theta[dev] = t.cpu()
        theta_err = float((theta["cpu"] - theta["cuda"]).abs().max())
    log(f"cuda vs cpu, {'oriented' if oriented else 'upright'} describe, frame {frame} "
        f"(376x1241): {int(v_c.sum())} corners, xy max diff {xy_err:.3g} px, descriptor bits "
        f"differing {flips} of {bits}" + (f", angle max diff {theta_err:.3g} rad"
                                          if oriented else ""))
    if xy_err > 1e-3 or flips > bits * 1e-4 or theta_err > ORIENTED_THETA_ATOL:
        raise AssertionError("the card and the CPU disagree beyond the stated bounds")
    return {"corners": int(v_c.sum()), "bits_differing": flips, "theta_max_err_rad": theta_err}


def _reset_launches():
    from stereo_orb_slam_torch.ops.kernels import describe, dlt, hamming, patches

    for mod in (hamming, patches, describe, dlt):
        mod.LAUNCHES = 0
    describe.ORIENTED_LAUNCHES = 0


def _read_launches():
    from stereo_orb_slam_torch.ops.kernels import describe, dlt, hamming, patches

    return {"hamming_top2": hamming.LAUNCHES, "extract_patches": patches.LAUNCHES,
            "orb_describe": describe.LAUNCHES,
            "orb_describe_oriented": describe.ORIENTED_LAUNCHES,
            "triangulate_dlt": dlt.LAUNCHES}


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
                    UPRIGHT_PER_FRAME, n)
    return summary, launches


def phase_oriented(seq, gt, frames=ORIENTED_FRAMES):
    """The oriented describe (`FrontendConfig(oriented=True)`), the fused
    oriented kernel's path: frame 0's descriptors on the card against the
    CPU path, then `frames` frames through `VisualOdometer.track` with
    finite poses and exactly ORIENTED_PER_FRAME launches per frame (ATE
    printed); its ms per frame beside upright VO's on the same frames, both
    warmed first (host clock, each run ending in a sync)."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap

    devices = phase_cuda_vs_cpu(seq, oriented=True, frame=0)
    pairs = datasets.load_dataset("kitti", seq)[:frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    rig = calib.load_camera(os.path.join(seq, "calib.txt"))
    # The first frames of each path pay for tables and plans once per process.
    for fe in (FrontendConfig(oriented=True), FrontendConfig()):
        warm = VisualOdometer(WorldMap(), rig, fe=fe)
        for il, ir in imgs[:2]:
            warm.track(il, ir)
    torch.cuda.synchronize()

    world = WorldMap()
    vo = VisualOdometer(world, rig, fe=FrontendConfig(oriented=True))
    _reset_launches()
    t0 = time.perf_counter()
    for il, ir in imgs:
        vo.track(il, ir)
    torch.cuda.synchronize()
    oriented_s = time.perf_counter() - t0
    launches = _read_launches()
    upright = VisualOdometer(WorldMap(), rig)
    t0 = time.perf_counter()
    for il, ir in imgs:
        upright.track(il, ir)
    torch.cuda.synchronize()
    upright_s = time.perf_counter() - t0
    poses = world.pose_global[: world.num_frames]
    if not (np.isfinite(poses).all() and poses.shape == (frames, 4, 4)):
        raise AssertionError("oriented path: poses are not finite [frames, 4, 4]")
    ate = evaluate.ate_rmse(poses, evaluate.load_kitti_gt(gt)[:frames])
    rec = {"frames": frames, "ms_per_frame": oriented_s * 1e3 / frames,
           "upright_ms_per_frame": upright_s * 1e3 / frames, "ate_m": ate,
           "points": world.num_points, "launches": launches, "cuda_vs_cpu": devices}
    log(f"oriented path: {frames} frames, {rec['ms_per_frame']:.2f} ms/frame against upright VO "
        f"{rec['upright_ms_per_frame']:.2f} ms/frame on the same frames, ATE {ate:.5f} m, "
        f"{world.num_points} points, launches {launches}")
    _check_launches("oriented path", launches, ORIENTED_PER_FRAME, frames)
    return rec


# The general (distorted, non-rectified) rig, EuRoC MAV's cam0 model
# (tests/synth_distorted.EUROC: 752x480, fx = fy = 458.654, k1, k2, baseline
# 0.110 m), through a textured plane at the depth of 20 px of disparity
# (2.52 m), moving in whole 8 px steps in undistorted coordinates (4.4 cm a
# frame, a MAV's speed at 20 Hz). The SLAM run goes out over the 60
# positions and back to the start (119 frames).
GENERAL_FRAMES = 60
GENERAL_STEP_PX = 8
GENERAL_DISPARITY_PX = 20
# ATE gates. The SLAM run's (BA on) is the general path's accuracy gate.
# The VO app alone sits far above it, in both packages: corners are
# detected in the distorted images, where the local warp moves each one's
# detected position, so undistorted disparities scatter (the landmark depth
# scatter is recorded in phase_general_devices; on the CPU test scene it is
# 2.65 % in both packages against 1e-5 without distortion,
# tests/test_torch_general_stereo.py), and the minimal-set RANSAC trades
# rotation against translation on the one plane (ROADMAP queue 3), so the
# error depends on the RANSAC draws. On this tree, on the CPU
# (tests/general_vo_witness.py), the JAX package's VO app reaches 0.1197 m,
# the port's 0.0388 m with its own draws and 0.1197 m with the JAX
# package's (its trajectory within 2.9e-4 m of JAX's); on an H100 the port
# reaches 0.13405 m, the same in every run (PERF.md). The VO gate sits
# just above the card's reading.
GENERAL_SLAM_ATE_M = 0.02
GENERAL_VO_ATE_M = 0.15
# Card against CPU on one distorted frame: the share of orb_describe's bits
# that may differ (the kernel's bound against its plain version, phase 3),
# then each bound a few times its reading on an H100 (PERF.md): undistorted
# pixels, each device's float32
# DLT against a float64 DLT of the same pixels (the two devices' points may
# differ by twice that), the RANSAC transform from the same minimal sets.
GENERAL_DESC_FLIPS = 1e-4
GENERAL_UV_ATOL = 2.5e-4
GENERAL_DLT_F64_ATOL = 5e-5
GENERAL_T_ATOL = 2e-5


def _render_general(root, frames=GENERAL_FRAMES, seed=42):
    """The general rig's sequences as EuRoC mav0 trees (uint8 PNGs) with
    the reference's camera file (type=Stereo, distortion, extrinsics) and
    KITTI-format ground truth: `frames` positions for VO, and the SLAM
    run's out-and-back over the same images (a tree of links)."""
    from synth_distorted import (
        euroc_scene, write_camera_file, write_euroc_replay, write_euroc_tree, write_gt,
    )

    scene = euroc_scene(np.random.default_rng(seed), GENERAL_DISPARITY_PX)
    step = GENERAL_STEP_PX * scene.depth / scene.fx
    xs = [i * step for i in range(frames)]
    g = {"vo": os.path.join(root, "euroc_vo"), "slam": os.path.join(root, "euroc_slam"),
         "camera": os.path.join(root, "euroc_camera.txt"), "step_m": step,
         "depth_m": scene.depth, "size": (scene.h, scene.w)}
    write_euroc_tree(g["vo"], scene, xs)
    write_camera_file(g["camera"], scene)
    write_gt(os.path.join(g["vo"], "gt.txt"), xs)
    order = list(range(frames)) + list(range(frames - 2, -1, -1))
    write_euroc_replay(g["slam"], g["vo"], order)
    write_gt(os.path.join(g["slam"], "gt.txt"), [xs[i] for i in order])
    return g


def phase_general_vo(g, out_dir, rectified_ms, device="cuda"):
    """The VO app on the general rig: `--dataset EuRoc` with the distorted
    camera file, on the card. Needs the non-rectified rig, ATE <
    GENERAL_VO_ATE_M and exactly GENERAL_PER_FRAME launches per frame (on the
    card); prints ms per frame beside the rectified main path's (phase 4)."""
    from stereo_orb_slam_torch.apps import visual_odometry
    from stereo_orb_slam_torch.io import calib

    if calib.load_camera(g["camera"], device="cpu").rectified:
        raise AssertionError("general path: the camera file gives a rectified rig")
    _reset_launches()
    summary = visual_odometry.main([
        "--dataset", "EuRoc", "--folder", g["vo"], "--camera", g["camera"],
        "--output_dir", out_dir, "--gt", os.path.join(g["vo"], "gt.txt"), "--device", device,
    ])
    launches = _read_launches()
    _sync(device)
    world = summary["world"]
    n = summary["frames"]
    poses = world.pose_global[: world.num_frames]
    rec = {"frames": n, "size": g["size"], "depth_m": g["depth_m"], "step_m": g["step_m"],
           "fps": summary["fps"], "median_ms": summary["median_ms"],
           "rectified_median_ms": rectified_ms, "ate_m": summary["ate_m"],
           "points": world.num_points, "launches": launches}
    log(f"general path (EuRoC cam0, distorted, non-rectified): {n} frames at "
        f"{g['size'][0]}x{g['size'][1]}, {summary['fps']:.2f} frames/s, median "
        f"{summary['median_ms']:.2f} ms/frame against the rectified main path's "
        f"{rectified_ms:.2f}, ATE {summary['ate_m']:.5f} m, {world.num_points} points, "
        f"launches {launches}")
    if not (np.isfinite(poses).all() and poses.shape == (n, 4, 4)):
        raise AssertionError("general path: poses are not finite [frames, 4, 4]")
    if not summary["ate_m"] < GENERAL_VO_ATE_M:
        raise AssertionError(f"general path: ATE {summary['ate_m']} m is not below "
                             f"{GENERAL_VO_ATE_M} m")
    if _is_cuda(device):
        _check_launches("general path", launches, GENERAL_PER_FRAME, n)
    return rec


def _syncs_per_frame(vo, imgs, warm=2):
    """Device syncs of one `track` call after `warm` frames."""
    for il, ir in imgs[:warm]:
        vo.track(il, ir)
    return _syncs_per_call(lambda: vo.track(*imgs[warm]))[1]


def _events_ms(fn, reps=100):
    """Milliseconds of one fn() call between CUDA events over `reps` calls
    issued back to back, for calls that sync the host (no graph can hold
    them): the events also hold the device's wait for the host between
    calls; a profile gives the kernels' own time."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _svd_call_us(A, reps=100):
    """(µs of one torch.linalg.svd(A) per call between CUDA events, device
    syncs of one call)."""
    import torch

    return (_events_ms(lambda: torch.linalg.svd(A), reps) * 1e3,
            _syncs_per_call(lambda: torch.linalg.svd(A))[1])


# The batched DLT kernel on a path's inputs: against its plain version (on
# the card cuSOLVER's float32 SVD) on the valid slots within
# DLT_PLAIN_ATOL (the card-against-CPU bound of the general path's points,
# 2 * GENERAL_DLT_F64_ATOL), against a float64 DLT within DLT_F64_RTOL of
# each valid point's depth (the kernel is that DLT rounded once; float32
# rounding alone is 6e-8), and finite on every slot, invalid ones included.
DLT_PLAIN_ATOL = 2 * GENERAL_DLT_F64_ATOL
DLT_F64_RTOL = 2e-6
DLT_REPLACES = "stereo_orb_slam_tpu/geometry/camera.py:185"
DLT_NOTE = ("a hand kernel with no Pallas counterpart: it replaces the SVD of the plain "
            "version (torch.linalg.svd, cuSOLVER on the card, 2 host syncs a call), whose "
            "JAX counterpart is jnp.linalg.svd inside the jitted program")


def _dlt_systems(P1, P2, uv1, uv2):
    """The [B * N, 4, 4] systems the plain version hands torch.linalg.svd."""
    import torch

    rows = [uv[..., c:c + 1] * P[..., 2, :] - P[..., c, :]
            for P, uv in ((P1, uv1), (P2, uv2)) for c in (0, 1)]
    return torch.stack(rows, dim=-2).reshape(-1, 4, 4)


def _dlt_record(name, path, P1, P2, uv1, uv2, valid, shape, plain_valid=None):
    """The kernel on [B, N, 2] correspondences (P [3, 4] or [B, 1, 3, 4])
    against its plain version and a float64 DLT, timed (device µs from a
    graph of 50 launches; the plain version and the library call per call
    between events: they sync), with the bound from this run's Jacobi
    sweeps and rotations; `valid` [B, N] marks the slots held against
    float64, `plain_valid` (by default `valid`) those held against the
    plain version."""
    import torch

    from stereo_orb_slam_torch.ops.kernels import dlt
    from synth_distorted import dlt_float64

    args = (P1, P2, uv1, uv2)
    got = dlt.triangulate_dlt(*args)
    plain = dlt.triangulate_dlt_plain(*args)
    _, work = dlt.triangulate_dlt_work(*args)
    torch.cuda.synchronize()
    B, n = uv1.shape[0], uv1.shape[1]
    g, pl = got.cpu().numpy(), plain.cpu().numpy()
    plain_valid = valid if plain_valid is None else plain_valid
    plain_gap = float(np.abs(g - pl)[plain_valid].max())
    rel = []
    for b in range(B):
        Q1, Q2 = (P.reshape(-1, 3, 4)[b if P.dim() > 2 else 0].cpu().numpy() for P in (P1, P2))
        x64 = dlt_float64(Q1, Q2, uv1[b].cpu().numpy()[valid[b]], uv2[b].cpu().numpy()[valid[b]])
        rel.append(np.abs(g[b][valid[b]] - x64).max(1) / np.abs(x64[:, 2]))
    f64_rel = float(np.concatenate(rel).max())
    nonfinite = int((~np.isfinite(g)).any(-1).sum())
    ms = time_device(lambda: dlt.triangulate_dlt(*args))
    call_ms = time_call(lambda: dlt.triangulate_dlt(*args))
    plain_ms = _events_ms(lambda: dlt.triangulate_dlt_plain(*args))
    A = _dlt_systems(*args)
    library_ms = _events_ms(lambda: torch.linalg.svd(A))
    library_kernels, library_device_ms = _kernels_in(lambda: torch.linalg.svd(A))
    # Operations of this run's data (float64 adds, multiplies, divisions and
    # square roots, an FMA as two): 99 per point for the system, its norm,
    # the column norms and the division, 162 per sweep (six pair tests: three
    # 4-term dot products and the test) and 60 per rotation (the angle and
    # two 4-row column updates of A and of V).
    w = work.cpu().numpy().reshape(-1, 2).astype(np.int64)
    ops = 99 * B * n + 162 * int(w[:, 0].sum()) + 60 * int(w[:, 1].sum())
    bytes_ = B * n * (2 * 8 + 12) + 2 * 48 * (B if P1.dim() > 2 else 1)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F64_OPS_PER_S * 1e3
    rec = _record(
        name, "stereo_orb_slam_torch/csrc/triangulate_dlt.cu", DLT_REPLACES, path,
        max_abs_err=plain_gap, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=library_ms,
        match=plain_gap <= DLT_PLAIN_ATOL and f64_rel <= DLT_F64_RTOL and nonfinite == 0,
        float64_rel_err=f64_rel, nonfinite=nonfinite, call_ms=call_ms,
        library_call="torch.linalg.svd of the [B * N, 4, 4] systems (cuSOLVER; per call "
                     "between events, it syncs)",
        library_device_ms=library_device_ms, library_kernels=library_kernels,
        sweeps_max=int(w[:, 0].max()), sweeps_mean=float(w[:, 0].mean()),
        rotations_mean=float(w[:, 1].mean()), ops=ops, valid=int(valid.sum()),
        against_plain=int(plain_valid.sum()), shape=shape,
        note=DLT_NOTE)
    log(f"kernel {name}: {shape}; against plain {plain_gap:.3g} m (bound {DLT_PLAIN_ATOL}), "
        f"against float64 {f64_rel:.3g} of the depth (bound {DLT_F64_RTOL}), {nonfinite} "
        f"non-finite; device {ms * 1e3:.2f} us (bound {rec['bound_ms'] * 1e3:.4f} us by "
        f"{rec['bound_by']}, {ops} operations, sweeps mean {rec['sweeps_mean']:.2f} max "
        f"{rec['sweeps_max']}), per call {call_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us "
        f"per call, torch.linalg.svd {library_ms * 1e3:.2f} us per call "
        f"({library_device_ms * 1e3:.2f} us device in {library_kernels} kernels)")
    if not rec["match"]:
        raise AssertionError(f"{name}: the DLT kernel is off its plain version ({plain_gap} m), "
                             f"off the float64 DLT ({f64_rel} of the depth) or non-finite "
                             f"({nonfinite} slots)")
    return rec


def phase_general_devices(g, seq, frame=1, device="cuda", reference_device="cpu"):
    """The general path's own pieces, the card against the CPU, on frames
    frame - 1 and frame of the distorted sequence (`frontend_step` on both
    devices, the same RANSAC sets): the counts and slot validity equal,
    undistorted pixels within GENERAL_UV_ATOL, the DLT points of valid slots
    within 2 * GENERAL_DLT_F64_ATOL of each other (and each device's DLT of
    the CPU's pixels within GENERAL_DLT_F64_ATOL of a float64 DLT), the
    RANSAC transform within GENERAL_T_ATOL; no non-finite DLT point on the
    card, invalid slots included (the kernel's guard). Also: the batched
    4x4 SVD's time per call at the frame's shape (CUDA events) and its
    syncs (the library call the DLT kernel replaced), and the syncs of one
    distorted and one rectified VO frame, which must be equal (both
    frames are one captured replay)."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import (
        VisualOdometer, _to_host, empty_slots, frontend_step,
    )
    from stereo_orb_slam_torch.geometry import camera as cam_mod
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.worldmap import WorldMap
    from synth_distorted import dlt_float64

    fe, rc = FrontendConfig(), RansacConfig()
    pairs = datasets.load_dataset("EuRoc", g["vo"])
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs[:3]]
    out, rigs = {}, {}
    for dev in (reference_device, device):
        rig = rigs[dev] = calib.load_camera(g["camera"], device=dev)
        prev, usable = empty_slots(fe.num_features, dev), False
        for j, (il, ir) in enumerate(imgs[: frame + 1]):
            res = frontend_step(torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev),
                                prev, torch.tensor(usable, device=dev),
                                _edge_sampler(j, rc.num_hypotheses), rig,
                                rig.max_sensible_distance(), fe, rc, rectified=False,
                                steer=orb.steer_table(fe.oriented, dev))
            prev, usable = res.slots, True
        out[dev] = _to_host(res)
    ref, got = out[reference_device], out[device]
    counts = {k: (int(getattr(ref, k)), int(getattr(got, k)))
              for k in ("num_stereo", "num_temporal", "num_inliers", "ransac_success")}
    valid = ref.slots.valid
    same_valid = bool(np.array_equal(valid, got.slots.valid))
    uv_gap = max(float(np.abs(ref.slots.kp_l - got.slots.kp_l).max()),
                 float(np.abs(ref.slots.kp_r - got.slots.kp_r)[valid].max()))
    pts_gap = float(np.abs(ref.slots.pts - got.slots.pts)[valid].max())
    t_gap = float(np.abs(ref.transform - got.transform).max())
    # The kernels' own outputs at this path's shapes: orb_describe's words
    # of every slot (the card's kernel against the CPU's plain version, at
    # most GENERAL_DESC_FLIPS of the bits) and hamming_top2's temporal
    # matches, which then decide the RANSAC inliers (equal).
    flips = int(np.unpackbits(np.bitwise_xor(ref.slots.desc, got.slots.desc)
                              .view(np.uint8)).sum())
    bits = ref.slots.desc.size * 32
    same_matches = bool(np.array_equal(ref.prev_idx, got.prev_idx)
                        and np.array_equal(ref.tracked, got.tracked))
    # The landmarks' depth against the plane's: the scatter that the
    # detector's positions in the distorted images leave (see
    # GENERAL_VO_ATE_M), and the stereo matches off by more than 10 %.
    rel = np.abs(ref.slots.pts[valid, 2] / g["depth_m"] - 1.0)
    depth_err = {"median_abs": float(np.median(rel)), "max_abs": float(rel.max()),
                 "share_over_10pct": float((rel > 0.1).mean())}

    # Each device's DLT of the CPU's ideal pixels against float64.
    kp_l, kp_r = ref.slots.kp_l, ref.slots.kp_r
    P_l, P_r = (rigs[reference_device].left.projection.numpy(),
                rigs[reference_device].right.projection.numpy())
    x64 = dlt_float64(P_l, P_r, kp_l[valid], kp_r[valid])
    f64_gap, nonfinite = {}, 0
    for dev, rig in rigs.items():
        pts, _ = cam_mod.triangulate_ideal(rig, torch.from_numpy(kp_l).to(dev),
                                           torch.from_numpy(kp_r).to(dev), rectified=False)
        pts = pts.cpu().numpy()
        f64_gap[dev] = float(np.abs(pts[valid] - x64).max())
        if dev == device:
            nonfinite = int((~np.isfinite(pts)).any(axis=1).sum())
            if not np.isfinite(pts[valid]).all():
                raise AssertionError("general path: the card's DLT of a valid slot is not "
                                     "finite")

    # The DLT's batched SVD at the frame's shape ([N, 4, 4]) on the card,
    # and the syncs of one VO frame, distorted and rectified, counted alike.
    svd_us = svd_syncs = general_syncs = rect_syncs = None
    A = _dlt_systems(rigs[device].left.projection, rigs[device].right.projection,
                     torch.from_numpy(kp_l).to(device), torch.from_numpy(kp_r).to(device))
    if _is_cuda(device):
        svd_us, svd_syncs = _svd_call_us(A)
        general_syncs = _syncs_per_frame(VisualOdometer(WorldMap(), rigs[device]), imgs)
        kitti = datasets.load_dataset("kitti", seq)[:3]
        kimgs = [(datasets.read_grayscale(p), datasets.read_grayscale(q)) for p, q in kitti]
        rect_syncs = _syncs_per_frame(VisualOdometer(WorldMap(), calib.load_camera(
            os.path.join(seq, "calib.txt"), device=device)), kimgs)

    rec = {"frame": frame, "counts_cpu_card": counts, "valid_slots": int(valid.sum()),
           "same_slot_validity": same_valid, "desc_bits_differing": flips,
           "desc_bits": bits, "same_temporal_matches": same_matches,
           "undistorted_px_max_diff": uv_gap,
           "points_max_diff_m": pts_gap, "transform_max_diff": t_gap,
           "dlt_vs_float64_m": f64_gap, "card_dlt_nonfinite_slots": nonfinite,
           "depth_rel_err": depth_err,
           "svd_call_us": svd_us, "svd_batch": list(A.shape),
           "svd_syncs_per_call": svd_syncs, "syncs_per_frame_general": general_syncs,
           "syncs_per_frame_rectified": rect_syncs,
           "bounds": {"desc_bits_share": GENERAL_DESC_FLIPS, "uv_px": GENERAL_UV_ATOL, "dlt_f64_m": GENERAL_DLT_F64_ATOL,
                      "points_m": 2 * GENERAL_DLT_F64_ATOL, "transform": GENERAL_T_ATOL}}
    log(f"general path, card against CPU on frame {frame}: counts {counts}, "
        f"{rec['valid_slots']} valid slots (validity equal: {same_valid}), descriptors "
        f"{flips} of {bits} bits differ, temporal matches and inliers equal: {same_matches}, "
        f"undistorted "
        f"pixels {uv_gap:.3g} px (bound {GENERAL_UV_ATOL}), DLT points {pts_gap:.3g} m "
        f"(bound {2 * GENERAL_DLT_F64_ATOL}), against float64 {f64_gap} (bound "
        f"{GENERAL_DLT_F64_ATOL}), transform {t_gap:.3g} (bound {GENERAL_T_ATOL}); "
        f"card DLT non-finite on {nonfinite} slots; landmark depth against "
        f"the plane's, relative: {depth_err}")
    log(f"general path: batched SVD {list(A.shape)} {svd_us} us per call on the card, "
        f"{svd_syncs} syncs per call; syncs per VO frame: distorted {general_syncs}, "
        f"rectified {rect_syncs}")
    if any(a != b for a, b in counts.values()) or not same_valid:
        raise AssertionError(f"general path: the card and the CPU disagree on counts {counts} "
                             f"or slot validity")
    if nonfinite:
        raise AssertionError(f"general path: the card's DLT is not finite on {nonfinite} "
                             f"slots")
    if _is_cuda(device) and general_syncs != rect_syncs:
        raise AssertionError(f"general path: a distorted VO frame syncs {general_syncs} times, "
                             f"a rectified one {rect_syncs}")
    if flips > bits * GENERAL_DESC_FLIPS or not same_matches:
        raise AssertionError(f"general path: orb_describe's words differ in {flips} of {bits} "
                             f"bits, or the temporal matches differ ({same_matches})")
    if not (uv_gap <= GENERAL_UV_ATOL and pts_gap <= 2 * GENERAL_DLT_F64_ATOL
            and max(f64_gap.values()) <= GENERAL_DLT_F64_ATOL and t_gap <= GENERAL_T_ATOL):
        raise AssertionError("general path: the card and the CPU disagree beyond the stated "
                             "bounds")
    return rec


def phase_path_kernels(path, dataset, folder, camera, rectified, desc_flips, frame=1,
                       device="cuda"):
    """A path's two kernels at its own shapes, on the inputs that path gives
    them: the wrappers' arguments are captured from `frontend_step` on
    frames frame - 1 and frame of the tree on the card (the left image's
    describe and the frame's matching), then each kernel is held against
    its plain version on them (hamming_top2 bit for bit, orb_describe at
    most `desc_flips` of the bits) and timed as in phase 3; on a general
    (non-rectified) path also the batched DLT on the frame's own
    undistorted correspondences, alone (S = 1) and stacked with the same
    frame seen through the rig with its views swapped (S = 2, one
    projection pair per problem), against its plain version and a float64
    DLT on the frame's valid slots (`_dlt_record`). Records are named
    "... (path)"."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import empty_slots, frontend_step
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.ops import match, orb
    from stereo_orb_slam_torch.ops.kernels import describe, dlt, hamming

    dev = torch.device(device)
    fe, rc = FrontendConfig(), RansacConfig()
    rig = calib.load_camera(camera, device=dev)
    calls = {"orb_describe": [], "hamming_top2": [], "triangulate_dlt": []}
    hooks = {(describe, "orb_describe"): "orb_describe",
             (match, "hamming_top2_pair"): "hamming_top2"}
    if not rectified:
        hooks[(dlt, "triangulate_dlt")] = "triangulate_dlt"
    originals = {site: getattr(*site) for site in hooks}

    def capture(key, fn):
        def call(*args):
            calls[key].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args)
        return call

    try:
        for site, key in hooks.items():
            setattr(*site, capture(key, originals[site]))
        prev, usable = empty_slots(fe.num_features, dev), False
        for j, (a, b) in enumerate(datasets.load_dataset(dataset, folder)[: frame + 1]):
            res = frontend_step(torch.from_numpy(datasets.read_grayscale(a)).to(dev),
                                torch.from_numpy(datasets.read_grayscale(b)).to(dev),
                                prev, torch.tensor(usable, device=dev),
                                _edge_sampler(j, rc.num_hypotheses), rig,
                                rig.max_sensible_distance(), fe, rc, rectified=rectified,
                                steer=orb.steer_table(fe.oriented, dev))
            prev, usable = res.slots, True
        _sync(device)
    finally:
        for site, fn in originals.items():
            setattr(*site, fn)
    if (len(calls["orb_describe"]) != 2 * (frame + 1) or len(calls["hamming_top2"]) != frame + 1
            or len(calls["triangulate_dlt"]) != (0 if rectified else frame + 1)):
        raise AssertionError(f"{path} kernels: captured {[len(c) for c in calls.values()]} "
                             f"calls over {frame + 1} frames")
    records = []

    # hamming_top2: the frame's left descriptors against its right ones and
    # the previous frame's slots, one launch.
    args = calls["hamming_top2"][-1]
    q, ta, va, tb, vb = args
    got = hamming.hamming_top2_pair(*args)
    plain = (hamming.hamming_top2_plain(q, ta, va), hamming.hamming_top2_plain(q, tb, vb))
    _sync(device)
    err = max(_check_equal(f"hamming_top2_pair ({path}, right image)", got[0], plain[0]),
              _check_equal(f"hamming_top2_pair ({path}, previous frame)", got[1], plain[1]))
    ms = time_device(lambda: hamming.hamming_top2_pair(*args))
    call_ms = time_call(lambda: hamming.hamming_top2_pair(*args))
    plain_ms = time_device(lambda: (hamming.hamming_top2_plain(q, ta, va),
                                    hamming.hamming_top2_plain(q, tb, vb)))
    B, n, m = q.shape[0], q.shape[-2], ta.shape[-2]
    bytes_ = B * (n * 32 + 2 * (m * 32 + m + n * 12))
    ops = B * 2 * 2 * n * m * 256
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / INT8_TENSOR_OPS_PER_S * 1e3
    records.append(_record(
        f"hamming_top2 ({path})", "stereo_orb_slam_torch/csrc/hamming_top2.cu",
        "stereo_orb_slam_tpu/ops/pallas/hamming.py:74", path,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=None, match=True,
        call_ms=call_ms, valid_train=[int(va.sum()), int(vb.sum())],
        shape=f"N={n} against the right image's M={m} and the previous frame's {m} "
              f"({path} frame {frame}, one launch)"))

    # orb_describe: the frame's left image, smoothed and padded, and its
    # corners.
    padded, xy, valid, table = calls["orb_describe"][-2]
    got = describe.orb_describe(padded, xy, valid, table)
    want = describe.orb_describe_plain(padded, xy, valid, table)
    _sync(device)
    diff = (orb.unpack_bits(got) - orb.unpack_bits(want)).abs()
    flips, bits = int(diff.sum()), diff.numel()
    if got.shape != want.shape or flips > bits * desc_flips:
        raise AssertionError(f"orb_describe ({path}) differs from its plain version in "
                             f"{flips} of {bits} bits")
    ms = time_device(lambda: describe.orb_describe(padded, xy, valid, table))
    call_ms = time_call(lambda: describe.orb_describe(padded, xy, valid, table))
    plain_ms = time_device(lambda: describe.orb_describe_plain(padded, xy, valid, table))
    (H, W), n = padded.shape[-2:], xy.shape[-2]
    B = padded.numel() // (H * W)
    bytes_ = B * (H * W * 4 + n * (8 + 1) + n * 32)
    fmas = B * n * 2 * orb.N_TESTS * describe.TAPS
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, 2 * fmas / F32_OPS_PER_S * 1e3
    records.append(_record(
        f"orb_describe ({path})", "stereo_orb_slam_torch/csrc/orb_describe.cu",
        "stereo_orb_slam_tpu/ops/pallas/patches.py:63", path,
        max_abs_err=float(diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=None,
        match=flips == 0, bits_differing=flips, call_ms=call_ms,
        valid_corners=int(valid.sum()),
        shape=f"N={n} ({int(valid.sum())} valid) img={H}x{W} ({path} frame {frame}, "
              f"left image)"))
    for r in records:
        log(f"kernel {r['name']}: {r['shape']}; match {r['match']}, device "
            f"{r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), "
            f"per call {r['call_ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us")
    if not rectified:
        # The DLT of the frame's stereo matches (undistorted pixels of every
        # slot), held on the slots the frame kept.
        P1, P2, uv1, uv2 = calls["triangulate_dlt"][-1]
        valid = res.slots.valid.reshape(1, -1).cpu().numpy()
        n = uv1.shape[-2]
        records.append(_dlt_record(
            f"triangulate_dlt ({path})", path, P1, P2, uv1, uv2, valid,
            f"N={n} ({int(valid.sum())} valid) ({path} frame {frame}, S = 1)"))
        stacked = (torch.stack([P1, P2])[:, None], torch.stack([P2, P1])[:, None],
                   torch.cat([uv1, uv2]), torch.cat([uv2, uv1]))
        records.append(_dlt_record(
            f"triangulate_dlt ({path}, S = 2)", path, *stacked, np.concatenate([valid, valid]),
            f"N={n} x S = 2 ({path} frame {frame} and the same with the views swapped, "
            f"P [2, 1, 3, 4])"))
    return records


GENERAL_MULTI_STEPS = 20


def phase_general_multi_seq(g, steps=GENERAL_MULTI_STEPS, seed=7, device="cuda"):
    """MultiSequenceSLAM over S = 2 distorted sequences at 752 x 480 with
    their rigs stacked, on the card: the first `steps` frames of the tree
    and a second plane (texture seed `seed`, the same rig and depth) that
    the camera passes the other way. Each sequence's poses bit for bit its
    own VisualOdometer run on the card, ATE < GENERAL_VO_ATE_M, and exactly
    GENERAL_PER_FRAME launches per step. Returns (record, (the
    MultiSequenceSLAM, imgs_l, imgs_r [steps, S, H, W]))."""
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.parallel.multi_seq import MultiSequenceSLAM
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap
    from synth_distorted import euroc_scene

    scene = euroc_scene(np.random.default_rng(seed), GENERAL_DISPARITY_PX)
    xs = [[i * g["step_m"] for i in range(steps)], [-i * g["step_m"] for i in range(steps)]]
    pairs = datasets.load_dataset("EuRoc", g["vo"])[:steps]
    imgs = [[(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs],
            [tuple(np.clip(scene.render(x, right=r), 0, 255).astype(np.uint8)
                   for r in (False, True)) for x in xs[1]]]
    imgs_l = np.stack([[seq[i][0] for seq in imgs] for i in range(steps)])
    imgs_r = np.stack([[seq[i][1] for seq in imgs] for i in range(steps)])
    S = imgs_l.shape[1]
    rigs = [calib.load_camera(g["camera"], device=device) for _ in range(S)]
    warm = MultiSequenceSLAM(rigs)
    for i in range(2):
        warm.process(imgs_l[i], imgs_r[i])
    _sync(device)

    multi = MultiSequenceSLAM(rigs)
    if multi.rig_batch.rectified is not False:
        raise AssertionError("general multi-sequence: the stacked rig is rectified")
    _reset_launches()
    t0 = time.perf_counter()
    multi_T = np.stack([np.stack(multi.process(imgs_l[i], imgs_r[i])) for i in range(steps)])
    _sync(device)
    multi_s = time.perf_counter() - t0
    launches = _read_launches()

    gaps, ates = [], []
    for s in range(S):
        vo = VisualOdometer(WorldMap(), rigs[s], seed=s)
        alone = np.stack([vo.track(imgs_l[i, s], imgs_r[i, s]) for i in range(steps)])
        gaps.append(float(np.abs(multi_T[:, s] - alone).max()))
        w = multi.worlds[s]
        poses = w.pose_global[: w.num_frames]
        if not (np.isfinite(poses).all() and w.num_frames == steps
                and np.array_equal(poses, vo.world.pose_global[: vo.world.num_frames])):
            raise AssertionError(f"general multi-sequence: sequence {s} lost frames, is not "
                                 f"finite or differs from its own VisualOdometer run")
        gt = np.tile(np.eye(4), (steps, 1, 1))
        gt[:, 0, 3] = xs[s]
        ates.append(evaluate.ate_rmse(poses, gt))
    rec = {"sequences": S, "steps": steps, "size": g["size"],
           "ms_per_step": multi_s * 1e3 / steps, "pose_gap_to_single": gaps, "ate_m": ates,
           "points": [w.num_points for w in multi.worlds], "launches": launches}
    log(f"general multi-sequence (S = {S} distorted sequences, {steps} steps at "
        f"{g['size'][0]}x{g['size'][1]}): {rec['ms_per_step']:.2f} ms per step, pose gaps to "
        f"each sequence alone {gaps}, ATE {ates} m, launches {launches}")
    if any(gaps):
        raise AssertionError(f"general multi-sequence: poses differ from each sequence "
                             f"tracked alone by {gaps}")
    if not max(ates) < GENERAL_VO_ATE_M:
        raise AssertionError(f"general multi-sequence: ATE {ates} m, not all below "
                             f"{GENERAL_VO_ATE_M} m")
    if _is_cuda(device):
        _check_launches("general multi-sequence", launches, GENERAL_PER_FRAME, steps)
    return rec, (multi, imgs_l, imgs_r)


def phase_general_slam(g, out_dir, device="cuda"):
    """The SLAM app on the general rig (`--dataset EuRoc`, K = 1, the
    shipped SlamConfig) over the out-and-back: every frame tracked, ATE
    after finish < GENERAL_SLAM_ATE_M, at least one loop edge measured
    (`measure_edges` on the general branch: the DLT of stored ideal
    observations), the exact launches of _slam_launches_expected (on the
    card); loop events reported."""
    from stereo_orb_slam_torch.apps import slam

    _reset_launches()
    summary = slam.main([
        "--dataset", "EuRoc", "--folder", g["slam"], "--camera", g["camera"],
        "--output_dir", out_dir, "--gt", os.path.join(g["slam"], "gt.txt"),
        "--batch_frames", "1", "--device", device,
    ])
    launches = _read_launches()
    _sync(device)
    system = summary["system"]
    n, world = summary["frames"], system.world
    ids = np.arange(world.num_points, dtype=np.int32)
    expected, bow_batches, edges, edge_batches = _slam_launches_expected(system, n, 1)
    rec = {"frames": n, "tracked": world.num_frames, "live_fps": summary["live_fps"],
           "median_ms": summary["median_ms"], "finish_seconds": summary["finish_seconds"],
           "ate_m": summary["ate_m"], "live_ate_m": summary["live_ate_m"],
           "points": world.num_points,
           "merged_points": int((world.canonical(ids) != ids).sum()),
           "max_loop_probability": max(system.loop.probabilities, default=0.0),
           "closures": [{k: h[k] for k in ("live", "loop_edges_measured", "num_loop_edges")}
                        for h in system.pgo.history],
           "edges_measured": edges, "loop_edge_batches": edge_batches, "launches": launches,
           "launches_expected": {"hamming_top2": expected, "orb_describe": 2 * n,
                                 "orb_describe_oriented": 0, "extract_patches": 0,
                                 "triangulate_dlt": n + 2 * edge_batches}}
    log(f"general SLAM (--dataset EuRoc, K = 1): {n} frames, {world.num_frames} tracked, live "
        f"{rec['live_fps']:.2f} fps, finish {rec['finish_seconds']:.2f} s, ATE "
        f"{rec['ate_m']:.5f} m (live {rec['live_ate_m']:.5f}), max loop probability "
        f"{rec['max_loop_probability']:.4f}, closures {rec['closures']}, {edges} loop edges "
        f"measured in {edge_batches} batches, {rec['merged_points']} landmarks merged, "
        f"launches {launches}, expected "
        f"{rec['launches_expected']}")
    poses = world.pose_global[: world.num_frames]
    if not (np.isfinite(poses).all() and world.num_frames == n):
        raise AssertionError("general SLAM: poses are not finite, or frames were lost")
    if not rec["ate_m"] < GENERAL_SLAM_ATE_M:
        raise AssertionError(f"general SLAM: ATE {rec['ate_m']} m is not below "
                             f"{GENERAL_SLAM_ATE_M} m")
    if not edges >= 1:
        raise AssertionError("general SLAM: no loop edge was measured on the general rig")
    bow = system.fused_score_batches + system.loop.score_batches
    if bow != bow_batches:
        raise AssertionError(f"general SLAM: {bow} BoW scoring batches, the trajectory gives "
                             f"{bow_batches}")
    if _is_cuda(device) and launches != rec["launches_expected"]:
        raise AssertionError(f"general SLAM: launches {launches}, expected "
                             f"{rec['launches_expected']}")
    return rec


# ------------------------------------------------------------------ canyon
# The canyon drive (tests/synth_canyon.py: benchmarks/canyon_drive.py's
# scene and flags at 376x1241, 192 frames of one circuit of a 3 m square
# and its revisit). Its ATE gate rests on tests/canyon_witness.py, which
# runs the JAX package's SLAM CLI on the CPU over the same tree with the
# same flags: ATE 0.429 m (live 0.802 m), 5 loop episodes, no loop exit.
CANYON_JAX_ATE_M = 0.429
CANYON_SLAM_ATE_M = 1.5 * CANYON_JAX_ATE_M + 0.01
CANYON_DESC_FLIPS = 1e-4     # orb_describe's words, card against CPU (frame 1)
CANYON_VO_FRAMES = 60


def _render_canyon(root):
    """The canyon drive's KITTI tree, rendered by `tests/synth_canyon.py`
    (a pool of processes) in a child process that starts no device
    runtime. Returns the tree's folder, ground truth and path length."""
    import synth_canyon

    folder = os.path.join(root, "canyon")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "synth_canyon.py"),
                          "--out", folder], check=True, capture_output=True, text=True,
                         timeout=900)
    info = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"canyon tree: {info['frames']} frames at {synth_canyon.CANYON['h']}x"
        f"{synth_canyon.CANYON['w']}, path {info['path_m']:.3f} m, rendered in "
        f"{info['seconds']:.1f} s by {os.cpu_count()} processes")
    return {"folder": folder, "gt": info["gt"], "path_m": info["path_m"],
            "frames": info["frames"], "camera": os.path.join(folder, "calib.txt")}


def phase_canyon_slam(c, out_dir, device="cuda"):
    """The SLAM app on the card over the canyon tree with the canyon drive's
    flags (synth_canyon.CANYON_FLAGS: 1024 features, --batch_frames 32,
    --loop_query_size 8, --ransac_refit, --live_ba_iterations 20,
    --finish_seconds 150, --preload_device). Needs every frame tracked, the
    loop probability past is_loop_thresh, a live closure with loop edges
    measured for every loop exit in the trace, loop edges measured at
    finish, ATE after finish below CANYON_SLAM_ATE_M, and the exact
    launches of _slam_launches_expected (loop edges: one hamming_top2 per
    batch). The trajectory ends inside its revisit, so the filter does not
    leave the loop and the closure comes at finish: the JAX package's trace
    on the same tree has no exit either (tests/canyon_witness.py: the
    probability stays at or above 0.325 after its first entry, against
    not_loop_thresh 0.1). Records live fps, median ms per frame, each
    closure's stall and split, finish seconds, loop episodes (counted as
    the drive counts them) and exits, and the edges measured per closure."""
    import synth_canyon

    from stereo_orb_slam_torch.apps import slam

    _reset_launches()
    summary = slam.main(["--dataset", "kitti", "--folder", c["folder"], "--camera",
                         c["camera"], "--output_dir", out_dir, "--gt", c["gt"],
                         *synth_canyon.CANYON_FLAGS, "--device", device])
    launches = _read_launches()
    _sync(device)
    system = summary["system"]
    n, world = summary["frames"], system.world
    k = system.cfg.batch_frames
    expected, bow_batches, edges, edge_batches = _slam_launches_expected(system, n, k)
    thresh = system.cfg.loop.is_loop_thresh
    events = synth_canyon.loop_events(os.path.join(out_dir, "loop_matches.txt"), thresh,
                                      system.cfg.loop.not_loop_thresh)
    hist = system.pgo.history
    live = [h for h in hist if h["live"]]
    rec = {
        "frames": n, "tracked": world.num_frames, "batch_frames": k,
        "live_fps": summary["live_fps"], "fps": summary["fps"],
        "median_ms": summary["median_ms"], "finish_seconds": summary["finish_seconds"],
        "ate_m": summary["ate_m"], "live_ate_m": summary["live_ate_m"], "rpe": summary["rpe"],
        "ate_gate_m": CANYON_SLAM_ATE_M, "jax_witness_ate_m": CANYON_JAX_ATE_M,
        "path_m": c["path_m"], "loop_events": events, "live_closures": len(live),
        "closures": [{key: h[key] for key in ("live", "num_vertices", "loop_edges_measured",
                                               "num_loop_edges", "wall_split_seconds",
                                               "wall_seconds")} for h in hist],
        "live_stall_seconds": system.pgo.live_stall_log,
        "edges_per_closure": [h["loop_edges_measured"] for h in hist],
        "edges_measured": edges, "loop_edge_batches": edge_batches,
        "points": world.num_points, "timers": system.timers.summary(),
        "launches": launches,
        "launches_expected": {"hamming_top2": expected, "orb_describe": 2 * n,
                              "orb_describe_oriented": 0, "extract_patches": 0,
                              "triangulate_dlt": 0},
        "bow_batches": system.fused_score_batches + system.loop.score_batches,
    }
    log(f"canyon SLAM (--batch_frames {k}): {n} frames, {world.num_frames} tracked, live "
        f"{rec['live_fps']:.2f} fps, overall {rec['fps']:.2f} fps, median "
        f"{rec['median_ms']:.2f} ms/frame, finish {rec['finish_seconds']:.2f} s, ATE "
        f"{rec['ate_m']:.5f} m (live {rec['live_ate_m']:.5f}; gate {CANYON_SLAM_ATE_M:.4f}, "
        f"JAX on the CPU {CANYON_JAX_ATE_M}) over {c['path_m']:.3f} m, RPE {rec['rpe']}, "
        f"loop events {events}, {len(live)} live closures, {world.num_points} points")
    for h in rec["closures"]:
        log(f"  pose graph ({'live' if h['live'] else 'finish'}): {h['num_vertices']} "
            f"vertices, loop edges {h['num_loop_edges']} of {h['loop_edges_measured']} "
            f"measured, split {h['wall_split_seconds']} s, total {h['wall_seconds']} s")
    log(f"  launches {launches}, expected {rec['launches_expected']} ({rec['bow_batches']} "
        f"BoW batches, {edges} loop edges in {edge_batches} batches)")
    poses = world.pose_global[: world.num_frames]
    if not (np.isfinite(poses).all() and world.num_frames == n == c["frames"]):
        raise AssertionError("canyon SLAM: poses are not finite, or frames were lost")
    if not events["max_probability"] > thresh:
        raise AssertionError("canyon SLAM: the loop probability never passed is_loop_thresh")
    if len(live) != events["exits"] or any(h["loop_edges_measured"] < 1 for h in live):
        raise AssertionError(f"canyon SLAM: {len(live)} live closures for {events['exits']} "
                             f"loop exits, or one measured no loop edge")
    if not (hist and not hist[-1]["live"] and hist[-1]["num_loop_edges"] >= 1):
        raise AssertionError("canyon SLAM: no loop edge was measured at finish")
    if not rec["ate_m"] < CANYON_SLAM_ATE_M:
        raise AssertionError(f"canyon SLAM: ATE {rec['ate_m']} m is not below "
                             f"{CANYON_SLAM_ATE_M} m")
    if rec["bow_batches"] != bow_batches:
        raise AssertionError(f"canyon SLAM: {rec['bow_batches']} BoW scoring batches, the "
                             f"trajectory gives {bow_batches}")
    if _is_cuda(device) and launches != rec["launches_expected"]:
        raise AssertionError(f"canyon SLAM: launches {launches}, expected "
                             f"{rec['launches_expected']}")
    return rec


def phase_canyon_devices(c, frame=1, device="cuda", reference_device="cpu"):
    """Frames frame - 1 and frame of the canyon tree through `frontend_step`
    on the card and on the CPU (the drive's configs: 1024 features, the
    RANSAC refit; the same RANSAC sets): the counts and slot validity equal,
    orb_describe's words of every slot at most CANYON_DESC_FLIPS of the bits
    apart (this frame carries sensor noise), hamming_top2's temporal matches
    equal; the slot pixels, points and transform gaps recorded."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import _to_host, empty_slots, frontend_step
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.ops import orb

    fe, rc = FrontendConfig(), RansacConfig(final_model_fitting=True)
    pairs = datasets.load_dataset("kitti", c["folder"])[: frame + 1]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    out = {}
    for dev in (reference_device, device):
        rig = calib.load_camera(c["camera"], device=dev)
        prev, usable = empty_slots(fe.num_features, dev), False
        for j, (il, ir) in enumerate(imgs):
            res = frontend_step(torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev),
                                prev, torch.tensor(usable, device=dev),
                                _edge_sampler(j, rc.num_hypotheses), rig,
                                rig.max_sensible_distance(), fe, rc, rectified=True,
                                steer=orb.steer_table(fe.oriented, dev))
            prev, usable = res.slots, True
        out[dev] = _to_host(res)
    ref, got = out[reference_device], out[device]
    counts = {k: (int(getattr(ref, k)), int(getattr(got, k)))
              for k in ("num_stereo", "num_temporal", "num_inliers", "ransac_success")}
    valid = ref.slots.valid
    same_valid = bool(np.array_equal(valid, got.slots.valid))
    flips = int(np.unpackbits(np.bitwise_xor(ref.slots.desc, got.slots.desc)
                              .view(np.uint8)).sum())
    bits = ref.slots.desc.size * 32
    same_matches = bool(np.array_equal(ref.prev_idx, got.prev_idx)
                        and np.array_equal(ref.tracked, got.tracked))
    rec = {"frame": frame, "counts_cpu_card": counts, "valid_slots": int(valid.sum()),
           "same_slot_validity": same_valid, "desc_bits_differing": flips, "desc_bits": bits,
           "same_temporal_matches": same_matches,
           "px_max_diff": max(float(np.abs(ref.slots.kp_l - got.slots.kp_l).max()),
                              float(np.abs(ref.slots.kp_r - got.slots.kp_r)[valid].max())),
           "points_max_diff_m": float(np.abs(ref.slots.pts - got.slots.pts)[valid].max()),
           "transform_max_diff": float(np.abs(ref.transform - got.transform).max()),
           "bounds": {"desc_bits_share": CANYON_DESC_FLIPS}}
    log(f"canyon, card against CPU on frame {frame}: counts {counts}, {rec['valid_slots']} "
        f"valid slots (validity equal: {same_valid}), descriptors {flips} of {bits} bits "
        f"differ, temporal matches equal: {same_matches}, pixels {rec['px_max_diff']:.3g} px, "
        f"points {rec['points_max_diff_m']:.3g} m, transform {rec['transform_max_diff']:.3g}")
    if any(a != b for a, b in counts.values()) or not same_valid:
        raise AssertionError(f"canyon: the card and the CPU disagree on counts {counts} or "
                             f"slot validity")
    if flips > bits * CANYON_DESC_FLIPS or not same_matches:
        raise AssertionError(f"canyon: orb_describe's words differ in {flips} of {bits} bits, "
                             f"or the temporal matches differ ({same_matches})")
    return rec


def phase_canyon_vo(c, frames=CANYON_VO_FRAMES, device="cuda"):
    """The fractional-pixel measurement (ROADMAP queue 3): the canyon tree's
    first `frames` frames (sub-pixel motion, depth variation, sensor noise)
    through `VisualOdometer` on the card with the shipped RansacConfig()
    and with final_model_fitting=True; both ATEs, finite poses and exactly
    UPRIGHT_PER_FRAME launches per frame."""
    from stereo_orb_slam_torch.config import RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", c["folder"])[:frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    gt = evaluate.load_kitti_gt(c["gt"])
    rig = calib.load_camera(c["camera"], device=device)
    rec = {"frames": frames}
    for name, rc in (("shipped", RansacConfig()),
                     ("refit", RansacConfig(final_model_fitting=True))):
        world = WorldMap()
        vo = VisualOdometer(world, rig, rc=rc)
        _reset_launches()
        fails = 0
        for il, ir in imgs:
            vo.track(il, ir)
            fails += not vo.success
        launches = _read_launches()
        _sync(device)
        poses = world.pose_global[: world.num_frames]
        if not (np.isfinite(poses).all() and world.num_frames == frames):
            raise AssertionError(f"canyon VO ({name}): poses are not finite, or frames lost")
        if _is_cuda(device):
            _check_launches(f"canyon VO ({name})", launches, UPRIGHT_PER_FRAME, frames)
        t_rpe, r_rpe = evaluate.rpe(poses, gt[:frames])
        rec[name] = {"ate_m": evaluate.ate_rmse(poses, gt[:frames]), "rpe_m": t_rpe,
                     "rpe_rad": r_rpe, "ransac_failures": fails}
    log(f"canyon VO over {frames} frames (fractional-pixel motion, depth variation, noise "
        f"sigma 1): ATE shipped RansacConfig() {rec['shipped']['ate_m']:.5f} m, with "
        f"final_model_fitting {rec['refit']['ate_m']:.5f} m; RPE {rec['shipped']['rpe_m']:.5f}"
        f" / {rec['refit']['rpe_m']:.5f} m; failures {rec['shipped']['ransac_failures']} / "
        f"{rec['refit']['ransac_failures']}")
    return rec


# The canyon drive at its full length (benchmarks/canyon_drive.py's
# default --frames 1216: six circuits of 200 frames, A A B A B A, 1200
# frames), with live closures. The witness is tests/canyon_witness.py
# --frames 1216: the JAX package's SLAM CLI on the CPU over the same tree
# and flags, its finish not cut by the 150 s budget (PERF.md).
CANYON_LONG_FRAMES = 1216
CANYON_LONG_JAX_ATE_M = 1.348
CANYON_LONG_ATE_M = 1.5 * CANYON_LONG_JAX_ATE_M + 0.01
CANYON_LONG_JAX_EXIT_FRAMES = (257, 466)


def _start_canyon_long_render(root):
    """Start rendering the long drive's tree in the background: a child
    process running tests/synth_canyon.py with all but two of the CPUs, at
    the lowest priority, so the phases before the long drive keep the host.
    Returns (process, folder)."""
    folder = os.path.join(root, "canyon_long")
    workers = max(1, (os.cpu_count() or 4) - 2)
    proc = subprocess.Popen(
        ["nice", "-n", "19", sys.executable, os.path.join(ROOT, "tests", "synth_canyon.py"),
         "--out", folder, "--frames", str(CANYON_LONG_FRAMES), "--workers", str(workers)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    return proc, folder


def _stop(proc):
    """Kill a background process and its process group (the render's pool)."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _finish_canyon_long_render(proc, folder, timeout=900):
    """Wait for the background render; the tree's description as
    `_render_canyon` gives it."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"the long canyon render failed ({proc.returncode}): {err[-2000:]}")
    info = json.loads(out.strip().splitlines()[-1])
    log(f"long canyon tree: {info['frames']} frames, path {info['path_m']:.3f} m, rendered in "
        f"{info['seconds']:.1f} s in the background")
    return {"folder": folder, "gt": info["gt"], "path_m": info["path_m"],
            "frames": info["frames"], "camera": os.path.join(folder, "calib.txt"),
            "render_seconds": info["seconds"]}


@contextlib.contextmanager
def _recording_graphs():
    """While inside, every pose-graph solve of PoseGraphOptimizer appends
    its input problem and config to the yielded list (references: the
    solve reads its problem and does not change it)."""
    from stereo_orb_slam_torch.backend import pose_graph

    solve, graphs = pose_graph.pg_solve_program, []

    def recording(prob, cfg, cache=None):
        graphs.append((prob, cfg))
        return solve(prob, cfg, cache)

    pose_graph.pg_solve_program = recording
    try:
        yield graphs
    finally:
        pose_graph.pg_solve_program = solve


def _program_delta(before, after):
    """Each body's program-cache counters between two `stats` snapshots."""
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v} for k, v in after.items()}


def phase_canyon_long(c, out_dir, device="cuda"):
    """The SLAM app on the card over the long canyon tree with the drive's
    flags (those of phase 12). Needs every frame tracked, ATE after finish
    below CANYON_LONG_ATE_M (1.5 x the JAX witness's + 0.01 m), a live
    closure where the JAX trace has a loop exit, live closures equal to
    the loop exits of the port's own trace and each with a loop edge
    measured, loop edges at finish, the exact launches of
    _slam_launches_expected, the BoW batches the trajectory gives, and no
    program built again after an eviction during the drive (the loop-edge
    buckets captured once each). Records live fps, median ms a frame, the
    finish split into pose graph and final BA, loop episodes and exit
    frames beside the JAX trace's, each closure's stall split (pg_solve,
    the loop-edge batch with E and E_pad, the rest), points, the card's
    peak memory and the program cache's captures. Returns (record, system,
    the recorded pose graphs)."""
    import torch

    import synth_canyon

    from stereo_orb_slam_torch.apps import slam
    from stereo_orb_slam_torch.utils import programs

    cache = programs.PROGRAMS
    stats0, rebuilds0, builds0 = copy.deepcopy(cache.stats), cache.rebuilds, cache.builds
    if _is_cuda(device):
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _recording_graphs() as graphs:
        summary = slam.main(["--dataset", "kitti", "--folder", c["folder"], "--camera",
                             c["camera"], "--output_dir", out_dir, "--gt", c["gt"],
                             *synth_canyon.CANYON_FLAGS, "--device", device])
    launches = _read_launches()
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if _is_cuda(device) else None
    system = summary["system"]
    n, world = summary["frames"], system.world
    k = system.cfg.batch_frames
    expected, _, edges, edge_batches = _slam_launches_expected(system, n, k)
    # The trajectory's own count of BoW scoring batches: the fused batches
    # after the one the vocabulary trained in, and one per frame of the
    # remainder that runs frame by frame.
    vocab_batches = -(-SLAM_VOCAB_FRAMES // k)
    bow_expected = n // k - vocab_batches + n % k
    thresh = system.cfg.loop.is_loop_thresh
    events = synth_canyon.loop_events(os.path.join(out_dir, "loop_matches.txt"), thresh,
                                      system.cfg.loop.not_loop_thresh)
    hist = system.pgo.history
    live = [h for h in hist if h["live"]]
    timers = system.timers.summary()
    closures = []
    for h in hist:
        split = h["wall_split_seconds"]
        closures.append({
            "live": h["live"], "frame": h["num_vertices"], "edges": h["loop_edges_measured"],
            "edges_padded": h["loop_edges_padded"], "loop_edges": h["num_loop_edges"],
            "stall_s": h["wall_seconds"], "pg_solve_s": split["pg_solve_writeback"],
            "loop_edge_batch_s": split["loop_edge_batch"],
            "rest_s": h["wall_seconds"] - split["pg_solve_writeback"]
            - split["loop_edge_batch"]})
    programs_drive = _program_delta(stats0, cache.stats)
    edge_bodies = programs_drive.get("EdgeProgram.measure", {})
    buckets = sorted({h["loop_edges_padded"] for h in hist if h["loop_edges_measured"]})
    rec = {
        "frames": n, "tracked": world.num_frames, "batch_frames": k,
        "live_fps": summary["live_fps"], "fps": summary["fps"],
        "median_ms": summary["median_ms"], "finish_seconds": summary["finish_seconds"],
        "finish_split_s": {"pose_graph": timers["pose_graph.final"]["total_s"],
                           "final_ba": timers["ba.final"]["total_s"]},
        "finish_ba": {"pose_graph_ba": summary["finish"]["pose_graph"].get("global_ba"),
                      "final_ba": summary["finish"].get("final_ba")},
        "ate_m": summary["ate_m"], "live_ate_m": summary["live_ate_m"], "rpe": summary["rpe"],
        "ate_gate_m": CANYON_LONG_ATE_M, "jax_witness_ate_m": CANYON_LONG_JAX_ATE_M,
        "path_m": c["path_m"], "loop_events": events,
        "jax_exit_frames": list(CANYON_LONG_JAX_EXIT_FRAMES),
        "live_closures": len(live), "closures": closures,
        "edges_measured": edges, "loop_edge_batches": edge_batches, "buckets": buckets,
        "points": world.num_points, "peak_memory_bytes": peak,
        "programs": {"builds": cache.builds - builds0, "rebuilds": cache.rebuilds - rebuilds0,
                     "bodies": programs_drive},
        "pose_graphs": len(graphs), "timers": timers, "launches": launches,
        "launches_expected": {"hamming_top2": expected, "orb_describe": 2 * n,
                              "orb_describe_oriented": 0, "extract_patches": 0,
                              "triangulate_dlt": 0},
        "bow_batches": system.fused_score_batches + system.loop.score_batches,
        "bow_batches_expected": bow_expected,
    }
    log(f"long canyon SLAM (--batch_frames {k}): {n} frames, {world.num_frames} tracked, live "
        f"{rec['live_fps']:.2f} fps, overall {rec['fps']:.2f} fps, median "
        f"{rec['median_ms']:.2f} ms/frame, finish {rec['finish_seconds']:.2f} s (pose graph "
        f"{rec['finish_split_s']['pose_graph']:.2f}, final BA "
        f"{rec['finish_split_s']['final_ba']:.2f}), ATE {rec['ate_m']:.5f} m (live "
        f"{rec['live_ate_m']:.5f}; gate {CANYON_LONG_ATE_M:.4f}, JAX on the CPU "
        f"{CANYON_LONG_JAX_ATE_M}) over {c['path_m']:.3f} m, RPE {rec['rpe']}, loop events "
        f"{events} (JAX exits at {list(CANYON_LONG_JAX_EXIT_FRAMES)}), {len(live)} live "
        f"closures, {world.num_points} points, peak memory {peak} B")
    log(f"  finish BAs (iterations, observations, path, chunked): {rec['finish_ba']}")
    for h in closures:
        log(f"  {'live' if h['live'] else 'finish'} closure at frame {h['frame']}: stall "
            f"{h['stall_s']:.4f} s = pg_solve {h['pg_solve_s']:.4f} + loop-edge batch "
            f"{h['loop_edge_batch_s']:.4f} (E = {h['edges']}, E_pad = {h['edges_padded']}, "
            f"{h['loop_edges']} kept) + rest {h['rest_s']:.4f}")
    log(f"  launches {launches}, expected {rec['launches_expected']} ({rec['bow_batches']} BoW "
        f"batches, {edges} loop edges in {edge_batches} batches, buckets {buckets}); programs "
        f"built {rec['programs']['builds']}, rebuilt {rec['programs']['rebuilds']}; loop-edge "
        f"program {edge_bodies}")
    poses = world.pose_global[: world.num_frames]
    if not (np.isfinite(poses).all() and world.num_frames == n == c["frames"]):
        raise AssertionError("long canyon SLAM: poses are not finite, or frames were lost")
    if CANYON_LONG_JAX_EXIT_FRAMES and not live:
        raise AssertionError("long canyon SLAM: no live closure, where the JAX trace has "
                             f"loop exits at frames {CANYON_LONG_JAX_EXIT_FRAMES}")
    if len(live) != events["exits"] or any(h["loop_edges_measured"] < 1 for h in live):
        raise AssertionError(f"long canyon SLAM: {len(live)} live closures for "
                             f"{events['exits']} loop exits, or one measured no loop edge")
    if not (hist and not hist[-1]["live"] and hist[-1]["num_loop_edges"] >= 1):
        raise AssertionError("long canyon SLAM: no loop edge was measured at finish")
    if not rec["ate_m"] < CANYON_LONG_ATE_M:
        raise AssertionError(f"long canyon SLAM: ATE {rec['ate_m']} m is not below "
                             f"{CANYON_LONG_ATE_M} m")
    if rec["bow_batches"] != bow_expected:
        raise AssertionError(f"long canyon SLAM: {rec['bow_batches']} BoW scoring batches, "
                             f"the trajectory gives {bow_expected}")
    if _is_cuda(device) and launches != rec["launches_expected"]:
        raise AssertionError(f"long canyon SLAM: launches {launches}, expected "
                             f"{rec['launches_expected']}")
    if _is_cuda(device) and (rec["programs"]["rebuilds"]
                             or edge_bodies.get("captures") != len(buckets)):
        raise AssertionError(f"long canyon SLAM: {rec['programs']['rebuilds']} programs built "
                             f"again after eviction, or loop-edge captures {edge_bodies} for "
                             f"buckets {buckets}")
    return rec, system, graphs


def phase_canyon_long_ba(system, iterations=4, device="cuda"):
    """Where the finish's time goes: the final BA's problem over the drive's
    world (a copy, all frames but the last, as finish() solves it) built
    and uploaded (`BundleAdjuster.prepare`, host seconds), then, after a
    warm solve of one iteration, `iterations` LM iterations of it under
    torch.profiler, with a wall cap as the finish gives one (60 s, which
    takes the chunked path: a probe chunk, then chunks sized from the
    measured rate) and uncapped: wall and device ms per LM iteration, the
    device's idle share and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.backend.ba import BundleAdjuster

    world = copy.deepcopy(system.world)
    ba = BundleAdjuster(world, system.rig, system.cfg.ba)
    n = world.num_frames
    t0 = time.perf_counter()
    setup = ba.prepare(0, n - 1)
    rec = {"cameras": setup.num_cams, "points": setup.num_points,
           "observations": setup.num_obs, "padded": [setup.C_pad, setup.P_pad, setup.O_pad],
           "path": setup.path, "prepare_s": time.perf_counter() - t0}
    for name, cap in (("capped", 60.0), ("uncapped", None)):
        ba.optimize(0, n - 1, max_iterations=1, max_seconds=cap)   # captures, off the record
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats = ba.optimize(0, n - 1, max_iterations=iterations, max_seconds=cap)
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        its = max(stats["iterations"], 1)
        rec[name] = {"iterations": stats["iterations"], "chunked": stats["chunked"],
                     "wall_ms": wall_ms, "wall_ms_per_iteration": wall_ms / its,
                     "device_ms_per_iteration": device_ms / its,
                     "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
                     "top_kernels_ms_per_iteration": {
                         e.key[:80]: e.self_device_time_total / 1e3 / its for e in top}}
    log(f"long canyon final BA's problem: {rec['cameras']} cameras, {rec['points']} points, "
        f"{rec['observations']} observations (padded {rec['padded']}), path {rec['path']}; "
        f"prepare {rec['prepare_s']:.2f} s; "
        + "; ".join(f"{m}: {r['iterations']} LM iterations (chunked {r['chunked']}) in "
                    f"{r['wall_ms']:.1f} ms, {r['wall_ms_per_iteration']:.1f} ms wall and "
                    f"{r['device_ms_per_iteration']:.1f} ms device each (idle "
                    f"{r['idle_share']:.3f}), top kernels {r['top_kernels_ms_per_iteration']}"
                    for m, r in ((m, rec[m]) for m in ("capped", "uncapped"))))
    return rec


def _keyed_edge_samplers(num_hypotheses, device, plain=False):
    """sampler_for_edge giving the matcher's own default draws (seed 1234);
    with `plain`, each wrapped as a plain callable, which runs the eager
    body at the exact E."""
    import torch

    from stereo_orb_slam_torch.apps import slam
    from stereo_orb_slam_torch.frontend import ransac

    def sampler_for(i):
        gen = torch.Generator(device=device)
        gen.manual_seed(slam._edge_seed(1234, i))
        smp = ransac.gumbel_sampler(gen, num_hypotheses)
        return (lambda valid: smp(valid)) if plain else smp

    return sampler_for


def phase_canyon_long_edges(system, device="cuda", reps=4):
    """The loop-edge batch, captured against eager, on the drive's own edge
    lists: for each bucket the drive reached, its largest recorded batch,
    measured from a copy of the world after the run (the host mirrors,
    which the drive's last frames and its finish read) by the program
    (keyed samplers: one replay at E_pad) and by the eager body at the
    exact E (the same draws through plain callables), each on a fresh copy:
    flags, transforms, inlier counts and merges bit for bit; wall ms (a
    synced start to the readback and merges, median of reps - 1 after a
    warm call) and hamming_top2 launches (one each). Then the largest
    batch from device rings, and again after the rings were replaced by
    grown copies and the old storage scrambled (as SlamSystem grows them):
    bit for bit the eager batch both times. Returns (records, the largest
    batch's edges)."""
    import torch

    from stereo_orb_slam_torch.apps import slam
    from stereo_orb_slam_torch.frontend.odometer import empty_banks
    from stereo_orb_slam_torch.ops.kernels import hamming
    from stereo_orb_slam_torch.utils import programs

    system.sync_feature_banks()   # the host mirrors, current
    world, cfg, rig = system.world, system.cfg, system.rig
    K = cfg.ransac.num_hypotheses
    lists = {}
    for h in system.pgo.history:
        e = h["loop_edges"]
        if e and len(e) > len(lists.get(slam.edge_bucket(len(e)), [])):
            lists[slam.edge_bucket(len(e))] = e

    def measure(edges, plain, bank_getter=None, w=None):
        w = copy.deepcopy(world) if w is None else w
        m = slam.make_loop_matcher(w, rig, cfg, bank_getter=bank_getter,
                                   sampler_for_edge=_keyed_edge_samplers(K, device, plain))
        _sync(device)
        h0 = hamming.LAUNCHES
        t0 = time.perf_counter()
        res = m.batch(edges)
        _sync(device)
        return res, (time.perf_counter() - t0) * 1e3, hamming.LAUNCHES - h0, m, w

    def same(a, b):
        (ra, _, _, ma, wa), (rb, _, _, mb, wb) = a, b
        return (ma.last["ok"] == mb.last["ok"]
                and ma.last["num_inliers"] == mb.last["num_inliers"]
                and all(np.array_equal(za, zb) for (za, _), (zb, _) in zip(ra, rb))
                and np.array_equal(wa.point_parent, wb.point_parent))

    records = []
    for bucket, edges in sorted(lists.items()):
        runs = {}
        for name, plain in (("captured", False), ("eager", True)):
            first = measure(edges, plain)
            times = [measure(edges, plain)[1] for _ in range(reps)]
            runs[name] = (first, statistics.median(times[1:]))
        (cap, cap_ms), (eag, eag_ms) = runs["captured"], runs["eager"]
        r = {"edges": len(edges), "edges_padded": bucket, "ok": sum(cap[3].last["ok"]),
             "bits_equal": same(cap, eag), "captured_ms": cap_ms, "eager_ms": eag_ms,
             "hamming_launches": [cap[2], eag[2]]}
        records.append(r)
        log(f"loop-edge batch E = {r['edges']} (E_pad {bucket}, {r['ok']} measured): captured "
            f"{cap_ms:.2f} ms, eager {eag_ms:.2f} ms, bits equal {r['bits_equal']}, "
            f"hamming_top2 launches {r['hamming_launches']}")
        if (not r["bits_equal"] or not r["ok"]
                or (_is_cuda(device) and r["hamming_launches"] != [1, 1])):
            raise AssertionError(f"loop-edge program against eager: {r}")

    # Rings, then rings replaced by grown copies.
    edges = lists[max(lists)]
    nf, n = world.num_frames, cfg.frontend.num_features
    rings = empty_banks(nf, n, device)
    rings[0][:nf] = torch.from_numpy(world.frame_desc[:nf].view(np.int32)).to(device)
    rings[1][:nf] = torch.from_numpy(world.frame_feat_valid[:nf]).to(device)
    rings[2][:nf] = torch.from_numpy(world.frame_feat_uv[:nf]).to(device)
    current = [rings]
    eager = measure(edges, True)
    w = copy.deepcopy(world)
    before = measure(edges, False, lambda: current[0], w)
    grown = empty_banks(2 * nf, n, device)
    for new, old in zip(grown, rings):
        new[:nf + 1] = old
        old[:nf] = old[:nf].flip(0)
    current[0] = grown
    after = measure(edges, False, lambda: current[0], copy.deepcopy(world))
    rings_rec = {"edges": len(edges), "before_growth_equal": same(before, eager),
                 "after_growth_equal": same(after, eager)}
    # Where the captured batch's time goes: the keys drawn (one sampler per
    # edge), the banks gathered from the rings into the static inputs, the
    # replay, the readback (each synced; medians of reps).
    E, E_pad = len(edges), slam.edge_bucket(len(edges))
    prog = programs.PROGRAMS.get(
        slam.EdgeProgram.key(E_pad, n, rig, cfg.frontend, cfg.ransac),
        lambda: slam.EdgeProgram(E_pad, n, rig, cfg.frontend, cfg.ransac))
    src, dst = [s for s, _ in edges], [d for _, d in edges]
    split = {"keys": [], "load": [], "replay": [], "readback": []}
    for _ in range(reps):
        samplers = [_keyed_edge_samplers(K, device)(i) for i in range(E)]
        _sync(device)
        t0 = time.perf_counter()
        for smp in samplers:
            smp.keys(n, device)
        _sync(device)
        t1 = time.perf_counter()
        samplers = [_keyed_edge_samplers(K, device)(i) for i in range(E)]
        _sync(device)
        t2 = time.perf_counter()
        prog.load(src, dst, samplers, banks=grown)
        _sync(device)
        t3 = time.perf_counter()
        prog.run("measure", prog.measure)
        _sync(device)
        t4 = time.perf_counter()
        prog.outputs(E)
        t5 = time.perf_counter()
        for key, a, b in (("keys", t0, t1), ("load", t2, t3), ("replay", t3, t4),
                          ("readback", t4, t5)):
            split[key].append((b - a) * 1e3)
    rings_rec["split_ms"] = {k: statistics.median(v) for k, v in split.items()}
    rings_rec["split_ms"]["gather"] = rings_rec["split_ms"]["load"] - \
        rings_rec["split_ms"]["keys"]
    log(f"loop-edge program at E = {E} (E_pad {E_pad}), ms: {rings_rec['split_ms']} (load = "
        f"the keys drawn and copied + the banks gathered from the rings)")
    log(f"loop-edge program from device rings (E = {len(edges)}): equal to eager "
        f"{rings_rec['before_growth_equal']}, after the rings grew "
        f"{rings_rec['after_growth_equal']}")
    if not (rings_rec["before_growth_equal"] and rings_rec["after_growth_equal"]):
        raise AssertionError(f"loop-edge program from device rings: {rings_rec}")
    return {"buckets": records, "rings": rings_rec}, edges


def phase_canyon_long_cg(graphs, out_path=None, device="cuda"):
    """The CG iterations that run in each Gauss-Newton step of the drive's
    pose-graph solves (every live closure and the finish), counted by an
    eager solve on the card (`pose_graph.cg_iterations_run`, not the
    captured program); with `out_path`, the graphs and counts as an .npz
    for tests/pg_cg_witness.py (the port and the JAX package on the CPU)."""
    from stereo_orb_slam_torch.backend import pose_graph

    out, arrays = [], {}
    for g, (prob, cfg) in enumerate(graphs):
        t0 = time.perf_counter()
        _, counts = pose_graph.cg_iterations_run(prob, cfg)
        out.append({"vertices": int(prob.poses.shape[0]), "edges": int(prob.edge_a.shape[0]),
                    "cg_iterations_run": counts.tolist(),
                    "seconds": time.perf_counter() - t0})
        if out_path:
            arrays.update({f"g{g}_{f}": t.cpu().numpy() for f, t in prob._asdict().items()})
            arrays[f"g{g}_card"] = counts
    if out_path:
        np.savez_compressed(out_path, **arrays)
    cap = graphs[0][1].cg_iterations if graphs else 0
    below = sum(c < cap for r in out for c in r["cg_iterations_run"])
    total = sum(len(r["cg_iterations_run"]) for r in out)
    log(f"pose-graph CG iterations run per GN step (cap {cap}), {len(out)} solves: "
        + "; ".join(f"{r['vertices']} v: {r['cg_iterations_run']}" for r in out)
        + f"; {below} of {total} steps exit below the cap")
    return {"solves": out, "steps_below_cap": below, "steps": total, "cap": cap}


def phase_canyon_long_kernel(system, edges, device="cuda"):
    """hamming_top2 at the loop-edge batch's shape on the long drive: the
    largest batch's dst descriptors against its src banks, padded to the
    bucket as the program pads them (B = E_pad, one launch), against its
    plain version bit for bit and timed (record path "canyon_long")."""
    import torch

    from stereo_orb_slam_torch.apps import slam
    from stereo_orb_slam_torch.ops.kernels import hamming

    world = system.world
    E, E_pad = len(edges), slam.edge_bucket(len(edges))
    src = [s for s, _ in edges] + [edges[-1][0]] * (E_pad - E)
    dst = [d for _, d in edges] + [edges[-1][1]] * (E_pad - E)
    q = torch.from_numpy(world.frame_desc[dst].view(np.int32)).to(device)
    t = torch.from_numpy(world.frame_desc[src].view(np.int32)).to(device)
    v = torch.from_numpy(world.frame_feat_valid[src]).to(device)
    v[E:] = False
    got = hamming.hamming_top2(q, t, v)
    want = hamming.hamming_top2_plain(q, t, v)
    _sync(device)
    err = _check_equal("hamming_top2 (canyon_long loop edges)", got, want)
    ms = time_device(lambda: hamming.hamming_top2(q, t, v))
    call_ms = time_call(lambda: hamming.hamming_top2(q, t, v))
    plain_ms = time_device(lambda: hamming.hamming_top2_plain(q, t, v))
    n, m = q.shape[-2], t.shape[-2]
    bytes_ = E_pad * (n * 32 + m * 32 + m + n * 12)
    ops = E_pad * 2 * n * m * 256
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / INT8_TENSOR_OPS_PER_S * 1e3
    rec = _record(
        "hamming_top2 (canyon_long loop edges)", "stereo_orb_slam_torch/csrc/hamming_top2.cu",
        "stereo_orb_slam_tpu/ops/pallas/hamming.py:74", "canyon_long",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=None, match=True,
        call_ms=call_ms, shape=f"B={E_pad} ({E} edges) x N={n} against M={m} (the long "
                               f"drive's largest loop-edge batch, one launch)")
    log(f"kernel {rec['name']}: {rec['shape']}; match True, device {ms * 1e3:.2f} us (bound "
        f"{rec['bound_ms'] * 1e3:.3f} us by {rec['bound_by']}), per call "
        f"{call_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us")
    return [rec]


MAP_SIZE = dict(C=1000, P=100_000, opc=200)   # tests/test_f32_scale.py's generator
MAP_LM_ITERATIONS = 6
# Card against CPU on a BA problem (phase 6b), each bound between the
# readings of the sound runs and those of the control with TF32 left on
# where the control moves the quantity (PERF.md has the readings). H_cc of
# the first LM step, largest difference over largest entry, per problem:
BA_DEVICE_HESSIAN_RTOL = {"window": 1e-6, "reference": 1e-5}
# The solve's end: largest pose6 and point differences, relative cost.
BA_DEVICE_POSE6_ATOL = 1e-4
BA_DEVICE_POINTS_ATOL = 2.5e-3
BA_DEVICE_COST_RTOL = 1e-6
# Map problem (phase 6f): relative difference of the final cost (the
# devices' whole-array sums run in another order; TF32 does not reach this
# path).
BA_MAP_COST_RTOL = 5e-6


def _is_cuda(device):
    import torch

    return torch.device(device).type == "cuda"


def _sync(device):
    import torch

    if _is_cuda(device):
        torch.cuda.synchronize()


def _solve_record(kind, ms, stats):
    return {"kind": kind, "ms": ms, "iterations": stats["iterations"],
            "cams": stats["num_cams"], "points": stats["num_points"],
            "obs": stats["num_obs"], "path": stats["path"], "chunked": stats["chunked"],
            "cost_initial": stats["cost_initial"], "cost_final": stats["cost_final"]}


def _summarize_solves(solves):
    """Per solve kind: count, median wall ms, median LM iterations, median ms
    per LM iteration, sizes and paths."""
    out = {}
    for kind in sorted({s["kind"] for s in solves}):
        ss = [s for s in solves if s["kind"] == kind]
        out[kind] = {
            "solves": len(ss),
            "median_ms": statistics.median(s["ms"] for s in ss),
            "max_ms": max(s["ms"] for s in ss),
            "median_iterations": statistics.median(s["iterations"] for s in ss),
            "median_ms_per_iteration": statistics.median(
                s["ms"] / max(s["iterations"], 1) for s in ss),
            "cams": [min(s["cams"] for s in ss), max(s["cams"] for s in ss)],
            "points": [min(s["points"] for s in ss), max(s["points"] for s in ss)],
            "obs": [min(s["obs"] for s in ss), max(s["obs"] for s in ss)],
            "paths": sorted({s["path"] for s in ss}),
        }
    return out


def phase_ba_tracking(seq, gt, device="cuda", frames=N_FRAMES):
    """`VisualOdometer` + `BundleAdjuster(BAConfig())` over the rendered
    frames with the live loop's cadence. Needs finite poses, ATE < 0.01 m
    and exactly 1 hamming_top2 and 2 orb_describe launches per frame (on
    the card). Returns (world, summary, the last window's world before its
    solve with its frame range)."""
    import copy

    from stereo_orb_slam_torch.backend.ba import BundleAdjuster
    from stereo_orb_slam_torch.config import BAConfig, SlamConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", seq)[:frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    rig = calib.load_camera(os.path.join(seq, "calib.txt"), device=device)
    world = WorldMap()
    vo = VisualOdometer(world, rig)
    adj = BundleAdjuster(world, rig, BAConfig())
    # SlamSystem.process's cadence: optimize(n-1, n) after each tracked
    # frame, optimize(max(0, n - 2 * refine_interval), n) every
    # refine_interval frames.
    slam_cfg = SlamConfig()
    refine = slam_cfg.refine_interval
    solves, last_window = [], None

    def solve(kind, start, end):
        t0 = time.perf_counter()
        stats = adj.optimize(start, end)
        _sync(device)
        if stats:
            solves.append(_solve_record(kind, (time.perf_counter() - t0) * 1e3, stats))

    _reset_launches()
    t_start = time.perf_counter()
    for il, ir in imgs:
        vo.track(il, ir)
        n = world.num_frames
        if n > 0 and vo.success:
            if slam_cfg.per_frame_ba:
                solve("per_frame", n - 1, n)
            if n % refine == 0:
                start = max(0, n - 2 * refine)
                last_window = (copy.deepcopy(world), start, n)
                solve("window", start, n)
    _sync(device)
    total_s = time.perf_counter() - t_start
    launches = _read_launches()
    n = world.num_frames
    poses = world.pose_global[:n]
    if not (np.isfinite(poses).all() and n == frames):
        raise AssertionError("tracking with BA: poses are not finite, or frames were lost")
    ate = evaluate.ate_rmse(poses, evaluate.load_kitti_gt(gt)[:n])
    summary = {"frames": n, "ms_per_frame": total_s * 1e3 / n, "ate_m": ate,
               "points": world.num_points, "obs": world.num_obs,
               "solves": _summarize_solves(solves), "launches": launches}
    log(f"tracking with BA: {n} frames, {summary['ms_per_frame']:.1f} ms/frame with BA, "
        f"ATE {ate:.5f} m, {world.num_points} points, {world.num_obs} observations, "
        f"launches per frame {({k: v / n for k, v in launches.items()})}")
    for kind, s in summary["solves"].items():
        log(f"  {kind} BA: {s['solves']} solves, median {s['median_ms']:.2f} ms "
            f"(max {s['max_ms']:.2f}), median {s['median_iterations']} LM iterations, "
            f"{s['median_ms_per_iteration']:.3f} ms per iteration, cams {s['cams']}, "
            f"points {s['points']}, obs {s['obs']}, path {s['paths']}")
    if not ate < 0.01:
        raise AssertionError(f"tracking with BA: ATE {ate} m is not below 0.01 m")
    if _is_cuda(device):
        _check_launches("tracking with BA", launches,
                        UPRIGHT_PER_FRAME, n)
    return world, summary, last_window


@contextlib.contextmanager
def _tf32_left_on():
    """The control for the card-against-CPU bounds: TF32 on for float32
    matrix products, and the solver's own switch (`ba.full_f32`, which sets
    the precision to "highest" around every entry point) made a no-op, so
    the solve runs as it would if the solver did not turn TF32 off."""
    import torch

    setter = torch.set_float32_matmul_precision
    before = torch.get_float32_matmul_precision()
    setter("high")
    torch.set_float32_matmul_precision = lambda precision: None
    try:
        yield
    finally:
        torch.set_float32_matmul_precision = setter
        setter(before)


def _gaps(got, ref):
    """Card against CPU: per quantity of the first step, the largest
    difference over the CPU's largest magnitude; of the solve's end state,
    the largest pose6 and point differences and the relative cost
    difference."""
    (step_g, (cg, _)), (step_r, (cr, _)) = got, ref
    out = {k: float((step_g[k].cpu() - step_r[k]).abs().max() / step_r[k].abs().max())
           for k in ("H_cc", "b_c", "step")}
    out.update(pose6=float((cg.prob.pose6.cpu() - cr.prob.pose6).abs().max()),
               points=float((cg.prob.points.cpu() - cr.prob.points).abs().max()),
               cost_rel=abs(float(cg.cost) - float(cr.cost)) / abs(float(cr.cost)))
    return out


def phase_ba_devices(seq, window, device="cuda", reference_device="cpu"):
    """The card against the port's CPU path on the same problems: the last
    window of the tracking run (`BAConfig()`, 50 LM iterations, its own
    path), and the reference's banded problem (64 cameras, 8,192 points;
    tests/test_torch_ba_oracles.py's card tests) for 4 LM iterations on
    each of the banded, dense and matrix-free paths.

    Two checks per problem. The first LM step: H_cc (relative to the CPU's
    largest entry) within BA_DEVICE_HESSIAN_RTOL, where TF32 rounding of
    the one-hot reduction shows; b_c and the proposed step are printed
    only (b_c nearly cancels at the window's start, near its minimum, and
    the reference problem's reduced system is ill-conditioned enough to
    turn H_cc's float32 differences into 1e-2 of the step). The solve's
    end: the CPU's iteration count, pose6, points and cost within
    BA_DEVICE_POSE6_ATOL, BA_DEVICE_POINTS_ATOL and BA_DEVICE_COST_RTOL.
    The card's solve is run twice and must repeat bit for bit (no
    reduction on the path adds in a varying order), so each reading holds
    from run to run. Each problem is also run on the card with TF32 left
    on (`_tf32_left_on`), the control: on the paths with cuBLAS products
    (dense, banded) its H_cc must break the bound, or the check has lost
    its power."""
    import torch

    from stereo_orb_slam_torch.backend import ba
    from stereo_orb_slam_torch.config import BAConfig
    from stereo_orb_slam_torch.io import calib
    from synth_ba import banded_problem, first_step

    world, start, end = window
    cfg = BAConfig()

    def window_problem(dev):
        adj = ba.BundleAdjuster(world, calib.load_camera(os.path.join(seq, "calib.txt"),
                                                         device=dev), cfg)
        setup = adj.prepare(start, end)
        return setup.prob, cfg, cfg.max_iterations, setup.solve_kwargs()

    def reference_problem(path):
        def make(dev):
            prob, _, (bases, B, Pc) = banded_problem(np.random.default_rng(0), device=dev)
            if path == "matrix-free":
                return prob, BAConfig(cg_iterations=50), 4, {}
            band = dict(band_bases=bases, band_B=B, band_Pc=Pc) if path == "banded" else {}
            return prob, cfg, 4, dict(dense_K=8, **band)
        return make

    def run(make, dev):
        prob, c, iters, kw = make(dev)
        step = first_step(prob, c, **kw)
        carry, n_it, _ = ba.ba_solve(prob, iters, c, **kw)
        return step, (carry, int(n_it))

    adj = ba.BundleAdjuster(world, calib.load_camera(os.path.join(seq, "calib.txt"),
                                                     device=reference_device), cfg)
    cases = {f"window [{start}, {end}) ({adj.prepare(start, end).path}, 50 iterations)":
             window_problem}
    cases.update({f"reference problem ({path}, 4 iterations)": reference_problem(path)
                  for path in ("banded", "dense", "matrix-free")})
    out = {}
    for name, make in cases.items():
        ref = run(make, reference_device)
        t0 = time.perf_counter()
        card = run(make, device)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        again = run(make, device)[1][0].prob
        repeats = all(torch.equal(a, b) for a, b in zip(
            (card[1][0].prob.pose6, card[1][0].prob.points), (again.pose6, again.points)))
        with _tf32_left_on():
            tf32 = run(make, device)
        sound, control = _gaps(card, ref), _gaps(tf32, ref)
        its = [card[1][1], ref[1][1], tf32[1][1]]
        out[name] = {"iterations": its, "gaps": sound, "gaps_tf32_on": control,
                     "repeats": repeats, "ms_first_step_and_solve": ms}
        for label, g in (("sound", sound), ("TF32 left on", control)):
            log(f"BA cuda vs cpu, {name}, {label}: first step H_cc {g['H_cc']:.3g}, b_c "
                f"{g['b_c']:.3g}, step {g['step']:.3g} (relative); end pose6 "
                f"{g['pose6']:.3g}, points {g['points']:.3g}, cost rel {g['cost_rel']:.3g}")
        log(f"  iterations card / cpu / card with TF32 {its}, {ms:.1f} ms on the card, "
            f"second card solve identical: {repeats}")
        h_rtol = BA_DEVICE_HESSIAN_RTOL[name.split()[0]]
        if not repeats:
            raise AssertionError(f"BA cuda vs cpu, {name}: two solves on the card differ")
        if not (its[0] == its[1] and sound["H_cc"] <= h_rtol
                and sound["pose6"] <= BA_DEVICE_POSE6_ATOL
                and sound["points"] <= BA_DEVICE_POINTS_ATOL
                and sound["cost_rel"] <= BA_DEVICE_COST_RTOL):
            raise AssertionError(f"BA cuda vs cpu, {name}: the devices differ beyond the "
                                 f"bounds (H_cc {h_rtol}, pose6 {BA_DEVICE_POSE6_ATOL}, "
                                 f"points {BA_DEVICE_POINTS_ATOL}, cost "
                                 f"{BA_DEVICE_COST_RTOL}): iterations {its[:2]}, {sound}")
        if _is_cuda(device) and "matrix-free" not in name and not control["H_cc"] > h_rtol:
            raise AssertionError(f"BA cuda vs cpu, {name}: with TF32 left on, H_cc stays "
                                 f"within {h_rtol}, so the bound would not catch it")
    return out


def phase_ba_refine(seq, gt, world, out_dir, device="cuda", iterations=50):
    """The refine app over a dump of the tracked world: final cost at most
    the initial, ATE < 0.01 m."""
    from stereo_orb_slam_torch.apps import refine
    from stereo_orb_slam_torch.io import export
    from stereo_orb_slam_torch.utils import evaluate

    dump = os.path.join(out_dir, "dump")
    export.dump_world(dump, world)
    t0 = time.perf_counter()
    stats = refine.main(["--input_dir", dump, "--camera", os.path.join(seq, "calib.txt"),
                         "--output_dir", os.path.join(out_dir, "refined"),
                         "--iterations", str(iterations), "--device", device])
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    refined = stats.pop("world")
    n = refined.num_frames
    ate = evaluate.ate_rmse(refined.pose_global[:n], evaluate.load_kitti_gt(gt)[:n])
    rec = dict(_solve_record("global_refine", ms, stats), ate_m=ate)
    log(f"refine app: {n} frames, {stats['num_points']} points, {stats['num_obs']} obs, "
        f"{stats['path']}, {stats['iterations']} iterations, cost {stats['cost_initial']:.6g} "
        f"-> {stats['cost_final']:.6g}, {ms:.1f} ms (restore + solve + dump), ATE {ate:.5f} m")
    if not (stats["cost_final"] <= stats["cost_initial"] and ate < 0.01):
        raise AssertionError("refine app: the cost rose or the ATE is not below 0.01 m")
    return rec


def phase_ba_recovery(seq, gt, world, device="cuda", seed=1):
    """Global BA from a perturbed copy of the tracked world: 2 cm and 0.2
    degrees (per-axis sigma) on every pose but the first, 5 cm on every
    point. Needs the cost below 1e-2 of its initial value and ATE < 0.01 m."""
    import copy

    from scipy.spatial.transform import Rotation

    from stereo_orb_slam_torch.backend.ba import BundleAdjuster
    from stereo_orb_slam_torch.config import BAConfig
    from stereo_orb_slam_torch.io import calib
    from stereo_orb_slam_torch.utils import evaluate

    rng = np.random.default_rng(seed)
    world = copy.deepcopy(world)
    n = world.num_frames
    for i in range(1, n):
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = Rotation.from_rotvec(rng.normal(0, np.deg2rad(0.2), 3)).as_matrix()
        d[:3, 3] = rng.normal(0, 0.02, 3)
        world.pose_global[i] = world.pose_global[i] @ d
    world.points[: world.num_points] += rng.normal(0, 0.05, (world.num_points, 3)).astype(
        np.float32)
    gt_poses = evaluate.load_kitti_gt(gt)[:n]
    ate0 = evaluate.ate_rmse(world.pose_global[:n], gt_poses)
    adj = BundleAdjuster(world, calib.load_camera(os.path.join(seq, "calib.txt"), device=device),
                         BAConfig())
    t0 = time.perf_counter()
    stats = adj.optimize(0, n)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    ate = evaluate.ate_rmse(world.pose_global[:n], gt_poses)
    ratio = stats["cost_final"] / stats["cost_initial"]
    rec = dict(_solve_record("global_recovery", ms, stats), ate_m=ate, ate_before_m=ate0,
               cost_ratio=ratio)
    log(f"recovery: {n} frames, {stats['path']}, {stats['iterations']} iterations, cost "
        f"{stats['cost_initial']:.6g} -> {stats['cost_final']:.6g} (ratio {ratio:.3g}), "
        f"ATE {ate0:.5f} -> {ate:.5f} m, {ms:.1f} ms")
    if not (np.isfinite(world.pose_global[:n]).all() and ratio < 1e-2 and ate < 0.01):
        raise AssertionError("recovery: the cost did not fall below 1e-2 of its initial "
                             "value, or the ATE is not below 0.01 m")
    return rec


def make_map_problem(device, C, P, opc, seed=0):
    """tests/test_f32_scale.py's global-BA generator: C cameras with opc
    observations each of P points (uniform), KITTI intrinsics, 0.5 px
    noise, poses perturbed by 0.003, point-sorted. Unpadded."""
    import torch

    from stereo_orb_slam_torch.backend.ba import BAProblem

    rng = np.random.default_rng(seed)
    fx, cx, cy, b = 718.856, 607.1928, 185.2157, 0.5371657
    P_l = np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0]], np.float32)
    P_r = P_l.copy()
    P_r[0, 3] = -fx * b
    O = C * opc
    pts = np.stack([rng.uniform(-20, 20, P), rng.uniform(-5, 5, P),
                    rng.uniform(5, 60, P)], 1).astype(np.float32)
    pose6 = rng.normal(0, 0.003, (C, 6)).astype(np.float32)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), opc)
    obs_point = rng.integers(0, P, O).astype(np.int32)
    order = np.argsort(obs_point, kind="stable")
    obs_point, obs_cam = obs_point[order], obs_cam[order]
    X = pts[obs_point]
    Xh = np.concatenate([X, np.ones((O, 1), np.float32)], 1)
    obs_uv = np.concatenate([(Xh @ Pm.T)[:, :2] / np.maximum((Xh @ Pm.T)[:, 2:3], 1e-6)
                             for Pm in (P_l, P_r)], 1).astype(np.float32)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape).astype(np.float32)
    cam_mask = np.r_[0.0, np.ones(C - 1)].astype(np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BAProblem(t(pose6), t(pts), t(obs_cam, torch.long), t(obs_point, torch.long),
                     t(obs_uv), torch.ones(O, device=device), t(cam_mask),
                     torch.ones(P, device=device), t(P_l), t(P_r))


def _map_solve(device, size, iters):
    """lm_init + `iters` LM iterations of the matrix-free path on the map
    problem. Returns (carry, iterations, cost0, init_ms, ms_per_iteration)."""
    from stereo_orb_slam_torch.backend import ba
    from stereo_orb_slam_torch.config import BAConfig

    cfg = BAConfig(cg_iterations=40, function_tolerance=0.0)
    prob = make_map_problem(device, **size)
    _sync(device)
    t0 = time.perf_counter()
    plan = ba._cam_reduction(prob, None, None)
    carry = ba.lm_init(prob, cfg, cam_red=plan)
    cost0 = float(carry.cost)
    t1 = time.perf_counter()
    carry, n_it, _ = ba.ba_resume(carry, iters, cfg, cam_red=plan)
    _sync(device)
    t2 = time.perf_counter()
    n_it = int(n_it)
    return carry, n_it, cost0, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(n_it, 1)


def phase_ba_map(device="cuda", reference_device="cpu", size=MAP_SIZE,
                 iters=MAP_LM_ITERATIONS):
    """The matrix-free path at map size (C = 1000 cameras, P = 100,000
    points, 200,000 observations; the unpadded C is above the 512-camera
    dense gate): ms per LM iteration and peak device memory on `device`,
    the final cost held against the port's CPU path within
    BA_MAP_COST_RTOL (the devices' whole-array sums run in another order),
    and the same
    again with TF32 left on (the control; this path has no cuBLAS product).
    Needs a falling, finite cost."""
    import torch

    base = None
    if _is_cuda(device):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()   # what the cached programs hold
        torch.cuda.reset_peak_memory_stats()
    carry, n_it, cost0, init_ms, ms_it = _map_solve(device, size, iters)
    peak = torch.cuda.max_memory_allocated() if _is_cuda(device) else None
    cost = float(carry.cost)
    finite = all(bool(torch.isfinite(x).all()) for x in (carry.prob.pose6, carry.prob.points))
    ref, n_ref, cost0_ref, _, ms_ref = _map_solve(reference_device, size, iters)
    cost_ref = float(ref.cost)
    rel = abs(cost - cost_ref) / cost_ref
    with _tf32_left_on():
        tf32 = _map_solve(device, size, iters)[0]
    rel_tf32 = abs(float(tf32.cost) - cost_ref) / cost_ref
    if _is_cuda(device):
        mem = _program_memory()
        log(f"map BA: before it, the program cache held {len(mem['static_bytes'])} programs "
            f"with {sum(b for _, b in mem['static_bytes']) / 2**20:.1f} MiB of static tensors "
            f"(largest {[(n, round(b / 2**20, 1)) for n, b in mem['static_bytes'][:4]]} MiB); "
            f"allocated {mem['allocated'] / 2**20:.1f} MiB, reserved "
            f"{mem['reserved'] / 2**20:.1f} MiB after the solve")
    rec = {"C": size["C"], "P": size["P"], "O": size["C"] * size["opc"], "iterations": n_it,
           "cost_initial": cost0, "cost_final": cost, "cost_final_reference": cost_ref,
           "cost_rel_diff": rel, "cost_rel_diff_tf32_on": rel_tf32, "init_ms": init_ms,
           "ms_per_iteration": ms_it, "reference_ms_per_iteration": ms_ref,
           "peak_bytes": peak, "allocated_before_bytes": base, "path": "matrix-free"}
    log(f"map BA ({size['C']} cams, {size['P']} points, {size['C'] * size['opc']} obs, "
        f"matrix-free, cg 40): {n_it} LM iterations, cost {cost0:.6g} -> {cost:.6g}, "
        f"{ms_it:.2f} ms per LM iteration (init {init_ms:.2f} ms), peak "
        f"{(peak or 0) / 2**20:.1f} MiB ({(base or 0) / 2**20:.1f} MiB allocated before); "
        f"{reference_device}: cost {cost_ref:.6g} "
        f"(rel diff {rel:.3g}; with TF32 left on {rel_tf32:.3g}), {ms_ref:.1f} ms per "
        f"LM iteration")
    if not (finite and cost < cost0 and n_it == iters == n_ref and rel <= BA_MAP_COST_RTOL):
        raise AssertionError("map BA: the cost did not fall, a value is not finite, or the "
                             f"devices disagree beyond rtol {BA_MAP_COST_RTOL}")
    return rec


def phase_ba_banded(device="cuda", iters=5, **size):
    """The banded and the dense Schur assembly on the reference's banded
    problem (64 cameras, 8192 points), `iters` LM iterations each: ms per LM
    iteration of both, and pose6 within 5e-5 of each other (the two sum in
    another order; tests/test_torch_ba_oracles.py states the bound)."""
    from stereo_orb_slam_torch.backend import ba
    from stereo_orb_slam_torch.config import BAConfig
    from synth_ba import banded_problem

    prob, slots, (bases, B, Pc) = banded_problem(np.random.default_rng(0), device=device,
                                                 **size)
    cfg = dataclasses.replace(BAConfig(), function_tolerance=0.0)
    out = {}
    for path, kw in (("dense", {}), ("banded", dict(band_bases=bases, band_B=B, band_Pc=Pc))):
        for _ in range(2):  # the second solve is timed, warm
            _sync(device)
            t0 = time.perf_counter()
            carry, n_it, _ = ba.ba_solve(prob, iters, cfg, dense_slots=slots, **kw)
            _sync(device)
        n_it = int(n_it)
        out[path] = (carry, n_it, (time.perf_counter() - t0) * 1e3 / (n_it + 1))
    (cd, itd, ms_d), (cb, itb, ms_b) = out["dense"], out["banded"]
    err = float((cd.prob.pose6 - cb.prob.pose6).abs().max())
    rec = {"C": prob.pose6.shape[0], "P": prob.points.shape[0], "O": prob.obs_cam.shape[0],
           "band_B": B, "band_chunks": len(bases), "iterations": [itd, itb],
           "dense_ms_per_iteration": ms_d, "banded_ms_per_iteration": ms_b,
           "pose6_max_diff": err,
           "cost": [float(cd.cost), float(cb.cost)]}
    log(f"banded vs dense ({rec['C']} cams, {rec['P']} points, {rec['O']} obs, band "
        f"{B} in {len(bases)} chunks): {rec['dense_ms_per_iteration']:.2f} / "
        f"{rec['banded_ms_per_iteration']:.2f} ms per LM iteration (second runs, init "
        f"counted as one), pose6 max diff {err:.3g}, cost {rec['cost'][0]:.6g} / "
        f"{rec['cost'][1]:.6g}")
    if itd != itb or not err <= 5e-5:
        raise AssertionError("banded and dense Schur solves disagree beyond 5e-5")
    return rec


def _device_summary(prof, wall_ms, per, unit="lm_iteration"):
    import torch

    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            f"device_launches_per_{unit}": sum(e.count for e in kernels) / per,
            "kernels": [{"name": e.key[:120], f"count_per_{unit}": e.count / per,
                         f"device_us_per_{unit}": e.self_device_time_total / per}
                        for e in top]}


def _syncs_per_call(fn):
    """(result, device syncs counted by torch's sync debug mode in fn())."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_ba_profile(seq, window, path, iters=3):
    """torch.profiler over `iters` LM iterations of the last window problem
    (its own path) and of the map problem (matrix-free), after one warm
    iteration each; device syncs per LM iteration counted separately."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.backend import ba
    from stereo_orb_slam_torch.config import BAConfig
    from stereo_orb_slam_torch.io import calib

    world, start, end = window
    adj = ba.BundleAdjuster(world, calib.load_camera(os.path.join(seq, "calib.txt")),
                            BAConfig())
    setup = adj.prepare(start, end)
    kw = setup.solve_kwargs()
    slots = None if kw["dense_K"] is None else ba.build_slots_device(
        setup.prob.obs_point, setup.prob.obs_cam, setup.prob.obs_weight, setup.P_pad,
        kw["dense_K"])
    cam_red = ba._cam_reduction(setup.prob, slots, kw["cam_K"])
    band = {k: kw[k] for k in ("band_bases", "band_B", "band_Pc")}
    map_prob = make_map_problem("cuda", **MAP_SIZE)
    map_cfg = BAConfig(cg_iterations=40, function_tolerance=0.0)
    map_plan = ba._cam_reduction(map_prob, None, None)
    cases = {
        f"window ({setup.path}, C={setup.num_cams}, P={setup.num_points}, "
        f"O={setup.num_obs})": (ba.lm_init(setup.prob, adj.cfg, slots, cam_red), adj.cfg,
                                dict(dense_slots=slots, cam_red=cam_red, **band)),
        "map (matrix-free, C=1000, P=100000, O=200000, cg 40)": (
            ba.lm_init(map_prob, map_cfg, cam_red=map_plan), map_cfg, dict(cam_red=map_plan)),
    }
    report = {}
    for name, (carry, cfg, kwargs) in cases.items():
        cfg = dataclasses.replace(cfg, function_tolerance=0.0)  # run every iteration
        carry, _, _ = ba.ba_resume(carry, 1, cfg, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, n_it, _ = ba.ba_resume(carry, iters, cfg, **kwargs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        n_it = int(n_it)
        rep = _device_summary(prof, wall_ms, n_it)
        (_, _, _), syncs = _syncs_per_call(lambda: ba.ba_resume(carry, iters, cfg, **kwargs))
        rep["device_syncs_per_lm_iteration"] = syncs / iters
        rep["wall_ms_per_lm_iteration"] = wall_ms / n_it
        report[name] = rep
        top = ", ".join(f"{k['name'][:48]} {k['device_us_per_lm_iteration']:.1f} us"
                        for k in rep["kernels"][:6])
        log(f"BA profile, {name}: {rep['wall_ms_per_lm_iteration']:.2f} ms wall per LM "
            f"iteration, device busy {rep['device_busy_ms'] / n_it:.3f} ms (idle share "
            f"{rep['device_idle_share']:.3f}), {rep['device_launches_per_lm_iteration']:.0f} "
            f"launches and {rep['device_syncs_per_lm_iteration']:.1f} syncs per LM iteration; "
            f"top: {top}")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    log(f"BA profile breakdown in {path}")


def phase_profile(seq, path, frames=20, warm=5, dataset="kitti", camera=None):
    """Where a frame's time goes: `frames` track() calls on the card under
    torch.profiler, after `warm` calls off the record, on the KITTI
    sequence `seq` (or another dataset's folder with its camera file).
    Writes the breakdown to `path` as JSON and prints a summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset(dataset, seq)[: warm + frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    vo = VisualOdometer(WorldMap(), calib.load_camera(camera or os.path.join(seq, "calib.txt")))
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
    log(f"profile ({dataset}): {report['wall_ms_per_frame']:.2f} ms/frame wall, device busy "
        f"{report['device_busy_ms_per_frame']:.3f} ms/frame (idle share "
        f"{report['device_idle_share']:.3f}), {report['device_launches_per_frame']:.0f} "
        f"device launches/frame; top: "
        + ", ".join(f"{k['name'][:40]} {k['device_us_per_frame']:.1f} us"
                    for k in report["kernels"][:6]) + f"; breakdown in {path}")


# The SLAM phase's trajectory, in whole 14 px steps of x (see
# _render_sequence): 64 frames out, 64 back over the outgoing views (the
# same images; id gaps pass LoopConfig.distant_frame_thresh = 50 from about
# frame 89, and about 8 matched frames lift the loop probability from 0.005
# past 0.9), 16 frames past the start (new views: about 9 misses take it
# below 0.1, and that exit runs the live closure), 16 back to the start and
# 12 out again over the first views (a second entry, whose edges the
# pose graph measures at finish()).
SLAM_STEPS = (list(range(64)) + list(range(63, -1, -1)) + list(range(-1, -17, -1))
              + list(range(-15, 1)) + list(range(1, 13)))
SLAM_VOCAB_FRAMES = 12     # SlamSystem's default vocab_train_frames
# Card against CPU in the SLAM phase, each set between the sound readings
# and the TF32-on control where the control moves the quantity (PERF.md):
SLAM_EDGE_Z_ATOL = 1e-4            # loop-edge transforms
SLAM_SCORE_ATOL = 1e-6             # BoW scores (no matrix product: min + sum)
# pg_solve on the final graph perturbed (see phase_slam_devices): rotation,
# translation (m) after 1 and after 10 GN steps. The solve returns to the
# consistent graph, so after 10 steps the two devices agree almost exactly.
SLAM_PG_ONE_STEP = (2e-6, 3e-5)
SLAM_PG_SOLVE = (1e-6, 1e-6)


def _slam_launches_expected(system, frames, k):
    """hamming_top2 launches of a SLAM run from what the run did: one per
    frame (the front end's stereo + temporal pair), one per BoW scoring
    batch (fused into the chain, or LoopDetector.process_batch), the
    vocabulary's iterations + 1 assignments and one per frame backfilled
    into the database (the frames recorded when it trained: the first
    batches that hold SLAM_VOCAB_FRAMES), and one per loop-edge batch the
    matcher measured (all edges of a closure in one launch). Returns
    (expected, the independent count of BoW batches from the trajectory
    alone, loop edges measured, loop-edge batches), for `frames` a multiple
    of `k`."""
    cfg = system.cfg.loop
    edges = sum(h["loop_edges_measured"] for h in system.pgo.history)
    edge_batches = system.pgo.loop_matcher.batches
    bow = system.fused_score_batches + system.loop.score_batches
    vocab_batches = -(-SLAM_VOCAB_FRAMES // k)
    vocab = cfg.vocab_iterations + 1 + vocab_batches * k
    expected = frames + bow + vocab + edge_batches
    return expected, -(-frames // k) - vocab_batches, edges, edge_batches


def phase_slam(seq, gt, out_dir, batch_frames):
    """The SLAM app (`stereo_orb_slam_torch.apps.slam.main`) on the card at
    full width: the loop sequence at 376x1241, 1024 features, a 1024-word
    vocabulary trained at frame 12, the shipped SlamConfig. Needs the loop
    probability past is_loop_thresh, loop edges measured at a live closure
    and at finish, merged landmarks, ATE < 0.01 m after finish and the exact
    launch counts."""
    import torch

    from stereo_orb_slam_torch.apps import slam

    _reset_launches()
    summary = slam.main([
        "--dataset", "kitti", "--folder", seq, "--camera", os.path.join(seq, "calib.txt"),
        "--output_dir", out_dir, "--gt", gt, "--batch_frames", str(batch_frames),
        "--device", "cuda",
    ])
    launches = _read_launches()
    torch.cuda.synchronize()
    system = summary["system"]
    n, world = summary["frames"], system.world
    hist = system.pgo.history
    live = [h for h in hist if h["live"]]
    ids = np.arange(world.num_points, dtype=np.int32)
    merged = int((world.canonical(ids) != ids).sum())
    expected, bow_batches, edges, edge_batches = _slam_launches_expected(system, n,
                                                                         batch_frames)
    splits = system.pgo.live_stall_splits
    rec = {
        "batch_frames": batch_frames, "frames": n, "tracked": world.num_frames,
        "live_fps": summary["live_fps"], "fps": summary["fps"],
        "median_ms": summary["median_ms"], "finish_seconds": summary["finish_seconds"],
        "ate_m": summary["ate_m"], "live_ate_m": summary["live_ate_m"],
        "rpe": summary["rpe"], "points": world.num_points, "merged_points": merged,
        "max_loop_probability": max(system.loop.probabilities),
        "vocab_train_ms": system.timers.totals["vocab.train"] * 1e3,
        "closures": [{k: h[k] for k in ("live", "num_vertices", "num_edges",
                                         "loop_edges_measured", "num_loop_edges",
                                         "wall_split_seconds", "wall_seconds")}
                     for h in hist],
        "live_stall_splits": splits, "ba_log": system.ba_log[-3:],
        "timers": system.timers.summary(), "launches": launches,
        "launches_expected": {"hamming_top2": expected, "orb_describe": 2 * n,
                              "orb_describe_oriented": 0, "extract_patches": 0,
                              "triangulate_dlt": 0},
        "bow_batches": system.fused_score_batches + system.loop.score_batches,
        "edges_measured": edges, "loop_edge_batches": edge_batches,
    }
    log(f"SLAM (--batch_frames {batch_frames}): {n} frames at {KITTI['h']}x{KITTI['w']}, "
        f"live {rec['live_fps']:.2f} fps, overall {rec['fps']:.2f} fps, median "
        f"{rec['median_ms']:.2f} ms/frame, vocabulary training {rec['vocab_train_ms']:.1f} ms, "
        f"finish {rec['finish_seconds']:.2f} s, ATE {rec['ate_m']:.5f} m (live "
        f"{rec['live_ate_m']:.5f}), RPE {rec['rpe']}, {world.num_points} points, "
        f"{merged} merged, max loop probability {rec['max_loop_probability']:.4f}")
    for h in rec["closures"]:
        log(f"  pose graph ({'live' if h['live'] else 'finish'}): {h['num_vertices']} "
            f"vertices, {h['num_edges']} edges, loop edges {h['num_loop_edges']} of "
            f"{h['loop_edges_measured']} measured, split {h['wall_split_seconds']} s, "
            f"total {h['wall_seconds']} s")
    log(f"  launches {launches}, expected {rec['launches_expected']} ({rec['bow_batches']} "
        f"BoW batches, {edges} loop edges in {edge_batches} batches); live closure stall "
        f"splits {splits}")
    poses = world.pose_global[: world.num_frames]
    if not (np.isfinite(poses).all() and world.num_frames == n):
        raise AssertionError("SLAM: poses are not finite, or frames were lost")
    if not rec["max_loop_probability"] > system.cfg.loop.is_loop_thresh:
        raise AssertionError("SLAM: the loop probability never passed is_loop_thresh")
    if not any(h["num_loop_edges"] >= 1 for h in live):
        raise AssertionError("SLAM: no loop edge was measured at a live closure")
    if not (hist and not hist[-1]["live"] and hist[-1]["num_loop_edges"] >= 1):
        raise AssertionError("SLAM: no loop edge was measured at finish")
    if merged < 1:
        raise AssertionError("SLAM: no landmarks were merged")
    if not rec["ate_m"] < 0.01:
        raise AssertionError(f"SLAM: ATE {rec['ate_m']} m is not below 0.01 m")
    if rec["bow_batches"] != bow_batches:
        raise AssertionError(f"SLAM: {rec['bow_batches']} BoW scoring batches, "
                             f"the trajectory gives {bow_batches}")
    if launches != rec["launches_expected"]:
        raise AssertionError(f"SLAM: launches {launches}, expected {rec['launches_expected']}")
    return rec, system


def _edge_sampler(i, num_hypotheses):
    """sampler_for_edge drawing on the CPU and moving the sets to the slots'
    device, so the card and the CPU measure an edge from the same sets."""
    import torch

    from stereo_orb_slam_torch.frontend import ransac

    gen = torch.Generator()
    gen.manual_seed(1000 + i)
    cpu_sample = ransac.gumbel_sampler(gen, num_hypotheses)
    return lambda valid: cpu_sample(valid.cpu()).to(valid.device)


def phase_slam_devices(system, device="cuda", reference_device="cpu"):
    """The SLAM path's pieces, the card against the CPU, on the phase's own
    data: the vocabulary assignment (the hamming_top2 kernel against its
    plain version, bit for bit, and timed); batch_score_update on 4 recorded
    frames against the final database (ids identical, scores within
    SLAM_SCORE_ATOL); the loop-edge batch over the committed edges with the
    same sets (flags and inlier counts identical, Z within
    SLAM_EDGE_Z_ATOL); pg_solve on the final graph after 1 and 10 GN steps
    (SLAM_PG_ONE_STEP, SLAM_PG_SOLVE). The edge batch and the pose graph run
    again with TF32 left on, the control."""
    import copy

    import torch

    from stereo_orb_slam_torch.apps import slam
    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.config import PoseGraphConfig
    from stereo_orb_slam_torch.geometry import camera, se3
    from stereo_orb_slam_torch.loop import vocab as vocab_mod
    from stereo_orb_slam_torch.ops.kernels import hamming

    rec = {}
    system.sync_feature_banks()
    world = system.world
    nf = world.num_frames
    voc = system.vocab
    banks = system.vo.last_banks
    # Vocabulary assignment at the live loop's shape (one frame's 1024 slots
    # against the 1024 words) and at the training corpus's.
    ones = torch.ones(voc.num_words, dtype=torch.bool, device=device)
    q = banks[0][nf - 1].contiguous()
    corpus = banks[0][:SLAM_VOCAB_FRAMES][banks[1][:SLAM_VOCAB_FRAMES]].contiguous()
    err = 0.0
    for name, desc in (("frame", q), ("corpus", corpus)):
        got = hamming.hamming_top2(desc, voc.centroids, ones)
        want = hamming.hamming_top2_plain(desc, voc.centroids, ones)
        torch.cuda.synchronize()
        err = max(err, _check_equal(f"assign_words ({name})", got, want))
    valid_q = torch.ones(q.shape[0], dtype=torch.bool, device=device)
    ms = time_device(lambda: vocab_mod.assign_words(q, valid_q, voc.centroids))
    plain_ms = time_device(lambda: hamming.hamming_top2_plain(q, voc.centroids, ones))
    rec["assign_words"] = {"match": True, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "shape": f"N={q.shape[0]} against W={voc.num_words}; corpus "
                                    f"N={corpus.shape[0]}"}
    log(f"assign_words (hamming_top2 against the words): bit for bit at N = {q.shape[0]} "
        f"and N = {corpus.shape[0]}; {ms * 1e3:.2f} us device with its masks, plain "
        f"{plain_ms * 1e3:.2f} us")

    # BoW scoring + append of 4 recorded frames against the final database.
    db, db_size = system.loop.database, system.loop.db_size
    rows = list(range(nf - 4, nf))
    args = (banks[0][rows], banks[1][rows], torch.ones(4, dtype=torch.bool, device=device),
            voc.centroids, voc.idf, db, torch.tensor(db_size - 4, device=device))
    out = {}
    for dev in (device, reference_device):
        a = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in args]
        out[dev] = [t.cpu() for t in vocab_mod.batch_score_update(*a, query_size=4)]
    (ig, sg, dg), (ir, sr, dr) = out[device], out[reference_device]
    s_err, d_err = float((sg - sr).abs().max()), float((dg - dr).abs().max())
    ms = time_call(lambda: vocab_mod.batch_score_update(*args, query_size=4), iters=50)
    rec["batch_score_update"] = {"ids_equal": bool(torch.equal(ig, ir)), "score_err": s_err,
                                 "database_err": d_err, "ms": ms,
                                 "shape": f"K=4 against {db_size - 4} of {db.shape[0]} rows"}
    log(f"batch_score_update (K = 4, {db_size - 4} database rows of {db.shape[0]}): ids "
        f"equal {rec['batch_score_update']['ids_equal']}, scores max diff {s_err:.3g}, rows "
        f"{d_err:.3g}; {ms * 1e3:.1f} us per call")
    if not torch.equal(ig, ir) or s_err > SLAM_SCORE_ATOL or d_err > SLAM_SCORE_ATOL:
        raise AssertionError("batch_score_update: the card and the CPU disagree")

    # The loop-edge batch with the same sets: 16 committed edges (the same
    # view twice: exact duplicates) and 16 with src one frame on (a real
    # one-step transform).
    committed = system.pgo.committed_edges[:16]
    edges = committed + [(s + 1, d) for s, d in committed]
    rig_c = system.rig
    rig_r = camera.StereoRig(*(type(c)(*(t.to(reference_device) for t in c))
                               for c in (rig_c.left, rig_c.right)),
                             rig_c.rectified, rig_c.baseline.to(reference_device))
    readings = {}
    for name, rig, ctx in (("card", rig_c, contextlib.nullcontext),
                           ("cpu", rig_r, contextlib.nullcontext),
                           ("card_tf32", rig_c, _tf32_left_on)):
        w = copy.deepcopy(world)
        m = slam.make_loop_matcher(w, rig, system.cfg, sampler_for_edge=lambda i: _edge_sampler(
            i, system.cfg.ransac.num_hypotheses))
        with ctx():
            if name == "card":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            res = m.batch(edges)
            if name == "card":
                edge_ms = (time.perf_counter() - t0) * 1e3
        readings[name] = (res, m.last, w.point_parent[: w.num_points].copy())
    (rc, lc, pc), (rr, lr, pr) = readings["card"], readings["cpu"]

    def z_err(a, b):
        return max((float(np.abs(za - zb).max()) for (za, oka), (zb, _) in zip(a, b) if oka),
                   default=0.0)

    rec["loop_edges"] = {"edges": len(edges), "ok": sum(lc["ok"]), "ms": edge_ms,
                         "flags_equal": lc["ok"] == lr["ok"],
                         "inliers_equal": lc["num_inliers"] == lr["num_inliers"],
                         "merges_equal": bool(np.array_equal(pc, pr)),
                         "z_err": z_err(rc, rr), "z_err_tf32": z_err(readings["card_tf32"][0], rr),
                         "inliers_equal_tf32":
                             readings["card_tf32"][1]["num_inliers"] == lr["num_inliers"]}
    le = rec["loop_edges"]
    log(f"loop-edge batch ({le['edges']} edges, {le['ok']} measured): {edge_ms:.1f} ms on the "
        f"card; card vs CPU flags equal {le['flags_equal']}, inliers equal "
        f"{le['inliers_equal']}, merges equal {le['merges_equal']}, Z max diff "
        f"{le['z_err']:.3g} (TF32 on: {le['z_err_tf32']:.3g}, inliers equal "
        f"{le['inliers_equal_tf32']})")
    if not (le["flags_equal"] and le["inliers_equal"] and le["merges_equal"]
            and le["z_err"] <= SLAM_EDGE_Z_ATOL):
        raise AssertionError("loop-edge batch: the card and the CPU disagree")
    le["batched"] = _edge_batch_times(system, system.pgo.committed_edges, device)

    # pg_solve on the final graph (the finish() solve's input), its free
    # poses perturbed by 2 cm / 2 mrad (seeded): the tracked graph is
    # consistent already, so unperturbed it barely moves.
    prob = system.pgo.last_problem
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    xi = torch.randn((prob.poses.shape[0], 6), generator=gen) * torch.tensor(
        [2e-3] * 3 + [2e-2] * 3)
    xi = (xi * prob.vertex_mask.cpu()[:, None]).to(device)
    prob = prob._replace(poses=prob.poses @ se3.se3_exp(xi))
    pg = {}
    for iters in (1, 10):
        cfg = PoseGraphConfig(iterations=iters)
        outs = {}
        for name, dev, ctx in (("card", device, contextlib.nullcontext),
                               ("cpu", reference_device, contextlib.nullcontext),
                               ("card_tf32", device, _tf32_left_on)):
            with ctx():
                p, c0, c1 = pose_graph.pg_solve(pose_graph.PoseGraphProblem(
                    *(t.to(dev) for t in prob)), cfg)
                outs[name] = (p.poses.cpu().double(), float(c0), float(c1))
        ref = outs["cpu"][0]
        for name in ("card", "card_tf32"):
            P = outs[name][0]
            pg[f"{name}_{iters}"] = {
                "rotation": float((P[:, :3, :3] - ref[:, :3, :3]).abs().max()),
                "translation": float((P[:, :3, 3] - ref[:, :3, 3]).abs().max()),
                "cost_rel": abs(outs[name][2] - outs["cpu"][2]) / max(abs(outs["cpu"][2]), 1e-30)}
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(pose_graph.pg_solve(prob, PoseGraphConfig())[2])  # its one readback
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pose_graph.pg_solve(prob, PoseGraphConfig())
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    pg.update(ms=statistics.median(times), launches=sum(e.count for e in kernels),
              device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
              vertices=prob.poses.shape[0], edges=prob.edge_a.shape[0])
    log(f"pg_solve ({pg['vertices']} vertices, {pg['edges']} edges, 10 GN steps of 200 "
        f"CG): {pg['ms']:.1f} ms wall (median of 3, readback included), "
        f"{pg['launches']} launches, {pg['device_ms']:.2f} ms device; card vs CPU "
        + "; ".join(f"{k} rot {v['rotation']:.3g} trans {v['translation']:.3g} cost "
                    f"{v['cost_rel']:.3g}" for k, v in pg.items() if isinstance(v, dict)))
    rec["pg_solve"] = pg
    for iters, (rb, tb) in ((1, SLAM_PG_ONE_STEP), (10, SLAM_PG_SOLVE)):
        g = pg[f"card_{iters}"]
        if not (g["rotation"] <= rb and g["translation"] <= tb):
            raise AssertionError(f"pg_solve ({iters} steps): the card and the CPU disagree "
                                 f"beyond {rb} / {tb}: {g}")
    return rec


def _edge_batch_times(system, edges, device="cuda", reps=4):
    """The loop-edge batch (`make_loop_matcher(...).batch`, one
    `measure_edges` program) at E = 1, 8 and all of `edges`, fed from the
    live loop's device rings with the matcher's own samplers, against the
    same E edges measured as E single calls (the serial measurement the
    batch replaced) in the same call: wall ms from a synced start to the
    last readback (median of reps - 1 after a warm call, each on a fresh
    copy of the world) and the hamming_top2 launches of each."""
    from stereo_orb_slam_torch.apps import slam
    from stereo_orb_slam_torch.ops.kernels import hamming

    def run(sub, serial):
        times, launches = [], set()
        for _ in range(reps):
            m = slam.make_loop_matcher(copy.deepcopy(system.world), system.rig, system.cfg,
                                       bank_getter=lambda: system.vo.last_banks)
            _sync(device)
            h0 = hamming.LAUNCHES
            t0 = time.perf_counter()
            if serial:
                for src, dst in sub:
                    m(src, dst)
            else:
                m.batch(sub)
            times.append((time.perf_counter() - t0) * 1e3)
            launches.add(hamming.LAUNCHES - h0)
        return statistics.median(times[1:]), sorted(launches)

    out = []
    for e in sorted({1, min(8, len(edges)), len(edges)} - {0}):
        ms, launches = run(edges[:e], False)
        serial_ms, serial_launches = run(edges[:e], True)
        out.append({"edges": e, "ms": ms, "ms_per_edge": ms / e, "hamming_launches": launches,
                    "serial_ms": serial_ms, "serial_ms_per_edge": serial_ms / e,
                    "serial_hamming_launches": serial_launches})
    log("loop-edge batch against single calls (from the device rings): "
        + "; ".join(f"E = {r['edges']}: {r['ms']:.2f} ms ({r['ms_per_edge']:.3f} ms per edge, "
                    f"hamming_top2 launches {r['hamming_launches']}) against "
                    f"{r['serial_ms']:.2f} ms ({r['serial_ms_per_edge']:.3f} ms per edge, "
                    f"{r['serial_hamming_launches']})" for r in out))
    if _is_cuda(device) and any(r["hamming_launches"] != [1]
                                or r["serial_hamming_launches"] != [r["edges"]] for r in out):
        raise AssertionError(f"loop-edge batch: not one hamming_top2 launch per batch: {out}")
    return out


def phase_slam_first_call(device="cuda"):
    """The closure path's first use in a process: pose_graph.warm_up (the
    one-time cost of PyTorch's first forward-mode product, which
    PoseGraphOptimizer pays when it is built), then two pg_solve calls on a
    small graph (a chain of 32 poses with one loop edge)."""
    import torch

    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.config import PoseGraphConfig

    t0 = time.perf_counter()
    pose_graph.warm_up()
    warm_s = time.perf_counter() - t0

    n = 32
    poses = torch.eye(4, device=device).repeat(n, 1, 1)
    poses[:, 0, 3] = torch.arange(n, device=device, dtype=torch.float32) * 0.2
    ea = torch.cat([torch.arange(n - 1), torch.tensor([n - 1])]).to(device)
    eb = torch.cat([torch.arange(1, n), torch.tensor([0])]).to(device)
    meas = torch.linalg.inv(poses[ea]) @ poses[eb]
    vm = torch.ones(n, device=device)
    vm[0] = 0.0
    prob = pose_graph.PoseGraphProblem(poses, ea, eb, meas, torch.ones(n, device=device), vm)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(pose_graph.pg_solve(prob, PoseGraphConfig())[2])
        times.append(time.perf_counter() - t0)
    log(f"pose_graph.warm_up (first forward mode in the process, on the CPU): {warm_s:.2f} s; "
        f"then pg_solve on the card, first call {times[0]:.2f} s, second {times[1]:.2f} s "
        f"({n} vertices)")
    return {"warm_up_s": warm_s, "first_s": times[0], "second_s": times[1]}


def phase_slam_profile(seq, path, warm=40, frames=20):
    """Where a SLAM frame's time goes: `frames` process_batch calls (K = 1)
    on the card under torch.profiler after `warm` calls off the record (the
    vocabulary trains at frame 12), then one pose-graph solve of that
    system's graph. Writes the breakdown to `path` as JSON."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.apps.slam import SlamSystem
    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.io import calib, datasets

    pairs = datasets.load_dataset("kitti", seq)[: warm + frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    system = SlamSystem(calib.load_camera(os.path.join(seq, "calib.txt")))
    up = [(torch.from_numpy(a.astype(np.uint8))[None].cuda(),
           torch.from_numpy(b.astype(np.uint8))[None].cuda()) for a, b in imgs]
    for il, ir in up[:warm]:
        system.process_batch(il, ir)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for il, ir in up[warm:]:
            system.process_batch(il, ir)
        system.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report = {"slam_frames": _device_summary(prof, wall_ms, frames, unit="frame")}
    system.pgo.optimize(run_global_ba=False)
    prob = system.pgo.last_problem
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, _, c = pose_graph.pg_solve(prob, system.pgo.cfg)
        float(c)
        wall_ms = (time.perf_counter() - t0) * 1e3
    report["pg_solve"] = _device_summary(prof, wall_ms, 1, unit="solve")
    report["pg_solve"]["graph"] = {"vertices": prob.poses.shape[0], "edges": prob.edge_a.shape[0]}
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    for name, per, count in (("slam_frames", "frame", frames), ("pg_solve", "solve", 1)):
        rep = report[name]
        top = ", ".join(f"{k['name'][:40]} {k[f'device_us_per_{per}']:.1f} us"
                        for k in rep["kernels"][:6])
        log(f"SLAM profile, {name}: {rep['wall_ms'] / count:.2f} ms wall per {per}, device "
            f"busy {rep['device_busy_ms'] / count:.3f} ms (idle share "
            f"{rep['device_idle_share']:.3f}), {rep[f'device_launches_per_{per}']:.0f} "
            f"launches per {per}; top: {top}")
    log(f"SLAM profile breakdown in {path}")


def phase_oriented_profile(seq, path, frames=ORIENTED_FRAMES, warm=2):
    """Where an oriented frame's time goes, with the fused kernel and with
    the chain the oriented path ran before it (the patch-cut kernel, then
    the moments, the 30 per-bin products, compare and pack) swapped in for
    it: `frames` track() calls each under torch.profiler, after `warm` off
    the record. Launches, device ms and wall ms per frame to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.config import FrontendConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import describe, patches
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", seq)[: warm + frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    rig = calib.load_camera(os.path.join(seq, "calib.txt"))

    def parent_describe(padded, xy, valid, table, orientation_radius=15):
        cut = patches.extract_patches(padded, *orb.window_starts(xy), orb.PATCH)
        return describe.steered_words_from_patches(cut.reshape(-1, orb.PATCH * orb.PATCH),
                                                   valid, table, orientation_radius)

    fused = describe.orb_describe_oriented
    report = {}
    try:
        for name, fn in (("fused", fused), ("parent_chain", parent_describe)):
            describe.orb_describe_oriented = fn
            vo = VisualOdometer(WorldMap(), rig, fe=FrontendConfig(oriented=True))
            for il, ir in imgs[:warm]:
                vo.track(il, ir)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for il, ir in imgs[warm:]:
                    vo.track(il, ir)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rep = _device_summary(prof, wall_ms, frames, unit="frame")
            rep["wall_ms_per_frame"] = wall_ms / frames
            rep["device_busy_ms_per_frame"] = rep["device_busy_ms"] / frames
            report[name] = rep
            log(f"oriented profile ({name}): {rep['wall_ms_per_frame']:.2f} ms/frame wall, "
                f"device busy {rep['device_busy_ms_per_frame']:.3f} ms/frame (idle share "
                f"{rep['device_idle_share']:.3f}), {rep['device_launches_per_frame']:.0f} "
                f"launches/frame")
    finally:
        describe.orb_describe_oriented = fused
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    log(f"oriented profile breakdown in {path}")
    return report


BATCH = 3   # the multi-sequence phase's sequences: KITTI 00, 02, 05 stand-ins


def phase_batched_kernels(rng, batch=BATCH):
    """The three kernels with a batch axis at B = `batch`, one launch each:
    bit for bit against their batched plain versions and against a B = 1
    launch on each slice, and timed beside the bound of B problems."""
    import torch

    from stereo_orb_slam_torch import convert
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.ops.kernels import describe, hamming, patches

    dev = torch.device("cuda")
    records = []
    n = m = 1024
    B = batch

    # hamming_top2: B x (1024 queries against two train sets of 1024), one
    # batch entry of each kind (masked columns, ties, an all-invalid set).
    cases = [(_hamming_case(rng, kind), _hamming_case(rng, kind))
             for kind in ("masked", "ties", "all_invalid")[:B]]
    q = convert.desc_to_tensor(np.stack([a[0] for a, _ in cases]), dev)
    ta = convert.desc_to_tensor(np.stack([a[1] for a, _ in cases]), dev)
    tb = convert.desc_to_tensor(np.stack([b[1] for _, b in cases]), dev)
    va = torch.as_tensor(np.stack([a[2] for a, _ in cases]), device=dev)
    vb = torch.as_tensor(np.stack([b[2] for _, b in cases]), device=dev)
    got = hamming.hamming_top2_pair(q, ta, va, tb, vb)
    plain = (hamming.hamming_top2_plain(q, ta, va), hamming.hamming_top2_plain(q, tb, vb))
    torch.cuda.synchronize()
    err = max(_check_equal("hamming_top2_pair (batch, set a)", got[0], plain[0]),
              _check_equal("hamming_top2_pair (batch, set b)", got[1], plain[1]))
    for b in range(B):
        one = hamming.hamming_top2_pair(q[b], ta[b], va[b], tb[b], vb[b])
        for s in range(2):
            _check_equal(f"hamming_top2_pair (batch entry {b}, set {s}) against B = 1",
                         tuple(x[b] for x in got[s]), one[s])
    ms = time_device(lambda: hamming.hamming_top2_pair(q, ta, va, tb, vb))
    plain_ms = time_device(lambda: (hamming.hamming_top2_plain(q, ta, va),
                                    hamming.hamming_top2_plain(q, tb, vb)))
    bytes_ = B * (n * 32 + 2 * (m * 32 + m + n * 12))
    ops = B * 2 * 2 * n * m * 256
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / INT8_TENSOR_OPS_PER_S * 1e3
    records.append(_record(
        f"hamming_top2 (B={B})", "stereo_orb_slam_torch/csrc/hamming_top2.cu",
        "stereo_orb_slam_tpu/ops/pallas/hamming.py:74", "multi_seq",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=None, match=True,
        batch=B, shape=f"B={B} x (N={n}, two train sets of M={m}), one launch"))

    # orb_describe and extract_patches on B padded KITTI images.
    H, W = KITTI["h"] + 2 * orb.PATCH_R, KITTI["w"] + 2 * orb.PATCH_R
    img = torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)).to(dev)
    xy = np.stack([rng.uniform(0, KITTI["w"] - 1, (B, n)),
                   rng.uniform(0, KITTI["h"] - 1, (B, n))], -1).astype(np.float32)
    xy[:, ::7] = np.floor(xy[:, ::7]) + 0.5
    xy = torch.from_numpy(xy).to(dev)
    valid = torch.from_numpy(rng.random((B, n)) >= 0.25).to(dev)
    table = orb.steer_table(False, dev)
    got = describe.orb_describe(img, xy, valid, table)
    want = describe.orb_describe_plain(img, xy, valid, table)
    torch.cuda.synchronize()
    diff = (orb.unpack_bits(got) - orb.unpack_bits(want)).abs()
    flips = int(diff.sum())
    log(f"orb_describe (B = {B}): {flips} of {B * n * orb.N_TESTS} bits differ from the "
        f"batched plain version")
    if got.shape != want.shape or flips:
        raise AssertionError(f"batched orb_describe differs from its plain version in "
                             f"{flips} bits")
    for b in range(B):
        _check_equal(f"orb_describe (image {b}) against B = 1",
                     (got[b],), (describe.orb_describe(img[b], xy[b], valid[b], table),))
    ms = time_device(lambda: describe.orb_describe(img, xy, valid, table))
    plain_ms = time_device(lambda: describe.orb_describe_plain(img, xy, valid, table))
    bytes_ = B * (H * W * 4 + n * (8 + 1) + n * 32)
    fmas = B * n * 2 * orb.N_TESTS * describe.TAPS
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, 2 * fmas / F32_OPS_PER_S * 1e3
    records.append(_record(
        f"orb_describe (B={B})", "stereo_orb_slam_torch/csrc/orb_describe.cu",
        "stereo_orb_slam_tpu/ops/pallas/patches.py:63", "multi_seq",
        max_abs_err=float(diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations", library_ms=None,
        match=True, batch=B, bits_differing=flips,
        shape=f"B={B} images of {H}x{W}, N={n} each (a quarter invalid), one launch"))

    ys, xs = orb.window_starts(xy)
    got = patches.extract_patches(img, ys, xs, orb.PATCH)
    want = patches.extract_patches_plain(img, ys, xs, orb.PATCH)
    torch.cuda.synchronize()
    err = _check_equal("extract_patches (batch)", (got,), (want,))
    for b in range(B):
        _check_equal(f"extract_patches (image {b}) against B = 1", (got[b],),
                     (patches.extract_patches(img[b], ys[b], xs[b], orb.PATCH),))
    ar = torch.arange(orb.PATCH, device=dev)
    image = torch.arange(B, device=dev)[:, None, None, None]
    rows = (ys.long().clamp(0, H - orb.PATCH)[..., None] + ar)[..., :, None]
    cols = (xs.long().clamp(0, W - orb.PATCH)[..., None] + ar)[..., None, :]
    ms = time_device(lambda: patches.extract_patches(img, ys, xs, orb.PATCH))
    plain_ms = time_device(lambda: patches.extract_patches_plain(img, ys, xs, orb.PATCH))
    library_ms = time_device(lambda: img[image, rows, cols])
    bytes_ = B * (H * W * 4 + 2 * n * 4 + n * orb.PATCH * orb.PATCH * 2)
    records.append(_record(
        f"extract_patches (B={B})", "stereo_orb_slam_torch/csrc/extract_patches.cu",
        "stereo_orb_slam_tpu/ops/pallas/patches.py:63", "oriented",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms, match=True, batch=B,
        shape=f"B={B} images of {H}x{W}, N={n} each, one launch",
        library_call="one advanced-index gather img[image, rows, cols] (float32 out)",
        note=EXTRACT_PATCHES_NOTE))

    raw = torch.from_numpy(rng.uniform(0, 255, (B, KITTI["h"], KITTI["w"])).astype(np.float32))
    smooth = orb.pad_edge(orb.smooth_image(raw.to(dev))).contiguous()
    records.append(_oriented_record(f"orb_describe_oriented (B={B})", smooth, xy, valid))
    for r in records:
        log(f"kernel {r['name']}: held against the batched plain version and B = 1 "
            f"launches; device {r['ms'] * 1e3:.2f} us per launch (bound {r['bound_ms'] * 1e3:.3f}"
            f" us by {r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library "
            f"{r['library_ms']}")
    return records


# The multi-sequence phase (BASELINE.json config 4): three whole-pixel
# PlaneScene sequences (texture seeds and steps per frame in pixels) at
# KITTI 00-02's size and intrinsics (KITTI 05 is 370 x 1226; stacked
# images share one shape, so all three are rendered at 376 x 1241).
MULTI_SEQ = ((0, 14), (2, 12), (5, 16))
MULTI_SEQ_POSE_ATOL = 1e-4


def _render_multi(frames=N_FRAMES, spec=MULTI_SEQ):
    """([frames, S, H, W] uint8 left, same right, [S, frames, 4, 4] GT)."""
    from synth import PlaneScene

    k = KITTI
    depth = k["fx"] * k["baseline"] / 38.0
    left, right, gts = [], [], []
    for seed, px in spec:
        step = px * depth / k["fx"]
        scene = PlaneScene(np.random.default_rng(seed), fx=k["fx"], cx=k["cx"], cy=k["cy"],
                           baseline=k["baseline"], depth=depth, h=k["h"], w=k["w"])
        left.append([scene.render(i * step).clip(0, 255).astype(np.uint8)
                     for i in range(frames)])
        right.append([scene.render(i * step, right=True).clip(0, 255).astype(np.uint8)
                      for i in range(frames)])
        gt = np.tile(np.eye(4), (frames, 1, 1))
        gt[:, 0, 3] = np.arange(frames) * step
        gts.append(gt)
    return (np.stack(left, 1), np.stack(right, 1), np.stack(gts))


def phase_multi_seq(seq, frames=N_FRAMES):
    """MultiSequenceSLAM over S = 3 sequences of `frames` frames at full
    width on the card (mesh None: one batched program), against each
    sequence tracked alone by VisualOdometer on the card: relative poses
    within MULTI_SEQ_POSE_ATOL, ATE < 0.01 m per sequence, and exactly 1
    hamming_top2, 2 orb_describe and 0 extract_patches launches per step.
    Steps/s and sequence-frames/s beside single-sequence VO on the same
    frames."""
    import torch

    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib
    from stereo_orb_slam_torch.parallel.multi_seq import MultiSequenceSLAM
    from stereo_orb_slam_torch.utils import evaluate
    from stereo_orb_slam_torch.worldmap import WorldMap

    t0 = time.perf_counter()
    imgs_l, imgs_r, gts = _render_multi(frames)
    render_s = time.perf_counter() - t0
    S = imgs_l.shape[1]
    rigs = [calib.load_camera(os.path.join(seq, "calib.txt")) for _ in range(S)]
    # The first step of each path is paid once per process (tables, plans):
    # both are warmed on a throwaway run of 2 frames.
    warm = MultiSequenceSLAM(rigs)
    for i in range(2):
        warm.process(imgs_l[i], imgs_r[i])
    VisualOdometer(WorldMap(), rigs[0]).track(imgs_l[0, 0], imgs_r[0, 0])
    torch.cuda.synchronize()

    multi = MultiSequenceSLAM(rigs)
    _reset_launches()
    t0 = time.perf_counter()
    multi_T = [np.stack(multi.process(imgs_l[i], imgs_r[i])) for i in range(frames)]
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    launches = _read_launches()

    single_s, gaps, ates = 0.0, [], []
    for s in range(S):
        vo = VisualOdometer(WorldMap(), rigs[s], seed=s)
        t0 = time.perf_counter()
        alone = [vo.track(imgs_l[i, s], imgs_r[i, s]) for i in range(frames)]
        torch.cuda.synchronize()
        single_s += time.perf_counter() - t0
        gaps.append(float(np.abs(np.stack([T[s] for T in multi_T]) - np.stack(alone)).max()))
        w = multi.worlds[s]
        poses = w.pose_global[: w.num_frames]
        if not (np.isfinite(poses).all() and w.num_frames == frames):
            raise AssertionError(f"multi-sequence: sequence {s} lost frames or is not finite")
        ates.append(evaluate.ate_rmse(poses, gts[s]))
    rec = {"sequences": S, "frames": frames, "shape": f"{KITTI['h']}x{KITTI['w']}",
           "steps_px": [px for _, px in MULTI_SEQ], "render_s": render_s,
           "steps_per_s": frames / multi_s, "sequence_frames_per_s": S * frames / multi_s,
           "ms_per_step": multi_s * 1e3 / frames,
           "single_vo_frames_per_s": S * frames / single_s,
           "pose_gap_to_single": gaps, "ate_m": ates, "launches": launches,
           "points": [w.num_points for w in multi.worlds]}
    log(f"multi-sequence (S = {S}, {frames} frames each at {rec['shape']}): "
        f"{rec['steps_per_s']:.2f} steps/s, {rec['sequence_frames_per_s']:.2f} sequence-frames/s "
        f"({rec['ms_per_step']:.2f} ms per step); single-sequence VO on the same frames "
        f"{rec['single_vo_frames_per_s']:.2f} frames/s; pose gaps to single {gaps}; ATE {ates} "
        f"m; launches {launches}")
    if max(gaps) > MULTI_SEQ_POSE_ATOL:
        raise AssertionError(f"multi-sequence: poses differ from single-sequence tracking by "
                             f"{max(gaps)} (> {MULTI_SEQ_POSE_ATOL})")
    if not max(ates) < 0.01:
        raise AssertionError(f"multi-sequence: ATE {ates} m, not all below 0.01 m")
    _check_launches("multi-sequence", launches,
                    UPRIGHT_PER_FRAME, frames)
    return rec, (multi, imgs_l, imgs_r)


def phase_multi_seq_profile(state, path, steps=20):
    """torch.profiler over `steps` further multi-sequence steps (launches,
    device busy, idle share per step), to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    multi, imgs_l, imgs_r = state
    n = imgs_l.shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            multi.process(imgs_l[i % n], imgs_r[i % n])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rep = _device_summary(prof, wall_ms, steps, unit="step")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    top = ", ".join(f"{k['name'][:40]} {k['device_us_per_step']:.1f} us"
                    for k in rep["kernels"][:6])
    log(f"multi-sequence profile: {wall_ms / steps:.2f} ms wall per step, device busy "
        f"{rep['device_busy_ms'] / steps:.3f} ms (idle share {rep['device_idle_share']:.3f}), "
        f"{rep['device_launches_per_step']:.0f} launches per step; top: {top}; in {path}")
    return rep


# Phase 13: the captured programs (stereo_orb_slam_torch/utils/programs.py)
# held bit for bit against the eager functions they replace, and the
# eager-against-captured figures of this call.
PROGRAM_CHAIN_KS = (4, 32)
PROGRAM_MULTI_STEPS = 20
PROGRAM_WINDOW_ITERATIONS = 20   # the canyon drive's live BA


@contextlib.contextmanager
def _eager_programs():
    """While inside, every program runs its bodies as eager launch streams,
    as the units ran before they were captured: the eager side of the
    eager-against-captured figures (the same kernels in the same order, so
    the same bits)."""
    from stereo_orb_slam_torch.utils import programs

    captures = programs.Program.captures
    programs.Program.captures = property(lambda self: False)
    try:
        yield
    finally:
        programs.Program.captures = captures


def _bits_equal(a, b):
    """Bitwise equality of two tensors or (nested) tuples of them."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
    return len(a) == len(b) and all(_bits_equal(x, y) for x, y in zip(a, b))


def _wall_ms(fn):
    """(fn(), host ms of fn with the device synchronised on both sides)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _kernels_in(fn):
    """(kernels the card ran in fn(), their device ms), by torch.profiler;
    a graph replay's kernels count where the profiler sees them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in kernels), sum(e.self_device_time_total for e in kernels) / 1e3


def _body_kernels(prog, names):
    """Kernels of one eager run of each named body of `prog` (the nodes its
    graph replays). Runs the bodies on the program's current state."""
    out = {}
    with _eager_programs():
        for name in names:
            out[name] = _kernels_in(lambda: prog.run(name, getattr(prog, name)))[0]
    return out


def _stat_delta(before, after):
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in ("captures", "replays",
                                                                "capture_ms")}
            for k, v in after.items()
            if v["replays"] != before.get(k, {}).get("replays", 0)
            or v["captures"] != before.get(k, {}).get("captures", 0)}


def _program_pose_graph(slam_graph):
    """pg_solve on phase 7's final graph, eager and captured in turns (eager,
    the program's first call with its captures, a call of replays only,
    eager): the poses and both costs bit for bit, wall ms, kernels and
    graph replays per solve, kernels per body."""
    import copy as copy_mod

    import torch

    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.config import PoseGraphConfig
    from stereo_orb_slam_torch.utils import programs

    dev = torch.device("cuda")
    vm = np.ones(len(slam_graph[0]), np.float32)
    vm[0] = 0.0
    prob = pose_graph.PoseGraphProblem(
        *(torch.as_tensor(x, device=dev) for x in slam_graph),
        edge_weight=torch.ones(len(slam_graph[1]), device=dev),
        vertex_mask=torch.as_tensor(vm, device=dev))
    cfg = PoseGraphConfig()
    cache = programs.ProgramCache()

    def flat(out):
        return (out[0].poses, out[1], out[2])

    want, eager_ms = _wall_ms(lambda: flat(pose_graph.pg_solve(prob, cfg)))
    first, capture_ms = _wall_ms(lambda: flat(pose_graph.pg_solve_program(prob, cfg,
                                                                          cache=cache)))
    stats0 = copy_mod.deepcopy(cache.stats)
    again, replay_ms = _wall_ms(lambda: flat(pose_graph.pg_solve_program(prob, cfg,
                                                                         cache=cache)))
    replays = _stat_delta(stats0, cache.stats)
    want2, eager2_ms = _wall_ms(lambda: flat(pose_graph.pg_solve(prob, cfg)))
    bits = all(_bits_equal(x, want) for x in (first, again, want2))
    eager_kernels, eager_dev = _kernels_in(lambda: pose_graph.pg_solve(prob, cfg))
    graph_kernels, graph_dev = _kernels_in(lambda: pose_graph.pg_solve_program(prob, cfg,
                                                                               cache=cache))
    prog = next(iter(cache._programs.values()))
    rec = {"vertices": prob.poses.shape[0], "edges": prob.edge_a.shape[0], "bits_equal": bits,
           "eager_ms": [eager_ms, eager2_ms], "first_call_ms": capture_ms,
           "captured_ms": replay_ms, "eager_kernels": eager_kernels,
           "eager_device_ms": eager_dev, "captured_kernels_seen": graph_kernels,
           "captured_device_ms": graph_dev,
           "graph_replays_per_solve": sum(v["replays"] for v in replays.values()),
           "capture_ms": {k: v["capture_ms"] for k, v in cache.stats.items()},
           "nodes": _body_kernels(prog, ("assemble", "cg", "update"))}
    cache.clear()
    log(f"programs, pose graph ({rec['vertices']} vertices, {rec['edges']} edges): bits equal "
        f"{bits}; eager {eager_ms:.1f} / {eager2_ms:.1f} ms, {eager_kernels} kernels, "
        f"{eager_dev:.1f} ms device; captured {replay_ms:.1f} ms ({rec['graph_replays_per_solve']}"
        f" graph replays, {graph_kernels} kernels seen, {graph_dev:.1f} ms device), first call "
        f"{capture_ms:.1f} ms (captures {rec['capture_ms']}); kernels per body {rec['nodes']}")
    return rec


def _program_ba(seq, window):
    """The LM solve, eager (`ba_solve`) and captured (`ba_solve_program`) in
    turns, on phase 6's last window (PROGRAM_WINDOW_ITERATIONS iterations,
    the exit off) and on the map problem (MAP_LM_ITERATIONS, matrix-free):
    carry, iteration count and initial cost bit for bit, ms per LM
    iteration, and the map problem's peak device memory eager, at the
    capture and at a replay."""
    import torch

    from stereo_orb_slam_torch.backend import ba
    from stereo_orb_slam_torch.config import BAConfig
    from stereo_orb_slam_torch.io import calib
    from stereo_orb_slam_torch.utils import programs

    world, start, end = window
    adj = ba.BundleAdjuster(copy.deepcopy(world),
                            calib.load_camera(os.path.join(seq, "calib.txt")), BAConfig())
    setup = adj.prepare(start, end)
    rec = {}
    cases = (("window", setup.prob, PROGRAM_WINDOW_ITERATIONS,
              dataclasses.replace(adj.cfg, function_tolerance=0.0), setup.solve_kwargs()),
             ("map", None, MAP_LM_ITERATIONS,
              BAConfig(cg_iterations=40, function_tolerance=0.0), {}))
    for name, prob, iters, cfg, kw in cases:
        if prob is None:
            prob = make_map_problem("cuda", **MAP_SIZE)
        cache = programs.ProgramCache()
        torch.cuda.empty_cache()
        peaks = []

        def run(fn):
            # Peak above what was allocated before the call (the process
            # cache's programs hold their static tensors throughout).
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, ms = _wall_ms(fn)
            peaks.append(torch.cuda.max_memory_allocated() - base)
            return out, ms

        def eager():
            return ba.ba_solve(prob, iters, cfg, **kw)

        def captured():
            return ba.ba_solve_program(prob, iters, cfg, cache=cache, **kw)

        want, e1 = run(eager)
        first, c1 = run(captured)
        again, c2 = run(captured)
        want2, e2 = run(eager)
        bits = all(_bits_equal(x, want) for x in (first, again, want2))
        prog = next(iter(cache._programs.values()))
        r = {"path": "matrix-free" if name == "map" else setup.path,
             "cams": prob.pose6.shape[0], "points": prob.points.shape[0],
             "obs": prob.obs_cam.shape[0], "iterations": int(want[1]), "bits_equal": bits,
             "eager_ms_per_iteration": [e1 / iters, e2 / iters],
             "captured_ms_per_iteration": c2 / iters, "first_call_ms": c1,
             "peak_bytes_above_base": {"eager": peaks[0], "capture": peaks[1],
                                       "replay": peaks[2]},
             "capture_ms": {k: v["capture_ms"] for k, v in cache.stats.items()},
             "nodes": _body_kernels(prog, ("start", "iteration"))}
        cache.clear()
        rec[name] = r
        log(f"programs, {name} BA ({r['path']}, C={r['cams']}, P={r['points']}, O={r['obs']}, "
            f"{iters} LM iterations): bits equal {bits}; eager {e1 / iters:.2f} / "
            f"{e2 / iters:.2f} ms per LM iteration, captured {c2 / iters:.2f} (first call "
            f"{c1:.1f} ms); peak MiB above the base: eager {peaks[0] / 2**20:.1f}, capture "
            f"{peaks[1] / 2**20:.1f}, replay {peaks[2] / 2**20:.1f}; kernels per body "
            f"{r['nodes']}")
    return rec


def _program_front_end(seq, multi_state):
    """The rectified front end's program against the eager functions: 60
    frames of `VisualOdometer.track` (one replay each) against one eager
    `frontend_chain` over the same frames and RANSAC draws, every frame's
    StepResult bit for bit; `frontend_chain_program` against
    `frontend_chain` at K = 4 and K = 32 (carry and stacked results, every
    chain); the multi-sequence step at S = 3 against the eager batched
    step over PROGRAM_MULTI_STEPS steps."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend import odometer
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.parallel import multi_seq as multi_mod
    from stereo_orb_slam_torch.utils import programs
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", seq)[:N_FRAMES]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    n = len(imgs)
    rig = calib.load_camera(os.path.join(seq, "calib.txt"))
    fe, rc = FrontendConfig(), RansacConfig()
    steer, md = orb.steer_table(fe.oriented, rig.device), rig.max_sensible_distance()
    L = torch.as_tensor(np.stack([a for a, _ in imgs])).cuda()
    R = torch.as_tensor(np.stack([b for _, b in imgs])).cuda()
    draws = VisualOdometer(WorldMap(), rig)   # the VO's per-frame samplers (seed 0)

    def samplers(lo, hi):
        return [draws._gumbel_for_frame(i) for i in range(lo, hi)]

    rec = {}
    vo = VisualOdometer(WorldMap(), rig)
    got = []
    for il, ir in imgs:
        vo.track(il, ir)
        got.append(vo.last_result)
    _, want = odometer.frontend_chain(L, R, odometer.empty_slots(fe.num_features), False,
                                      samplers(0, n), rig, md, fe, rc, True, steer)
    rec["vo_frames"] = n
    rec["vo_bits_equal"] = all(_bits_equal(got[j], odometer._select(want, j)) for j in range(n))
    for k in PROGRAM_CHAIN_KS:
        cache = programs.ProgramCache()
        ok, carry_e, carry_c = True, (odometer.empty_slots(fe.num_features), False), None
        carry_c = carry_e
        for lo in range(0, n - k + 1, k):
            args = (L[lo:lo + k], R[lo:lo + k])
            carry_e, res_e = odometer.frontend_chain(*args, *carry_e, samplers(lo, lo + k), rig,
                                                     md, fe, rc, True, steer)
            carry_c, res_c = odometer.frontend_chain_program(*args, *carry_c,
                                                             samplers(lo, lo + k), rig, md, fe,
                                                             rc, steer, cache=cache)
            ok = ok and _bits_equal(res_c, res_e) and _bits_equal(carry_c, carry_e)
        prog = next(iter(cache._programs.values()))
        rec[f"chain_k{k}"] = {"chains": n // k, "bits_equal": ok,
                              "capture_ms": {a: b["capture_ms"] for a, b in cache.stats.items()},
                              "replays": {a: b["replays"] for a, b in cache.stats.items()}}
        if k == PROGRAM_CHAIN_KS[0]:
            rec["step_nodes"] = _body_kernels(prog, ("step",))["step"]
        cache.clear()

    multi, imgs_l, imgs_r = multi_state
    S = imgs_l.shape[1]
    step = multi_mod.batched_frontend_step(multi.fe, multi.rc, True)
    prev = multi_mod.batch_slots([odometer.empty_slots(multi.fe.num_features)] * S)
    usable = torch.zeros(S, dtype=torch.bool, device="cuda")
    ok = True
    for i in range(PROGRAM_MULTI_STEPS):
        il, ir = torch.as_tensor(imgs_l[i]).cuda(), torch.as_tensor(imgs_r[i]).cuda()

        def smp():
            return [v._gumbel_for_frame(i) for v in multi.vos]

        res_e = step(il, ir, prev, usable, smp(), multi.rig_batch, multi.max_d, multi.steer)
        res_c = odometer.batched_frontend_step_program(il, ir, prev, usable, smp(),
                                                       multi.rig_batch, multi.max_d, multi.fe,
                                                       multi.rc, multi.steer)
        ok = ok and _bits_equal(res_c, res_e)
        prev, usable = res_e.slots, torch.ones(S, dtype=torch.bool, device="cuda")
    rec["multi_seq"] = {"sequences": S, "steps": PROGRAM_MULTI_STEPS, "bits_equal": ok}
    log(f"programs, front end: VO {n} frames bits equal {rec['vo_bits_equal']}; chains "
        + ", ".join(f"K = {k} {rec[f'chain_k{k}']['bits_equal']}" for k in PROGRAM_CHAIN_KS)
        + f"; multi-sequence S = {S} x {PROGRAM_MULTI_STEPS} steps {ok}; kernels per step "
        f"{rec['step_nodes']}; chain captures {[rec[f'chain_k{k}']['capture_ms'] for k in PROGRAM_CHAIN_KS]}")
    return rec


PROGRAM_GENERAL_K = 4
PROGRAM_GENERAL_WORDS = 1024   # the shipped vocabulary's size


def _program_general(g, multi_state, frames=GENERAL_FRAMES, k=PROGRAM_GENERAL_K,
                     device="cuda"):
    """The general (distorted) rig's captured programs against their eager
    bodies, bit for bit: `frames` VO frames of `track` (one replay each)
    against one eager `frontend_chain` over the same frames and RANSAC
    draws; `frontend_chain_bow_program` against `frontend_chain_bow` in
    K = 4 chains over those frames with a random 1024-word vocabulary
    (carry, results, top-k, database, size and bank rings); phase 11's
    stacked two-rig multi-sequence step against the eager batched step over
    its GENERAL_MULTI_STEPS steps. On the card also a VO frame's kernels
    and device ms, captured and eager (torch.profiler over 20 frames). On
    the CPU (a rehearsal) the programs run their bodies as they are."""
    import torch

    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend import odometer
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.ops import orb
    from stereo_orb_slam_torch.parallel import multi_seq as multi_mod
    from stereo_orb_slam_torch.utils import programs
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("EuRoc", g["vo"])[:frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    n = len(imgs)
    rig = calib.load_camera(g["camera"], device=device)
    fe, rc = FrontendConfig(), RansacConfig()
    steer, md = orb.steer_table(fe.oriented, rig.device), rig.max_sensible_distance()
    L = torch.as_tensor(np.stack([a for a, _ in imgs])).to(device)
    R = torch.as_tensor(np.stack([b for _, b in imgs])).to(device)
    draws = VisualOdometer(WorldMap(), rig)   # the VO's per-frame samplers (seed 0)

    def samplers(lo, hi):
        return [draws._gumbel_for_frame(i) for i in range(lo, hi)]

    vo = VisualOdometer(WorldMap(), rig)
    got = []
    for il, ir in imgs:
        vo.track(il, ir)
        got.append(vo.last_result)
    _, want = odometer.frontend_chain(L, R, odometer.empty_slots(fe.num_features, device), False,
                                      samplers(0, n), rig, md, fe, rc, False, steer)
    rec = {"vo_frames": n,
           "vo_bits_equal": all(_bits_equal(got[j], odometer._select(want, j))
                                for j in range(n))}
    if _is_cuda(device):
        # Device time and kernels of a general VO frame, captured and eager:
        # 20 `track` calls under torch.profiler after 5.
        rec["vo_frame_device"] = {}
        for mode, ctx in (("captured", contextlib.nullcontext), ("eager", _eager_programs)):
            with ctx():
                v = VisualOdometer(WorldMap(), rig)
                for il, ir in imgs[:5]:
                    v.track(il, ir)
                kernels, dev_ms = _kernels_in(lambda: [v.track(il, ir) for il, ir in imgs[5:25]])
            rec["vo_frame_device"][mode] = {"kernels": kernels / 20, "device_ms": dev_ms / 20}

    gen = torch.Generator().manual_seed(3)
    centroids = torch.randint(-2 ** 31, 2 ** 31 - 1, (PROGRAM_GENERAL_WORDS, 8), generator=gen,
                              dtype=torch.int32).to(device)
    idf = (torch.rand(PROGRAM_GENERAL_WORDS, generator=gen) + 0.5).to(device)
    capacity = 2 * n
    state = {mode: [(odometer.empty_slots(fe.num_features, device), False),
                    torch.zeros((capacity, PROGRAM_GENERAL_WORDS), device=device),
                    torch.zeros((), dtype=torch.int64, device=device),
                    odometer.empty_banks(capacity, fe.num_features, device)]
             for mode in ("eager", "captured")}
    cache = programs.ProgramCache()
    ok = True
    for lo in range(0, n - k + 1, k):
        args = (L[lo:lo + k], R[lo:lo + k])
        carry, db, size, banks = state["eager"]
        out_e = odometer.frontend_chain_bow(*args, *carry, samplers(lo, lo + k), rig, md, fe, rc,
                                            False, steer, centroids, idf, db, size, 4, banks)
        carry, db, size, banks = state["captured"]
        out_c = odometer.frontend_chain_bow_program(*args, *carry, samplers(lo, lo + k), rig, md,
                                                    fe, rc, steer, centroids, idf, db, size, 4,
                                                    banks, cache=cache)
        ok = ok and _bits_equal(out_c[:6], out_e[:6])
        for mode, out in (("eager", out_e), ("captured", out_c)):
            state[mode][:3] = [out[0], out[4], out[5]]
    ok = ok and _bits_equal(state["captured"][3], state["eager"][3])
    rec[f"chain_bow_k{k}"] = {"chains": n // k, "bits_equal": ok,
                              "database_rows": int(state["eager"][2]),
                              "capture_ms": {a: b["capture_ms"] for a, b in cache.stats.items()},
                              "replays": {a: b["replays"] for a, b in cache.stats.items()}}
    prog = next(iter(cache._programs.values()))
    rec["step_nodes"] = _body_kernels(prog, ("step",))["step"] if _is_cuda(device) else None
    cache.clear()

    multi, imgs_l, imgs_r = multi_state
    S, steps = imgs_l.shape[1], imgs_l.shape[0]
    step = multi_mod.batched_frontend_step(multi.fe, multi.rc, False)
    prev = multi_mod.batch_slots([odometer.empty_slots(multi.fe.num_features, device)] * S)
    usable = torch.zeros(S, dtype=torch.bool, device=device)
    ok = True
    for i in range(steps):
        il, ir = torch.as_tensor(imgs_l[i]).to(device), torch.as_tensor(imgs_r[i]).to(device)

        def smp():
            return [v._gumbel_for_frame(i) for v in multi.vos]

        res_e = step(il, ir, prev, usable, smp(), multi.rig_batch, multi.max_d, multi.steer)
        res_c = odometer.batched_frontend_step_program(il, ir, prev, usable, smp(),
                                                       multi.rig_batch, multi.max_d, multi.fe,
                                                       multi.rc, multi.steer)
        ok = ok and _bits_equal(res_c, res_e)
        prev, usable = res_e.slots, torch.ones(S, dtype=torch.bool, device=device)
    rec["multi_seq"] = {"sequences": S, "steps": steps, "bits_equal": ok}
    log(f"programs, general rig: VO {n} frames bits equal {rec['vo_bits_equal']}, a frame's "
        f"kernels and device ms {rec.get('vo_frame_device')}; BoW chains "
        f"K = {k} {rec[f'chain_bow_k{k}']['bits_equal']} ({rec[f'chain_bow_k{k}']['chains']} "
        f"chains, {rec[f'chain_bow_k{k}']['database_rows']} database rows); multi-sequence "
        f"S = {S} x {steps} steps {ok}; kernels per step {rec['step_nodes']}; captures "
        f"{rec[f'chain_bow_k{k}']['capture_ms']}")
    return rec


def _multi_seq_rate(multi_state, steps=30):
    """Steps/s of a fresh MultiSequenceSLAM over `steps` steps (after 2)."""
    import torch

    from stereo_orb_slam_torch.parallel.multi_seq import MultiSequenceSLAM

    multi, imgs_l, imgs_r = multi_state
    m = MultiSequenceSLAM([multi.vos[s].rig for s in range(len(multi.vos))])
    for i in range(2):
        m.process(imgs_l[i], imgs_r[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 2 + steps):
        m.process(imgs_l[i], imgs_r[i])
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def _program_memory():
    """What the process's program cache holds on the card: each program's
    static tensors (bytes, largest first), and the allocator's allocated
    and reserved bytes."""
    import torch

    from stereo_orb_slam_torch.utils import programs

    def nbytes(x, seen):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cuda" or x.data_ptr() in seen:
                return 0
            seen.add(x.data_ptr())
            return x.untyped_storage().nbytes()
        if isinstance(x, (tuple, list)):
            return sum(nbytes(y, seen) for y in x)
        return 0

    held = sorted(((type(p).__name__, nbytes(list(vars(p).values()), set()))
                   for p in programs.PROGRAMS._programs.values()), key=lambda e: -e[1])
    return {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
            "static_bytes": held}


def phase_programs_profile(seq, window, slam_graph, path, frames=20, warm=5, lm_iters=3):
    """torch.profiler, captured and then eager (`_eager_programs`): `frames`
    VO frames through `track` after `warm`, one pose-graph solve of phase
    7's final graph after a warm one, and `lm_iters` LM iterations of the
    last window problem after a warm solve. Device busy, idle share and
    kernels per unit, to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.backend import ba, pose_graph
    from stereo_orb_slam_torch.config import BAConfig, PoseGraphConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.worldmap import WorldMap

    pairs = datasets.load_dataset("kitti", seq)[: warm + frames]
    imgs = [(datasets.read_grayscale(a), datasets.read_grayscale(b)) for a, b in pairs]
    rig = calib.load_camera(os.path.join(seq, "calib.txt"))
    vm = np.ones(len(slam_graph[0]), np.float32)
    vm[0] = 0.0
    graph = pose_graph.PoseGraphProblem(
        *(torch.as_tensor(x, device="cuda") for x in slam_graph),
        edge_weight=torch.ones(len(slam_graph[1]), device="cuda"),
        vertex_mask=torch.as_tensor(vm, device="cuda"))
    world, start, end = window
    adj = ba.BundleAdjuster(copy.deepcopy(world), rig, BAConfig())
    setup = adj.prepare(start, end)
    cfg = dataclasses.replace(adj.cfg, function_tolerance=0.0)

    def profiled(fn, per, unit):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return _device_summary(prof, wall_ms, per, unit=unit)

    report = {}
    for mode, ctx in (("captured", contextlib.nullcontext), ("eager", _eager_programs)):
        with ctx():
            vo = VisualOdometer(WorldMap(), rig)
            for il, ir in imgs[:warm]:
                vo.track(il, ir)
            rep = {"vo_frame": profiled(lambda: [vo.track(il, ir) for il, ir in imgs[warm:]],
                                        frames, "frame")}
            pose_graph.pg_solve_program(graph, PoseGraphConfig())
            rep["pg_solve"] = profiled(
                lambda: float(pose_graph.pg_solve_program(graph, PoseGraphConfig())[2]), 1,
                "solve")
            prog = ba.lm_program(setup.prob, cfg, setup.dense_K, setup.cam_K, setup.band)
            ba.full_f32(prog.solve)(setup.prob, 1)   # as BundleAdjuster runs it
            rep["window_lm_iteration"] = profiled(lambda: ba.full_f32(prog.iterate)(lm_iters),
                                                  lm_iters, "lm_iteration")
        for rec in rep.values():
            rec["kernels"] = rec["kernels"][:12]
        report[mode] = rep
        for name, r in rep.items():
            per = [k for k in r if k.startswith("device_launches_per_")][0]
            log(f"programs profile ({mode}), {name}: {r['wall_ms']:.2f} ms wall, device busy "
                f"{r['device_busy_ms']:.3f} ms (idle share {r['device_idle_share']:.3f}), "
                f"{r[per]:.0f} kernels per unit seen")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    log(f"programs profile in {path}")
    return report


def phase_programs(seq, gt, window, slam_graph, multi_state, slam_data, canyon_data, tmp,
                   captured, general_data, general_multi_state):
    """Phase 13: every captured unit against its eager body, bit for bit
    (the pose graph on phase 7's final graph, the window and map BA solves,
    60 VO frames, K = 4 and K = 32 chains, S = 3 multi-sequence steps; on
    the general rig 60 VO frames, K = 4 chains with BoW and S = 2 x 20
    multi-sequence steps), the eager-against-captured unit figures, then
    the main path, the SLAM app at K = 1 and 4, the canyon drive,
    multi-sequence tracking and the general rig's VO, SLAM and
    multi-sequence runs again with every program run eagerly
    (`_eager_programs`): their gates hold there too, and their figures
    stand beside the captured runs of phases 4, 7, 8, 11 and 12
    (`captured`)."""
    from stereo_orb_slam_torch.utils import programs

    rec = {"pose_graph": _program_pose_graph(slam_graph), "ba": _program_ba(seq, window),
           "front_end": _program_front_end(seq, multi_state),
           "general": _program_general(general_data, general_multi_state)}
    fe, gen = rec["front_end"], rec["general"]
    bits = {"pose_graph": rec["pose_graph"]["bits_equal"],
            **{f"ba_{k}": v["bits_equal"] for k, v in rec["ba"].items()},
            "vo": fe["vo_bits_equal"], "multi_seq": fe["multi_seq"]["bits_equal"],
            **{f"chain_k{k}": fe[f"chain_k{k}"]["bits_equal"] for k in PROGRAM_CHAIN_KS},
            "general_vo": gen["vo_bits_equal"],
            f"general_chain_bow_k{PROGRAM_GENERAL_K}":
                gen[f"chain_bow_k{PROGRAM_GENERAL_K}"]["bits_equal"],
            "general_multi_seq": gen["multi_seq"]["bits_equal"]}
    rec["bits_equal"] = bits
    if not all(bits.values()):
        raise AssertionError(f"programs: a captured unit differs from its eager body: {bits}")

    slam_seq, slam_gt = slam_data
    multi_captured = _multi_seq_rate(multi_state)
    with _eager_programs():
        vo, _ = phase_main_path(seq, gt, os.path.join(tmp, "vo_out_eager"))
        slam = {k: phase_slam(slam_seq, slam_gt, os.path.join(tmp, f"slam_eager_{k}"), k)[0]
                for k in (1, 4)}
        canyon = phase_canyon_slam(canyon_data, os.path.join(tmp, "canyon_eager"))
        multi_eager = _multi_seq_rate(multi_state)
        general = {
            "vo": phase_general_vo(general_data, os.path.join(tmp, "general_eager"),
                                   vo["median_ms"]),
            "slam": phase_general_slam(general_data, os.path.join(tmp, "general_slam_eager")),
            "multi_seq": phase_general_multi_seq(general_data)[0]}

    def pick(r, keys):
        return {k: r[k] for k in keys}

    slam_keys = ("live_fps", "fps", "median_ms", "finish_seconds", "live_stall_splits",
                 "ate_m")
    rec["end_to_end"] = {
        "vo": {"captured": pick(captured["vo"], ("fps", "median_ms", "ate_m")),
               "eager": pick(vo, ("fps", "median_ms", "ate_m"))},
        **{f"slam_k{k}": {"captured": pick(captured["slam"][k], slam_keys),
                          "eager": pick(slam[k], slam_keys),
                          "stall_s": {"captured": [h["wall_seconds"] for h in
                                                   captured["slam"][k]["closures"] if h["live"]],
                                      "eager": [h["wall_seconds"] for h in slam[k]["closures"]
                                                if h["live"]]}}
           for k in (1, 4)},
        "canyon": {"captured": pick(captured["canyon"], ("live_fps", "median_ms",
                                                         "finish_seconds", "ate_m")),
                   "eager": pick(canyon, ("live_fps", "median_ms", "finish_seconds", "ate_m"))},
        "multi_seq_steps_per_s": {"captured": multi_captured, "eager": multi_eager},
        "general_vo": {m: pick(r["vo"], ("fps", "median_ms", "ate_m"))
                       for m, r in (("captured", captured["general"]), ("eager", general))},
        "general_slam": {m: pick(r["slam"], ("live_fps", "median_ms", "finish_seconds",
                                             "ate_m"))
                         for m, r in (("captured", captured["general"]), ("eager", general))},
        "general_multi_seq_ms_per_step": {m: r["multi_seq"]["ms_per_step"] for m, r in
                                          (("captured", captured["general"]),
                                           ("eager", general))},
    }
    rec["programs"] = programs.PROGRAMS.summary()
    e2e = rec["end_to_end"]
    log("programs, eager against captured: VO median "
        f"{e2e['vo']['eager']['median_ms']:.2f} -> {e2e['vo']['captured']['median_ms']:.2f} ms"
        + "".join(f"; SLAM K = {k} live fps {e2e[f'slam_k{k}']['eager']['live_fps']:.2f} -> "
                  f"{e2e[f'slam_k{k}']['captured']['live_fps']:.2f}, finish "
                  f"{e2e[f'slam_k{k}']['eager']['finish_seconds']:.2f} -> "
                  f"{e2e[f'slam_k{k}']['captured']['finish_seconds']:.2f} s, stalls "
                  f"{e2e[f'slam_k{k}']['stall_s']['eager']} -> "
                  f"{e2e[f'slam_k{k}']['stall_s']['captured']} s" for k in (1, 4))
        + f"; canyon live fps {e2e['canyon']['eager']['live_fps']:.2f} -> "
        f"{e2e['canyon']['captured']['live_fps']:.2f}, median "
        f"{e2e['canyon']['eager']['median_ms']:.2f} -> "
        f"{e2e['canyon']['captured']['median_ms']:.2f} ms, finish "
        f"{e2e['canyon']['eager']['finish_seconds']:.2f} -> "
        f"{e2e['canyon']['captured']['finish_seconds']:.2f} s; multi-sequence "
        f"{multi_eager:.2f} -> {multi_captured:.2f} steps/s; general VO median "
        f"{e2e['general_vo']['eager']['median_ms']:.2f} -> "
        f"{e2e['general_vo']['captured']['median_ms']:.2f} ms, general SLAM live fps "
        f"{e2e['general_slam']['eager']['live_fps']:.2f} -> "
        f"{e2e['general_slam']['captured']['live_fps']:.2f}, finish "
        f"{e2e['general_slam']['eager']['finish_seconds']:.2f} -> "
        f"{e2e['general_slam']['captured']['finish_seconds']:.2f} s, general multi-sequence "
        f"{e2e['general_multi_seq_ms_per_step']['eager']:.2f} -> "
        f"{e2e['general_multi_seq_ms_per_step']['captured']:.2f} ms per step")
    return rec


# The distributed phase (BASELINE.json config 5): bounds of
# tests/test_dist_ba.py and tests/test_dist_pose_graph.py for ranks above 1
# (their sums run in another order); 1 rank is held bit for bit against
# the same code with no process group.
DIST_LM_ITERATIONS = 6
DIST_COST_RTOL, DIST_COST_ATOL = 1e-3, 1e-4
DIST_POSE_ATOL, DIST_POINT_ATOL = 5e-3, 2e-2
DIST_PG_ATOL = 2e-3
DIST_GLOO_RANKS = (2, 4)
DIST_PG_GLOO_RANKS = (4,)   # the pose graph's gloo run (2,030 all_reduces a solve)


def _rig_numpy(rig):
    return {"left": {k: v.cpu().numpy() for k, v in rig.left._asdict().items()},
            "right": {k: v.cpu().numpy() for k, v in rig.right._asdict().items()},
            "rectified": rig.rectified, "baseline": rig.baseline.cpu().numpy()}


def _collectives():
    from stereo_orb_slam_torch.parallel import mesh as mesh_mod

    return mesh_mod.ALL_REDUCES, mesh_mod.ALL_REDUCE_BYTES


def _dist_solves(mesh, world, rig_np, map_size, graph, iters=DIST_LM_ITERATIONS, warm=True):
    """On this rank: DistributedBundleAdjuster (both layouts) over copies of
    the tracked world, the point-aligned solve of the map problem, and the
    pose graph when `graph` is given. Per solve: results as NumPy, wall ms
    per LM iteration (host set-up, solve and write-back; lm_init counted in
    the map solve's), all_reduces and their bytes per LM iteration, peak
    device memory. `warm`: each solve first runs once off the clock (the
    process's first use of its shapes)."""
    import torch

    from stereo_orb_slam_torch import convert
    from stereo_orb_slam_torch.config import BAConfig, PoseGraphConfig
    from stereo_orb_slam_torch.parallel import dist_ba, dist_pose_graph

    dev = mesh.device
    rig = convert.rig_from_numpy(rig_np, dev)
    out = {}

    cuda = _is_cuda(dev)

    def measured(fn, n_it):
        _sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        n0, b0 = _collectives()
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        n1, b1 = _collectives()
        return res, {"ms_per_iteration": ms / n_it, "all_reduces_per_iteration": (n1 - n0) / n_it,
                     "all_reduce_bytes_per_iteration": (b1 - b0) / n_it,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}

    for scheme in ("point_aligned", "obs"):
        w = copy.deepcopy(world)
        adj = dist_ba.DistributedBundleAdjuster(w, rig, mesh, BAConfig(max_iterations=iters),
                                                scheme=scheme)
        if warm:
            dist_ba.DistributedBundleAdjuster(copy.deepcopy(world), rig, mesh,
                                              BAConfig(max_iterations=1),
                                              scheme=scheme).optimize(0, world.num_frames)
        stats, m = measured(lambda: adj.optimize(0, w.num_frames), iters)
        out[f"window_{scheme}"] = dict(m, stats=stats, poses=w.pose_global[:w.num_frames].copy(),
                                       points=w.points[:w.num_points].copy())

    shard = dist_ba.place_point_aligned(mesh, *dist_ba.build_point_aligned(
        *(x.numpy() for x in _map_host(map_size)), mesh.size))
    cfg = BAConfig(cg_iterations=40, function_tolerance=0.0)
    solve = dist_ba.sharded_ba_solve_point_aligned(mesh, cfg)
    if warm:
        solve(shard, 1)
    (carry, n_it, c0), m = measured(lambda: solve(shard, iters), iters)
    out["map"] = dict(m, iterations=int(n_it), cost_initial=float(c0), cost=float(carry.cost),
                      pose6=carry.prob.pose6.cpu().numpy())

    if graph is not None:
        if warm:
            dist_pose_graph.solve(*graph, mesh, PoseGraphConfig(iterations=1))
        (poses, costs), m = measured(lambda: dist_pose_graph.solve(*graph, mesh), 1)
        out["pose_graph"] = dict(m, poses=poses, costs=costs)
    return out


def _dist_gloo_rank(rank, world_size, world, rig_np, map_size, graph):
    """A spawned gloo rank on the card (all ranks share cuda:0): the solves
    of _dist_solves, not warmed (gloo ranks on one card are timed for
    their collectives' count, not their speed)."""
    import torch

    from stereo_orb_slam_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    return _dist_solves(make_mesh(device="cuda:0"), world, rig_np, map_size, graph,
                        warm=False)


def _graph_numpy(prob):
    return (prob.poses.cpu().numpy(), prob.edge_a.cpu().numpy(), prob.edge_b.cpu().numpy(),
            prob.edge_meas.cpu().numpy())


def _pose_gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def phase_distributed(tmp, seq, world, slam_graph, map_size=MAP_SIZE):
    """Distributed BA and pose graph on the card (parallel/): at 1 rank
    under NCCL in this process, held bit for bit against the same code
    with no process group; at 2 and 4 gloo ranks spawned on cuda:0, held
    against the single-process card solve within the DIST_* bounds; every
    rank's replica the same. The tracked 60-frame world (both layouts),
    the map problem (point-aligned, matrix-free) and the SLAM phase's final
    pose graph, each DIST_LM_ITERATIONS LM iterations (the graph
    PoseGraphConfig's 10 GN steps). Also ms, all_reduces and bytes per LM
    iteration, peak memory per rank, and device syncs per LM iteration at 1
    NCCL rank (the single-process count expected)."""
    import torch

    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.backend.ba import BundleAdjuster
    from stereo_orb_slam_torch.config import BAConfig, PoseGraphConfig
    from stereo_orb_slam_torch.io import calib
    from stereo_orb_slam_torch.parallel import dist_ba, multihost
    from stereo_orb_slam_torch.parallel.mesh import Mesh, make_mesh

    dev = torch.device("cuda", 0)
    rig = calib.load_camera(os.path.join(seq, "calib.txt"))
    rig_np = _rig_numpy(rig)
    iters = DIST_LM_ITERATIONS
    rec = {}

    # The single-process card solves the ranks are held against.
    w = copy.deepcopy(world)
    BundleAdjuster(w, rig, BAConfig(max_iterations=iters)).optimize(0, w.num_frames)
    ref_window = (w.pose_global[:w.num_frames].copy(), w.points[:w.num_points].copy())
    ref_map, _, _, _, _ = _map_solve("cuda", map_size, iters)
    vm = np.ones(len(slam_graph[0]), np.float32)
    vm[0] = 0.0
    pg_prob = pose_graph.PoseGraphProblem(
        *(torch.as_tensor(x, device=dev) for x in slam_graph),
        edge_weight=torch.ones(len(slam_graph[1]), device=dev),
        vertex_mask=torch.as_tensor(vm, device=dev))
    ref_pg = pose_graph.pg_solve(pg_prob, PoseGraphConfig())[0].poses.cpu().numpy()

    def held(name, got):
        """Gaps of one rank's results to the single-process solves."""
        g = {f"window_{s}": (_pose_gap(got[f"window_{s}"]["poses"], ref_window[0]),
                             _pose_gap(got[f"window_{s}"]["points"], ref_window[1]))
             for s in ("point_aligned", "obs")}
        g["map"] = (_pose_gap(got["map"]["pose6"], ref_map.prob.pose6.cpu().numpy()),
                    abs(got["map"]["cost"] - float(ref_map.cost)) / float(ref_map.cost))
        if "pose_graph" in got:
            g["pose_graph"] = _pose_gap(got["pose_graph"]["poses"], ref_pg)
        for key in ("window_point_aligned", "window_obs"):
            if g[key][0] > DIST_POSE_ATOL or g[key][1] > DIST_POINT_ATOL:
                raise AssertionError(f"{name}: {key} differs from the single-process solve "
                                     f"by {g[key]}")
        if g["map"][0] > DIST_POSE_ATOL or g["map"][1] > DIST_COST_RTOL:
            raise AssertionError(f"{name}: map solve differs from single-process by {g['map']}")
        if g.get("pose_graph", 0.0) > DIST_PG_ATOL:
            raise AssertionError(f"{name}: pose graph differs by {g['pose_graph']}")
        return g

    def summary(got):
        return {k: {f: v[f] for f in ("ms_per_iteration", "all_reduces_per_iteration",
                                      "all_reduce_bytes_per_iteration", "peak_bytes")}
                for k, v in got.items()}

    # 1 rank under NCCL, in this process.
    multihost.initialize(init_method="file://" + os.path.join(tmp, "nccl_store"),
                         num_processes=1, process_id=0, backend="nccl")
    try:
        nccl = make_mesh(device=dev)
        got = _dist_solves(nccl, world, rig_np, map_size, slam_graph)
        alone = _dist_solves(Mesh(None, 0, 1, dev), world, rig_np, map_size, slam_graph)
        identical = {}
        for key in got:
            fields = [f for f in ("poses", "points", "pose6") if f in got[key]]
            identical[key] = all(np.array_equal(got[key][f], alone[key][f]) for f in fields)
        # Device syncs per LM iteration: the map solve with the NCCL group
        # and without one.
        shard = dist_ba.place_point_aligned(nccl, *dist_ba.build_point_aligned(
            *(x.numpy() for x in _map_host(map_size)), 1))
        cfg = BAConfig(cg_iterations=40, function_tolerance=0.0)
        _, syncs_nccl = _syncs_per_call(
            lambda: dist_ba.sharded_ba_solve_point_aligned(nccl, cfg)(shard, 2))
        _, syncs_alone = _syncs_per_call(
            lambda: dist_ba.sharded_ba_solve_point_aligned(Mesh(None, 0, 1, dev), cfg)(shard, 2))
    finally:
        multihost.shutdown()
    rec["nccl_1"] = {"identical_to_no_group": identical, "gaps_to_single": held("nccl x1", got),
                     "per_solve": summary(got), "per_solve_no_group": summary(alone),
                     "syncs_per_lm_iteration": syncs_nccl / 2,
                     "syncs_per_lm_iteration_no_group": syncs_alone / 2}
    log(f"distributed, 1 NCCL rank: bit for bit against no group {identical}; gaps to the "
        f"single-process solves {rec['nccl_1']['gaps_to_single']}; syncs per LM iteration "
        f"{syncs_nccl / 2} (no group: {syncs_alone / 2}); per solve {rec['nccl_1']['per_solve']}"
        f"; with no group {rec['nccl_1']['per_solve_no_group']}")
    if not all(identical.values()):
        raise AssertionError(f"1 NCCL rank is not bit for bit the solve with no group: {identical}")
    if syncs_nccl != syncs_alone:
        raise AssertionError(f"1 NCCL rank syncs {syncs_nccl} times, no group {syncs_alone}")

    for n in DIST_GLOO_RANKS:
        t0 = time.perf_counter()
        graph = slam_graph if n in DIST_PG_GLOO_RANKS else None
        outs = multihost.launch(_dist_gloo_rank, n, backend="gloo", timeout_s=600,
                                args=(world, rig_np, map_size, graph))
        wall_s = time.perf_counter() - t0
        for other in outs[1:]:
            for key in ("window_point_aligned", "window_obs"):
                for f in ("poses", "points"):
                    if not np.array_equal(other[key][f], outs[0][key][f]):
                        raise AssertionError(f"gloo x{n}: ranks hold different {key} {f}")
            if graph is not None and not np.array_equal(other["pose_graph"]["poses"],
                                                        outs[0]["pose_graph"]["poses"]):
                raise AssertionError(f"gloo x{n}: ranks hold different pose graphs")
        rec[f"gloo_{n}"] = {"gaps_to_single": held(f"gloo x{n}", outs[0]),
                            "per_solve_rank0": summary(outs[0]),
                            "peak_bytes_per_rank": [o["map"]["peak_bytes"] for o in outs],
                            "spawn_wall_s": wall_s}
        log(f"distributed, {n} gloo ranks on one card (correctness and collective counts, not "
            f"scaling): gaps to single {rec[f'gloo_{n}']['gaps_to_single']}; rank 0 per solve "
            f"{rec[f'gloo_{n}']['per_solve_rank0']}; map peak bytes per rank "
            f"{rec[f'gloo_{n}']['peak_bytes_per_rank']}; {wall_s:.1f} s with the spawn")
    return rec


def _map_host(map_size):
    """The map problem's arrays for build_point_aligned (CPU tensors)."""
    p = make_map_problem("cpu", **map_size)
    return (p.pose6, p.points, p.obs_cam, p.obs_point, p.obs_uv, p.cam_mask, p.P_l, p.P_r)


def phase_refine_torchrun(tmp, seq, gt, iterations=50):
    """`apps.refine --distributed` under torchrun (one NCCL rank) over the
    dump phase 6c wrote: cost not above its initial value, ATE < 0.01 m."""
    from stereo_orb_slam_torch.io import export
    from stereo_orb_slam_torch.utils import evaluate

    out = os.path.join(tmp, "refined_torchrun")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           "-m", "stereo_orb_slam_torch.apps.refine", "--input_dir", os.path.join(tmp, "dump"),
           "--camera", os.path.join(seq, "calib.txt"), "--output_dir", out, "--iterations",
           str(iterations), "--distributed", "--backend", "nccl", "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun refine failed ({proc.returncode}):\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    line = [ln for ln in (proc.stdout + proc.stderr).splitlines() if "global BA:" in ln][-1]
    poses = export.read_poses_txt(os.path.join(out, "poses.txt"))
    ate = evaluate.ate_rmse(poses, evaluate.load_kitti_gt(gt)[:len(poses)])
    log(f"refine --distributed under torchrun (1 NCCL rank): {wall_s:.1f} s wall with the "
        f"launch; {line.strip()[:300]}; ATE {ate:.5f} m")
    if not ate < 0.01:
        raise AssertionError(f"torchrun refine: ATE {ate} m is not below 0.01 m")
    return {"wall_s": wall_s, "ate_m": ate, "log": line.strip()}


def phase_scaling_bench():
    """apps.scaling_bench at 1 NCCL rank: LM iterations/s of the sharded LM
    step on its C = 200, P = 20,000 problem (CUDA events)."""
    from stereo_orb_slam_torch.apps import scaling_bench

    res = scaling_bench.run([1], n_iter=8, device="cuda", backend="nccl")["1"]
    log(f"scaling_bench, 1 NCCL rank (C=200, P=20000, O=120000, cg 25): "
        f"{res['ba_iterations_per_sec']:.2f} LM iterations/s, {res['all_reduces_per_iteration']:.0f}"
        f" all_reduces per iteration, peak {res['peak_bytes'] / 2**20:.1f} MiB")
    return res


def phase_dist_profile(path, map_size=MAP_SIZE, iters=3):
    """torch.profiler over `iters` LM iterations of the point-aligned map
    solve at 1 NCCL rank (launches, device busy, idle share, all_reduce
    kernels), to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.config import BAConfig
    from stereo_orb_slam_torch.parallel import dist_ba, multihost
    from stereo_orb_slam_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(init_method="file://" + os.path.join(tmp, "store"),
                             num_processes=1, process_id=0, backend="nccl")
        try:
            mesh = make_mesh(device="cuda:0")
            shard = dist_ba.place_point_aligned(mesh, *dist_ba.build_point_aligned(
                *(x.numpy() for x in _map_host(map_size)), 1))
            solve = dist_ba.sharded_ba_solve_point_aligned(
                mesh, BAConfig(cg_iterations=40, function_tolerance=0.0))
            solve(shard, 1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solve(shard, iters)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            multihost.shutdown()
    rep = _device_summary(prof, wall_ms, iters + 1)   # lm_init counted as one
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    top = ", ".join(f"{k['name'][:40]} {k['device_us_per_lm_iteration']:.1f} us"
                    for k in rep["kernels"][:6])
    log(f"distributed profile (map, point-aligned, 1 NCCL rank): "
        f"{wall_ms / (iters + 1):.2f} ms wall per LM iteration, device busy "
        f"{rep['device_busy_ms'] / (iters + 1):.3f} ms (idle share "
        f"{rep['device_idle_share']:.3f}), {rep['device_launches_per_lm_iteration']:.0f} launches "
        f"per LM iteration; top: {top}; in {path}")
    return rep


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also profile 20 frames of the main path (breakdown written to "
                         "PATH) and of the general rig (_general before the extension), "
                         "10 oriented frames with the fused kernel and with the "
                         "chain it replaced (_oriented before the extension), 3 LM "
                         "iterations of a window and of the map problem (_ba) and 20 SLAM "
                         "frames and a pose-graph solve (_slam)")
    ap.add_argument("--out", metavar="DIR", default=None,
                    help="also write the long canyon drive's pose graphs and the card's CG "
                         "counts to DIR/canyon_long_graphs.npz (for tests/pg_cg_witness.py)")
    args = ap.parse_args(argv)
    phase_card()
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # synth, synth_ba
    import torch

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t
        log(f"[{name}: {seconds[name]:.1f} s]")
        return out

    timed("build", phase_build)
    records, floor_ms = timed("kernels", phase_kernels, rng)
    records += timed("kernels_batched", phase_batched_kernels, rng)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        long_render = _start_canyon_long_render(tmp)
        stack.callback(_stop, long_render[0])
        seq, gt = timed("render", _render_sequence, tmp, N_FRAMES)
        timed("cuda_vs_cpu", phase_cuda_vs_cpu, seq)
        summary, launches = timed("main_path", phase_main_path, seq, gt,
                                  os.path.join(tmp, "vo_out"))
        oriented = timed("oriented", phase_oriented, seq, gt)
        general_data = timed("render_general", _render_general, tmp)
        general = {"vo": timed("general", phase_general_vo, general_data,
                               os.path.join(tmp, "general_out"), summary["median_ms"]),
                   "cuda_vs_cpu": timed("general_devices", phase_general_devices, general_data,
                                        seq),
                   "slam": timed("general_slam", phase_general_slam, general_data,
                                 os.path.join(tmp, "general_slam_out")),
                   "multi_seq": None}
        general["multi_seq"], general_multi_state = timed(
            "general_multi_seq", phase_general_multi_seq, general_data)
        records += timed("general_kernels", phase_path_kernels, "general", "EuRoc",
                         general_data["vo"], general_data["camera"], False, GENERAL_DESC_FLIPS)
        multi_seq, multi_state = timed("multi_seq", phase_multi_seq, seq)
        ba_world, tracking, window = timed("ba_tracking", phase_ba_tracking, seq, gt)
        dist_world = copy.deepcopy(ba_world)
        ba = {"tracking": tracking,
              "cuda_vs_cpu": timed("ba_devices", phase_ba_devices, seq, window),
              "refine": timed("ba_refine", phase_ba_refine, seq, gt, ba_world, tmp),
              "recovery": timed("ba_recovery", phase_ba_recovery, seq, gt, ba_world),
              "banded": timed("ba_banded", phase_ba_banded),
              "map": timed("ba_map", phase_ba_map)}
        slam_seq, slam_gt = timed("render_slam", _render_sequence, os.path.join(tmp, "slam"),
                                  len(SLAM_STEPS), SLAM_STEPS)
        first_call = timed("slam_first_call", phase_slam_first_call)
        slam_runs = {}
        for k in (1, 4):
            slam_runs[k], system = timed(f"slam_k{k}", phase_slam, slam_seq, slam_gt,
                                         os.path.join(tmp, f"slam_out_{k}"), k)
            if k == 1:
                slam_devices = timed("slam_devices", phase_slam_devices, system)
                slam_graph = _graph_numpy(system.pgo.last_problem)
            del system
        canyon_data = timed("render_canyon", _render_canyon, tmp)
        canyon = {"slam": timed("canyon_slam", phase_canyon_slam, canyon_data,
                                os.path.join(tmp, "canyon_out")),
                  "cuda_vs_cpu": timed("canyon_devices", phase_canyon_devices, canyon_data),
                  "vo": timed("canyon_vo", phase_canyon_vo, canyon_data)}
        records += timed("canyon_kernels", phase_path_kernels, "canyon", "kitti",
                         canyon_data["folder"], canyon_data["camera"], True, CANYON_DESC_FLIPS)
        programs_rec = timed("programs", phase_programs, seq, gt, window, slam_graph,
                             multi_state, (slam_seq, slam_gt), canyon_data, tmp,
                             {"vo": summary, "slam": slam_runs, "canyon": canyon["slam"],
                              "general": general}, general_data, general_multi_state)
        long_data = timed("render_canyon_long_wait", _finish_canyon_long_render, *long_render)
        long_rec, long_system, long_graphs = timed(
            "canyon_long", phase_canyon_long, long_data, os.path.join(tmp, "canyon_long_out"))
        canyon_long = {"slam": long_rec, "render_seconds": long_data["render_seconds"]}
        canyon_long["edges"], long_edges = timed("canyon_long_edges", phase_canyon_long_edges,
                                                 long_system)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        canyon_long["cg"] = timed(
            "canyon_long_cg", phase_canyon_long_cg, long_graphs,
            os.path.join(args.out, "canyon_long_graphs.npz") if args.out else None)
        records += timed("canyon_long_kernels", phase_canyon_long_kernel, long_system,
                         long_edges)
        canyon_long["final_ba"] = timed("canyon_long_ba", phase_canyon_long_ba, long_system)
        if args.out:
            for name in ("trajectory_slam.txt", "loop_matches.txt"):
                shutil.copy(os.path.join(tmp, "canyon_long_out", name),
                            os.path.join(args.out, f"canyon_long_{name}"))
        del long_system, long_graphs
        gap = abs(slam_runs[4]["ate_m"] - slam_runs[1]["ate_m"])
        log(f"SLAM --batch_frames 4 against 1: ATE {slam_runs[4]['ate_m']:.5f} / "
            f"{slam_runs[1]['ate_m']:.5f} m, gap {gap:.3g} m")
        if not gap <= 1e-3:
            raise AssertionError("SLAM: --batch_frames 4 and 1 differ in ATE by more than "
                                 "1e-3 m")
        distributed = {
            "ba_pose_graph": timed("distributed", phase_distributed, tmp, seq, dist_world,
                                   slam_graph),
            "refine_torchrun": timed("refine_torchrun", phase_refine_torchrun, tmp, seq, gt),
            "scaling_bench": timed("scaling_bench", phase_scaling_bench),
        }
        if args.profile:
            root, ext = os.path.splitext(args.profile)
            timed("profile", phase_profile, seq, args.profile)
            timed("profile_general", phase_profile, general_data["vo"],
                  f"{root}_general{ext or '.json'}", dataset="EuRoc",
                  camera=general_data["camera"])
            timed("profile_oriented", phase_oriented_profile, seq,
                  f"{root}_oriented{ext or '.json'}")
            timed("profile_multi_seq", phase_multi_seq_profile, multi_state,
                  f"{root}_multi_seq{ext or '.json'}")
            timed("profile_dist", phase_dist_profile, f"{root}_dist{ext or '.json'}")
            timed("profile_ba", phase_ba_profile, seq, window, f"{root}_ba{ext or '.json'}")
            timed("profile_slam", phase_slam_profile, slam_seq,
                  f"{root}_slam{ext or '.json'}")
            timed("profile_programs", phase_programs_profile, seq, window, slam_graph,
                  f"{root}_programs{ext or '.json'}")
    paths = {"main": launches, "oriented": oriented["launches"],
             "general": general["vo"]["launches"], "slam_general": general["slam"]["launches"],
             "multi_seq_general": general["multi_seq"]["launches"],
             "multi_seq": multi_seq["launches"],
             "ba_tracking": tracking["launches"], "slam": slam_runs[1]["launches"],
             "slam_batch4": slam_runs[4]["launches"], "canyon": canyon["slam"]["launches"],
             "canyon_long": canyon_long["slam"]["launches"]}
    for r in records:
        kernel = r["name"].split(" ")[0]
        r["launches"] = paths[r["path"]][kernel]
        r["launches_by_path"] = {p: ls[kernel] for p, ls in paths.items()}
    log(json.dumps({"main_path": {k: summary[k] for k in ("frames", "fps", "median_ms",
                                                          "ate_m")},
                    "launch_floor_ms": floor_ms}))
    log(json.dumps({"oriented": oriented}))
    log(json.dumps({"general": general}, default=float))
    log(json.dumps({"ba": ba}))
    log(json.dumps({"slam": {str(k): {key: v for key, v in r.items() if key != "timers"}
                             for k, r in slam_runs.items()},
                    "slam_timers": slam_runs[1]["timers"], "slam_devices": slam_devices,
                    "slam_first_call": first_call}, default=float))
    log(json.dumps({"canyon": canyon}, default=float))
    log(json.dumps({"canyon_long": canyon_long}, default=float))
    log(json.dumps({"multi_seq": multi_seq, "distributed": distributed}, default=float))
    log(json.dumps({"programs": programs_rec}, default=float))
    from stereo_orb_slam_torch.utils import programs

    log(json.dumps({"program_cache": programs.PROGRAMS.summary()}, default=float))
    log(json.dumps({"phase_seconds": seconds}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

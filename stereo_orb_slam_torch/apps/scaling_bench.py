"""Distributed-BA scaling harness: LM iterations per second of the sharded
LM step at given world sizes (BASELINE.json config 5's metric).

PyTorch counterpart of the JAX package's `apps/scaling_bench.py`. Each
world size runs in its own group of spawned ranks (`parallel/multihost.
launch`); every rank builds the same problem from the seed and steps its
shard of the observation-sharded layout. On the card the time of each
step comes from CUDA events around it, after one warm-up step; on the
CPU from the host clock.

    python -m stereo_orb_slam_torch.apps.scaling_bench --ranks 1 2 \
        --iters 8 --device cuda --backend nccl

NCCL takes one card per rank; several ranks on one card need
`--backend gloo`, which stages every all_reduce through the host: such a
run measures the collectives' count and correctness, not scaling. Under
NCCL each step is one captured program (`backend.ba.lm_step_program`, as
the JAX package jits its sharded step); under gloo it runs eagerly. Each
result says which ("captured").
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def make_problem(C=200, P=20000, obs_per_cam=600, seed=0, device="cuda"):
    """The JAX package's scaling problem: C cameras with obs_per_cam
    observations each of P uniform points, KITTI intrinsics, 0.5 px noise,
    poses perturbed by 0.01. A BAProblem on `device` (unpadded)."""
    from stereo_orb_slam_torch.backend.ba import BAProblem

    rng = np.random.default_rng(seed)
    fx, cx, cy, b = 718.856, 607.1928, 185.2157, 0.5371657
    P_l = np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0]], np.float32)
    P_r = P_l.copy()
    P_r[0, 3] = -fx * b
    O = C * obs_per_cam
    pts = np.stack(
        [rng.uniform(-20, 20, P), rng.uniform(-5, 5, P), rng.uniform(5, 60, P)], 1,
    ).astype(np.float32)
    pose6 = rng.normal(0, 0.01, (C, 6)).astype(np.float32)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), obs_per_cam)
    obs_point = rng.integers(0, P, O).astype(np.int32)
    X = pts[obs_point]

    def proj(Pm):
        Xh = np.concatenate([X, np.ones((O, 1), np.float32)], 1)
        uvw = Xh @ Pm.T
        return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)

    obs_uv = np.concatenate([proj(P_l), proj(P_r)], 1).astype(np.float32)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape).astype(np.float32)
    cam_mask = np.asarray([0.0] + [1.0] * (C - 1), np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BAProblem(t(pose6), t(pts), t(obs_cam, torch.int64), t(obs_point, torch.int64),
                     t(obs_uv), torch.ones(O, device=device), t(cam_mask),
                     torch.ones(P, device=device), t(P_l), t(P_r))


def measure(mesh, n_iter: int, cfg) -> dict:
    """Iterations/s of the sharded LM step on this rank's mesh, with the
    all_reduce count and bytes per step. Called on every rank."""
    from stereo_orb_slam_torch.parallel import mesh as mesh_mod
    from stereo_orb_slam_torch.parallel.dist_ba import shard_problem, sharded_lm_step

    prob = shard_problem(mesh, make_problem(device="cpu"))
    step = sharded_lm_step(mesh, cfg)
    lam = torch.tensor(1e-4, device=mesh.device)
    cuda = mesh.device.type == "cuda"
    prob, *_ = step(prob, lam)   # warm-up
    if cuda:
        torch.cuda.synchronize(mesh.device)
    n0, b0 = mesh_mod.ALL_REDUCES, mesh_mod.ALL_REDUCE_BYTES
    times = []
    for _ in range(n_iter):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            prob, *_ = step(prob, lam)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            prob, *_ = step(prob, lam)
            float(prob.pose6[0, 0])
            times.append(time.perf_counter() - t0)
    return {"ba_iterations_per_sec": 1.0 / float(np.median(times)),
            "captured": cuda and mesh_mod.capturable(mesh.group),
            "all_reduces_per_iteration": (mesh_mod.ALL_REDUCES - n0) / n_iter,
            "all_reduce_bytes_per_iteration": (mesh_mod.ALL_REDUCE_BYTES - b0) / n_iter,
            "peak_bytes": torch.cuda.max_memory_allocated(mesh.device) if cuda else None}


def _rank(rank, world_size, n_iter, device):
    from stereo_orb_slam_torch.config import BAConfig
    from stereo_orb_slam_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(device=None if device == "cuda" else "cpu")
    return measure(mesh, n_iter, BAConfig(cg_iterations=25))


def run(ranks, n_iter=8, device="cuda", backend="nccl", timeout_s=900.0) -> dict:
    """measure() at each world size of `ranks` (rank 0's numbers), with the
    efficiency against the first size."""
    from stereo_orb_slam_torch.parallel import multihost

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    results, first = {}, None
    for n in ranks:
        r = multihost.launch(_rank, n, args=(n_iter, device), backend=backend,
                             timeout_s=timeout_s)[0]
        first = first or r["ba_iterations_per_sec"]
        r["scaling_efficiency"] = r["ba_iterations_per_sec"] * ranks[0] / (first * n)
        results[str(n)] = r
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="Distributed BA scaling harness (PyTorch)")
    ap.add_argument("--ranks", type=int, nargs="+", default=[1])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    results = run(args.ranks, args.iters, args.device, args.backend)
    for n, r in results.items():
        print(f"ranks={n}: {r['ba_iterations_per_sec']:.2f} it/s "
              f"({'captured' if r['captured'] else 'eager'}), efficiency "
              f"{r['scaling_efficiency']:.2%}, {r['all_reduces_per_iteration']:.0f} "
              f"all_reduces per iteration")
    print(json.dumps({"scaling": results}))
    return results


if __name__ == "__main__":
    main()

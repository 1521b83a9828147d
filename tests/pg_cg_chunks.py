"""The pose graph's CG replayed in chunks of k iterations, on the card.

`GNProgram` (stereo_orb_slam_torch/backend/pose_graph.py) captures one
masked PCG iteration as its `cg` body and replays it cg_iterations times
a Gauss-Newton step: iterations x (cg_iterations + 2) replays a solve.
This script measures the same solve with a `cg` body of k iterations
(iterations x (cg_iterations / k + 2) replays): k = 1 is the shipped
program, any other k a subclass of it here. Each iteration tests the exit
on the device and keeps its state once the test fails, so every k gives
the same bits.

    python tests/pg_cg_chunks.py GRAPHS.npz [--chunks 1 25 200]

GRAPHS.npz holds padded graphs as `chip_smoke.py --out DIR` writes them
(DIR/canyon_long_graphs.npz; the layout is in tests/pg_cg_witness.py).
For each k and graph, in a fresh program cache: the capture's ms (the
first call's), a replay call's wall ms, its span between CUDA events,
the device ms of its kernels (their sum, torch.profiler), and whether
the poses and both costs are bit for bit eager `pg_solve`'s on the same
problem. Needs a CUDA device; prints the card's name and power limit,
then one JSON line per (k, graph).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

FIELDS = ("poses", "edge_a", "edge_b", "edge_meas", "edge_weight", "vertex_mask")


def chunked_solver(k: int):
    """fn(prob, cfg, cache) -> (poses, cost0, cost): pg_solve_program with
    a `cg` body of k PCG iterations (k = 1: pg_solve_program itself)."""
    from stereo_orb_slam_torch.backend import ba, pose_graph
    from stereo_orb_slam_torch.utils import programs

    if k == 1:
        def solve(prob, cfg, cache):
            p, c0, c1 = pose_graph.pg_solve_program(prob, cfg, cache=cache)
            return p.poses, c0, c1
        return solve

    class ChunkedGNProgram(pose_graph.GNProgram):
        def cg(self):
            for _ in range(k):
                ba.pcg_iteration(self.state, self._matvec, self.M_inv)

        def solve(self):
            for it in range(self.cfg.iterations):
                self.run("assemble", self.assemble)
                if it == 0:
                    self.cost0.copy_(self.cost)
                for _ in range(self.cfg.cg_iterations // k):
                    self.run("cg", self.cg)
                self.run("update", self.update)

    @ba.full_f32
    def solve(prob, cfg, cache):
        if cfg.cg_iterations % k:
            raise ValueError(f"a chunk of {k} does not divide {cfg.cg_iterations} iterations")
        key = (ChunkedGNProgram, programs.tensor_key(*prob), cfg, k)
        prog = cache.get(key, lambda: ChunkedGNProgram(prob, cfg))
        prog.load(prob)
        prog.solve()
        return prog.prob.poses.clone(), prog.cost0.clone(), prog.cost.clone()
    return solve


def measure(prob, cfg, k, want) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_orb_slam_torch.utils import programs

    solve, cache = chunked_solver(k), programs.ProgramCache()

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(prob, cfg, cache)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    first, first_ms = call()
    capture_ms = cache.capture_ms
    again, replay_ms = call()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    solve(prob, cfg, cache)
    b.record()
    b.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(prob, cfg, cache)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    bits = all(all(torch.equal(x, y) for x, y in zip(out, want)) for out in (first, again))
    cache.clear()
    return {"k": k, "replays_per_solve": cfg.iterations * (cfg.cg_iterations // k + 2),
            "capture_ms": capture_ms, "first_call_ms": first_ms, "replay_call_ms": replay_ms,
            "replay_span_ms": a.elapsed_time(b), "replay_device_ms": device_us / 1e3,
            "bits_equal": bits}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("graphs", help="an .npz of padded graphs (see the module docstring)")
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 25, 200],
                    help="CG iterations a replay of the cg body (default 1 25 200)")
    args = ap.parse_args(argv)

    import torch

    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.config import PoseGraphConfig

    if not torch.cuda.is_available():
        sys.exit("pg_cg_chunks: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip(), flush=True)
    data = np.load(args.graphs)
    dtypes = (torch.float32, torch.int64, torch.int64, torch.float32, torch.float32,
              torch.float32)
    cfg = PoseGraphConfig()
    for g in range(len({k.split("_", 1)[0] for k in data.files})):
        prob = pose_graph.PoseGraphProblem(*(
            torch.as_tensor(data[f"g{g}_{f}"], dtype=dt, device="cuda")
            for f, dt in zip(FIELDS, dtypes)))
        p, c0, c1 = pose_graph.pg_solve(prob, cfg)
        want = (p.poses, c0, c1)
        for k in args.chunks:
            line = {"graph": g, "bucket": [prob.poses.shape[0], prob.edge_a.shape[0]]}
            line.update(measure(prob, cfg, k, want))
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

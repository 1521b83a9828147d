"""The pose graph's CG iterations that actually run, port and JAX package,
on the CPU.

Both packages' pose-graph solves run 10 Gauss-Newton steps, each with a
block-Jacobi PCG of at most 200 iterations that exits once ||r|| <=
cg_tol ||b||: the JAX package's `while_loop` stops there, the port runs
every iteration masked (`backend/ba.py::pcg_iteration`, `active`). This
script counts, per Gauss-Newton step, the iterations that run:

- the port's: `stereo_orb_slam_torch.backend.pose_graph.cg_iterations_run`
  (an eager solve, counting `active`), on the CPU;
- the JAX package's: `pose_graph.pg_solve_impl` traced with
  `jax.lax.while_loop` wrapped to carry a counter, which
  `jax.debug.callback` hands back once per loop (the package's own loop,
  unchanged), on the CPU.

    python tests/pg_cg_witness.py GRAPHS.npz [--only 0 3 -1]

GRAPHS.npz holds graphs as `chip_smoke.py --out DIR` writes them for the
long canyon drive (`DIR/canyon_long_graphs.npz`: for graph g the arrays
`g{g}_poses` [N, 4, 4], `g{g}_edge_a`, `g{g}_edge_b` [E], `g{g}_edge_meas`
[E, 4, 4], `g{g}_edge_weight` [E], `g{g}_vertex_mask` [N], and `g{g}_card`,
the card's counts). It prints one JSON line per graph: its size and the
counts of the card, of the port on the CPU and of the JAX package on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

FIELDS = ("poses", "edge_a", "edge_b", "edge_meas", "edge_weight", "vertex_mask")


def jax_cg_iterations(arrays, **cfg) -> list:
    """The JAX package's pg_solve on one graph (`arrays` in FIELDS order,
    NumPy) with PoseGraphConfig(**cfg), on the CPU: the CG iterations its
    while_loop ran in each Gauss-Newton step."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from stereo_orb_slam_tpu.backend import pose_graph as jpg
    from stereo_orb_slam_tpu.config import PoseGraphConfig

    counts = []
    real = jax.lax.while_loop

    def counting(cond, body, init):
        n, out = real(lambda st: cond(st[1]), lambda st: (st[0] + 1, body(st[1])),
                      (jnp.int32(0), init))
        jax.debug.callback(lambda k: counts.append(int(k)), n, ordered=True)
        return out

    jax.lax.while_loop = counting
    try:
        dtypes = (jnp.float32, jnp.int32, jnp.int32, jnp.float32, jnp.float32, jnp.float32)
        prob = jpg.PoseGraphProblem(*(jnp.asarray(a, dt) for a, dt in zip(arrays, dtypes)))
        jax.block_until_ready(jax.jit(lambda p: jpg.pg_solve_impl(p, PoseGraphConfig(**cfg)))(
            prob))
        jax.effects_barrier()
    finally:
        jax.lax.while_loop = real
    return counts


def port_cg_iterations(arrays, **cfg) -> list:
    """The port's counts for the same graph (`cg_iterations_run`) on the CPU."""
    import torch

    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.config import PoseGraphConfig

    dtypes = (torch.float32, torch.int64, torch.int64, torch.float32, torch.float32,
              torch.float32)
    prob = pose_graph.PoseGraphProblem(*(torch.as_tensor(np.asarray(a), dtype=dt)
                                         for a, dt in zip(arrays, dtypes)))
    return [int(c) for c in pose_graph.cg_iterations_run(prob, PoseGraphConfig(**cfg))[1]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("graphs", help="an .npz of graphs (see the module docstring)")
    ap.add_argument("--only", type=int, nargs="*", default=None,
                    help="graph indices to count (negative from the end; default all)")
    args = ap.parse_args(argv)
    data = np.load(args.graphs)
    n = len({k.split("_", 1)[0] for k in data.files})
    picks = range(n) if args.only is None else sorted({i % n for i in args.only})
    for g in picks:
        arrays = [data[f"g{g}_{f}"] for f in FIELDS]
        card = data[f"g{g}_card"].tolist() if f"g{g}_card" in data.files else None
        print(json.dumps({"graph": g, "vertices": int(arrays[0].shape[0]),
                          "edges": int(arrays[1].shape[0]), "card": card,
                          "port_cpu": port_cg_iterations(arrays),
                          "jax_cpu": jax_cg_iterations(arrays)}), flush=True)


if __name__ == "__main__":
    main()

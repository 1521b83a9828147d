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
the card's counts), each as the optimizer solved it: padded to its
power-of-two bucket (identity vertices held fixed after the real n, edges
of weight 0 after the real E), or at its own size. Both packages count on
the graph as given. It prints one JSON line per graph: its real and
padded sizes, the counts of the card, of the port on the CPU and of the
JAX package on the CPU, and, for a padded graph, the port's counts on the
graph cut to its real vertices and edges and the largest rotation and
translation gaps between the two solves' real vertices; then the same
gaps for a faulty padding (`faulty`: the padded edges repeat the last
real edge at weight 1), what chip_smoke.py's bucketed-against-exact gate
would read for it.
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


def real_size(arrays) -> tuple:
    """(n, E) of a graph in FIELDS order: its vertices up to the last free
    one (vertex 0 is the fixed gauge) and its edges of weight > 0, which
    the padding puts after the real ones."""
    return int(np.flatnonzero(arrays[5]).max()) + 1, int((arrays[4] > 0).sum())


def cut(arrays) -> list:
    """The graph cut to its real vertices and edges."""
    n, E = real_size(arrays)
    return [a[:n] if i in (0, 5) else a[:E] for i, a in enumerate(arrays)]


def faulty(arrays) -> list:
    """The graph with a faulty padding: its padded edges repeat the last
    real edge at weight 1 in place of the null edges (0, 0) of weight 0."""
    _, E = real_size(arrays)
    out = [np.array(a) for a in arrays]
    for i in (1, 2, 3, 4):
        out[i][E:] = arrays[i][E - 1]
    return out


def _gaps(P, R) -> dict:
    gap = np.abs(P - R)
    return {"rotation": float(gap[:, :3, :3].max()), "translation": float(gap[:, :3, 3].max())}


def port_cg_iterations(arrays, **cfg) -> tuple:
    """The port's counts for the same graph (`cg_iterations_run`) on the
    CPU, and its final poses [N, 4, 4] as float64."""
    import torch

    from stereo_orb_slam_torch.backend import pose_graph
    from stereo_orb_slam_torch.config import PoseGraphConfig

    dtypes = (torch.float32, torch.int64, torch.int64, torch.float32, torch.float32,
              torch.float32)
    prob = pose_graph.PoseGraphProblem(*(torch.as_tensor(np.asarray(a), dtype=dt)
                                         for a, dt in zip(arrays, dtypes)))
    final, counts = pose_graph.cg_iterations_run(prob, PoseGraphConfig(**cfg))
    return [int(c) for c in counts], final.poses.double().numpy()


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
        (n, E), padded = real_size(arrays), [int(arrays[0].shape[0]), int(arrays[1].shape[0])]
        counts, poses = port_cg_iterations(arrays)
        line = {"graph": g, "vertices": n, "edges": E, "padded": padded, "card": card,
                "port_cpu": counts, "jax_cpu": jax_cg_iterations(arrays)}
        if padded != [n, E]:
            exact_counts, exact = port_cg_iterations(cut(arrays))
            line.update(port_cpu_exact=exact_counts, padded_vs_exact=_gaps(poses[:n], exact),
                        faulty_vs_exact=_gaps(port_cg_iterations(faulty(arrays))[1][:n], exact))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

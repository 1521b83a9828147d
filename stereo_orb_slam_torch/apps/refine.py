"""Offline refinement: restore a dumped problem and re-run global BA.

PyTorch counterpart of the JAX package's `apps/refine.py`: load
poses/points/constraints (the reference's dump, SURVEY.md §5.4), run
global bundle adjustment over every frame, write the refined dump back.

    python -m stereo_orb_slam_torch.apps.refine --input_dir DUMP \
        --camera calib.txt --output_dir OUT [--iterations 50] [--device cuda]

`--device` defaults to `cuda` and fails without a card; `cpu` runs on the
CPU only when asked. The process keeps TF32 off for float32 matrix
products (the Schur products and the one-hot reductions need full f32).

`--distributed` splits the solve over the ranks of a process group
(`parallel/dist_ba.py`, the point-aligned layout). Start it under
torchrun, one process per rank:

    torchrun --standalone --nproc_per_node=N -m stereo_orb_slam_torch.apps.refine \
        --distributed --backend nccl ...

Every rank loads the dump and solves its shard; rank 0 writes the output.
`--backend` is the process group's (nccl: one card per rank; gloo: CPU
tensors, or several ranks sharing one card). Without torchrun's
environment it runs as a group of one. Under NCCL the solve is one
captured program, its all_reduces inside the graphs; under gloo it runs
eagerly. The log's stats say which ("captured").
"""

from __future__ import annotations

import argparse

import torch

from stereo_orb_slam_torch.backend.ba import BundleAdjuster
from stereo_orb_slam_torch.config import BAConfig
from stereo_orb_slam_torch.io import calib, checkpoint, export
from stereo_orb_slam_torch.utils import logging as slog


def main(argv=None) -> dict:
    """Run the CLI; returns the solve's stats and the refined WorldMap
    (under "world")."""
    ap = argparse.ArgumentParser(description="Offline global BA over a dump (PyTorch)")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--camera", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--distributed", action="store_true",
                    help="split the solve over the ranks of a process group "
                         "(torchrun's environment, or a group of one)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="the process group's backend with --distributed")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False

    world = checkpoint.restore_world(args.input_dir)
    cfg = BAConfig(max_iterations=args.iterations)
    if args.distributed:
        from stereo_orb_slam_torch.parallel import multihost
        from stereo_orb_slam_torch.parallel.dist_ba import DistributedBundleAdjuster
        from stereo_orb_slam_torch.parallel.mesh import make_mesh

        info = multihost.initialize(backend=args.backend)
        mesh = make_mesh(device=None if args.device == "cuda" else "cpu")
        rig = calib.load_camera(args.camera, device=mesh.device)
        adj = DistributedBundleAdjuster(world, rig, mesh, cfg)
        primary = multihost.is_primary()
    else:
        info = None
        rig = calib.load_camera(args.camera, device=args.device)
        adj = BundleAdjuster(world, rig, cfg)
        primary = True

    stats = adj.optimize(0, world.num_frames)
    if primary:
        slog.info(f"global BA: {stats}" + (f" ({info})" if info else ""))
        export.dump_world(args.output_dir, world)
        export.save_kitti_trajectory(
            f"{args.output_dir}/trajectory_refined.txt",
            world.pose_global[: world.num_frames],
        )
    if args.distributed:
        multihost.shutdown()
    return dict(stats, world=world)


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

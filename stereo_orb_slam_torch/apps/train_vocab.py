"""Offline vocabulary trainer.

PyTorch counterpart of the JAX package's `apps/train_vocab.py`: builds the
flat BoW codebook from a dataset's images (the counterpart of the
reference's prebuilt DBoW2 vocabulary at ref `src/slam.cpp:101`; the
reference cannot train one, its commented-out constructor at
`src/loop_detector.cpp:8-16` is dead code). The `.npz` it writes loads in
either package.

    python -m stereo_orb_slam_torch.apps.train_vocab \\
        --dataset kitti --folder .../sequences/00 --out vocab.npz \\
        --stride 10 --words 1024 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from stereo_orb_slam_torch.config import FrontendConfig
from stereo_orb_slam_torch.frontend.odometer import detect_and_describe
from stereo_orb_slam_torch.io import datasets
from stereo_orb_slam_torch.loop import OrbVocabulary
from stereo_orb_slam_torch.utils import logging as slog


def main(argv=None) -> OrbVocabulary:
    ap = argparse.ArgumentParser(description="Train the flat ORB vocabulary (PyTorch)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--folder", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--stride", type=int, default=10, help="use every Nth frame")
    ap.add_argument("--words", type=int, default=1024)
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    pairs = datasets.load_dataset(args.dataset, args.folder)[:: args.stride]
    if args.max_frames:
        pairs = pairs[: args.max_frames]

    fe = FrontendConfig()
    corpus = []
    for i, (pl, _) in enumerate(pairs):
        img = torch.from_numpy(datasets.read_grayscale(pl)).to(args.device)
        _, v, d = detect_and_describe(img, fe)
        corpus.append(d[v].cpu().numpy().view(np.uint32))
        if i % 20 == 0:
            slog.info(f"described frame {i}/{len(pairs)}")

    all_desc = np.concatenate(corpus)
    slog.info(f"training on {len(all_desc)} descriptors")
    vocab = OrbVocabulary.train(all_desc, num_words=args.words, iterations=args.iterations,
                                device=args.device)
    vocab.save(args.out)
    slog.info(f"saved vocabulary to {args.out}")
    return vocab


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

"""Descriptor matching: top-2 Hamming match + Lowe-ratio and distance gates.

PyTorch counterpart of the JAX package's `ops/match.py` (the reference's
brute-force Hamming kNN(k=2) + ratio test, ref
`src/visual_odometer.cpp:262-289` and MatchPoints at :64-91). The top-2
search is `kernels/hamming.py::hamming_top2` (or `hamming_top2_pair`, two
train sets against one query set in one launch), a CUDA kernel on the card
and `hamming_matrix` + `knn2` on the CPU; `gate_matches` applies the gates
to its result.

Matches are one-directional (no cross check): each query row takes its best
train column, gated by d1 < max_distance and d1/d2 < ratio. Query validity
masks d1 only, as the JAX package's fused-kernel path does; idx is the real
argmin on invalid query rows too, and every consumer masks it.
"""

from __future__ import annotations

import torch

from stereo_orb_slam_torch.ops.kernels.hamming import (  # noqa: F401 (public API)
    BIG, BITS, hamming_matrix, hamming_top2, hamming_top2_pair, knn2, signs_from_packed,
)


def match_descriptors(desc_q, desc_t, valid_q, valid_t, max_distance=30.0,
                      ratio=0.5):
    """One-directional kNN(2) + Lowe ratio + absolute distance gate.

    Returns:
      idx: [N] int32 best train index per query row.
      ok:  [N] bool, passes both gates and both rows valid.
      d1:  [N] float32 best distance (257 on invalid query rows).
    """
    return gate_matches(hamming_top2(desc_q, desc_t, valid_t), valid_q,
                        max_distance, ratio)


def gate_matches(top2, valid_q, max_distance=30.0, ratio=0.5):
    """The gates of `match_descriptors` on a top-2 result (d1, idx1, d2):
    d1 masked to 257 on invalid query rows, then d1 < max_distance and
    d1/d2 < ratio. Returns (idx, ok, d1) as `match_descriptors` does."""
    d1, idx1, d2 = top2
    d1 = torch.where(valid_q, d1, BIG)
    safe_d2 = torch.clamp(d2, min=1e-6)
    ok = (d1 < max_distance) & (d1 / safe_d2 < ratio) & valid_q & (d1 <= BITS)
    return idx1, ok, d1


def mutual_filter(idx_qt, ok_qt, idx_tq):
    """Optional cross-check (not in the reference): keep q->t matches whose
    train row's best query is q."""
    q_ids = torch.arange(idx_qt.shape[0], dtype=idx_qt.dtype, device=idx_qt.device)
    return ok_qt & (idx_tq[idx_qt.long()] == q_ids)

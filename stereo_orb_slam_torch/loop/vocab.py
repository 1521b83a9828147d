"""Flat ORB vocabulary: binary k-medians + tf-idf bag of words.

PyTorch counterpart of the JAX package's `loop/vocab.py`, which replaces
DBoW2 (ref `src/loop_detector.h:5-16`, TF_IDF weighting and L1 scoring per
the commented constructor at ref `src/loop_detector.cpp:8-16`) with a FLAT
codebook of `words` 256-bit centroids.

Nearest-word assignment is a top-1 Hamming search of the descriptors
against the words: the `hamming_top2` kernel with the words as its train
set (its lowest-index tie rule is `argmin`'s first-index rule), or its
plain version for tensors on the CPU. Training is Lloyd's algorithm in
Hamming space: assignment, then a per-word bitwise majority vote, with
empty words re-seeded from the corpus on the host.

Scoring is DBoW2's L1 similarity on L1-normalised tf-idf vectors:
    s(v, w) = 1 - 0.5 * |v - w|_1 = sum_i min(v_i, w_i)
so a query against the whole frame database is one broadcast min and a
row sum.

Descriptors are int32 [N, 8] tensors holding the uint32 words; the saved
`.npz` holds `centroids` uint32 [W, 8] and `idf` float32 [W], the JAX
package's format.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_orb_slam_torch.ops import orb
from stereo_orb_slam_torch.ops.detect import top_k_stable
from stereo_orb_slam_torch.ops.kernels import hamming

NO_WORD_DIST = hamming.BIG  # 257: the distance of an invalid query row


def desc_tensor(desc, device) -> torch.Tensor:
    """Descriptor words as an int32 tensor on `device`: a tensor is moved,
    a uint32 / int32 array is viewed as int32 (the same bits)."""
    if isinstance(desc, torch.Tensor):
        return desc.to(device=device, dtype=torch.int32)
    words = np.ascontiguousarray(np.asarray(desc)).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def assign_words(desc, valid, centroids):
    """Nearest-centroid assignment by Hamming distance.

    desc [N, 8] int32, valid [N] bool, centroids [W, 8] int32 ->
    (word [N] int64, dist [N] float32). Invalid rows take word 0 at
    distance 257, as the JAX function's whole-row mask gives them.
    """
    d1, idx1, _ = hamming.hamming_top2(
        desc, centroids,
        torch.ones(centroids.shape[0], dtype=torch.bool, device=centroids.device))
    word = torch.where(valid, idx1.long(), 0)
    return word, torch.where(valid, d1, NO_WORD_DIST)


def _kmedians_iter(desc_bits, valid, centroids, num_words: int):
    """One Lloyd iteration in Hamming space.

    desc_bits: [N, 256] {0,1} float32; centroids packed [W, 8] int32.
    Returns the new packed centroids and the per-word counts.

    The per-word sums of bits and counts are integer-valued float32 below
    2^24, so `index_add_` gives the exact sums in whatever order its adds
    land (CUDA atomics included); the real-valued sums of BA may not use it.
    """
    desc_packed = orb.pack_bits(desc_bits > 0.5)
    word, _ = assign_words(desc_packed, valid, centroids)
    w = valid.to(torch.float32)
    sums = torch.zeros((num_words, desc_bits.shape[1]), dtype=torch.float32,
                       device=desc_bits.device).index_add_(0, word, desc_bits * w[:, None])
    counts = torch.zeros(num_words, dtype=torch.float32,
                         device=desc_bits.device).index_add_(0, word, w)
    maj = sums > 0.5 * torch.clamp(counts[:, None], min=1e-6)
    return orb.pack_bits(maj), counts


def _tf_idf(word, valid, idf, rows: int):
    """L1-normalised tf-idf vectors [rows, W] from words [rows, N] (the
    counts are integers, so `index_add_` is exact here too)."""
    W = idf.shape[0]
    flat = (word + W * torch.arange(rows, device=word.device)[:, None]).reshape(-1)
    tf = torch.zeros(rows * W, dtype=torch.float32, device=word.device).index_add_(
        0, flat, valid.reshape(-1).to(torch.float32)).reshape(rows, W)
    v = tf * idf
    return v / torch.clamp(torch.sum(torch.abs(v), dim=-1, keepdim=True), min=1e-12)


class OrbVocabulary:
    """Flat binary codebook with tf-idf weights, on one device."""

    def __init__(self, centroids, idf, device="cuda"):
        self.centroids = desc_tensor(centroids, device)          # [W, 8] int32
        self.idf = torch.as_tensor(np.asarray(idf, np.float32) if not isinstance(
            idf, torch.Tensor) else idf, dtype=torch.float32).to(device)  # [W]
        self.num_words = self.centroids.shape[0]
        self.device = self.centroids.device

    @staticmethod
    def train(descriptors: np.ndarray, num_words: int = 1024, iterations: int = 8,
              seed: int = 0, device="cuda") -> "OrbVocabulary":
        """Binary k-medians over a descriptor corpus [M, 8] uint32, with the
        JAX package's seeding (numpy's default_rng(seed)) step for step."""
        descriptors = np.asarray(descriptors, np.uint32)
        rng = np.random.default_rng(seed)
        M = len(descriptors)
        if M < num_words:
            # Duplicate-pad tiny corpora so every word has a seed.
            reps = -(-num_words // max(M, 1))
            descriptors = np.tile(descriptors, (reps, 1))[: max(num_words, M)]
            M = len(descriptors)
        init_idx = rng.choice(M, num_words, replace=False)
        centroids = desc_tensor(descriptors[init_idx], device)

        corpus = desc_tensor(descriptors, device)
        desc_bits = orb.unpack_bits(corpus)
        valid = torch.ones(M, dtype=torch.bool, device=corpus.device)
        for _ in range(iterations):
            centroids_new, counts = _kmedians_iter(desc_bits, valid, centroids, num_words)
            # Re-seed empty words from random descriptors (host side).
            empty = np.where(counts.cpu().numpy() == 0)[0]
            cent_np = centroids_new.cpu().numpy().view(np.uint32).copy()
            if len(empty):
                cent_np[empty] = descriptors[rng.choice(M, len(empty), replace=False)]
            centroids = desc_tensor(cent_np, device)

        # idf from the corpus occupancy: rare words score higher.
        word, _ = assign_words(corpus, valid, centroids)
        occ = np.bincount(word.cpu().numpy(), minlength=num_words).astype(np.float64)
        idf = np.log(M / (occ + 1.0)).astype(np.float32)
        return OrbVocabulary(centroids, idf, device)

    def centroids_u32(self) -> np.ndarray:
        return self.centroids.cpu().numpy().view(np.uint32)

    def bow_vector(self, desc, valid):
        """L1-normalised tf-idf BoW vector [W] of one frame's descriptors."""
        desc = desc_tensor(desc, self.device)
        valid = torch.as_tensor(valid, device=self.device)
        word, _ = assign_words(desc, valid, self.centroids)
        return _tf_idf(word[None], valid[None], self.idf, 1)[0]

    def save(self, path: str):
        np.savez_compressed(path, centroids=self.centroids_u32(),
                            idf=self.idf.cpu().numpy())

    @staticmethod
    def load(path: str, device="cuda") -> "OrbVocabulary":
        data = np.load(path)
        return OrbVocabulary(data["centroids"], data["idf"], device)


def l1_scores(query_vec, database):
    """DBoW2 L1 similarity of one BoW vector against all database rows.

    query_vec [W], database [F, W] (rows L1-normalised) -> [F] in [0, 1].
    """
    return torch.sum(torch.minimum(query_vec[None, :], database), dim=1)


def batch_score_update(desc, valid, recorded, centroids, idf, database, db_size,
                       query_size: int = 4):
    """K frames of BoW scoring + database append, with no host sync.

    The batched form of K sequential Query()+Track() calls (ref
    `src/loop_detector.cpp:51-91`):
      - BoW vectors of all K frames (one assignment over the K*N rows);
      - each recorded frame j scores against every EARLIER recorded frame:
        the database rows [0, db_size) and the recorded batch frames before
        j (the reference queries before tracking, so the database never
        holds the current frame, ref src/slam.cpp:131-134);
      - the recorded frames are appended to the database in order.

    Args:
      desc: [K, N, 8] int32; valid: [K, N] bool; recorded: [K] bool (frames
        the tracker recorded; the others take no part);
      database: [cap, W] L1-normalised rows; db_size: rows in use (int or
        0-d tensor).

    Returns (top_ids [K, query_size] int32 frame ids, -1 padding, sorted by
    score descending; top_scores [K, query_size] float32; new_database
    [cap, W], a new tensor with the recorded rows written).
    """
    K, N = desc.shape[0], desc.shape[1]
    cap, W = database.shape
    dev = database.device
    db_size = torch.as_tensor(db_size, dtype=torch.int64, device=dev)
    word, _ = assign_words(desc.reshape(K * N, 8), valid.reshape(K * N), centroids)
    bows = _tf_idf(word.reshape(K, N), valid, idf, K)  # [K, W]

    rec_i = recorded.to(torch.int64)
    rows = db_size + torch.cumsum(rec_i, 0) - rec_i  # db row / frame id if recorded

    # Scores against the database rows, one query at a time (a [K, cap, W]
    # broadcast grows with the capacity).
    db_scores = torch.stack([l1_scores(b, database) for b in bows])  # [K, cap]
    col = torch.arange(cap, device=dev)[None, :]
    db_valid = col < db_size
    # Query j against the earlier recorded batch frames i.
    cross = torch.sum(torch.minimum(bows[:, None, :], bows[None, :, :]), dim=-1)
    ii = torch.arange(K, device=dev)
    batch_valid = recorded[None, :] & (ii[None, :] < ii[:, None])

    all_scores = torch.cat([torch.where(db_valid, db_scores, -1.0),
                            torch.where(batch_valid, cross, -1.0)], dim=1)
    all_ids = torch.cat([col.expand(K, cap), rows[None, :].expand(K, K)], dim=1)
    # `lax.top_k`'s order (torch.topk fixes none among ties, and equal BoW
    # scores are common: identical frames, the -1 padding).
    top_scores, top_idx = top_k_stable(all_scores, query_size)
    top_ids = torch.gather(all_ids, 1, top_idx)
    top_ids = torch.where(top_scores >= 0.0, top_ids, -1).to(torch.int32)

    # Append the recorded rows; unrecorded frames write a scratch row that
    # is cut off, so the order of their duplicate writes does not matter.
    padded = torch.cat([database, torch.zeros((1, W), dtype=database.dtype, device=dev)])
    padded[torch.where(recorded, rows, cap)] = bows
    return top_ids, top_scores, padded[:cap]

"""Bayesian loop detector over the BoW frame database.

PyTorch counterpart of the JAX package's `loop/detector.py`, a
re-implementation of the reference's loop filter (ref
`src/loop_detector.cpp:51-197`) with its quirks handled deliberately:

- `query()` runs BEFORE `track()` each frame, so the database never holds
  the current frame at query time (ref `src/slam.cpp:131-134`).
- top-`query_size` database hits; hits within `adjacent_frame_thresh` keep
  the running adjacent-score estimate; hits beyond `distant_frame_thresh`
  are loop candidates (ref :83-114).
- candidate probability = erf of the z-score of the hit's score against the
  adjacent scores around the candidate frame (ref `MatchProbability`,
  :172-197). Fixed against the reference: the score window is indexed by
  frame id into a per-frame array (the reference appends to `m_scores` only
  on adjacent hits, then indexes it by frame id, ref :86-91,179-183); one
  score is recorded per frame and the window is clamped.
- Bayes update p <- p * match_p / score_p with the score prior stubbed at
  0.5 as the reference does (ref `ScoreProbability`, :167-170), clamped to
  [min, max]; decay by 0.75 on a miss (ref :116-120).
- entering a loop (p > is_loop) commits the queued candidate edges once;
  leaving it (p < not_loop) commits the rest and TRIGGERS the pose-graph
  optimizer (ref :123-151).

The database is a [capacity, W] float32 tensor of L1-normalised BoW rows on
the vocabulary's device; the Bayes filter is host Python.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from stereo_orb_slam_torch.config import LoopConfig
from stereo_orb_slam_torch.loop.vocab import (
    OrbVocabulary, batch_score_update, desc_tensor, l1_scores,
)


class LoopDetector:
    def __init__(self, vocab: OrbVocabulary, cfg: Optional[LoopConfig] = None,
                 optimizer=None):
        self.vocab = vocab
        self.cfg = cfg or LoopConfig()
        self.optimizer = optimizer  # PoseGraphOptimizer or None
        self.device = vocab.device

        self.database = torch.zeros((self.cfg.database_capacity, vocab.num_words),
                                    dtype=torch.float32, device=self.device)
        self.db_size = 0
        # Scoring launches (BoW query batches); each runs one word assignment.
        self.score_batches = 0

        self.loop_probability = self.cfg.min_loop_probability
        self.in_loop = False
        self.potential_edges: list = []
        self.frame_scores: list = []   # per-frame adjacent-match score
        self.matches: list = []        # (best_id, best_score) per query
        self.probabilities: list = []  # p trace per query

    # ------------------------------------------------------------------ DB ops
    def _ensure_capacity(self, need: int):
        cap = self.database.shape[0]
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        bigger = torch.zeros((new_cap, self.vocab.num_words), dtype=torch.float32,
                             device=self.device)
        bigger[:cap] = self.database
        self.database = bigger

    def track(self, desc, valid):
        """Add the frame's BoW vector to the database (ref :51-54)."""
        self._ensure_capacity(self.db_size + 1)
        vec = self.vocab.bow_vector(desc, valid)
        self.database = self.database.clone()
        self.database[self.db_size] = vec
        self.db_size += 1

    def query(self, desc, valid) -> Optional[tuple]:
        """Score against all prior frames; run the Bayes loop filter.

        Returns (best_id, best_score), or None if the database is empty.
        """
        if self.db_size == 0:
            return self._filter_update([])
        vec = self.vocab.bow_vector(desc, valid)
        scores = l1_scores(vec, self.database).cpu().numpy()[: self.db_size]
        k = min(self.cfg.query_size, len(scores))
        top_ids = np.argsort(-scores)[:k]
        return self._filter_update([(int(i), float(scores[i])) for i in top_ids])

    def process_batch(self, desc_stack, valid_stack, recorded) -> list:
        """K frames of Query()+Track() in one scoring pass and one readback.

        desc_stack [K, N, 8], valid_stack [K, N], recorded [K] bool (frames
        the tracker recorded; the others are skipped, a deliberate fix of the
        reference, which queries and tracks a STALE feature container on
        failed frames and lets database ids drift off frame ids, ref
        src/slam.cpp:131-134 + src/loop_detector.cpp:58).

        Equivalent to the sequential path: batch_score_update's candidate
        masking reproduces the query-before-track order. Returns K results,
        (best_id, best_score) or None each.
        """
        recorded = np.asarray(recorded, bool)
        self._ensure_capacity(self.db_size + int(recorded.sum()))
        dev = self.device
        valid = (valid_stack.to(dev) if isinstance(valid_stack, torch.Tensor)
                 else torch.as_tensor(np.asarray(valid_stack, bool), device=dev))
        top_ids, top_scores, new_db = batch_score_update(
            desc_tensor(desc_stack, dev), valid,
            torch.as_tensor(recorded, device=dev), self.vocab.centroids, self.vocab.idf,
            self.database, self.db_size, query_size=self.cfg.query_size,
        )
        self.score_batches += 1
        return self.ingest_batch_topk(top_ids.cpu().numpy(), top_scores.cpu().numpy(),
                                      recorded, new_db)

    def ingest_batch_topk(self, top_ids, top_scores, recorded, new_database) -> list:
        """Host Bayes-filter replay from a batch's top-k candidates.

        Used by process_batch and by the fused front-end path
        (odometer.frontend_chain_bow), whose device work has already scored
        and appended the recorded frames: `new_database` is adopted as it is
        and db_size advances by one per recorded frame.
        """
        self.database = new_database
        results = []
        for j in range(len(recorded)):
            if not recorded[j]:
                results.append(None)
                continue
            top = [(int(i), float(s)) for i, s in zip(top_ids[j], top_scores[j]) if i >= 0]
            results.append(self._filter_update(top))
            self.db_size += 1  # the device work already appended the row
        return results

    def _filter_update(self, top: list) -> Optional[tuple]:
        """One Bayes-filter step given the top-k (frame_id, score) candidates
        of the CURRENT frame (id = db_size). Shared by the sequential and
        batched query paths (ref :83-151)."""
        cfg = self.cfg
        curr_id = self.db_size

        if not top:
            self.matches.append((-1, 0.0))
            self.frame_scores.append(0.0)
            self.probabilities.append(self.loop_probability)
            return None

        self.matches.append(top[0])

        # Adjacent hit -> update the running per-frame score (ref :83-91).
        adjacent_score = 0.0
        for fid, score in top:
            if curr_id - fid < cfg.adjacent_frame_thresh:
                adjacent_score = score
                break
        self.frame_scores.append(adjacent_score)

        # Distant hit -> loop candidate (ref :93-114).
        matched = False
        for fid, score in top:
            if curr_id - fid > cfg.distant_frame_thresh:
                p = self._match_probability(int(fid), score)
                if p > cfg.match_probability_thresh:
                    self.loop_probability = min(
                        self.loop_probability * p / cfg.score_probability,
                        cfg.max_loop_probability,
                    )
                    self.potential_edges.append((int(fid), curr_id))
                    matched = True
                    break

        if not matched:
            self.loop_probability = max(self.loop_probability * cfg.decay_rate,
                                        cfg.min_loop_probability)

        if self.loop_probability > cfg.is_loop_thresh and not self.in_loop:
            # Entering a loop: commit the queued edges once (ref :123-134).
            self._commit_edges()
            self.in_loop = True

        if self.loop_probability < cfg.not_loop_thresh:
            # Leaving / denying (ref :137-151).
            if self.in_loop:
                self._commit_edges()
                self.in_loop = False
                if self.optimizer is not None:
                    # A mid-run solve on the live loop's critical path: its
                    # global BA is capped (PoseGraphConfig.live_ba_max_seconds).
                    self.optimizer.optimize(live=True)
            self.potential_edges.clear()

        self.probabilities.append(self.loop_probability)
        return top[0]

    # ------------------------------------------------------------- internals
    def _commit_edges(self):
        if self.optimizer is not None:
            for (a, b) in self.potential_edges:
                self.optimizer.add_loop_edge(a, b)
        self.potential_edges.clear()

    def _match_probability(self, fid: int, score: float) -> float:
        """erf z-score of the candidate score against the adjacent scores
        near fid (ref :172-197, window clamped, variance floored)."""
        w = self.cfg.score_window
        lo = max(0, min(fid, len(self.frame_scores) - 1))
        window = self.frame_scores[lo: lo + w]
        if not window:
            return 0.0
        arr = np.asarray(window, np.float64)
        avg = arr.mean()
        var = max(arr.var(), 1e-8)
        dev = (score - avg) / math.sqrt(var)
        return math.erf(dev)

    def save_trace(self, path: str):
        """loop_matches.txt equivalent (ref :36-49)."""
        with open(path, "w") as f:
            for i, ((fid, s), p) in enumerate(zip(self.matches, self.probabilities)):
                f.write(f"frame {i} matches with frame {fid} at score {s:.6g} "
                        f"probability = {p:.6g}\n")

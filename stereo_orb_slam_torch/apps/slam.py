"""Full SLAM system + CLI.

PyTorch counterpart of the JAX package's `apps/slam.py` (the reference
`slam` executable, ref `src/slam.cpp:40-174`): VisualOdometer -> per-frame
BA -> sliding-window BA -> loop Query/Track -> (on loop exit) pose-graph
optimization + global BA, then the txt/PLY artifacts and the vocabulary.

Component wiring follows ref `src/slam.cpp:84-101`: one shared WorldMap,
the pose-graph optimizer holding the bundle adjuster (global BA after every
pose-graph solve, ref pose_graph_optimizer.cpp:95) and the loop detector
holding the optimizer (optimize on loop exit, ref loop_detector.cpp:146).

A loop edge is measured as the reference measures it (MatchPoints +
CalcTransformation, ref pose_graph_optimizer.cpp:189,229): the stored
descriptor banks of the two frames are re-matched, the observations
re-triangulated through the rig and a rigid transform fitted by RANSAC;
matched landmark identities are merged in the world map. All edges pending
at a closure are measured as one batched program (`measure_edges`: one
`hamming_top2` launch and one RANSAC solve for E edges), as the JAX
package's `_loop_edges_core` measures them. With keyed samplers (every
default one) it runs as an `EdgeProgram`, captured once per power-of-two
bucket of E, as the JAX package compiles one program per bucket.

    python -m stereo_orb_slam_torch.apps.slam --dataset kitti --folder SEQ \\
        --camera SEQ/calib.txt --output_dir OUT [--gt GT] [--device cpu]

`--device` defaults to `cuda`; nothing falls back to the CPU by itself. The
process keeps TF32 off for float32 matrix products (RANSAC's Horn
iterations and reprojections need full float32).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from stereo_orb_slam_torch.backend.ba import BundleAdjuster
from stereo_orb_slam_torch.backend.pose_graph import PoseGraphOptimizer
from stereo_orb_slam_torch.config import SlamConfig
from stereo_orb_slam_torch.frontend import ransac as ransac_mod
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer, empty_banks
from stereo_orb_slam_torch.geometry import camera as cam_mod
from stereo_orb_slam_torch.io import calib, datasets, export
from stereo_orb_slam_torch.loop import LoopDetector, OrbVocabulary
from stereo_orb_slam_torch.loop.vocab import desc_tensor
from stereo_orb_slam_torch.ops import match as match_mod
from stereo_orb_slam_torch.utils import evaluate, logging as slog, programs
from stereo_orb_slam_torch.utils.profiling import StageTimers
from stereo_orb_slam_torch.worldmap import WorldMap


def _edge_seed(seed: int, edge: int) -> int:
    return (seed * 0x9E3779B1 + 0x5851F42D + edge) % (1 << 63)


def measure_edges(d_s, d_d, v_s, v_d, uv_s, uv_d, samplers, rig, fe, rc, rectified):
    """E loop edges (src, dst) as one batched program, the counterpart of the
    JAX package's `_loop_edges_core`: every input carries a leading edge
    axis ([E, N, 8] descriptors, [E, N] masks, [E, N, 4] observations) and
    `samplers` holds one RANSAC sampler per edge.

    Per edge, dst's descriptors (queries) are matched against src's (train),
    as MatchPoints is called with (src, dst) at ref
    pose_graph_optimizer.cpp:229: one `hamming_top2` launch for all E
    (batch axis on the kernel's grid). Both frames' stored observations
    (already ideal pinhole: the front end undistorted them) are
    re-triangulated (on the general rig two launches of the DLT kernel,
    which does not sync the host), and one RANSAC solve over the E problems
    fits T with
    X_dst = T @ X_src. Device tensors in, device tensors out: (transform
    [E, 4, 4], idx [E, N] int32, inlier mask [E, N], success [E],
    num_inliers [E])."""
    idx, ok, _ = match_mod.match_descriptors(
        d_d, d_s, v_d, v_s, max_distance=fe.match_max_distance, ratio=fe.match_ratio)
    uv_s_m = torch.gather(uv_s, 1, idx.long()[..., None].expand(-1, -1, uv_s.shape[-1]))
    pts_d, tv_d = cam_mod.triangulate_ideal(rig, uv_d[..., :2], uv_d[..., 2:],
                                            rectified=rectified)
    pts_s, tv_s = cam_mod.triangulate_ideal(rig, uv_s_m[..., :2], uv_s_m[..., 2:],
                                            rectified=rectified)
    pair_valid = ok & tv_d & tv_s
    # RANSAC's n_valid >= min_pairs gate covers the host pre-check of the
    # serial matcher (pair_valid <= ok everywhere).
    res = ransac_mod.solve(
        samplers, pts_s, pts_d, uv_s_m, uv_d, pair_valid,
        torch.ones(d_d.shape[:2], dtype=torch.float32, device=d_d.device),
        rig.left.projection, rig.right.projection,
        inlier_threshold_px=rc.inlier_threshold_px, min_pairs=rc.min_pairs,
        min_inliers=rc.min_inliers,
    )
    return res.transform, idx, res.inlier_mask, res.success, res.num_inliers


def frame_banks(ids, banks, world: WorldMap, device, out=None):
    """The feature banks of frames `ids`: (descriptors [len, N, 8] int32,
    validity [len, N] bool, ideal observations [len, N, 4] float32),
    gathered on the device from the rings `banks` (odometer.empty_banks)
    or, when `banks` is None, uploaded from `world`'s host mirrors;
    written into `out`'s tensors when given."""
    out = out or (None, None, None)
    if banks is not None:
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=device)
        return tuple(torch.index_select(b, 0, rows, out=o) for b, o in zip(banks, out))
    got = []
    for mirror, o in zip((world.frame_desc, world.frame_feat_valid, world.frame_feat_uv), out):
        host = np.ascontiguousarray(mirror[ids])
        host = torch.from_numpy(host.view(np.int32) if host.dtype == np.uint32 else host)
        got.append(host.to(device) if o is None else o.copy_(host))
    return tuple(got)


def edge_bucket(E: int) -> int:
    """The padded edge count of a batch of E: the next power of two, at
    least 2 (the JAX package's `E_pad`)."""
    return max(2, 1 << (E - 1).bit_length())


class EdgeProgram(programs.Program):
    """`measure_edges` as a captured program for one bucket of E_pad edges
    on one rig: the two frames' banks ([E_pad, N, ...] each side) and the
    RANSAC keys ([E_pad, K_hyp, N], drawn outside the graph by each edge's
    `ransac.KeyedSampler`) in static tensors, and one body, `measure`, that
    runs `measure_edges` on them and packs its five outputs into one
    [E_pad, 16 + 2N + 2] int32 table (the transform's bits, idx, the
    inlier mask, success, the inlier count), read back once.

    `load` fills the inputs outside the graph: from device rings by a
    gather on frame ids, or from host mirrors by one upload each, so the
    graph never reads a tensor that can be replaced between replays (the
    live loop grows its rings into new tensors). Rows past E repeat the
    last real edge's frames and keys with every slot invalid, so RANSAC's
    min_pairs gate fails them."""

    def __init__(self, E_pad: int, n: int, rig: cam_mod.StereoRig, fe, rc):
        super().__init__(rig.device)
        dev = rig.device
        self.rig, self.fe, self.rc = rig, fe, rc
        self.rectified = bool(rig.rectified)
        self.banks = tuple((torch.empty((E_pad, n, 8), dtype=torch.int32, device=dev),
                            torch.empty((E_pad, n), dtype=torch.bool, device=dev),
                            torch.empty((E_pad, n, 4), dtype=torch.float32, device=dev))
                           for _ in range(2))   # src, dst
        self.keys = torch.empty((E_pad, rc.num_hypotheses, n), dtype=torch.float32, device=dev)
        self.packed = torch.empty((E_pad, 16 + 2 * n + 2), dtype=torch.int32, device=dev)

    @staticmethod
    def key(E_pad, n, rig, fe, rc):
        return (EdgeProgram, E_pad, n, id(rig), bool(rig.rectified), rig.device, fe, rc)

    def measure(self):
        (d_s, v_s, uv_s), (d_d, v_d, uv_d) = self.banks
        samplers = [functools.partial(ransac_mod.sets_from_keys, k) for k in self.keys]
        T, idx, inl, ok, n_inl = measure_edges(d_s, d_d, v_s, v_d, uv_s, uv_d, samplers,
                                               self.rig, self.fe, self.rc, self.rectified)
        self.packed.copy_(torch.cat([T.reshape(-1, 16).view(torch.int32), idx,
                                     inl.to(torch.int32), ok.to(torch.int32)[:, None],
                                     n_inl.to(torch.int32)[:, None]], dim=1))

    def load(self, src, dst, samplers, banks=None, world: Optional[WorldMap] = None):
        """The E real edges' banks (from the rings `banks`, else from
        `world`'s host mirrors) and keys, padded to the bucket."""
        E, E_pad, n = len(src), self.keys.shape[0], self.keys.shape[2]
        for side, ids in zip(self.banks, (src, dst)):
            frame_banks(list(ids) + [ids[-1]] * (E_pad - E), banks, world, self.device,
                        out=side)
            side[1][E:] = False
        for e, smp in enumerate(samplers):
            self.keys[e].copy_(smp.keys(n, self.device))
        self.keys[E:] = self.keys[E - 1]

    def outputs(self, E: int):
        """(transform [E, 4, 4] float32, idx [E, N] int32, inlier mask
        [E, N] bool, success [E] bool, num_inliers [E] int64) on the host,
        from one readback of the first E rows."""
        n = self.keys.shape[2]
        rows = self.packed[:E].cpu().numpy()
        return (rows[:, :16].view(np.float32).reshape(E, 4, 4), rows[:, 16:16 + n],
                rows[:, 16 + n:16 + 2 * n].astype(bool), rows[:, -2].astype(bool),
                rows[:, -1].astype(np.int64))


def measure_edges_program(src, dst, samplers, rig: cam_mod.StereoRig, fe, rc, banks=None,
                          world: Optional[WorldMap] = None,
                          cache: Optional[programs.ProgramCache] = None):
    """The E edges (src[e], dst[e]) through the cache's `EdgeProgram` of
    their bucket (one replay on the card; the body as it is on the CPU),
    their banks from the rings `banks` or from `world`'s host mirrors, one
    `ransac.KeyedSampler` per edge. Returns `EdgeProgram.outputs(E)`: the
    first E rows of `measure_edges` at E_pad, which are those of
    `measure_edges` at E bit for bit."""
    E = len(src)
    n = fe.num_features
    cache = programs.PROGRAMS if cache is None else cache
    E_pad = edge_bucket(E)
    prog = cache.get(EdgeProgram.key(E_pad, n, rig, fe, rc),
                     lambda: EdgeProgram(E_pad, n, rig, fe, rc))
    prog.load(src, dst, samplers, banks, world)
    prog.run("measure", prog.measure)
    return prog.outputs(E)


def make_loop_matcher(world: WorldMap, rig: cam_mod.StereoRig, cfg: SlamConfig,
                      seed: int = 1234, bank_getter=None,
                      sampler_for_edge: Optional[Callable[[int], ransac_mod.Sampler]] = None):
    """Loop-edge measurement: re-match stored frame features, RANSAC the
    relative transform, merge matched landmark identities.

    Returns a callable (src, dst) -> (Z, ok), the E = 1 case of its
    `.batch(edges)` method, which measures all pending edges as one
    `measure_edges` program with one readback. Edge i of the
    matcher's life draws its RANSAC sets from `sampler_for_edge(i)`, by
    default a Gumbel sampler on a generator seeded from (seed, i); the
    counter advances once per real edge in either mode, so E single calls
    and one batch of E see the same draws (the JAX package folds i into its
    key). When every sampler of a batch is a `ransac.KeyedSampler` the batch
    runs through `measure_edges_program` (padded to its bucket, the padded
    rows reusing the last real edge's keys); any other sampler, which a
    graph cannot replay, runs `measure_edges` eagerly at E.

    `bank_getter` (optional): () -> (bank_desc, bank_valid, bank_uv) device
    rings (odometer.empty_banks) or None. With rings (the fused-BoW live
    loop, whose host descriptor mirror is stale) the frames' banks are
    gathered on the device by frame id; otherwise they are uploaded from
    the world's host mirrors.

    Z satisfies X_dst = Z @ X_src (T_dst^-1 T_src = Z), the reference's
    loop-edge convention. `.last` holds the last batch's per-edge ok flags
    and inlier counts, its E and bucket (`edges`, `edges_padded`; the
    bucket is E when it ran eagerly), `.batches` the number of non-empty
    batches measured (one Hamming launch each)."""
    counter = [0]
    fe, rc = cfg.frontend, cfg.ransac
    dev = rig.device
    rectified = bool(rig.rectified)

    def default_sampler(i: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_edge_seed(seed, i))
        return ransac_mod.gumbel_sampler(gen, rc.num_hypotheses)

    sampler_for = sampler_for_edge or default_sampler

    def _merge(src: int, dst: int, idx_np, inl):
        # Merge matched landmark identities (Frame::UpdateMapPoint, ref
        # pose_graph_optimizer.cpp:241): dst's landmark is replaced by src's
        # for inlier matches.
        dst_pid = world.frame_feat_point[dst]
        src_pid = world.frame_feat_point[src][idx_np]
        sel = inl & (dst_pid >= 0) & (src_pid >= 0)
        if sel.any():
            world.merge_points(dst_pid[sel], src_pid[sel])

    def batch(edges):
        """[(src, dst)] -> [(Z, ok)]: the E edges measured by one
        `measure_edges` program on the device (one Hamming launch, one
        RANSAC solve), one readback; the landmark merges replay on the host
        in edge order (merge_points touches only the union-find and count
        tables, never the banks the matcher reads)."""
        E = len(edges)
        if E == 0:
            return []
        samplers = [sampler_for(counter[0] + e) for e in range(E)]
        counter[0] += E
        src = [s for s, _ in edges]
        dst = [d for _, d in edges]
        banks = bank_getter() if bank_getter is not None else None
        if all(isinstance(smp, ransac_mod.KeyedSampler) for smp in samplers):
            Zs, idx, inl, ok, n_inl = measure_edges_program(src, dst, samplers, rig, fe, rc,
                                                            banks, world)
            bucket = edge_bucket(E)
        else:
            (d_s, v_s, uv_s), (d_d, v_d, uv_d) = (frame_banks(ids, banks, world, dev)
                                                  for ids in (src, dst))
            outs = measure_edges(d_s, d_d, v_s, v_d, uv_s, uv_d, samplers, rig, fe, rc,
                                 rectified)
            Zs, idx, inl, ok, n_inl = (x.cpu().numpy() for x in outs)
            bucket = E
        matcher.batches += 1
        matcher.last = {"ok": ok.tolist(), "num_inliers": n_inl.tolist(), "edges": E,
                        "edges_padded": bucket}
        out = []
        for e, (src, dst) in enumerate(edges):
            if not ok[e]:
                out.append((np.eye(4, dtype=np.float32), False))
                continue
            _merge(src, dst, idx[e].astype(np.int64), inl[e])
            out.append((Zs[e].copy(), True))
        return out

    def matcher(src: int, dst: int):
        return batch([(src, dst)])[0]

    matcher.batch = batch
    matcher.last = None
    matcher.batches = 0
    return matcher


class SlamSystem:
    """End-to-end SLAM over a stereo stream, on the rig's device.

    `sampler_for_frame` (frame RANSAC) and `sampler_for_edge` (loop-edge
    RANSAC) default to the odometer's and the loop matcher's seeded Gumbel
    samplers; tests inject the JAX package's sets through them."""

    def __init__(self, rig: cam_mod.StereoRig, cfg: Optional[SlamConfig] = None,
                 vocab: Optional[OrbVocabulary] = None, seed: int = 0,
                 vocab_train_frames: int = 12, sampler_for_frame=None,
                 sampler_for_edge=None):
        self.cfg = cfg or SlamConfig()
        self.rig = rig
        self.device = rig.device
        self.world = WorldMap(feat_slots=self.cfg.frontend.num_features)
        self.vo = VisualOdometer(self.world, rig, self.cfg.frontend, self.cfg.ransac,
                                 seed=seed, sampler_for_frame=sampler_for_frame)
        self.ba = BundleAdjuster(self.world, rig, self.cfg.ba)
        self.pgo = PoseGraphOptimizer(
            self.world, self.cfg.pose_graph, bundle_adjuster=self.ba,
            loop_matcher=make_loop_matcher(
                self.world, rig, self.cfg,
                # The rings as of the last COLLECTED batch: the matcher
                # gathers frame banks on the device.
                bank_getter=lambda: self.vo.last_banks,
                sampler_for_edge=sampler_for_edge),
            device=self.device,
        )
        self.vocab = vocab
        self.vocab_train_frames = vocab_train_frames
        self.loop: Optional[LoopDetector] = None
        if vocab is not None:
            self.loop = LoopDetector(vocab, self.cfg.loop, optimizer=self.pgo)
        self.curr_pose = np.eye(4, dtype=np.float32)
        self.timers = StageTimers()
        self.ba_log = []  # (frames, wall_s, iterations, num_obs) per pipelined solve
        self.frame_index = 0
        # BoW scoring batches fused into the front-end chain (one word
        # assignment launch each).
        self.fused_score_batches = 0
        # Pipelined live loop: the finish() closure of the BA solve launched
        # for the previous batch, and the dispatch_batch handle in flight.
        self._pending_ba = None
        self._pending_batch = None
        # Device (database, db_size) threaded between fused dispatches; None
        # = rebuild from the LoopDetector's state.
        self._bow_dev = None
        # Device feature-bank rings threaded alongside; rows = frame ids.
        self._bank_dev = None
        self.pgo.pre_optimize_hook = self._finish_pending_ba

    def _finish_pending_ba(self):
        """Apply the previous batch's in-flight BA solve (readback +
        writeback). Nothing modifies the world between its launch and this
        call, so the result is the synchronous solve's."""
        if self._pending_ba is not None:
            fin, self._pending_ba = self._pending_ba, None
            with self.timers.time("ba.finish"):
                t0 = time.perf_counter()
                st = fin() or {}
                # The stats of THIS solve (the JAX package logs the adjuster's
                # last_stats, which a skipped solve leaves stale).
                self.ba_log.append((self.world.num_frames, time.perf_counter() - t0,
                                    st.get("iterations", -1), st.get("num_obs", -1)))

    def flush(self) -> list:
        """Drain the live-loop pipeline: collect the in-flight batch and
        apply the in-flight BA, so the world is complete."""
        out = self._collect_pending_batch()
        self._finish_pending_ba()
        return out

    # ------------------------------------------------------------ vocabulary
    def _maybe_train_vocab(self):
        """Train the vocabulary on the first frames' descriptors, then
        backfill the BoW database for every frame recorded so far. (The
        reference loads a prebuilt DBoW2 file instead, ref slam.cpp:101.)"""
        if self.loop is not None or self.world.num_frames < self.vocab_train_frames:
            return
        n = self.world.num_frames
        descs = [self.world.frame_desc[f][self.world.frame_feat_valid[f]] for f in range(n)]
        corpus = np.concatenate(descs) if descs else np.zeros((0, 8), np.uint32)
        if len(corpus) < self.cfg.loop.vocab_words:
            return
        slog.info(f"training vocabulary on {len(corpus)} descriptors")
        with self.timers.time("vocab.train"):
            self.vocab = OrbVocabulary.train(
                corpus, num_words=self.cfg.loop.vocab_words,
                iterations=self.cfg.loop.vocab_iterations, device=self.device)
            self.loop = LoopDetector(self.vocab, self.cfg.loop, optimizer=self.pgo)
            for f in range(n):
                self.loop.track(self.world.frame_desc[f], self.world.frame_feat_valid[f])

    # ----------------------------------------------------------------- frames
    def sync_feature_banks(self):
        """Copy the device descriptor rings into world.frame_desc (one bulk
        readback). Needed before anything reads host descriptors after
        fused-BoW batches: a vocabulary retrain, or sequential tracking,
        whose loop matcher reads the host mirrors."""
        if self._bank_dev is None or not self.world.frame_desc_stale:
            return
        nf = self.world.num_frames
        self.world.frame_desc[:nf] = self._bank_dev[0][:nf].cpu().numpy().view(np.uint32)
        self.world.frame_desc_stale = False

    def process(self, img_l, img_r) -> np.ndarray:
        """One frame through the full pipeline (ref slam.cpp:108-148)."""
        cfg = self.cfg
        self.flush()
        if self._bank_dev is not None:
            # Batched -> sequential: the sequential matcher and bookkeeping
            # use the host mirrors, so copy the rings down once and retire
            # them.
            self.sync_feature_banks()
            self._bank_dev = None
            self._bow_dev = None
            self.vo.last_banks = None
        with self.timers.time("vo.track"):
            trans = self.vo.track(img_l, img_r)

        n = self.world.num_frames
        if n > 0 and self.vo.success:
            if cfg.per_frame_ba:
                with self.timers.time("ba.per_frame"):
                    self.ba.optimize(n - 1, n)
            if n % cfg.refine_interval == 0:
                with self.timers.time("ba.window"):
                    self.ba.optimize(max(0, n - 2 * cfg.refine_interval), n)

        # Loop detection on the current frame's features (ref
        # slam.cpp:131-134), query before track. Frames the tracker did not
        # record are skipped (a deliberate fix: the reference re-queries
        # the stale previous container there and lets database ids drift
        # off frame ids, ref src/loop_detector.cpp:58).
        feats = self.vo.current_frame_features
        if self.vo.frame_recorded and feats is not None:
            self._maybe_train_vocab()
            if self.loop is not None:
                with self.timers.time("loop.query"):
                    # The frame's descriptors are still on the device.
                    desc = self.vo.last_result.slots.desc
                    self.loop.process_batch(desc[None], np.asarray(feats[3])[None], [True])
                # A loop exit above may have deferred a polish BA.
                self._adopt_deferred_polish()

        self.curr_pose = self.curr_pose @ trans
        self.frame_index += 1
        return trans

    def _grow_banks(self, cap: int):
        n = self.cfg.frontend.num_features
        bigger = empty_banks(cap, n, self.device)
        old = self._bank_dev[0].shape[0] - 1
        for new, ring in zip(bigger, self._bank_dev):
            new[:old] = ring[:old]
        self._bank_dev = bigger

    def process_batch(self, imgs_l, imgs_r) -> list:
        """K frames through the full pipeline, pipelined two batches deep.

        Per call: (1) apply the in-flight BA writeback (K > 1), (2) launch
        this batch's chain (K frame steps + BoW scoring and database append,
        with the tracker state, the database and the feature rings threading
        on the device), then (3) collect the previous batch: readback, map
        bookkeeping and Bayes filter on the host, and launch its windowed BA
        without waiting for it. The host replays everything in dispatch
        order, so the world and the filter are those of the unpipelined run.

        Returns the transforms of the PREVIOUS batch ([] on the first call);
        flush()/finish() drain the last one.

        As in the JAX package, the reference's per-frame BA (ref
        slam.cpp:123) and its every-10-frames window BA (ref
        slam.cpp:126-129) become one solve per batch over a window covering
        both (at K = 1, one solve per refine interval).
        """
        cfg = self.cfg
        k = len(imgs_l)
        if k > 1:
            # K = 1 defers the BA finish to the next solve's launch (see
            # _collect_pending_batch); batched mode applies it up front.
            self._finish_pending_ba()
        drained: list = []

        bow = None
        if self.loop is not None:
            if self._pending_batch is not None and self._pending_batch["bow"] is None:
                # The vocabulary trained while a bow-less batch was in
                # flight: its rows reach the database only through the host
                # replay, so drain BEFORE taking the device database.
                drained = self._collect_pending_batch()
                self._bow_dev = None
                self._bank_dev = None
            inflight = self._pending_batch["k"] if self._pending_batch else 0
            if self.loop.db_size + inflight + k > self.loop.database.shape[0]:
                # Grow the database (and the rings) after draining.
                drained += self._collect_pending_batch()
                self.loop._ensure_capacity(self.loop.db_size + k)
                self._bow_dev = None
                if self._bank_dev is not None:
                    self._grow_banks(self.loop.database.shape[0])
            if self._bow_dev is None:
                self._bow_dev = (self.loop.database,
                                 torch.tensor(self.loop.db_size, device=self.device))
            if self._bank_dev is None:
                # Fresh rings at the database's capacity; frames recorded
                # before the fused mode began backfill from the host mirrors.
                if self.world.frame_desc_stale:
                    raise RuntimeError(
                        "frame_desc stale while rebuilding the device banks: "
                        "sync_feature_banks() must run before the rings are retired")
                nf = self.world.num_frames
                banks = empty_banks(self.loop.database.shape[0],
                                    self.cfg.frontend.num_features, self.device)
                if nf > 0:
                    banks[0][:nf] = desc_tensor(
                        self.world.frame_desc[:nf].reshape(-1, 8), self.device
                    ).reshape(nf, -1, 8)
                    banks[1][:nf] = torch.as_tensor(self.world.frame_feat_valid[:nf],
                                                    device=self.device)
                    banks[2][:nf] = torch.as_tensor(self.world.frame_feat_uv[:nf],
                                                    device=self.device)
                self._bank_dev = banks
            bow = (self.vocab.centroids, self.vocab.idf, self._bow_dev[0], self._bow_dev[1],
                   cfg.loop.query_size)

        with self.timers.time("vo.dispatch"):
            handle = self.vo.dispatch_batch(imgs_l, imgs_r, bow=bow, banks=self._bank_dev)
        if bow is not None:
            self.fused_score_batches += 1
            self._bow_dev = (handle["bow"][0], handle["bow"][1])
            self._bank_dev = handle["banks"]

        out = self._collect_pending_batch()
        self._pending_batch = handle
        return drained + out

    def _collect_pending_batch(self) -> list:
        """Collect the in-flight batch: readback, map update, BA launch,
        Bayes-filter replay, pose chaining."""
        if self._pending_batch is None:
            return []
        handle, self._pending_batch = self._pending_batch, None
        cfg = self.cfg
        if handle["k"] > 1:
            # Batched mode: apply any in-flight BA BEFORE this batch's map
            # bookkeeping, which keeps the pipelined world that of the eager
            # order. At K = 1 the finish waits for the next solve's launch
            # below, so a readback one frame after a launch does not wait on
            # the solve's execution.
            self._finish_pending_ba()
        n_before = self.world.num_frames
        with self.timers.time("vo.collect"):
            trans_list = self.vo.collect_batch(handle)

        n = self.world.num_frames
        if n > n_before and n >= 2:
            lo = (min(max(0, n_before - 1), max(0, n - 2 * cfg.refine_interval))
                  if cfg.per_frame_ba else max(0, n - 2 * cfg.refine_interval))
            crossed = (n // cfg.refine_interval) > (n_before // cfg.refine_interval)
            # K = 1: solve on refine-interval crossings only; the window
            # [lo, n) covers every frame since the last solve.
            if (cfg.per_frame_ba and handle["k"] > 1) or crossed:
                self._finish_pending_ba()
                with self.timers.time("ba.window"):
                    self._pending_ba = self.ba.optimize_async(
                        lo, n, max_iterations=cfg.live_ba_iterations)

        if handle["bow"] is not None and n > n_before:
            # A loop exit inside this replay runs the pose graph, whose
            # pre_optimize_hook finishes the in-flight BA first.
            with self.timers.time("loop.query"):
                self.loop.ingest_batch_topk(
                    self.vo.last_topk_ids, self.vo.last_topk_scores,
                    self.vo.last_batch_recorded, self.vo.last_new_database)
        elif handle["bow"] is not None:
            self.loop.database = self.vo.last_new_database  # unchanged rows
        elif self.loop is not None and n > n_before:
            # Launched before the vocabulary existed (it trained while this
            # batch was in flight): replay the batch's query + track in one
            # scoring pass so the database rows stay aligned with frame ids.
            with self.timers.time("loop.query"):
                lb = self.vo.last_batch
                self.loop.process_batch(lb.slots.desc, lb.slots.valid,
                                        self.vo.last_batch_recorded)
                self._bow_dev = None
                self._bank_dev = None
        if self.loop is None and n > n_before:
            self._maybe_train_vocab()

        self._adopt_deferred_polish()
        for trans in trans_list:
            self.curr_pose = self.curr_pose @ trans
        self.frame_index += handle["k"]
        return trans_list

    def _adopt_deferred_polish(self):
        """Move a live closure's deferred polish-BA finisher into the
        pending-BA slot, so the next batch boundary collects it. The slot is
        free in the normal order (the closure's pre_optimize_hook finished
        the window solve); if it is not, the pending solve is finished first
        rather than dropped (the JAX package asserts here)."""
        fin = getattr(self.pgo, "deferred_ba_finish", None)
        if fin is not None:
            self.pgo.deferred_ba_finish = None
            if self._pending_ba is not None:
                self._finish_pending_ba()
            self._pending_ba = fin

    def finish(self, max_seconds: Optional[float] = None) -> dict:
        """End of sequence: pose graph + final global BA (ref
        slam.cpp:152-156). `max_seconds` bounds the whole stage: the pose
        graph's global BA gets half, the final BA what remains (each cap
        deflated by 0.8, since a cap is checked between solve chunks only).
        None = BAConfig's max_solve_seconds per solve."""
        self.flush()
        t0 = time.perf_counter()
        stats = {}
        slack = 0.8
        with self.timers.time("pose_graph.final"):
            stats["pose_graph"] = self.pgo.optimize(
                ba_max_seconds=(max_seconds / 2 * slack if max_seconds else None))
        n = self.world.num_frames
        if n >= 2:
            with self.timers.time("ba.final"):
                remaining = None
                if max_seconds is not None:
                    # A floor: the capped path still runs its one-iteration
                    # probe chunk.
                    remaining = max((max_seconds - (time.perf_counter() - t0)) * slack, 0.5)
                # The reference's global BA leaves out the last frame (end =
                # N-1, exclusive; ref slam.cpp:156), kept for parity.
                stats["final_ba"] = self.ba.optimize(0, n - 1, max_seconds=remaining)
        stats["seconds"] = time.perf_counter() - t0
        return stats

    def export(self, folder: str, suffix: Optional[str] = None):
        """Write the txt + PLY artifacts (ref slam.cpp:159-171), the loop
        trace and the vocabulary."""
        self.flush()
        suffix = suffix or self.cfg.output_suffix
        os.makedirs(folder, exist_ok=True)
        export.dump_world(folder, self.world)
        w = self.world
        poses = w.pose_global[: w.num_frames]
        live = w.point_obs_count[: w.num_points] > 0
        export.save_poses_ply(os.path.join(folder, f"waypoints_{suffix}.ply"), poses)
        export.save_map_ply(os.path.join(folder, f"map_{suffix}.ply"), poses,
                            w.points[: w.num_points][live],
                            w.point_obs_count[: w.num_points][live])
        export.save_pose_graph_ply(os.path.join(folder, f"pose_graph_{suffix}.ply"), poses,
                                   getattr(self.pgo, "committed_edges", []))
        export.save_kitti_trajectory(os.path.join(folder, f"trajectory_{suffix}.txt"), poses)
        if self.loop is not None:
            self.loop.save_trace(os.path.join(folder, "loop_matches.txt"))
        if self.vocab is not None:
            self.vocab.save(os.path.join(folder, "vocabulary.npz"))


def main(argv=None) -> dict:
    """Run the CLI; returns a summary: frames, tracked, live_fps, fps,
    median_ms (per frame, over the process calls), frame_ms, finish stats
    and seconds, ate_m / rpe (None without --gt) and the SlamSystem."""
    ap = argparse.ArgumentParser(description="Stereo SLAM, the full pipeline (PyTorch)")
    ap.add_argument("--dataset", required=True, help="kitti | EuRoc | other")
    ap.add_argument("--folder", required=True)
    ap.add_argument("--camera", required=True, help="calibration file")
    ap.add_argument("--refine_interval", type=int, default=10)
    ap.add_argument("--batch_frames", type=int, default=1,
                    help="frames per launched batch of the live loop")
    ap.add_argument("--output_suffix", default="slam")
    ap.add_argument("--output_dir", default=".")
    ap.add_argument("--vocab", default=None, help="vocabulary .npz (optional)")
    ap.add_argument("--num_features", type=int, default=0,
                    help="corners per image (0 = config default 1024; the "
                         "reference's MAX_CORNER is a compile-time constant, "
                         "ref src/params.h:9)")
    ap.add_argument("--loop_query_size", type=int, default=0,
                    help="BoW top-k per query (0 = config default 4, ref "
                         "src/params.h:54). Larger keeps distant-frame "
                         "candidates visible during long revisits, when "
                         "adjacent hits crowd a small top-k.")
    ap.add_argument("--ransac_refit", action="store_true",
                    help="re-fit the RANSAC pose on the winning hypothesis's "
                         "inliers (final_model_fitting). The reference ships "
                         "it OFF (ref src/params.h:18), which stays the "
                         "default.")
    ap.add_argument("--finish_seconds", type=float, default=0.0,
                    help="wall budget for the end-of-sequence pose graph + "
                         "global BA polish (0 = per-solve BAConfig caps only)")
    ap.add_argument("--preload_device", action="store_true",
                    help="decode and upload every frame to the device before "
                         "the timed loop")
    ap.add_argument("--live_ba_iterations", type=int, default=0,
                    help="LM iteration budget of each live window solve "
                         "(0 = config default 12)")
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--gt", default=None, help="KITTI ground-truth poses for ATE")
    ap.add_argument("--debug_viz", default=None, metavar="DIR",
                    help="write Stereo/Temporal/Tracking debug PNGs (the "
                         "reference's three imshow windows, ref "
                         "visual_odometer.cpp:31-33)")
    ap.add_argument("--debug_viz_every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False

    pairs = datasets.load_dataset(args.dataset, args.folder)
    if args.max_frames:
        pairs = pairs[: args.max_frames]
    rig = calib.load_camera(args.camera, device=args.device)
    vocab = OrbVocabulary.load(args.vocab, device=args.device) if args.vocab else None
    cfg = SlamConfig().replace(refine_interval=args.refine_interval,
                               output_suffix=args.output_suffix,
                               batch_frames=max(1, args.batch_frames))
    if args.num_features:
        cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend,
                                                       num_features=args.num_features))
    if args.loop_query_size:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, query_size=args.loop_query_size))
    if args.ransac_refit:
        cfg = cfg.replace(ransac=dataclasses.replace(cfg.ransac, final_model_fitting=True))
    if args.live_ba_iterations:
        cfg = cfg.replace(live_ba_iterations=args.live_ba_iterations)
    system = SlamSystem(rig, cfg, vocab=vocab)

    times = []  # (seconds, frames) per process call

    def run(fn, *imgs, k=1, first=0):
        t0 = time.perf_counter()
        fn(*imgs)
        dt = time.perf_counter() - t0
        times.append((dt, k))
        slog.info(f"frames #{first}-{first + k - 1}: {dt * 1e3:.1f} ms "
                  f"({dt * 1e3 / k:.1f} ms/frame)")

    staged = None
    if args.preload_device and not args.debug_viz:
        # All batches on the device before the timed loop.
        rdr = datasets.DeviceBatchReader(pairs, cfg.batch_frames, device=args.device)
        staged = list(rdr)
        staged_rem = list(rdr.remainder)

    t_start = time.perf_counter()
    i = 0
    if not args.debug_viz:
        # K frames per call through the pipelined dispatch/collect pair; K = 1
        # is the reference cadence (one pose out per frame in). The reader
        # thread decodes and uploads ahead of the loop.
        reader = staged if staged is not None else datasets.DeviceBatchReader(
            pairs, cfg.batch_frames, device=args.device)
        for dl, dr in reader:
            k = int(dl.shape[0])
            run(system.process_batch, dl, dr, k=k, first=i)
            i += k
        remainder = staged_rem if staged is not None else reader.remainder
        for img_l, img_r in remainder:
            run(system.process, img_l, img_r, first=i)
            i += 1
    else:
        from stereo_orb_slam_torch.utils import viz

        prev_img, prev_slots = None, None
        for img_l, img_r in datasets.PrefetchingReader(pairs):
            prev_slots = system.vo.prev
            run(system.process, img_l, img_r, first=i)
            if i % max(1, args.debug_viz_every) == 0 and system.vo.last_result is not None:
                viz.save_frame_debug(args.debug_viz, i, img_l, img_r, system.vo.last_result,
                                     prev_img=prev_img, prev_slots=prev_slots)
            if system.vo.success:
                prev_img = img_l
            i += 1
    system.flush()  # drain the pipeline: live fps covers every tracked frame
    t_live = time.perf_counter() - t_start
    live_ate = None
    if args.gt:
        gt = evaluate.load_kitti_gt(args.gt)
        n0 = system.world.num_frames
        live_ate = evaluate.ate_rmse(system.world.pose_global[:n0], gt)
        print(f"live ATE RMSE: {live_ate:.3f} m")
    finish = system.finish(max_seconds=args.finish_seconds or None)
    total = time.perf_counter() - t_start

    system.export(args.output_dir, args.output_suffix)
    n = system.world.num_frames
    # Live fps leaves out the end-of-sequence pose graph + global BA (the
    # reference prints per-frame times for the same region, ref
    # slam.cpp:136-138); the overall figure includes them.
    slog.info(f"live loop: {len(pairs) / t_live:.2f} fps")
    slog.info(f"processed {len(pairs)} frames -> {n} tracked, {len(pairs) / total:.2f} fps")
    print(system.timers.report())
    per_frame = [dt / k for dt, k in times]
    summary = {"frames": len(pairs), "tracked": n, "live_fps": len(pairs) / t_live,
               "fps": len(pairs) / total,
               "median_ms": float(np.median(per_frame) * 1e3) if per_frame else 0.0,
               "frame_ms": [t * 1e3 for t in per_frame], "finish": finish,
               "finish_seconds": finish["seconds"], "live_ate_m": live_ate, "ate_m": None,
               "rpe": None, "system": system}
    if args.gt:
        ate = evaluate.ate_rmse(system.world.pose_global[:n], gt)
        t_rpe, r_rpe = evaluate.rpe(system.world.pose_global[:n], gt)
        print(f"ATE RMSE: {ate:.3f} m   RPE: {t_rpe:.4f} m / {r_rpe:.5f} rad")
        summary["ate_m"], summary["rpe"] = ate, (t_rpe, r_rpe)
    return summary


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

"""Per-frame stereo visual odometry front end.

PyTorch counterpart of the JAX package's `frontend/odometer.py` (the
reference `VisualOdometer`, ref `src/visual_odometer.h:16-96`,
`src/visual_odometer.cpp:105-221`). The per-frame compute (corners on both
images, ORB descriptors, stereo matching, triangulation and depth gating,
temporal matching, batched RANSAC) runs on the tensors' device; the host
then does the map bookkeeping on the small per-frame results.

Per-frame state lives in slot-aligned arrays of capacity `num_features`
with validity masks: slot i of every array refers to left corner i.

Behaviour kept from the JAX package (and the reference):
- fewer than `min_stereo_matches` stereo matches: the frame is not
  recorded (ref :117-121);
- RANSAC failure: the frame is recorded with identity relative pose, all
  its points become new landmarks, and the previous frame is kept for the
  next temporal match (ref :206-217);
- each slot's own descriptor is kept (the reference's wrong-index append at
  :407 is fixed).

The minimal-set sampler of frame i is `sampler_for_frame(i)`, by default a
Gumbel sampler on a generator seeded from (seed, i), so `track_batch` and K
`track` calls see the same draws.

On either rig, rectified or general (distorted, non-rectified), the
entry points run the captured front end (`ChainProgram`,
utils/programs.py), the counterpart of the JAX package's
`frontend_step_fused` and `frontend_chain` with `rectified` static (one
device program for a step, a `lax.scan` for K): `batched_frontend_step`
with the record/swap state machine is captured once per shape and rig as
a CUDA graph, a `track` is one replay, a K-frame batch K replays and the
BoW scoring one more. The general rig's undistort and batched DLT run
inside the graph (the DLT's hand kernel has no host sync). The eager
functions (`frontend_step`, `frontend_chain`, `frontend_chain_bow`) are
its plain versions, held to it bit for bit. Each frame's RANSAC keys are
drawn outside the graph (`ransac.KeyedSampler`).

The live loop (apps/slam.py) runs K-frame batches as a two-deep pipeline:
`dispatch_batch` launches a batch's chain (with the BoW scoring and the
feature-bank rings of `frontend_chain_bow` once a vocabulary exists) and,
right behind it, the copy of its results to pinned host memory, while the
tracker state threads on the device; `collect_batch` waits for that copy
alone and replays the host bookkeeping, while the device runs what was
launched after it. The host replay is one per frame (`_record`, what
`track` runs), so a K-frame batch writes the map as K `track` calls do, a
frame at a time. After a collected batch the previous
frame's slots (descriptors included) are the device carry, so a switch to
`track` finds them even when the host mirror kept no descriptors.
"""

from __future__ import annotations

import functools
import gc
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
from stereo_orb_slam_torch.frontend import ransac
from stereo_orb_slam_torch.geometry import camera as cam_mod
from stereo_orb_slam_torch.loop.vocab import batch_score_update
from stereo_orb_slam_torch.ops import detect, match, orb
from stereo_orb_slam_torch.utils import programs
from stereo_orb_slam_torch.utils.profiling import TRACER
from stereo_orb_slam_torch.worldmap import WorldMap


class FrameSlots(NamedTuple):
    """Slot-aligned per-frame state. Slot = left-corner index."""

    kp_l: torch.Tensor   # [N,2]
    kp_r: torch.Tensor   # [N,2]
    desc: torch.Tensor   # [N,8] int32 words (uint32 bit patterns)
    pts: torch.Tensor    # [N,3] camera-frame 3D points
    valid: torch.Tensor  # [N] bool


class StepResult(NamedTuple):
    slots: FrameSlots
    transform: torch.Tensor       # [4,4] rel pose: X_prev = T @ X_curr
    prev_idx: torch.Tensor        # [N] temporal match into prev slots
    tracked: torch.Tensor         # [N] temporal match passed RANSAC inliers
    ransac_success: torch.Tensor  # bool
    num_stereo: torch.Tensor      # int32
    num_temporal: torch.Tensor    # int32
    num_inliers: torch.Tensor     # int32


def empty_slots(n: int, device="cuda") -> FrameSlots:
    return FrameSlots(
        kp_l=torch.zeros((n, 2), dtype=torch.float32, device=device),
        kp_r=torch.zeros((n, 2), dtype=torch.float32, device=device),
        desc=torch.zeros((n, 8), dtype=torch.int32, device=device),
        pts=torch.zeros((n, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def detect_and_describe(img, fe: FrontendConfig, steer=None):
    """Corners + ORB descriptors for one image [H, W], or for a batch of
    images [S, H, W] (one describe launch for all of them)."""
    xy, _, v = detect.detect_corners(
        img, num_features=fe.num_features, quality_level=fe.quality_level,
        block_size=fe.block_size, min_distance=fe.min_distance,
        subpix=fe.subpix,
    )
    if steer is None:
        steer = orb.steer_table(fe.oriented, img.device)
    d, _ = orb.compute_descriptors(
        img, xy, v, smoothing_ksize=fe.smoothing_ksize,
        orientation_radius=fe.orientation_radius, steer=steer,
    )
    return xy, v, d


def _take(x, idx):
    """x[s, idx[s]] for every sequence s: x [S, N, ...], idx [S, M] int64."""
    seq = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[seq, idx]


def associate(
    xy_l, v_l, d_l, xy_r, v_r, d_r,
    prev: FrameSlots, prev_usable, samplers,
    rig: cam_mod.StereoRig, max_distance,
    fe: FrontendConfig, rc: RansacConfig,
    rectified: Optional[bool] = None,
) -> StepResult:
    """Stereo match + triangulate + temporal match + RANSAC, for S
    sequences at once: every input with a leading S axis ([S] for
    prev_usable), one sampler per sequence, and a rig shared by all or
    stacked (`camera.stack_rigs`, one per sequence); max_distance is a
    scalar or [S].

    Both matching stages take the left descriptors as queries, so one
    top-2 search runs against the right images' and the previous frames'
    descriptors together (one launch for all S sequences); each result is
    then gated with its own query validity (left-corner validity for
    stereo, the slot validity that stereo produces for temporal)."""
    prev_valid = prev.valid & prev_usable[:, None]
    stereo_top2, temporal_top2 = match.hamming_top2_pair(
        d_l, d_r, v_r, prev.desc, prev_valid)
    # Stereo matching: left query -> right train (ref :262-289).
    r_idx, s_ok, _ = match.gate_matches(
        stereo_top2, v_l, max_distance=fe.match_max_distance, ratio=fe.match_ratio,
    )
    kp_r = _take(xy_r, r_idx.long())

    # A non-rectified rig's pixels are undistorted once, here, so slots,
    # map observations and RANSAC all see ideal pinhole coordinates.
    if rectified is False:
        xy_l = cam_mod.undistort_points(rig.left, xy_l)
        kp_r = cam_mod.undistort_points(rig.right, kp_r)

    pts, tri_ok = cam_mod.triangulate_ideal(
        rig, xy_l, kp_r, rectified=(True if rectified is None else rectified),
    )
    depth_ok = torch.abs(pts[..., 2]) < torch.as_tensor(max_distance)[..., None]
    slot_valid = v_l & s_ok & tri_ok & depth_ok
    pts = torch.where(slot_valid[..., None], pts, 0.0)

    slots = FrameSlots(kp_l=xy_l, kp_r=kp_r, desc=d_l, pts=pts, valid=slot_valid)
    num_stereo = torch.sum(slot_valid.to(torch.int32), dim=-1)

    # Temporal matching curr -> prev (ref :316-333; MatchPoints :64-91);
    # the slots' descriptors are d_l.
    prev_idx, t_ok, _ = match.gate_matches(
        temporal_top2, slot_valid, max_distance=fe.match_max_distance,
        ratio=fe.match_ratio,
    )
    num_temporal = torch.sum(t_ok.to(torch.int32), dim=-1)

    # Batched RANSAC pose (ref :158-177), one sampler per sequence.
    pi = prev_idx.long()
    obs_curr = torch.cat([slots.kp_l, slots.kp_r], dim=-1)
    obs_prev_all = torch.cat([prev.kp_l, prev.kp_r], dim=-1)
    res = ransac.solve(
        samplers,
        slots.pts,
        _take(prev.pts, pi),
        obs_curr,
        _take(obs_prev_all, pi),
        t_ok,
        torch.ones(t_ok.shape, dtype=torch.float32, device=xy_l.device),
        rig.left.projection,
        rig.right.projection,
        inlier_threshold_px=rc.inlier_threshold_px,
        min_pairs=rc.min_pairs,
        min_inliers=rc.min_inliers,
        final_model_fitting=rc.final_model_fitting,
    )
    return StepResult(
        slots=slots,
        transform=res.transform,
        prev_idx=prev_idx,
        tracked=res.inlier_mask & t_ok,
        ransac_success=res.success,
        num_stereo=num_stereo,
        num_temporal=num_temporal,
        num_inliers=res.num_inliers,
    )


def batched_frontend_step(imgs_l, imgs_r, prev: FrameSlots, prev_usable, samplers,
                          rig: cam_mod.StereoRig, max_distance, fe: FrontendConfig,
                          rc: RansacConfig, rectified=None, steer=None) -> StepResult:
    """The full per-frame front end, Track() (ref visual_odometer.cpp:105-221),
    for S sequences in one batched program: imgs [S, H, W] (uint8 or float32
    tensors on the rig's device), prev with a leading S axis, prev_usable
    [S], one sampler per sequence, a shared or stacked rig. Every field of
    the result has the leading S axis. On the card a step launches
    `hamming_top2` once and `orb_describe` twice (left images, right
    images), whatever S is. The JAX package vmaps `frontend_step` over
    sequences (its parallel/multi_seq.py); each sequence's result is the
    one it gets alone."""
    imgs_l = imgs_l.to(torch.float32)
    imgs_r = imgs_r.to(torch.float32)
    xy_l, v_l, d_l = detect_and_describe(imgs_l, fe, steer)
    xy_r, v_r, d_r = detect_and_describe(imgs_r, fe, steer)
    return associate(xy_l, v_l, d_l, xy_r, v_r, d_r, prev, prev_usable, samplers,
                     rig, max_distance, fe, rc, rectified)


def frontend_step(img_l, img_r, prev: FrameSlots, prev_usable, sampler,
                  rig: cam_mod.StereoRig, max_distance, fe: FrontendConfig,
                  rc: RansacConfig, rectified=None, steer=None) -> StepResult:
    """The full per-frame front end of one sequence: `batched_frontend_step`
    with S = 1. Images may be uint8 or float32 tensors on the rig's
    device."""
    prev_b = FrameSlots(*(x[None] for x in prev))
    usable = torch.as_tensor(prev_usable, device=prev.valid.device).reshape(1)
    res = batched_frontend_step(img_l[None], img_r[None], prev_b, usable, [sampler], rig,
                                max_distance, fe, rc, rectified, steer)
    return StepResult(FrameSlots(*(x[0] for x in res.slots)), *(x[0] for x in res[1:]))


def frontend_chain(imgs_l, imgs_r, prev: FrameSlots, prev_initialized, samplers,
                   rig, max_distance, fe: FrontendConfig, rc: RansacConfig,
                   rectified=None, steer=None):
    """K dependent frame steps, with the host's record/swap state machine
    kept on the device (no host sync between frames):

      record = num_stereo >= min_stereo_matches
      swap   = record & (first_frame | ransac_success)

    Returns ((prev, initialized) after the K frames, the K StepResults
    stacked on a leading axis).
    """
    initialized = torch.as_tensor(prev_initialized, device=prev.valid.device)
    results = []
    for img_l, img_r, sampler in zip(imgs_l, imgs_r, samplers):
        res = frontend_step(img_l, img_r, prev, initialized, sampler, rig,
                            max_distance, fe, rc, rectified, steer)
        record = res.num_stereo >= fe.min_stereo_matches
        swap = record & (~initialized | res.ransac_success)
        prev = FrameSlots(*(torch.where(swap, new, old)
                            for new, old in zip(res.slots, prev)))
        # Any frame, recorded or not, marks the odometer initialized.
        initialized = torch.ones_like(initialized)
        results.append(res)
    stacked = StepResult(
        slots=FrameSlots(*(torch.stack(f) for f in zip(*(r.slots for r in results)))),
        **{name: torch.stack([getattr(r, name) for r in results])
           for name in StepResult._fields[1:]},
    )
    return (prev, initialized), stacked


def empty_banks(capacity: int, n: int, device="cuda"):
    """Feature-bank rings for `capacity` frames of n slots: descriptors
    [capacity + 1, n, 8] int32, validity [capacity + 1, n] bool and ideal
    stereo observations [capacity + 1, n, 4] float32. Row f holds frame f;
    the last row is scratch, written by the frames that are not recorded."""
    return (torch.zeros((capacity + 1, n, 8), dtype=torch.int32, device=device),
            torch.zeros((capacity + 1, n), dtype=torch.bool, device=device),
            torch.zeros((capacity + 1, n, 4), dtype=torch.float32, device=device))


class Rings(programs.Program):
    """A set of feature-bank rings (`empty_banks`) that the program cache
    owns, as a program owns its static tensors: the fused front end is
    captured on the rings it writes, so every live loop of one capacity,
    feature count and device that writes the same set replays the programs
    captured on it. `holder` (a weak reference) is the live loop writing
    them; a set whose holder is gone is free."""

    def __init__(self, capacity: int, n: int, device):
        super().__init__(device)
        self.banks = empty_banks(capacity, n, device)
        self.holder = None

    def held(self) -> bool:
        return self.holder is not None and self.holder() is not None


def take_rings(capacity: int, n: int, device, holder, cache=None):
    """Rings for `holder` to write (`empty_banks`' tensors): a set of this
    capacity, feature count and device in the program cache that no live
    holder writes, else a new one. When every set is held, holders that
    only a reference cycle keeps are collected first. A taken set keeps the
    rows of its last holder: rows past the frames recorded so far are never
    read."""
    cache = programs.PROGRAMS if cache is None else cache
    dev = torch.device(device)

    def free_slot():
        slot = 0
        while (Rings, capacity, n, dev, slot) in cache:
            if not cache.get((Rings, capacity, n, dev, slot), None).held():
                return slot, True
            slot += 1
        return slot, False

    slot, free = free_slot()
    if not free and slot:
        gc.collect()
        slot, free = free_slot()
    rings = cache.get((Rings, capacity, n, dev, slot), lambda: Rings(capacity, n, dev))
    rings.holder = weakref.ref(holder)
    return rings.banks


def frontend_chain_bow(imgs_l, imgs_r, prev: FrameSlots, prev_initialized, samplers,
                       rig, max_distance, fe: FrontendConfig, rc: RansacConfig,
                       rectified, steer, centroids, idf, database, db_size,
                       query_size: int, banks):
    """frontend_chain + the K frames' BoW scoring and database append
    (loop/vocab.batch_score_update), all launched with no host sync: the
    per-batch hot path of ref `src/slam.cpp:108-134` (Track + loop
    Query/Track). `recorded` is derived on the device from the state
    machine that the host replays (the num_stereo gate).

    The recorded frames' feature banks (descriptors, validity, ideal stereo
    observations) are written into the rings `banks` (see empty_banks) at
    row db_size + #recorded-before, the database's row rule, so ring rows,
    database rows and world frame ids agree; the loop-edge matcher gathers
    them there. The rings are written in place (rows only ever appended;
    unrecorded frames write the scratch row); the database is a new tensor.

    Returns (carry, stacked StepResult, top_ids [K, q] int32, top_scores
    [K, q], new_database, new_db_size (0-d), banks)."""
    carry, res = frontend_chain(imgs_l, imgs_r, prev, prev_initialized, samplers, rig,
                                max_distance, fe, rc, rectified, steer)
    top_ids, top_scores, new_db, new_db_size = _score_and_bank(
        res, fe, centroids, idf, database, db_size, query_size, banks)
    return carry, res, top_ids, top_scores, new_db, new_db_size, banks


def _score_and_bank(res: StepResult, fe: FrontendConfig, centroids, idf, database, db_size,
                    query_size: int, banks):
    """The K stacked frames' BoW scoring and database append, and their
    bank rows written into the rings `banks` in place. Returns (top_ids,
    top_scores, new_database, new_db_size)."""
    recorded = res.num_stereo >= fe.min_stereo_matches
    top_ids, top_scores, new_db = batch_score_update(
        res.slots.desc, res.slots.valid, recorded, centroids, idf, database, db_size,
        query_size=query_size)
    rec_i = recorded.to(torch.int64)
    new_db_size = db_size + torch.sum(rec_i)
    rows = db_size + torch.cumsum(rec_i, 0) - rec_i
    safe_rows = torch.where(recorded, rows, banks[0].shape[0] - 1)
    uv4 = torch.cat([res.slots.kp_l, res.slots.kp_r], dim=-1)
    for ring, vals in zip(banks, (res.slots.desc, res.slots.valid, uv4)):
        ring[safe_rows] = vals
    return top_ids, top_scores, new_db, new_db_size


def _empty_results(lead: tuple, n: int, device) -> StepResult:
    """A StepResult of empty tensors with leading dims `lead`."""
    def e(shape, dtype):
        return torch.empty(lead + shape, dtype=dtype, device=device)

    f32, i64 = torch.float32, torch.int64
    return StepResult(
        slots=FrameSlots(e((n, 2), f32), e((n, 2), f32), e((n, 8), torch.int32),
                         e((n, 3), f32), e((n,), torch.bool)),
        transform=e((4, 4), f32), prev_idx=e((n,), torch.int32), tracked=e((n,), torch.bool),
        ransac_success=e((), torch.bool), num_stereo=e((), i64), num_temporal=e((), i64),
        num_inliers=e((), i64))


def _leaves(res: StepResult):
    return list(res.slots) + list(res[1:])


def _select(res, index):
    """A StepResult or FrameSlots (tensors or NumPy arrays) with `index`
    applied to every field's leading dims; a None field (host descriptors
    left on the device) stays None."""
    if isinstance(res, FrameSlots):
        return FrameSlots(*(None if x is None else x[index] for x in res))
    return StepResult(_select(res.slots, index), *(x[index] for x in res[1:]))


class ChainProgram(programs.Program):
    """The front end as a captured program: `batched_frontend_step`
    together with `frontend_chain`'s record/swap state machine for S
    sequences on the rig's path (rectified or general, a static choice as
    the JAX package's `rectified` argument), with the carry (prev slots,
    initialized) in static tensors
    and each step's result written into row j of a static [K, S, ...]
    stack; plus, with `bow`, the K frames' BoW scoring, database append and
    bank writes as a second body. `frontend_chain` is K replays of `step`
    (the counterpart of the JAX package's `lax.scan`), `frontend_step` and
    `track` one, a multi-sequence step one at S sequences.

    Each frame's RANSAC randomness is drawn outside the graph: every
    sampler is a `ransac.KeyedSampler`, whose [K_hyp, N] Gumbel keys go
    into a static tensor that `step` selects from. The rig, the sampling
    table and, with `bow`, the vocabulary and the bank rings are read in
    place (the program keeps them and is keyed by their identity); images,
    keys, the carry, max_distance and the database are copied in."""

    def __init__(self, S: int, K: int, imgs, max_distance, rig: cam_mod.StereoRig, steer,
                 fe: FrontendConfig, rc: RansacConfig, bow=None):
        super().__init__(rig.device)
        dev, n = rig.device, fe.num_features
        self.rig, self.steer, self.fe, self.rc = rig, steer, fe, rc
        self.rectified = bool(rig.rectified)
        self.imgs_l = torch.empty((S,) + tuple(imgs.shape[-2:]), dtype=imgs.dtype, device=dev)
        self.imgs_r = torch.empty_like(self.imgs_l)
        self.keys = torch.empty((S, rc.num_hypotheses, n), dtype=torch.float32, device=dev)
        self.max_distance = torch.empty(tuple(max_distance.shape), dtype=torch.float32,
                                        device=dev)
        self.j = torch.zeros(1, dtype=torch.int64, device=dev)
        self.prev = _empty_results((S,), n, dev).slots
        self.initialized = torch.empty((S,), dtype=torch.bool, device=dev)
        self.out = _empty_results((K, S), n, dev)
        self.bow_args = None
        if bow is not None:
            centroids, idf, database, query_size, banks = bow[:5]
            self.bow_args = (centroids, idf, query_size, banks)
            self.database = torch.empty_like(database)
            self.db_size = torch.empty((), dtype=torch.int64, device=dev)
            self.top_ids = torch.empty((K, query_size), dtype=torch.int32, device=dev)
            self.top_scores = torch.empty((K, query_size), dtype=torch.float32, device=dev)

    @staticmethod
    def key(S, K, imgs, max_distance, rig, steer, fe, rc, bow=None):
        bow_key = None
        if bow is not None:
            centroids, idf, database, query_size, banks = bow[:5]
            bow_key = (id(centroids), id(idf), programs.tensor_key(database), query_size,
                       tuple(id(b) for b in banks), programs.tensor_key(*banks))
        return (ChainProgram, S, K, programs.tensor_key(imgs[0, 0]),
                tuple(max_distance.shape), id(rig), bool(rig.rectified), id(steer), fe, rc,
                bow_key)

    def step(self):
        S = self.imgs_l.shape[0]
        samplers = [functools.partial(ransac.sets_from_keys, self.keys[s]) for s in range(S)]
        res = batched_frontend_step(self.imgs_l, self.imgs_r, self.prev, self.initialized,
                                    samplers, self.rig, self.max_distance, self.fe, self.rc,
                                    self.rectified, self.steer)
        record = res.num_stereo >= self.fe.min_stereo_matches
        swap = record & (~self.initialized | res.ransac_success)
        new_prev = FrameSlots(*(torch.where(swap.reshape((S,) + (1,) * (new.dim() - 1)),
                                            new, old)
                                for new, old in zip(res.slots, self.prev)))
        for dst, src in zip(_leaves(self.out), _leaves(res)):
            dst.index_copy_(0, self.j, src[None])
        programs.copy_into(self.prev, new_prev)
        # Any frame, recorded or not, marks the odometer initialized.
        self.initialized.fill_(True)

    def bow(self):
        centroids, idf, query_size, banks = self.bow_args
        top_ids, top_scores, new_db, new_db_size = _score_and_bank(
            _select(self.out, (slice(None), 0)), self.fe, centroids, idf, self.database,
            self.db_size, query_size, banks)
        self.top_ids.copy_(top_ids)
        self.top_scores.copy_(top_scores)
        self.database.copy_(new_db)
        self.db_size.copy_(new_db_size)

    def chain(self, imgs_l, imgs_r, prev: FrameSlots, initialized, samplers, max_distance):
        """K steps: imgs [K, S, H, W], prev with a leading S axis,
        initialized a bool or an [S] (or 0-d) bool tensor, samplers K lists
        of S KeyedSamplers."""
        n = self.fe.num_features
        programs.copy_into(self.prev, prev)
        if isinstance(initialized, torch.Tensor):
            self.initialized.copy_(initialized)
        else:
            self.initialized.fill_(bool(initialized))
        self.max_distance.copy_(max_distance)
        for j, frame_samplers in enumerate(samplers):
            self.imgs_l.copy_(imgs_l[j])
            self.imgs_r.copy_(imgs_r[j])
            for s, smp in enumerate(frame_samplers):
                if not isinstance(smp, ransac.KeyedSampler):
                    raise TypeError("the captured front end draws its RANSAC keys apart from "
                                    f"the step: a ransac.KeyedSampler is needed, not {smp!r}")
                self.keys[s].copy_(smp.keys(n, self.device))
            self.j.fill_(j)
            self.run("step", self.step)

    def scores(self, database, db_size):
        self.database.copy_(database)
        if isinstance(db_size, torch.Tensor):
            self.db_size.copy_(db_size)
        else:
            self.db_size.fill_(int(db_size))
        self.run("bow", self.bow)


def keyed(samplers) -> bool:
    """Whether every sampler is a `ransac.KeyedSampler`, whose keys are drawn
    apart from the step, as a captured program needs. The entry points run
    the captured programs for those (every default sampler is one) and the
    eager bodies for any other sampler, one that draws when called (the
    tests inject the JAX package's minimal sets that way): a graph cannot
    replay a host call."""
    return all(isinstance(s, ransac.KeyedSampler) for s in samplers)


def _chain_program(imgs_l, imgs_r, prev: FrameSlots, initialized, samplers, rig, max_distance,
                   fe: FrontendConfig, rc: RansacConfig, steer, bow=None,
                   cache: Optional[programs.ProgramCache] = None) -> ChainProgram:
    """Run K steps of S sequences (imgs [K, S, H, W], samplers K lists of
    S) through the cache's ChainProgram; returns the program."""
    if steer is None:
        steer = orb.steer_table(fe.oriented, rig.device)
    max_distance = torch.as_tensor(max_distance, dtype=torch.float32, device=rig.device)
    K, S = imgs_l.shape[0], imgs_l.shape[1]
    cache = programs.PROGRAMS if cache is None else cache
    key = ChainProgram.key(S, K, imgs_l, max_distance, rig, steer, fe, rc, bow)
    prog = cache.get(key, lambda: ChainProgram(S, K, imgs_l, max_distance, rig, steer, fe, rc,
                                               bow))
    prog.chain(imgs_l, imgs_r, prev, initialized, samplers, max_distance)
    if bow is not None:
        prog.scores(bow[2], bow[5])
    return prog


def frontend_step_program(img_l, img_r, prev: FrameSlots, prev_usable, sampler,
                          rig: cam_mod.StereoRig, max_distance, fe: FrontendConfig,
                          rc: RansacConfig, steer=None,
                          cache: Optional[programs.ProgramCache] = None) -> StepResult:
    """`frontend_step` on the rig's path through the captured program (one
    replay on the card). Equal to `frontend_step` bit for bit; returns new
    tensors."""
    prog = _chain_program(img_l[None, None], img_r[None, None], _select(prev, None),
                          prev_usable, [[sampler]], rig, max_distance, fe, rc, steer,
                          cache=cache)
    return programs.clone(_select(prog.out, (0, 0)))


def batched_frontend_step_program(imgs_l, imgs_r, prev: FrameSlots, prev_usable, samplers,
                                  rig: cam_mod.StereoRig, max_distance, fe: FrontendConfig,
                                  rc: RansacConfig, steer=None,
                                  cache: Optional[programs.ProgramCache] = None) -> StepResult:
    """`batched_frontend_step` of S sequences on a shared or stacked rig
    (the rigs' path) through the captured program (one replay on the card).
    Equal to it bit for bit; returns new tensors."""
    prog = _chain_program(imgs_l[None], imgs_r[None], prev, prev_usable, [list(samplers)], rig,
                          max_distance, fe, rc, steer, cache=cache)
    return programs.clone(_select(prog.out, 0))


def frontend_chain_program(imgs_l, imgs_r, prev: FrameSlots, prev_initialized, samplers,
                           rig, max_distance, fe: FrontendConfig, rc: RansacConfig, steer=None,
                           cache: Optional[programs.ProgramCache] = None):
    """`frontend_chain` on the rig's path through the captured program: K
    replays of the step on the card. Equal to `frontend_chain` bit for bit
    and returns what it returns, as new tensors."""
    prog = _chain_program(imgs_l[:, None], imgs_r[:, None], _select(prev, None),
                          prev_initialized, [[smp] for smp in samplers], rig, max_distance,
                          fe, rc, steer, cache=cache)
    carry = (programs.clone(_select(prog.prev, 0)), prog.initialized[0].clone())
    return carry, programs.clone(_select(prog.out, (slice(None), 0)))


def frontend_chain_bow_program(imgs_l, imgs_r, prev: FrameSlots, prev_initialized, samplers,
                               rig, max_distance, fe: FrontendConfig, rc: RansacConfig, steer,
                               centroids, idf, database, db_size, query_size: int, banks,
                               cache: Optional[programs.ProgramCache] = None):
    """`frontend_chain_bow` on the rig's path through the captured program:
    K replays of the step, then one of the scoring body, which writes the
    rings `banks` in place as the eager function does. Equal to
    `frontend_chain_bow` bit for bit and returns what it returns, the
    database as a new tensor."""
    prog = _chain_program(imgs_l[:, None], imgs_r[:, None], _select(prev, None),
                          prev_initialized, [[smp] for smp in samplers], rig, max_distance,
                          fe, rc, steer,
                          bow=(centroids, idf, database, query_size, banks, db_size),
                          cache=cache)
    carry = (programs.clone(_select(prog.prev, 0)), prog.initialized[0].clone())
    return (carry, programs.clone(_select(prog.out, (slice(None), 0))), prog.top_ids.clone(),
            prog.top_scores.clone(), prog.database.clone(), prog.db_size.clone(), banks)


def _step_fields(res: StepResult, with_desc: bool) -> list:
    """A StepResult's tensors in field order, the descriptors left out when
    `with_desc` is False."""
    return [t for name, t in zip(FrameSlots._fields, res.slots)
            if name != "desc" or with_desc] + list(res[1:])


def _packed(tensors: list):
    """The tensors' bytes in one uint8 tensor on their device, widest
    elements first, so every field starts aligned; and the order."""
    order = sorted(range(len(tensors)), key=lambda i: -tensors[i].element_size())
    return torch.cat([tensors[i].reshape(-1).view(torch.uint8) for i in order]), order


def _unpacked(buf: np.ndarray, tensors: list, order: list) -> list:
    """NumPy views into `buf` (as `_packed` laid it out) shaped and typed as
    `tensors`, in their order."""
    out, off = [None] * len(tensors), 0
    for i in order:
        t = tensors[i]
        nbytes = t.numel() * t.element_size()
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out[i] = buf[off:off + nbytes].view(dtype).reshape(tuple(t.shape))
        off += nbytes
    return out


def _host_result(arrays: list, res: StepResult, with_desc: bool) -> StepResult:
    """A StepResult of the host arrays of `_step_fields(res, with_desc)`:
    descriptor words as uint32, or desc None without them."""
    n_slots = len(arrays) - (len(res) - 1)
    slots = arrays[:n_slots]
    if with_desc:
        slots[2] = slots[2].view(np.uint32)
    else:
        slots.insert(2, None)
    return StepResult(FrameSlots(*slots), *arrays[n_slots:])


def _to_host(res: StepResult, with_desc: bool = True) -> StepResult:
    """NumPy copy of a (possibly stacked or batched) StepResult in one
    device-to-host copy: the fields' bytes are packed into one buffer,
    widest elements first, so every field starts aligned. Descriptor
    words come back as uint32, or not at all (desc None) when `with_desc` is
    False."""
    fields = _step_fields(res, with_desc)
    packed, order = _packed(fields)
    return _host_result(_unpacked(packed.cpu().numpy(), fields, order), res, with_desc)


class Readback:
    """Device tensors on their way to the host in one copy, started when
    made: their bytes packed as `_to_host` packs them, then, on the card,
    copied without blocking into pinned host memory (PyTorch's caching host
    allocator) on the current stream, with an event recorded behind the
    copy. Launched right after the work that makes the tensors, the copy
    is ordered behind that work alone, not behind what the stream takes
    after it. Off the card the bytes are packed at once.

    `ready()` says whether the bytes have arrived; `arrays()` waits on the
    event alone (no stream sync) and returns NumPy views, one a tensor."""

    def __init__(self, tensors: list):
        self.tensors = tensors
        packed, self.order = _packed(tensors)
        self.event = None
        if packed.is_cuda:
            self.buf = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            self.buf.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf = packed

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def arrays(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return _unpacked(self.buf.numpy(), self.tensors, self.order)


def _frame_seed(seed: int, frame: int) -> int:
    return (seed * 0x9E3779B1 + frame) % (1 << 63)


class VisualOdometer:
    """Host-side orchestration: device front end + world-map bookkeeping.

    Runs on the rig's device. `sampler_for_frame(i)` gives frame i's RANSAC
    sampler (valid -> [K,3]); the default draws Gumbel top-3 from a
    generator seeded from (seed, i).
    """

    def __init__(
        self,
        world: WorldMap,
        rig: cam_mod.StereoRig,
        fe: Optional[FrontendConfig] = None,
        rc: Optional[RansacConfig] = None,
        seed: int = 0,
        sampler_for_frame: Optional[Callable[[int], ransac.Sampler]] = None,
    ):
        self.world = world
        self.rig = rig
        self.device = rig.device
        self.fe = fe or FrontendConfig()
        self.rc = rc or RansacConfig()
        self.seed = seed
        self.sampler_for_frame = sampler_for_frame or self._gumbel_for_frame
        self._frame_counter = 0
        self.max_distance = rig.max_sensible_distance()
        self.rectified = bool(rig.rectified)
        # Host copies of the rectified intrinsics: the host map recomputes
        # its points from the keypoints through the NumPy mirror.
        self._tri_np = None
        if self.rectified:
            vals = torch.stack([rig.left.fx, rig.left.cx, rig.left.cy,
                                rig.right.cx, rig.baseline]).cpu().numpy()
            self._tri_np = tuple(np.float32(v) for v in vals)
        self.steer = orb.steer_table(self.fe.oriented, self.device)
        self.prev = empty_slots(self.fe.num_features, self.device)
        self.prev_global_idx = np.full(self.fe.num_features, -1, np.int64)
        self.initialized = False
        self.success = True
        self.frame_recorded = False
        self.last_result = None        # StepResult of the last track()
        self.last_batch = None         # host StepResult of the last collected batch
        self.last_batch_recorded = []
        self.last_new_database = None  # BoW database after the last fused batch
        self.last_topk_ids = None      # [K, query_size] int32
        self.last_topk_scores = None   # [K, query_size] float32
        # Feature-bank rings as of the last collected batch: the loop-edge
        # matcher's source (apps/slam.py).
        self.last_banks = None
        # (prev slots, initialized) on the device after the last dispatched
        # batch; None when the host mirrors are current (after track() or at
        # the start).
        self._carry_dev = None
        # (desc, uv4, point_ids, valid) of the latest recorded frame.
        self._current_features = None
        # Batch collects whose readback had arrived when they began, and
        # those that waited for it (collect_batch).
        self.readback_stats = {"ready": 0, "waited": 0}

    def _gumbel_for_frame(self, frame: int) -> ransac.Sampler:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_frame_seed(self.seed, frame))
        return ransac.gumbel_sampler(gen, self.rc.num_hypotheses)

    def _upload(self, img):
        return torch.as_tensor(img).to(self.device)

    def track(self, img_l, img_r) -> np.ndarray:
        """Process one stereo pair (uint8 or float32 arrays or tensors);
        returns the 4x4 relative transform. The frame is a `vo.track` span
        whose children cover it: `vo.upload` (both images), `vo.launch`
        (the key draw through the step's outputs), `vo.readback`
        (`_to_host`, which waits for the frame's device work) and `vo.map`
        (`_ingest`'s host map)."""
        with TRACER.span("vo.track", frame=self._frame_counter):
            with TRACER.span("vo.upload"):
                img_l, img_r = self._upload(img_l), self._upload(img_r)
            with TRACER.span("vo.launch"):
                sampler = self.sampler_for_frame(self._frame_counter)
                self._frame_counter += 1
                if keyed([sampler]):
                    res = frontend_step_program(
                        img_l, img_r, self.prev, self.initialized, sampler, self.rig,
                        self.max_distance, self.fe, self.rc, self.steer)
                else:
                    res = frontend_step(
                        img_l, img_r, self.prev,
                        torch.tensor(self.initialized, device=self.device), sampler,
                        self.rig, self.max_distance, self.fe, self.rc, self.rectified,
                        self.steer,
                    )
            self._carry_dev = None  # the host mirrors are now ahead of the device
            with TRACER.span("vo.readback"):
                host = _to_host(res)
            with TRACER.span("vo.map"):
                return self._ingest(res, host)

    def track_batch(self, imgs_l, imgs_r, bow=None) -> list:
        """Process K stereo pairs: the K frame steps run back to back on the
        device with the swap/record state kept there, then one readback,
        then the host runs `track`'s own replay (`_record`) on each of the
        K frames in turn. With `bow` (see dispatch_batch) the K frames' BoW
        scoring runs with them."""
        return self.collect_batch(self.dispatch_batch(imgs_l, imgs_r, bow))

    def dispatch_batch(self, imgs_l, imgs_r, bow=None, banks=None) -> dict:
        """Launch the K-frame chain and its readback; returns a handle for
        collect_batch. Does not wait for the device: the tracker state
        threads on the device, so the next batch can be launched before this
        one is collected (the live loop's two-deep pipeline). Handles are
        collected in dispatch order.

        Right behind the chain (and the scoring body, with `bow`) the batch's
        results start for the host in one packed copy (`Readback`: on the
        card into pinned memory, an event behind it), so the batch is read
        back right after its own chain, whatever the stream takes after it:
        the next batch's chain, the window BA.

        `bow` = (centroids, idf, database, db_size, query_size) adds the
        frames' BoW scoring and database append (frontend_chain_bow), with
        the feature-bank rings `banks` (throwaway rings at the database's
        capacity when None).

        While tracing is on, a `dev.chain` device timer (`utils/profiling`)
        brackets the chain (and the scoring body); collect_batch reads it."""
        k = len(imgs_l)
        samplers = [self.sampler_for_frame(self._frame_counter + j) for j in range(k)]
        self._frame_counter += k
        if self._carry_dev is None:
            self._carry_dev = (self.prev, self.initialized)
        args = (self._upload(imgs_l), self._upload(imgs_r), self._carry_dev[0],
                self._carry_dev[1], samplers, self.rig, self.max_distance, self.fe, self.rc)
        # The captured programs, on either rig (the eager bodies for host
        # samplers, see `keyed`).
        captured = keyed(samplers)
        handle = {"k": k, "bow": None, "banks": None}
        topk = []
        timer = TRACER.device_timer("dev.chain", self.device)
        if bow is None:
            if captured:
                carry, stacked = frontend_chain_program(*args, self.steer)
            else:
                carry, stacked = frontend_chain(*args, self.rectified, self.steer)
        else:
            centroids, idf, database, db_size, query_size = bow
            if banks is None:
                banks = empty_banks(database.shape[0], self.fe.num_features, self.device)
            db_size = torch.as_tensor(db_size, dtype=torch.int64, device=self.device)
            bow_args = (centroids, idf, database, db_size, query_size, banks)
            if captured:
                out = frontend_chain_bow_program(*args, self.steer, *bow_args)
            else:
                out = frontend_chain_bow(*args, self.rectified, self.steer, *bow_args)
            carry, stacked, top_ids, top_scores, new_db, new_db_size, banks = out
            handle["bow"] = (new_db, new_db_size, query_size)
            handle["banks"] = banks
            topk = [top_ids, top_scores]
        self._carry_dev = carry
        if timer is not None:
            timer.stop()
        handle["timer"] = timer
        handle["carry"] = carry
        handle["stacked"] = stacked
        # With the rings the descriptors stay on the device.
        handle["readback"] = Readback(_step_fields(stacked, bow is None) + topk)
        return handle

    def collect_batch(self, handle: dict) -> list:
        """Read a dispatch_batch handle's results back and replay the host
        bookkeeping: `_record` on each frame's row in turn, as `track` runs
        it (map update, swap/record mirrors), then the loop top-k. The read
        waits on the handle's readback alone, which dispatch_batch ordered
        right behind the batch's own chain, so it never waits for work
        launched after it; `readback_stats` counts whether the bytes had
        arrived when the collect began ("ready") or it had to wait
        ("waited"; off the card nothing waits). On the fused-BoW path the
        descriptors stay on the device (in the rings) and the world's host
        descriptor mirror is marked stale."""
        with_bow = handle["bow"] is not None
        readback = handle["readback"]
        self.readback_stats["ready" if readback.ready() else "waited"] += 1
        arrays = readback.arrays()
        if handle["timer"] is not None:
            handle["timer"].read()   # the chain ran before the readback's copy
        if with_bow:
            self.last_new_database = handle["bow"][0]
            self.last_banks = handle["banks"]
            self.last_topk_ids, self.last_topk_scores = arrays[-2:]
            arrays = arrays[:-2]
        batch = _host_result(arrays, handle["stacked"], not with_bow)
        self.last_batch = batch
        out, self.last_batch_recorded = [], []
        for j in range(handle["k"]):
            out.append(self._record(_select(batch, j)))
            self.last_batch_recorded.append(self.frame_recorded)
        # The device carry after this batch is the state the host replay
        # reached (the same swap rule), and it keeps the descriptors.
        self.prev = handle["carry"][0]
        return out

    @property
    def current_frame_features(self):
        """Descriptor bank of the most recently recorded frame, (desc, uv4,
        point_ids, valid), the reference's GetCurrFrameData (ref
        visual_odometer.cpp:59-62); desc is None after a fused-BoW batch."""
        return self._current_features

    def _host_points(self, slots: FrameSlots) -> np.ndarray:
        """Camera-frame points of one frame's host slots."""
        if not self.rectified:
            return slots.pts
        pts = cam_mod.triangulate_rectified_np(*self._tri_np, slots.kp_l, slots.kp_r)
        pts[~slots.valid] = 0.0
        return pts

    def _ingest(self, res: StepResult, host: StepResult) -> np.ndarray:
        """One device StepResult and its NumPy copy `host`: the host replay
        (`_record`), then the previous-frame swap on the device slots."""
        self.last_result = res
        trans = self._record(host)
        if self.success:  # recorded, and the first frame or RANSAC held
            self.prev = res.slots
        return trans

    def _record(self, host: StepResult) -> np.ndarray:
        """One frame's host bookkeeping on its NumPy results, mirroring
        Update() (ref :105-221, :335-444): the record / first / RANSAC
        state machine, the map update and the landmark-id carry. Touches no
        device tensor; returns the frame's relative transform."""
        if int(host.num_stereo) < self.fe.min_stereo_matches:
            # Reference early return: the frame is not recorded (:117-121).
            self.success = False
            self.frame_recorded = False
            self.initialized = True
            return np.eye(4, dtype=np.float32)
        first = not self.initialized
        self.frame_recorded = self.initialized = True
        self.success = first or bool(host.ransac_success)
        trans = np.eye(4, dtype=np.float32) if first else host.transform

        world = self.world
        slots = host.slots
        valid = slots.valid
        fid = world.add_frame(trans)
        gids = np.full(len(valid), -1, np.int64)
        # New landmarks: valid slots not tracked (every slot on the first
        # frame or after a failed RANSAC).
        new_mask = valid.copy()
        if not first and self.success:
            # Tracked slots inherit the matched prev slot's landmark id.
            t_idx = np.flatnonzero(host.tracked & valid)
            if len(t_idx):
                inherited = self.prev_global_idx[host.prev_idx[t_idx]]
                ok = inherited >= 0
                t_idx = t_idx[ok]
                gids[t_idx] = inherited[ok]
                new_mask[t_idx] = False

        # New landmarks move to the world frame by the new frame's global
        # pose (ref :386-388).
        n0 = world.num_points
        if new_mask.any():
            pl = self._host_points(slots)[new_mask]
            ph = np.concatenate([pl, np.ones((len(pl), 1), np.float32)], 1)
            pw = (world.pose_global[fid] @ ph.T).T[:, :3]
            gids[new_mask] = world.add_points(pw, fid)

        uv4 = np.concatenate([slots.kp_l, slots.kp_r], axis=1, dtype=np.float32)
        gids32 = gids.astype(np.int32)
        obs_mask = valid & (gids >= 0)
        world.add_observations(fid, gids32[obs_mask], uv4[obs_mask])
        # New points start at 1 in add_points and add_observations counts
        # them again: take the double count back (ids n0 onwards).
        world.point_obs_count[n0 : world.num_points] -= 1
        world.set_frame_features(fid, slots.desc, uv4, gids32, obs_mask)
        self._current_features = (slots.desc, uv4, gids32, obs_mask)
        if self.success:
            self.prev_global_idx = gids
        # else: keep the previous frame (ref :214-217)
        return trans

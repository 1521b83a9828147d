"""Concurrent multi-sequence tracking (BASELINE.json config 4).

PyTorch counterpart of the JAX package's `parallel/multi_seq.py`, which
vmaps `frontend_step` over a leading sequence axis. Here the sequence axis
is a real tensor axis through the whole front end
(`frontend.odometer.batched_frontend_step`): one step of S sequences
launches `hamming_top2` once and `orb_describe` twice (all left images,
all right images), whatever S is. The step runs as the front end's
captured program (`odometer.batched_frontend_step_program`, one graph
replay on the card) on stacked rectified and stacked distorted rigs
alike, as the JAX package runs one vmapped program. Host map bookkeeping
stays per sequence
(a `VisualOdometer` and a `WorldMap` each); one device-to-host copy
brings back every sequence's results.

With a mesh (`parallel/mesh.py`), the sequences are split over the ranks:
each rank tracks its contiguous share and holds only those sequences'
maps, and `process` returns all S transforms on every rank (one
all_reduce of the [S, 4, 4] transforms, each written by one rank).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch

from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
from stereo_orb_slam_torch.frontend import odometer
from stereo_orb_slam_torch.frontend.odometer import FrameSlots, StepResult, VisualOdometer
from stereo_orb_slam_torch.geometry import camera as cam_mod
from stereo_orb_slam_torch.ops import orb
from stereo_orb_slam_torch.parallel import mesh as mesh_mod
from stereo_orb_slam_torch.worldmap import WorldMap


def batched_frontend_step(fe: FrontendConfig, rc: RansacConfig, rectified=None):
    """The per-frame front end over a sequence axis: fn(imgs_l [S,H,W],
    imgs_r, prev (FrameSlots with a leading S axis), prev_usable [S],
    samplers (one per sequence), rig (stacked), max_distance [S], steer) ->
    StepResult with a leading S axis on every field."""
    def step(imgs_l, imgs_r, prev, prev_usable, samplers, rig, max_distance, steer):
        return odometer.batched_frontend_step(imgs_l, imgs_r, prev, prev_usable, samplers,
                                              rig, max_distance, fe, rc, rectified, steer)
    return step


stack_rigs = cam_mod.stack_rigs


def batch_slots(slots: Sequence[FrameSlots]) -> FrameSlots:
    """S FrameSlots as one, every field with a leading sequence axis."""
    return FrameSlots(*(torch.stack(fs) for fs in zip(*slots)))


def _sequence(res: StepResult, s: int) -> StepResult:
    """Sequence s of a batched StepResult (tensors or NumPy arrays)."""
    slots = FrameSlots(*(None if x is None else x[s] for x in res.slots))
    return StepResult(slots, *(x[s] for x in res[1:]))


class MultiSequenceSLAM:
    """Track S sequences concurrently; device compute fully batched.

    Sequence s's odometer is `VisualOdometer(..., seed=seed + s)` and draws
    its RANSAC sets from its own `sampler_for_frame` stream, so a sequence
    tracked here gets the poses it gets alone. `mesh` None runs all S
    sequences on the rigs' device in one batched program; a mesh splits
    them over its ranks (each rank passes all S rigs and all S images)."""

    def __init__(self, rigs: Sequence[cam_mod.StereoRig],
                 fe: Optional[FrontendConfig] = None,
                 rc: Optional[RansacConfig] = None,
                 mesh: Optional[mesh_mod.Mesh] = None, seed: int = 0,
                 sampler_for_frame=None):
        self.fe = fe or FrontendConfig()
        self.rc = rc or RansacConfig()
        self.S = len(rigs)
        self.mesh = mesh
        lo, hi = (0, self.S) if mesh is None else mesh_mod.shard_bounds(
            self.S, mesh.size, mesh.rank)
        self.sequences = range(lo, hi)   # the sequences this rank tracks
        local = list(rigs[lo:hi])
        self.device = mesh.device if mesh is not None else rigs[0].device
        # `sampler_for_frame(s, i)`, when given, is sequence s's sampler of
        # frame i (tests inject the JAX package's keys through it).
        self.worlds = [WorldMap(feat_slots=self.fe.num_features) for _ in local]
        self.vos = [
            VisualOdometer(w, r, self.fe, self.rc, seed=seed + s,
                           sampler_for_frame=(None if sampler_for_frame is None
                                              else partial(sampler_for_frame, s)))
            for s, w, r in zip(self.sequences, self.worlds, local)
        ]
        self.initialized = np.zeros(len(local), bool)
        if local:
            self.rig_batch = stack_rigs(local)
            self.max_d = torch.stack([r.max_sensible_distance() for r in local])
            self.steer = orb.steer_table(self.fe.oriented, self.device)
            self.prev = batch_slots([vo.prev for vo in self.vos])

    def process(self, imgs_l, imgs_r) -> List[np.ndarray]:
        """One frame for every sequence. imgs_*: [S,H,W] arrays or tensors.
        Returns the S relative poses ([4, 4] float32)."""
        out = np.zeros((self.S, 4, 4), np.float32)
        if self.vos:
            lo, hi = self.sequences.start, self.sequences.stop
            samplers = []
            for vo in self.vos:
                samplers.append(vo.sampler_for_frame(vo._frame_counter))
                vo._frame_counter += 1
            il = torch.as_tensor(imgs_l[lo:hi]).to(self.device)
            ir = torch.as_tensor(imgs_r[lo:hi]).to(self.device)
            usable = torch.as_tensor(self.initialized, device=self.device)
            if odometer.keyed(samplers):
                # The captured step program: one replay for all S sequences.
                res = odometer.batched_frontend_step_program(
                    il, ir, self.prev, usable, samplers, self.rig_batch, self.max_d, self.fe,
                    self.rc, self.steer)
            else:   # host samplers (odometer.keyed): the eager step
                res = odometer.batched_frontend_step(
                    il, ir, self.prev, usable, samplers, self.rig_batch, self.max_d, self.fe,
                    self.rc, self.rig_batch.rectified, self.steer)
            host = odometer._to_host(res)   # one readback for the rank's sequences
            for k, vo in enumerate(self.vos):
                out[lo + k] = vo._ingest(_sequence(res, k), _sequence(host, k))
            self.prev = batch_slots([vo.prev for vo in self.vos])
            self.initialized[:] = [vo.initialized for vo in self.vos]
        if self.mesh is not None and self.mesh.group is not None:
            gathered = torch.as_tensor(out, device=self.mesh.device)
            out = mesh_mod.all_reduce(gathered, self.mesh.group).cpu().numpy()
        return list(out)

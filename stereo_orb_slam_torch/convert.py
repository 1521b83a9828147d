"""Carry state and tables from NumPy into the port's tensors.

The JAX package's objects, fetched to the host as NumPy arrays (camera rigs,
per-frame slots, sampling tables, BA problems, vocabularies, loop databases
and configs), become the port's objects here, so two runs can start from
the same rig, the same previous-frame state, the same BA problem or the
same vocabulary. Descriptor words arrive as uint32 and are kept as int32
tensors holding the same bit patterns. Batched state converts the same way
(slots with a leading sequence axis, stacked rigs), and so do the
distributed solvers' inputs (a point-aligned problem with its meta, a
pose graph with its edges).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereo_orb_slam_torch.backend.ba import BAProblem
from stereo_orb_slam_torch.backend.pose_graph import PoseGraphProblem
from stereo_orb_slam_torch.config import (
    BAConfig, FrontendConfig, LoopConfig, PoseGraphConfig, RansacConfig, SlamConfig,
)
from stereo_orb_slam_torch.frontend.odometer import FrameSlots
from stereo_orb_slam_torch.geometry.camera import Pinhole, StereoRig
from stereo_orb_slam_torch.loop.vocab import OrbVocabulary

_PINHOLE_FIELDS = Pinhole._fields


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def pinhole_from_numpy(cam, device="cuda") -> Pinhole:
    """A Pinhole from a mapping or NamedTuple of NumPy values with the
    fields fx, fy, cx, cy, dist, pose, projection."""
    return Pinhole(**{f: _tensor(_get(cam, f), device) for f in _PINHOLE_FIELDS})


def rig_from_numpy(rig, device="cuda") -> StereoRig:
    """A StereoRig from a mapping or NamedTuple with left, right (see
    pinhole_from_numpy), rectified and baseline. A stacked rig (every
    field with a leading sequence axis, as the JAX package's `stack_rigs`
    makes it) gives the port's stacked rig; its `rectified` flags must
    agree."""
    flags = np.unique(np.asarray(_get(rig, "rectified"), bool))
    if len(flags) != 1:
        raise ValueError("a stacked rig's sequences must share the triangulation path")
    return StereoRig(
        left=pinhole_from_numpy(_get(rig, "left"), device),
        right=pinhole_from_numpy(_get(rig, "right"), device),
        rectified=bool(flags[0]),
        baseline=_tensor(_get(rig, "baseline"), device),
    )


def desc_to_tensor(desc_u32, device="cuda") -> torch.Tensor:
    """[N, 8] uint32 descriptor words -> int32 tensor of the same bits."""
    words = np.ascontiguousarray(np.asarray(desc_u32, np.uint32)).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def slots_from_numpy(slots, device="cuda") -> FrameSlots:
    """FrameSlots from a mapping or NamedTuple of NumPy arrays (kp_l, kp_r,
    desc as uint32, pts, valid), with or without a leading sequence axis
    (the JAX package's `batch_slots`)."""
    return FrameSlots(
        kp_l=_tensor(_get(slots, "kp_l"), device),
        kp_r=_tensor(_get(slots, "kp_r"), device),
        desc=desc_to_tensor(_get(slots, "desc"), device),
        pts=_tensor(_get(slots, "pts"), device),
        valid=torch.as_tensor(np.array(_get(slots, "valid"), bool), device=device),
    )


def table_from_numpy(table, device="cuda") -> torch.Tensor:
    """A sampling table given as any float array of bf16 values -> a bf16
    tensor (exact: the values are representable)."""
    return torch.as_tensor(np.asarray(table, np.float32), device=device).to(torch.bfloat16)


def ba_problem_from_numpy(prob, device="cuda") -> BAProblem:
    """A BAProblem from a mapping or NamedTuple with BAProblem's fields
    (the JAX package's BAProblem converts field by field): index arrays
    become int64 tensors, everything else float32."""
    index_fields = ("obs_cam", "obs_point")
    return BAProblem(**{
        f: (torch.as_tensor(np.array(_get(prob, f), np.int64), device=device)
            if f in index_fields else _tensor(_get(prob, f), device))
        for f in BAProblem._fields
    })


def point_aligned_from_numpy(prob, meta, rank: int, device="cuda") -> BAProblem:
    """Rank `rank`'s shard of a point-aligned problem given as host arrays
    with the [n_dev * S] layout and its meta (the JAX package's
    `build_point_aligned` output, or the port's): the rank's points and
    observations (local point indices), camera state and projections
    whole. meta["bounds"] holds every rank's (point_lo, point_hi) as
    consecutive entries."""
    n_dev = meta["n_dev"]
    sharded = {"points", "point_mask", "obs_cam", "obs_point", "obs_uv", "obs_weight"}
    arrays = {}
    for f in BAProblem._fields:
        x = np.asarray(_get(prob, f))
        if f in sharded:
            k = x.shape[0] // n_dev
            x = x[rank * k:(rank + 1) * k]
        arrays[f] = x
    return ba_problem_from_numpy(arrays, device)


def pose_graph_problem_from_numpy(prob, device="cuda") -> PoseGraphProblem:
    """A PoseGraphProblem from a mapping or NamedTuple of its fields (the
    JAX package's, fetched to the host): edge ends as int64 tensors,
    everything else float32."""
    return PoseGraphProblem(**{
        f: (torch.as_tensor(np.array(_get(prob, f), np.int64), device=device)
            if f in ("edge_a", "edge_b") else _tensor(_get(prob, f), device))
        for f in PoseGraphProblem._fields
    })


def ba_config_from(cfg) -> BAConfig:
    """The port's BAConfig with the field values of `cfg`, any dataclass
    with BAConfig's fields (the JAX package's BAConfig). The port assembles
    the reduced system in float32 only, so a config asking for the bfloat16
    assembly (`dense_assemble_bf16`) is refused."""
    values = dataclasses.asdict(cfg)
    if values.get("dense_assemble_bf16"):
        raise ValueError("the port has no bfloat16 Schur assembly (dense_assemble_bf16)")
    return BAConfig(**{f.name: values[f.name] for f in dataclasses.fields(BAConfig)})


def _dataclass_from(cls, cfg):
    values = dataclasses.asdict(cfg)
    return cls(**{f.name: values[f.name] for f in dataclasses.fields(cls)})


def slam_config_from(cfg) -> SlamConfig:
    """The port's SlamConfig with the field values of `cfg`, a dataclass
    with SlamConfig's fields and nested configs (the JAX package's
    SlamConfig). Refuses what `ba_config_from` refuses."""
    nested = {"frontend": FrontendConfig, "ransac": RansacConfig,
              "pose_graph": PoseGraphConfig, "loop": LoopConfig}
    values = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(SlamConfig)}
    for name, cls in nested.items():
        values[name] = _dataclass_from(cls, values[name])
    values["ba"] = ba_config_from(values["ba"])
    return SlamConfig(**values)


def vocabulary_from_numpy(centroids_u32, idf, device="cuda") -> OrbVocabulary:
    """An OrbVocabulary from its weights: centroids uint32 [W, 8] and idf
    float32 [W] (the arrays of the JAX package's vocabulary.npz)."""
    return OrbVocabulary(np.asarray(centroids_u32, np.uint32), np.asarray(idf, np.float32),
                         device)


def loop_database_from_numpy(database, db_size: int, device="cuda") -> torch.Tensor:
    """A loop detector's BoW database rows [capacity, W] float32 as the
    port's tensor (a JAX LoopDetector's `database`, fetched to the host);
    rows at and past `db_size` are zeroed, as unused rows are."""
    rows = np.array(database, np.float32)
    rows[db_size:] = 0.0
    return torch.as_tensor(rows, device=device)

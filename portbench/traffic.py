"""The one generator of the benchmark's traffic: stereo streams from a seed.

A cell's traffic is the `traffic` object of its file under
`portbench/workloads/`: the scene's trajectory and the order in which the
rendered frames are handed over. The scene itself (image size, rig,
texture) is the configuration's. Frames are rendered on the card in a few
large calls, then handed to host memory as uint8 arrays, as a camera hands
them over.

Trajectories: `{"kind": "line", "positions": n, "step_px": p}`, n rig
positions along x, p pixels of disparity-plane motion apart (the EuRoC
plane). Orders: `pingpong` (0..n-1, n-2..1, ...).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.scene import plane


@dataclass
class Stream:
    pairs: np.ndarray    # [F, 2, H, W] uint8, host memory
    order: list          # frame index of each hand-over in one period
    offset: int          # where in the period the stream starts
    seconds: float       # wall seconds the render took (set-up)

    def frame(self, i: int) -> int:
        """The frame handed over i-th (the order repeats)."""
        return self.order[(i + self.offset) % len(self.order)]


def hand_over_order(n: int, kind: str) -> list:
    if kind == "pingpong":
        return list(range(n)) + list(range(n - 2, 0, -1))
    raise ValueError(f"unknown order {kind!r}")


def trajectory(spec: dict, cfg: dict) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses of the rig's left camera."""
    if spec["kind"] == "line":
        step_m = spec["step_px"] * cfg["scene"]["depth_m"] / cfg["fx"]
        poses = np.tile(np.eye(4), (spec["positions"], 1, 1))
        poses[:, 0, 3] = step_m * np.arange(spec["positions"])
        return poses
    raise ValueError(f"unknown trajectory {spec['kind']!r}")


def make_scene(cfg: dict, device):
    """The configuration's scene, its textures drawn from the configuration's
    own `texture_seed`: they stand for the dataset's images, which every run
    sees alike."""
    sc = cfg["scene"]
    generator = torch.Generator(device=device)
    generator.manual_seed(sc["texture_seed"])
    if sc["kind"] == "distorted_plane":
        return plane.DistortedPlaneScene(plane.make_texture(generator), cfg["fx"], cfg["cx"],
                                         cfg["cy"], cfg["baseline_m"], sc["depth_m"], cfg["h"],
                                         cfg["w"], dist=cfg["dist"], fy=cfg["fy"])
    raise ValueError(f"unknown scene {sc['kind']!r}")


def make_stream(cfg: dict, traffic: dict, seed: int, device) -> Stream:
    """Render the cell's frames on `device` and hand them to the host. The
    seed draws where in the period the stream starts, so every seed sees the
    same frames' sizes and motions, in another order."""
    import time

    t0 = time.perf_counter()
    scene = make_scene(cfg, device)
    truth = trajectory(traffic["trajectory"], cfg)
    host = scene.render_pairs(truth[:, 0, 3]).cpu().numpy()
    order = hand_over_order(len(truth), traffic["order"])
    return Stream(pairs=host, order=order, offset=int(seed) % len(order),
                  seconds=time.perf_counter() - t0)

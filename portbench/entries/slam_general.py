"""The general-rig SLAM entry: `entries/slam.py`'s drives, window and judge
on a distorted, unrectified stereo rig, through `SlamSystem.process_batch`
as `apps/slam.py` runs it.

`run` is `entries/slam.py::run` with that module's rectified-only names
swapped for the call (as its recorder swaps the program's), so that the
two SLAM cells share their set-up, drive loop, window and judge:

- `render`: the drive rendered through the configuration's cameras and
  distortion (`portbench/scene/canyon_distorted.py`);
- `_rig`: the port's rig with the configuration's fy and distortion, not
  rectified: the front end undistorts and triangulates by the DLT kernel
  in every step of the chain, and a closure's loop-edge batch
  re-triangulates the stored ideal observations by two DLT launches;
- `ref_le`: `reference/general.py`, the general rig's front-end frame (with
  RANSAC's refit) and loop edges (the DLT in float64);
- `_stereo_points`: `reference/general.py::stereo_points`, the points by
  which the pose graph's poses are compared;
- `_Recorder`: `entries/slam.py`'s recorder, whose draw of a loop-edge
  batch counts only batches of at least `judge.min_edges` edges;
- `_ba_numbers`: the window BA's `points` and `pose` over the landmarks
  that the reference's solution resolves (below);
- `span_times`: also takes the program's device timers (`dev.chain`,
  `dev.ba`; `utils/profiling.py`) before the tracer is reset;

and `harness.reduce_profile` notes the DLT's launch counter at the
profiler slice's end and reads the slice's events from the profiler's
kineto result (`_Profile`), and the program's `apps/slam.py::_edge_program`
records each loop-edge batch launched in the slice.

The profiler slice is the two batches around the drive's first closure
(the workload's `trace`): the loop filter leaves its loop at frame 1347 or
1348 of every seed's drive (batch 42), and the closure runs in the call of
batch 43. The window pays the slice's reduction; `closure_stall_ms` and
the other span readers need a closure outside the slice, which comes in the
second drive (at about frame 1,380), so the first drive, its slice
included, has to end well inside the window.

The configuration states the window BA's marginalisation and solve in
float64, which the program chooses for a short baseline
(`backend/ba.py::marginalize_in_float64`); a program that does not choose
it on this rig is refused before anything is rendered. In float32 the
window solves stray on a few of a drive's 115 windows (up to 2.4 in
`points`), so one drawn window would not tell the two apart;
tests/test_portbench_slam_general.py holds such a window of the drive.

`correct` reads what `entries/slam.py` reads. The pose graph and the window
BA are held to `reference/pose_graph.py` and `reference/ba.py` as they
are: their measurement models hold for this rig in ideal coordinates. The
pose graph's is the rig's relative SE(3) poses, which know no camera; the
BA's is the stereo pinhole projection, through the recorded problem's own
P_l = K [I | 0] and P_r = K [I | -b e_x], of observations that the front
end undistorted, which is this rig's model once the distortion is taken
out (both cameras share K and the distortion).

The window BA's `points` (a landmark's largest coordinate gap over its
depth in its first camera) and `pose` (metres: landmarks moved by either
pose) are `entries/slam.py`'s, read over the landmarks that the
reference's solution resolves and LM has fitted, 94-99.8% of a window's
(H100 drives of seeds 2147483902 to 2147483971):

- in front of their first camera and nearer than fx * baseline (50.45 m
  here): the depth of a landmark past it has less than a pixel of
  disparity, the front end triangulates no such point (`Rig.max_depth`),
  and the solve may leave it anywhere along its ray, past infinity too (a
  far-wall landmark at 1.1 px of disparity ends at z = -8,237 m in the
  float64 reference and -7,242 m in the program, their projections equal
  to 1e-3 px, which read 12% as a gap over depth);
- every observation fitted within Huber's width (1 px): a landmark with an
  observation on the loss's linear part, most often a track whose two
  stereo points disagree (disparities of 2.8 and 5.7 px), sits where the
  cost is weakly curved along the segment between its observations' fits,
  and LM's fixed iterations have not converged there. On ten recorded
  windows of three seeds' drives (float64, CPU), the reference's own
  iterate was 5e-8 to 0.043 of a depth from its converged solution on
  such landmarks and under 1e-5 on the rest; two converged solves from
  different starts (the recorded start and the program's solution) met
  within 5e-5 on every landmark, at costs equal to 3e-10. The optimum is
  unique: a gap there measures how far each LM path has come, and
  rounding sets it (the float32 reference reads up to 0.023 there, as
  the program does). The judge prints, for each window, how many
  landmarks it reads and what it leaves out (0.2-3.3% of those windows).

On `kitti_00`'s rig the depth range is 385 m, past the canyon's far wall.

A traced run's trace carries, beside `entries/slam.py`'s:

- `device_ms`: {"dev.chain": [...], "dev.ba": [...], "dev.ba.capped":
  [...]} device milliseconds, one a batch's chain, one a captured window
  solve and one a capped solve (a closure's polish), outside the profiler
  slice (empty for a program without device timers);
- `edge_dlt`: for each loop-edge batch in the profiler slice, the DLT
  launches it made (`launches`), the DLT launches after it to the slice's
  end (`after`), and each launch's projections and pixel pairs (`calls`),
  for `metrics/roofline.triangulate_dlt.edges.py`.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench.entries import slam
from portbench.reference import ba as ref_ba
from portbench.reference import general
from portbench.scene import canyon
from portbench.scene.canyon_distorted import DistortedCanyonScene


def render(cfg: dict, traffic: dict, seed: int, device):
    """The drive's uint8 pairs [F, 2, H, W] in host memory, rendered on
    `device` through the configuration's cameras (textures from its
    `texture_seed`, blurred by its `blur_texels`; sensor noise from
    `seed`), and the render's wall seconds."""
    t0 = time.perf_counter()
    sc = cfg["scene"]
    if sc["kind"] != "canyon_distorted":
        raise ValueError(f"unknown scene {sc['kind']!r}")
    tex_gen = torch.Generator(device=device)
    tex_gen.manual_seed(sc["texture_seed"])
    textures = canyon.make_textures(tex_gen, sigma=sc["blur_texels"])
    scene = DistortedCanyonScene(textures, cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"],
                                 cfg["baseline_m"], cfg["h"], cfg["w"], cfg["dist"],
                                 noise_sigma=sc["noise_sigma"])
    noise = torch.Generator(device=device)
    noise.manual_seed(int(seed) % (1 << 63))
    pairs = scene.render_pairs(slam.trajectory(traffic["trajectory"]), noise).cpu().numpy()
    return pairs, time.perf_counter() - t0


def _rig(cfg: dict, device):
    from stereo_orb_slam_torch.geometry import camera

    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = cfg["baseline_m"]
    left, right = (camera.Pinhole.create(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"],
                                         dist=cfg["dist"], pose=pose, device=device)
                   for pose in (None, pose_r))
    return camera.StereoRig.create(left, right, rectified=cfg["rectified"],
                                   baseline=cfg["baseline_m"])


class _Recorder(slam._Recorder):
    """`entries/slam.py`'s recorder; its reservoir of one loop-edge batch
    draws among the batches of at least `judge.min_edges` edges."""

    def __init__(self, seed: int, judge_spec: dict):
        super().__init__(seed, judge_spec)
        self.min_edges = judge_spec["min_edges"]
        self._counted = 0   # edges of the drive's batches before the last one

    def start_drive(self, system):
        super().start_drive(system)
        self._counted = 0

    def _keep(self, what: str) -> bool:
        if what == "edges":
            # Asked right after a batch of the drive's edges was counted.
            E, self._counted = self.edge_count - self._counted, self.edge_count
            if E < self.min_edges:
                return False
        return super()._keep(what)


class _Traced:
    """What the swapped names record for a traced run's trace."""

    def __init__(self):
        self.device_ms = {}
        self.edge_batches = []
        self.slice_end = None

    def trace_items(self) -> dict:
        """The trace's `device_ms` and `edge_dlt` (see the module's
        docstring)."""
        edge_dlt = []
        for b in self.edge_batches:
            P1, P2 = (P.cpu().numpy() for P in b["projections"])
            calls = [{"P1": P1, "P2": P2,
                      "uv1": uv[..., :2].reshape(-1, 2).cpu().numpy(),
                      "uv2": uv[..., 2:].reshape(-1, 2).cpu().numpy()} for uv in b["uv"]]
            edge_dlt.append({"launches": b["launches"], "after": self.slice_end - b["counter"],
                             "calls": calls})
        return {"device_ms": self.device_ms, "edge_dlt": edge_dlt}


class _Span:
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    __slots__ = ("name", "time_range", "device_type")

    def __init__(self, name, start, end, device_type):
        self.name, self.time_range, self.device_type = name, _Span(start, end), device_type


class _Profile:
    """A finished torch.profiler run whose `events()` are read from its
    kineto result with the names, times (µs from the trace's start) and
    device types that `prof.events()` gives them: the same names left out
    and each demangled alike (torch.autograd.profiler's
    `_parse_kineto_results`), without the FunctionEvents, memory records and
    tree that it builds, which took 14-22 s for a slice's 200,000-300,000
    events (H100 machine), all inside the window. A torch without the
    kineto result or those helpers gets `prof.events()`."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        from torch.autograd import profiler_util

        result = getattr(getattr(self.prof, "profiler", None), "kineto_results", None)
        skip = getattr(profiler_util, "_filter_name", None)
        rewrite = getattr(profiler_util, "_rewrite_name", None)
        if result is None or skip is None or rewrite is None:
            return self.prof.events()
        t0 = result.trace_start_ns()
        names, out = {}, []
        for k in result.events():
            raw = k.name()
            if skip(raw) or getattr(k, "is_hidden_event", lambda: False)():
                continue
            name = names.get(raw)
            if name is None:
                name = names[raw] = rewrite(name=raw, with_wildcard=True)
            out.append(_Event(name, (k.start_ns() - t0) / 1000, (k.end_ns() - t0) / 1000,
                              k.device_type()))
        return out


def _ba_numbers_within(max_depth: float):
    """`entries/slam.py::_ba_numbers` over the landmarks that the
    reference's solution resolves (see the module's docstring): at
    0 < z < `max_depth` in their first camera, every observation fitted
    within Huber's width; NaN where it resolves none. Prints the share
    judged and what it leaves out, one line a call."""

    def _ba_numbers(side, ref, b: dict) -> dict:
        st = b["setup"]
        C, P, O = st.num_cams, st.num_points, st.num_obs
        pose_s, pts_s = (torch.as_tensor(x).to(ref[0].device).double() for x in side)
        pose_r, pts_r = ref
        dev = pose_r.device
        cam = st.prob.obs_cam[:O].to(dev).long()
        pt = st.prob.obs_point[:O].to(dev).long()

        def moved(pose6, X):
            return (ref_ba.rotation(pose6[:, :3]) @ X[..., None])[..., 0] + pose6[:, 3:]

        first = torch.full((P,), O, dtype=torch.long, device=dev).scatter_reduce(
            0, pt, torch.arange(O, device=dev), "amin")
        z = moved(pose_r[cam[first]], pts_r)[:, 2]
        r = torch.vmap(ref_ba.residual, in_dims=(0, 0, 0, None, None))(
            pose_r[cam], pts_r[pt], st.prob.obs_uv[:O].to(dev).double(),
            st.prob.P_l.to(dev).double(), st.prob.P_r.to(dev).double())
        outside = r.norm(dim=-1) > b["cfg"].huber_delta
        fitted = torch.zeros(P, dtype=torch.float64, device=dev).index_add_(
            0, pt, outside.double()) == 0
        resolved = (z > 0) & (z < max_depth)
        near = resolved & fitted
        print(f"window BA: {int(near.sum())} of {P} landmarks judged "
              f"({float(near.double().mean()):.4f}): {int((~resolved).sum())} past fx * baseline "
              f"or behind, {int((resolved & ~fitted).sum())} outside Huber's width",
              file=sys.stderr, flush=True)
        if not bool(near.any()):
            return {"points": float("nan"), "pose": float("nan")}
        gap = (pts_s - pts_r).abs().amax(-1) / z.clamp(min=1e-9)
        X = pts_r[pt]
        moved_gap = (moved(pose_s[cam], X) - moved(pose_r[cam], X)).norm(dim=-1)
        return {"points": float(gap[near].max()), "pose": float(moved_gap[near[pt]].max())}

    return _ba_numbers


@contextlib.contextmanager
def _general(traced: _Traced, cfg: dict):
    """`entries/slam.py`, `harness` and the program's `_edge_program`
    with this entry's names (see the module's docstring)."""
    from stereo_orb_slam_torch.apps import slam as slam_mod
    from stereo_orb_slam_torch.ops.kernels import dlt
    from stereo_orb_slam_torch.utils import profiling

    orig_spans, orig_reduce = slam.span_times, harness.reduce_profile
    orig_edges = slam_mod._edge_program

    def span_times(spans):
        times = getattr(profiling.TRACER, "device_times", None)
        traced.device_ms = times() if times is not None else {}
        return orig_spans(spans)

    def reduce_profile(prof, window_s, frames):
        traced.slice_end = dlt.LAUNCHES
        return orig_reduce(_Profile(prof), window_s, frames)

    def _edge_program(src, dst, samplers, rig, fe, rc, banks, world, cache):
        if not torch.autograd._profiler_enabled():
            return orig_edges(src, dst, samplers, rig, fe, rc, banks, world, cache)
        before = dlt.LAUNCHES
        prog = orig_edges(src, dst, samplers, rig, fe, rc, banks, world, cache)
        n = prog.keys.shape[2]
        (_, _, uv_s), (_, _, uv_d) = prog.banks
        idx = prog.packed[:, 16:16 + n].long()
        # The pixel pairs of the batch's two launches: dst's own
        # observations, and src's gathered by the match (`measure_edges`).
        uv_s_m = torch.gather(uv_s, 1, idx[..., None].expand(-1, -1, uv_s.shape[-1]))
        traced.edge_batches.append({"launches": dlt.LAUNCHES - before, "counter": dlt.LAUNCHES,
                                    "uv": [uv_d.clone(), uv_s_m],
                                    "projections": (rig.left.projection, rig.right.projection)})
        return prog

    swaps = [(slam, "render", render), (slam, "_rig", _rig), (slam, "ref_le", general),
             (slam, "_stereo_points", general.stereo_points), (slam, "_Recorder", _Recorder),
             (slam, "_ba_numbers", _ba_numbers_within(cfg["fx"] * cfg["baseline_m"])),
             (slam, "span_times", span_times), (harness, "reduce_profile", reduce_profile),
             (slam_mod, "_edge_program", _edge_program)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in swaps]
    for owner, name, value in swaps:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def run(cfg: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False) -> dict:
    """Set up, run the window and judge it (`entries/slam.py::run` on the
    general rig); returns the entry's outcome (see portbench/run.py). A
    program that would not solve this rig's window BA in float64 is
    refused before anything is rendered."""
    from stereo_orb_slam_torch.backend import ba as ba_mod

    choose = getattr(ba_mod, "marginalize_in_float64", None)
    if choose is None or not choose(_rig(cfg, "cpu")):
        raise RuntimeError("this program does not solve the window BA in float64 on this rig, "
                           "which the configuration's precision states")
    traced = _Traced()
    with _general(traced, cfg):
        out = slam.run(cfg, cell, seed, seconds, trace, device, control)
    if out["trace"] is not None:
        out["trace"].update(traced.trace_items())
    return out

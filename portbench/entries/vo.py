"""The visual-odometry entry: one camera stream through
`VisualOdometer.track`, a frame at a time, as `apps/visual_odometry.py`
drives it, in a closed loop (the next pair is handed over when the pose of
the last one has returned).

Set-up: the kernels built (from the checkout's build directory), the
stream rendered on the card from the seed and handed to host memory as
uint8 pairs, the odometer made with the port's RANSAC seeded from the
seed, and the first `warmup_frames` of the stream tracked, which captures
the front end's program. The window then hands the stream over, in its
order, until `seconds` have passed; each pair is uploaded from host memory
by the port itself. With `trace`, torch.profiler records a slice of the
window's frames.

`correct`: the window is cut into runs of `judge.frames` consecutive
frames, and `judge.runs` of the complete ones are drawn from the seed over
the whole window (a reservoir, so the draw needs no frame count ahead). After
the window, the plain reference (`portbench.reference.frontend`) follows
each drawn run on its own: it starts from the raw pair of the frame before
the run, carries its own slots from frame to frame, draws each frame's
RANSAC keys from the seed, and chains its own poses. Each frame's
`reference.judge.NUMBERS` and each run's chained pose against the port's
trajectory are held to the cell's limits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import harness, traffic
from portbench.reference import frontend as ref_fe
from portbench.reference import judge

_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def _program(cfg: dict, seed: int, device):
    """The port's odometer for the configuration (its world map, rig and
    configs)."""
    from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig
    from stereo_orb_slam_torch.frontend.odometer import VisualOdometer
    from stereo_orb_slam_torch.geometry import camera
    from stereo_orb_slam_torch.worldmap import WorldMap

    dist = cfg.get("dist", [0.0] * 5)
    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = cfg["baseline_m"]
    left = camera.Pinhole.create(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], dist=dist,
                                 device=device)
    right = camera.Pinhole.create(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], dist=dist,
                                  pose=pose_r, device=device)
    rig = camera.StereoRig.create(left, right, rectified=cfg["rectified"],
                                  baseline=cfg["baseline_m"])
    fields = {f.name for f in dataclasses.fields(FrontendConfig)}
    fe = FrontendConfig(**{k: v for k, v in cfg["frontend"].items() if k in fields})
    rc = RansacConfig(**cfg["ransac"])
    return VisualOdometer(WorldMap(feat_slots=fe.num_features), rig, fe=fe, rc=rc, seed=seed)


class Runs:
    """A reservoir of `size` runs of `length` consecutive window frames,
    drawn uniformly from the seed among the complete runs of the window."""

    def __init__(self, seed: int, size: int, length: int):
        self.rng = np.random.default_rng(int(seed))
        self.size, self.length = size, length
        self.kept, self.current, self.complete = [], [], 0

    def add(self, record: tuple):
        self.current.append(record)
        if len(self.current) < self.length:
            return
        run, self.current = self.current, []
        if len(self.kept) < self.size:
            self.kept.append(run)
        else:
            j = int(self.rng.integers(0, self.complete + 1))
            if j < self.size:
                self.kept[j] = run
        self.complete += 1


def run(cfg: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False) -> dict:
    """Set up, run the window and judge it; returns the entry's outcome
    (see portbench/run.py). With `control`, the control's readings of the
    judged runs come back too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from stereo_orb_slam_torch.ops.kernels import _build

        _build.build()
    stream = traffic.make_stream(cfg, cell["traffic"], seed, device)
    vo = _program(cfg, seed, device)
    for i in range(cell["warmup_frames"]):
        f = stream.frame(i)
        vo.track(stream.pairs[f, 0], stream.pairs[f, 1])
    if trace:
        # The profiler's first start loads and initialises its tracer;
        # pay that here, not in the traced slice.
        with torch.profiler.profile(activities=_ACTIVITIES):
            torch.ones(1, device=device).add_(1.0)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs = Runs(seed, cell["judge"]["runs"], cell["judge"]["frames"])
    tr = cell["trace"]
    traced, latencies, failed = [], [], 0
    prof, prof_t0, reduced = None, None, None
    setup_s = harness.process_age_s()

    i = cell["warmup_frames"]
    t_start = time.perf_counter()
    deadline = t_start + seconds
    # A traced run goes on past the deadline until its slice is recorded;
    # its end-to-end metrics are not reported.
    while time.perf_counter() < deadline or (trace and reduced is None):
        pos = i - cell["warmup_frames"]
        if trace and pos == tr["start"]:
            prof = torch.profiler.profile(activities=_ACTIVITIES)
            prof.__enter__()
            prof_t0 = time.perf_counter()
        f = stream.frame(i)
        counter = vo._frame_counter
        t_a = time.perf_counter()
        T = vo.track(stream.pairs[f, 0], stream.pairs[f, 1])
        latencies.append(time.perf_counter() - t_a)
        if not vo.success:
            failed += 1
        # (frame before, frame, RANSAC counter, result, pose, world frame id)
        record = (stream.frame(i - 1), f, counter, vo.last_result, T,
                  vo.world.num_frames - 1 if vo.frame_recorded else None)
        runs.add(record)
        if prof is not None and not cfg["rectified"]:
            traced.append(record)
        if prof is not None and pos == tr["start"] + tr["frames"] - 1:
            if on_card:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - prof_t0
            prof.__exit__(None, None, None)
            reduced = harness.reduce_profile(prof, window_s, tr["frames"])
            prof = None
        i += 1
    t_end = time.perf_counter()
    frames = len(latencies)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    if reduced is not None:
        reduced["shapes"] = _shapes(cfg, traced)
    judged = [[rec + (_global(vo, rec[5]),) for rec in r] for r in runs.kept]
    start_poses = [_global_before(vo, r) for r in runs.kept]
    del vo, traced, runs
    if on_card:
        torch.cuda.empty_cache()
    readings, control_readings = _judge(cfg, cell, seed, stream, judged, start_poses, device,
                                        control)
    lat = np.array(latencies) * 1e3
    return {
        "frames": frames, "failed": failed, "window_s": t_end - t_start,
        "setup_s": setup_s, "render_s": stream.seconds,
        "latency_ms": lat, "memory_peak_bytes": memory_peak, "trace": reduced,
        "readings": readings, "control_readings": control_readings,
        "metrics": {
            "fps": (frames / (t_end - t_start), "frames/s"),
            "frame_p95_ms": (float(np.percentile(lat, 95)) if frames else float("nan"), "ms"),
            "setup_s": (setup_s, "s"),
        },
    }


def _global(vo, fid):
    """The world's camera-to-world pose of frame `fid` (None: not recorded)."""
    return None if fid is None else np.array(vo.world.pose_global[fid], np.float64)


def _global_before(vo, run: list):
    """The world's pose of the last frame recorded before the run."""
    fid = next((rec[5] for rec in run if rec[5] is not None), None)
    if fid is None:
        return None
    return _global(vo, fid - 1) if fid > 0 else np.eye(4)


def _shapes(cfg: dict, traced: list) -> dict:
    """The kernels' shapes in the traced frames, for the roofline readers."""
    n = cfg["frontend"]["num_features"]
    shapes = {"hamming_top2": {"n": n, "m": n, "sets": 2},
              "orb_describe": {"hp": cfg["h"] + 30, "wp": cfg["w"] + 30, "n": n}}
    if not cfg["rectified"]:
        rig = ref_fe.Rig(cfg, "cpu")
        shapes["triangulate_dlt"] = [
            {"P1": rig.P_l.numpy(), "P2": rig.P_r.numpy(),
             "uv1": rec[3].slots.kp_l.cpu().numpy(), "uv2": rec[3].slots.kp_r.cpu().numpy()}
            for rec in traced]
    return shapes


def _follow(cfg, seed, stream, run, rig, table, device, low):
    """The reference (or with `low` the control) along one run: its own
    frames, from the raw pair of the frame before the run on."""
    fe, rc = cfg["frontend"], cfg["ransac"]

    def pair(f):
        return (torch.from_numpy(stream.pairs[f, e]).to(device) for e in (0, 1))

    def keys(counter):
        return ref_fe.gumbel_keys(seed, counter, rc["num_hypotheses"], fe["num_features"],
                                  device)

    first = run[0]
    prev = ref_fe.frame(*pair(first[0]), ref_fe.empty_slots(fe["num_features"], device),
                        keys(first[2] - 1), rig, fe, rc, table, low)
    frames, chain = [], torch.eye(4, dtype=torch.float64, device=device)
    for _before, f, counter, *_ in run:
        out = ref_fe.frame(*pair(f), prev, keys(counter), rig, fe, rc, table, low)
        frames.append(out)
        chain = chain @ out["T"].double()
        if out["success"]:
            prev = out
    return frames, chain


def _judge(cfg, cell, seed, stream, judged, start_poses, device, control):
    """The reference's readings of the judged runs (and the control's): one
    dict of numbers a frame, the run's `trajectory` on its last frame."""
    rig = ref_fe.Rig(cfg, device)
    table = ref_fe.sampling_table(device)
    readings, control_readings = [], []
    for run_, G0 in zip(judged, start_poses):
        ref, ref_chain = _follow(cfg, seed, stream, run_, rig, table, device, False)
        port = [dict(judge.slots(rec[3].slots), prev_idx=rec[3].prev_idx,
                     tracked=rec[3].tracked, T=torch.as_tensor(np.asarray(rec[4])))
                for rec in run_]
        G1 = next((rec[6] for rec in reversed(run_) if rec[6] is not None), None)
        # A run of which no frame was recorded has not moved the port's
        # trajectory.
        port_chain = np.eye(4) if G1 is None else np.linalg.inv(G0) @ G1
        readings += judge.run_numbers(port, port_chain, ref, ref_chain)
        if control:
            low, low_chain = _follow(cfg, seed, stream, run_, rig, table, device, True)
            control_readings += judge.run_numbers(low, low_chain, ref, ref_chain)
    return readings, control_readings

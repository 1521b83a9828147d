"""The SLAM entry: drives through `SlamSystem.process_batch`, as
`apps/slam.py` runs them, back to back in a closed loop (the next batch is
handed over as soon as the call returns).

Set-up: the kernels built; the drive's stereo pairs rendered on the card
(`portbench/scene/canyon.py`, the sensor noise drawn from the seed) and
handed to host memory as uint8; the vocabulary, trained by a `SlamSystem`
with none on the drive's first frames (`SlamSystem._maybe_train_vocab`);
on the card, `prewarm_closure_path(frames)` and one whole drive as the
window drives it, which captures every program the window replays. The
window then starts drives from frame 0 until `seconds` have passed and one
drive has ended (the judge reads a drive's closures): each drive a fresh
`SlamSystem(rig, cfg, vocab=set-up's, seed=seed)`, which writes the rings
the drives before it wrote (`odometer.take_rings`), so that it replays the
programs set-up captured; its host pairs uploaded by
`io/datasets.DeviceBatchReader`'s thread, K frames a call, the last partial
batch uploaded and handed over at the drive's end, then `flush()`.
`fps` counts the frames whose transform has returned. With `trace`, the
program's tracer records the window's spans, except in the profiler slice
(the batches `trace.batch` to `trace.batch + trace.batches - 1` of the
window's first drive), whose device time the tracer's regions would swell.

`correct`: readings against the plain references, on data recorded from the
timed path (`_Recorder`), each a dict of `reference.judge.NUMBERS`:

- front end: `judge.runs` runs of `judge.frames` consecutive frames of one
  drive, drawn from the seed over the window (`vo.Runs`); the reference
  (`reference/loop_edges.py::frame`, RANSAC's refit on) follows each from
  the raw pair of the frame before it, and every number of each frame is
  read, `trajectory` from the port's returned transforms chained over the
  run (not the world's poses, which BA and the pose graph move);
- loop edges: one live closure drawn from the seed, its edges measured again
  by the reference from the same banks with the same keys: `temporal` (the
  share of an edge's slots whose match or inlier flag differs) and `pose`
  (metres: the src frame's valid points moved by either transform), each
  against the reference's answer nearest the port's pose of those its rule
  gives where errors move by 1e-3 px (an edge has no refit, so its pose
  jumps between hypotheses where an error lies on the inlier threshold);
- pose graph: one live solve drawn from the seed, its problem solved again
  by `reference/pose_graph.py` in float64, each Gauss-Newton step by the
  program's stated solve (200 iterations of block-Jacobi CG): `trajectory`,
  the largest distance over the real vertices between each frame's valid
  points moved by the port's and the reference's pose. The same distance
  from the steps' exact (dense Cholesky) solve goes to stderr: the CG's
  200 iterations stop short of it on graphs of thousands of vertices;
- window BA: one pipelined solve drawn from the seed, its problem solved
  again by `reference/ba.py` (float64, the same iterations): `points` (a
  landmark's largest coordinate gap over its depth in its first camera)
  and `pose` (metres: each camera's landmarks moved by either pose).

With `control`, the control (the references one precision step below: a
bfloat16 front end and a float32 back end) is read in the port's place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench.entries.vo import Runs
from portbench.reference import ba as ref_ba
from portbench.reference import frontend as ref_fe
from portbench.reference import judge
from portbench.reference import loop_edges as ref_le
from portbench.reference import pose_graph as ref_pg
from portbench.scene import canyon

_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
# The spans the per-layer readers take (the first five) and the stages a
# traced run reports on stderr, by name.
SPANS = ("slam.batch", "pg.optimize", "pg.edges", "pg.solve", "ba.finish", "pg.polish",
         "vo.dispatch", "vo.collect", "ba.window", "loop.query")


# ------------------------------------------------------------------ stream
def trajectory(spec: dict) -> np.ndarray:
    """[F, 4, 4] camera-to-world poses of the drive. `two_episode`: the
    canyon drive's A A B A B A (`canyon.two_episode_trajectory`).
    `shuttle`: sideways along the rig's baseline, `step_m` a frame:
    `frames_per_leg` frames out, as many back over the same ground, twice as
    many on past the start: a revisit that ends, in few frames."""
    if spec["kind"] == "two_episode":
        return canyon.two_episode_trajectory(spec["frames"], spec["side_a"], spec["side_b"])
    if spec["kind"] == "shuttle":
        n, step = spec["frames_per_leg"], spec["step_m"]
        x = np.concatenate([np.arange(n), n - np.arange(n), -np.arange(2 * n)]) * step
        poses = np.tile(np.eye(4, dtype=np.float32), (len(x), 1, 1))
        poses[:, 0, 3] = x
        return poses
    raise ValueError(f"unknown trajectory {spec['kind']!r}")


def render(cfg: dict, traffic: dict, seed: int, device):
    """The drive's uint8 pairs [F, 2, H, W] in host memory, rendered on
    `device` (textures from the configuration's `texture_seed`, blurred by
    its `blur_texels`; sensor noise from `seed`), and the render's wall
    seconds."""
    t0 = time.perf_counter()
    sc = cfg["scene"]
    if sc["kind"] != "canyon":
        raise ValueError(f"unknown scene {sc['kind']!r}")
    tex_gen = torch.Generator(device=device)
    tex_gen.manual_seed(sc["texture_seed"])
    textures = canyon.make_textures(tex_gen, sigma=sc["blur_texels"])
    scene = canyon.CanyonScene(textures, cfg["fx"], cfg["cx"], cfg["cy"],
                               cfg["baseline_m"], cfg["h"], cfg["w"],
                               noise_sigma=sc["noise_sigma"])
    noise = torch.Generator(device=device)
    noise.manual_seed(int(seed) % (1 << 63))
    pairs = scene.render_pairs(trajectory(traffic["trajectory"]), noise).cpu().numpy()
    return pairs, time.perf_counter() - t0


def _drain(readers: list):
    """Take what the readers of stopped drives uploaded after the stop, so
    their threads end."""
    for reader in readers:
        for _ in reader:
            pass
    readers.clear()


class _Frames:
    """The host pairs of one drive, in order, as `DeviceBatchReader` reads
    them; `stop` ends the iteration at the next pair."""

    def __init__(self, pairs: np.ndarray):
        self.pairs, self.stop = pairs, False

    def __iter__(self):
        for p in self.pairs:
            if self.stop:
                return
            yield p[0], p[1]


# ------------------------------------------------------------------ program
def _rig(cfg: dict, device):
    from stereo_orb_slam_torch.geometry import camera

    pose_r = np.eye(4, dtype=np.float32)
    pose_r[0, 3] = cfg["baseline_m"]
    left = camera.Pinhole.create(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], device=device)
    right = camera.Pinhole.create(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], pose=pose_r,
                                  device=device)
    return camera.StereoRig.create(left, right, rectified=cfg["rectified"],
                                   baseline=cfg["baseline_m"])


def slam_config(cfg: dict):
    """The port's SlamConfig of the configuration: its front end, RANSAC
    and `slam` settings, every other field the program's default."""
    from stereo_orb_slam_torch.config import FrontendConfig, LoopConfig, RansacConfig, SlamConfig

    fields = {f.name for f in dataclasses.fields(FrontendConfig)}
    fe = FrontendConfig(**{k: v for k, v in cfg["frontend"].items() if k in fields})
    s = cfg["slam"]
    return SlamConfig().replace(
        frontend=fe, ransac=RansacConfig(**cfg["ransac"]), batch_frames=s["batch_frames"],
        loop=dataclasses.replace(LoopConfig(), query_size=s["loop_query_size"]),
        live_ba_iterations=s["live_ba_iterations"])


def _failed(batch, first: int, fe) -> int:
    """Frames of a collected batch that did not track: not recorded (too
    few stereo matches), or RANSAC failed on a frame after the drive's
    first."""
    rec = batch.num_stereo >= fe.min_stereo_matches
    ok = rec & (batch.ransac_success.astype(bool) | (np.arange(len(rec)) + first == 0))
    return int((~ok).sum())


# ------------------------------------------------------------------ recorder
class _Recorder:
    """What the judge reads, recorded from the timed path while `install`ed
    (module and class attributes swapped for recording wrappers, as
    chip_smoke.py's `_recording_graphs` does): one live closure's loop-edge
    batch, one live pose-graph solve and one pipelined window BA, each drawn
    from the seed by a reservoir of one, and the front end's runs."""

    def __init__(self, seed: int, judge_spec: dict):
        self.runs = Runs(seed, judge_spec["runs"], judge_spec["frames"])
        self.rng = np.random.default_rng([int(seed), 1])
        self.seen = {"edges": 0, "pg": 0, "ba": 0}
        self.kept = {"edges": None, "pg": None, "ba": None}
        self.system = None
        self.edge_count = 0
        self.desc = None
        self._ba_armed = None   # the iteration budget of the solve being finished

    def _keep(self, what: str) -> bool:
        self.seen[what] += 1
        return int(self.rng.integers(0, self.seen[what])) == 0

    def start_drive(self, system):
        self.system, self.edge_count, self.runs.current = system, 0, []

    def frames(self, out: list, first: int):
        """A returned batch's frames, drive frames first..first + k - 1."""
        b = self.system.vo.last_batch
        for j, T in enumerate(out):
            f = first + j
            if f == 0:
                continue
            self.runs.add((f, b, j, self.desc, np.asarray(T)))

    @contextlib.contextmanager
    def install(self):
        from stereo_orb_slam_torch.apps import slam as slam_mod
        from stereo_orb_slam_torch.backend import ba as ba_mod
        from stereo_orb_slam_torch.backend import pose_graph as pg_mod
        from stereo_orb_slam_torch.frontend import odometer

        rec = self
        saved = [(slam_mod, "measure_edges_program"), (pg_mod, "pg_solve_program"),
                 (ba_mod.BundleAdjuster, "optimize_async"), (ba_mod.BundleAdjuster,
                                                              "_apply_result"),
                 (odometer.VisualOdometer, "collect_batch")]
        orig = {name: getattr(owner, name) for owner, name in saved}

        def measure_edges_program(src, dst, samplers, rig, fe, rc, banks=None, world=None,
                                  cache=None):
            out = orig["measure_edges_program"](src, dst, samplers, rig, fe, rc, banks, world,
                                                cache)
            first, rec.edge_count = rec.edge_count, rec.edge_count + len(src)
            if rec._keep("edges"):
                rows = [torch.as_tensor(np.asarray(ids, np.int64), device=banks[0].device)
                        for ids in (src, dst)]
                rec.kept["edges"] = {
                    "first": first, "src": list(src), "dst": list(dst), "out": out,
                    "banks": [tuple(b.index_select(0, r) for b in banks) for r in rows]}
            return out

        def pg_solve_program(prob, cfg, cache=None, group=None):
            out = orig["pg_solve_program"](prob, cfg, cache, group)
            if rec._keep("pg"):
                rec.kept["pg"] = {"prob": prob, "poses": out[0].poses, "cfg": cfg,
                                  "n": rec.system.world.num_frames, "world": rec.system.world}
            return out

        def optimize_async(self, start, end, max_iterations=None, max_seconds=None):
            fin = orig["optimize_async"](self, start, end, max_iterations, max_seconds)
            if fin is None or max_iterations is None or max_seconds is not None:
                return fin

            def finish():
                rec._ba_armed = max_iterations
                try:
                    return fin()
                finally:
                    rec._ba_armed = None

            return finish

        def _apply_result(self, setup, flat, chunked):
            if rec._ba_armed is not None and rec._keep("ba"):
                rec.kept["ba"] = {"setup": setup, "flat": flat, "cfg": self.cfg,
                                  "iterations": rec._ba_armed}
            return orig["_apply_result"](self, setup, flat, chunked)

        def collect_batch(self, handle):
            rec.desc = handle["stacked"].slots.desc
            return orig["collect_batch"](self, handle)

        wrappers = {"measure_edges_program": measure_edges_program,
                    "pg_solve_program": pg_solve_program, "optimize_async": optimize_async,
                    "_apply_result": _apply_result, "collect_batch": collect_batch}
        for owner, name in saved:
            setattr(owner, name, wrappers[name])
        try:
            yield self
        finally:
            for owner, name in saved:
                setattr(owner, name, orig[name])


# ------------------------------------------------------------------ run
def run(cfg: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False) -> dict:
    """Set up, run the window and judge it; returns the entry's outcome
    (see portbench/run.py). With `control`, the control's readings come
    back too."""
    from stereo_orb_slam_torch.apps.slam import SlamSystem
    from stereo_orb_slam_torch.io.datasets import DeviceBatchReader
    from stereo_orb_slam_torch.utils import profiling, programs

    from stereo_orb_slam_torch.frontend import odometer

    if not hasattr(odometer, "take_rings"):
        # Nothing may be captured in the window: a program whose drives each
        # write rings of their own captures its front end again every drive.
        raise RuntimeError("this program's live loop has no rings in the program cache "
                           "(odometer.take_rings): every drive would capture its front end")
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from stereo_orb_slam_torch.ops.kernels import _build

        _build.build()
    pairs, render_s = render(cfg, cell["traffic"], seed, device)
    rig = _rig(cfg, device)
    scfg = slam_config(cfg)
    K = scfg.batch_frames

    def drive(system, frames: _Frames, readers: list):
        """Hand the drive's batches over; yields (batch index, transforms
        returned) after each call, the flush's last. The drive's reader is
        in `readers` until it has handed over its last batch."""
        reader = DeviceBatchReader(frames, K, device=device)
        readers.append(reader)
        i = 0
        for dl, dr in reader:
            yield i, system.process_batch(dl, dr)
            i += 1
        readers.remove(reader)
        if frames.stop:
            return
        if reader.remainder:
            dl, dr = (torch.from_numpy(np.stack(side)).to(device)
                      for side in zip(*reader.remainder))
            yield i, system.process_batch(dl, dr)
            i += 1
        yield i, system.flush()

    if trace:
        # The profiler's first start loads and initialises its tracer; pay
        # that here, not in the traced slice, and before the set-up drive:
        # started after its captures, it took minutes (H100).
        with torch.profiler.profile(activities=_ACTIVITIES):
            torch.ones(1, device=device).add_(1.0)

    # Set-up: the vocabulary, trained on the drive's first frames; then, on
    # the card, one whole drive as the window drives it, which captures every
    # program they replay (the drives are alike to the bit).
    t_setup = time.perf_counter()
    trainer, frames, readers = SlamSystem(rig, scfg, vocab=None, seed=seed), _Frames(pairs), []
    for _ in drive(trainer, frames, readers):
        if trainer.vocab is not None:
            frames.stop = True
            break
    _drain(readers)
    vocab = trainer.vocab
    if vocab is None:
        raise RuntimeError("the drive's frames trained no vocabulary")
    del trainer
    if on_card:
        first = SlamSystem(rig, scfg, vocab=vocab, seed=seed)
        first.prewarm_closure_path(len(pairs))
        for _ in drive(first, _Frames(pairs), readers):
            pass
        del first
    setup_drive_s = time.perf_counter() - t_setup
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cache = programs.PROGRAMS
    builds0 = cache.builds
    tracer = profiling.TRACER
    tracer.reset()
    rec = _Recorder(seed, cell["judge"])
    tr = cell["trace"]
    setup_s = harness.process_age_s()

    returned = failed = drives = 0
    prof = reduced = loop_filter = None
    closures = []
    with rec.install():
        tracer.enable(trace)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        done = False
        try:
            while not done:
                system = SlamSystem(rig, scfg, vocab=vocab, seed=seed)
                rec.start_drive(system)
                frames, got = _Frames(pairs), 0
                for i, out in drive(system, frames, readers):
                    if out:
                        failed += _failed(system.vo.last_batch, got, scfg.frontend)
                        rec.frames(out, got)
                        got += len(out)
                    if trace and drives == 0 and i + 1 == tr["batch"]:
                        tracer.enable(False)
                        prof = torch.profiler.profile(activities=_ACTIVITIES)
                        prof.__enter__()
                        prof_t0, prof_frames = time.perf_counter(), got
                    if prof is not None and i + 1 == tr["batch"] + tr["batches"]:
                        if on_card:
                            torch.cuda.synchronize()
                        slice_s = time.perf_counter() - prof_t0
                        prof.__exit__(None, None, None)
                        reduced = harness.reduce_profile(prof, slice_s, got - prof_frames)
                        prof = None
                        tracer.enable(True)
                    if drives and time.perf_counter() >= deadline and not (trace and reduced
                                                                            is None):
                        frames.stop = done = True
                        break
                returned += got
                if drives == 0:
                    loop_filter = loop_events(system.loop)
                drives += 1
                done = done or time.perf_counter() >= deadline
                closures += [h for h in system.pgo.history if h.get("live")]
        finally:
            tracer.enable(False)
        t_end = time.perf_counter()
    _drain(readers)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    captures = cache.builds - builds0
    stats = {"render_s": render_s, "setup_drive_s": setup_drive_s, "drives": drives,
             "frames": returned, "programs_built_in_window": captures,
             "loop_filter": loop_filter,
             "closures": [{k: h[k] for k in ("num_vertices", "num_loop_edges", "edges_padded",
                                             "vertices_padded", "wall_seconds")}
                          for h in closures]}
    print("slam window: " + json.dumps(stats), file=sys.stderr, flush=True)
    if reduced is not None:
        reduced["spans"] = span_times(tracer.spans())
        reduced["closures"] = stats["closures"]
        print("spans outside the profiler slice (count, mean ms): " + json.dumps(
            {k: [len(v), sum(v) / len(v) if v else None] for k, v in reduced["spans"].items()}),
              file=sys.stderr, flush=True)
    tracer.reset()
    del system
    readings, control_readings = _judge(cfg, cell["judge"], seed, pairs, rec, device,
                                        control)
    return {
        "frames": returned, "failed": failed, "window_s": t_end - t_start,
        "setup_s": setup_s, "render_s": render_s, "latency_ms": np.zeros(0),
        "memory_peak_bytes": memory_peak, "trace": reduced, "readings": readings,
        "control_readings": control_readings, "stats": stats,
        "metrics": {"fps": (returned / (t_end - t_start), "frames/s"),
                    "setup_s": (setup_s, "s")},
    }


def loop_events(loop) -> dict:
    """The loop filter's course over a drive, by query (frame ids, where
    every frame was recorded): where its probability entered a loop (rose
    above `is_loop_thresh`) and where it left one (fell below
    `not_loop_thresh`: a live closure), whether the drive ended inside a
    loop, and the loop edges no closure measured (queued by the filter or
    committed to the pose graph)."""
    cfg, inside = loop.cfg, False
    entries, exits = [], []
    for q, p in enumerate(loop.probabilities):
        if p > cfg.is_loop_thresh and not inside:
            entries.append(q)
            inside = True
        elif p < cfg.not_loop_thresh and inside:
            exits.append(q)
            inside = False
    return {"entries": entries, "exits": exits, "in_loop_at_end": bool(loop.in_loop),
            "edges_pending_at_end": len(loop.potential_edges) + len(loop.optimizer.loop_edges)}


def span_times(spans) -> dict:
    """{name: [milliseconds of each recorded span]} of the names in SPANS."""
    out = {name: [] for name in SPANS}
    for s in spans:
        if s.name in out and s.end_ns >= 0:
            out[s.name].append((s.end_ns - s.start_ns) * 1e-6)
    return out


# ------------------------------------------------------------------ judge
def _port_frame(record) -> dict:
    """The port's frame of a recorded run entry (dicts as `judge.numbers`
    takes them)."""
    _f, b, j, desc, T = record
    s = b.slots
    return {"kp_l": s.kp_l[j], "kp_r": s.kp_r[j], "desc": desc[j], "pts": s.pts[j],
            "valid": s.valid[j], "prev_idx": b.prev_idx[j], "tracked": b.tracked[j],
            "T": torch.as_tensor(T)}


def _follow(cfg, seed, pairs, run_, rig, table, device, low):
    """The reference (or with `low` the control) along one run: its own
    frames, from the raw pair of the frame before the run on, each frame's
    keys those of its drive frame."""
    fe, rc = cfg["frontend"], cfg["ransac"]

    def pair(f):
        return (torch.from_numpy(pairs[f, e]).to(device) for e in (0, 1))

    def keys(f):
        return ref_fe.gumbel_keys(seed, f, rc["num_hypotheses"], fe["num_features"], device)

    f0 = run_[0][0]
    prev = ref_le.frame(*pair(f0 - 1), ref_fe.empty_slots(fe["num_features"], device),
                        keys(f0 - 1), rig, fe, rc, table, low)
    frames, chain = [], torch.eye(4, dtype=torch.float64, device=device)
    for f, *_ in run_:
        out = ref_le.frame(*pair(f), prev, keys(f), rig, fe, rc, table, low)
        frames.append(out)
        chain = chain @ out["T"].double()
        if out["success"]:
            prev = out
    return frames, chain


def _edge_numbers(port, ref: list) -> list:
    """`temporal` and `pose` of each loop edge: the port's (Z [E, 4, 4],
    idx [E, N], inlier mask [E, N], ...) against the reference's answer
    nearest to the port's pose, of those its rule gives under rounding
    (`reference/loop_edges.py::tied`)."""
    Z, idx, inl = port[:3]
    out = []
    for e, r in enumerate(ref):
        dev = r["idx"].device
        p_idx = torch.as_tensor(np.asarray(idx[e]), device=dev).long()
        p_inl = torch.as_tensor(np.asarray(inl[e]), device=dev).bool()
        gaps = [judge._moved_gap(np.asarray(Z[e]), T.cpu(), r) for T, _, _ in r["answers"]]
        k = int(np.argmin(gaps))
        differ = (r["ok"] & (p_idx != r["idx"].long())) | (p_inl != r["answers"][k][1])
        out.append({"temporal": float(differ.float().mean()), "pose": gaps[k]})
    return out


def _stereo_points(uv, valid, rig: ref_fe.Rig):
    """Camera-frame points [F, N, 3] float64 of ideal stereo observations
    [F, N, 4] by the rectified closed form, and their validity."""
    uv = uv.double()
    d = uv[..., 0] - uv[..., 2]
    z = rig.fx * rig.baseline / torch.where(d.abs() < 1e-6, 1e-6, d)
    pts = torch.stack([(uv[..., 0] - rig.cx) * z / rig.fx, (uv[..., 1] - rig.cy) * z / rig.fx, z],
                      -1)
    return pts, valid & (z > 0)


def _pg_gap(poses_a, poses_b, world, n, rig) -> float:
    """The largest distance over frames [0, n) between each frame's valid
    points moved by its pose in `poses_a` and in `poses_b` ([n, 4, 4])."""
    dev = poses_a.device
    worst = 0.0
    for lo in range(0, n, 512):
        hi = min(n, lo + 512)
        uv = torch.as_tensor(world.frame_feat_uv[lo:hi], device=dev)
        valid = torch.as_tensor(world.frame_feat_valid[lo:hi], device=dev)
        X, ok = _stereo_points(uv, valid, rig)
        A, B = poses_a[lo:hi].double(), poses_b[lo:hi].double()
        gap = ((X @ A[:, :3, :3].transpose(1, 2) + A[:, None, :3, 3])
               - (X @ B[:, :3, :3].transpose(1, 2) + B[:, None, :3, 3])).norm(dim=-1)
        if bool(ok.any()):
            worst = max(worst, float(gap[ok].max()))
    return worst


def _pg_solve(g: dict, dtype, linear: str):
    """The reference's solve of a recorded pose graph's real vertices and
    edges, with the program's configuration (its CG budget for "pcg")."""
    prob, cfg, n = g["prob"], g["cfg"], g["n"]
    real = prob.edge_weight > 0
    return ref_pg.solve(prob.poses[:n], prob.edge_a[real], prob.edge_b[real],
                        prob.edge_meas[real], cfg.iterations, cfg.info_translation,
                        cfg.info_rotation, cfg.huber_delta, cfg.damping, (0,), dtype, linear,
                        cfg.cg_iterations, cfg.cg_tol)[0]


def _ba_solve(b: dict, dtype):
    st, cfg = b["setup"], b["cfg"]
    p, C, P, O = st.prob, st.num_cams, st.num_points, st.num_obs
    return ref_ba.solve(p.pose6[:C], p.points[:P], p.obs_cam[:O], p.obs_point[:O],
                        p.obs_uv[:O], p.P_l, p.P_r, b["iterations"], dataclasses.asdict(cfg),
                        free=p.cam_mask[:C] > 0, dtype=dtype)[:2]


def _ba_numbers(side, ref, b: dict) -> dict:
    """`points` and `pose` of a window BA's solution `side` (pose6, points)
    against the reference's."""
    st = b["setup"]
    C, P, O = st.num_cams, st.num_points, st.num_obs
    pose_s, pts_s = (torch.as_tensor(x).to(ref[0].device).double() for x in side)
    pose_r, pts_r = ref
    cam = st.prob.obs_cam[:O].to(pose_r.device).long()
    pt = st.prob.obs_point[:O].to(pose_r.device).long()

    def moved(pose6, X):
        return (ref_ba.rotation(pose6[:, :3]) @ X[..., None])[..., 0] + pose6[:, 3:]

    first = torch.full((P,), O, dtype=torch.long, device=cam.device).scatter_reduce(
        0, pt, torch.arange(O, device=cam.device), "amin")
    depth = moved(pose_r[cam[first]], pts_r)[:, 2].abs().clamp(min=1e-9)
    points = float(((pts_s - pts_r).abs().amax(-1) / depth).max())
    X = pts_r[pt]
    pose = float((moved(pose_s[cam], X) - moved(pose_r[cam], X)).norm(dim=-1).max())
    return {"points": points, "pose": pose}


def _judge(cfg, judge_spec, seed, pairs, rec: _Recorder, device, control):
    """The readings of the recorded data against the plain references (and
    the control's, with `control`). A part of the back end that the window
    never ran reads NaN: every run is judged on all of them."""
    rig = ref_fe.Rig(cfg, device)
    table = ref_fe.sampling_table(device)
    fe, rc = cfg["frontend"], cfg["ransac"]
    readings, control_readings = [], []
    parts = {}

    def both(part, port_numbers, low_numbers):
        readings.extend(port_numbers)
        low = low_numbers() if control else []
        control_readings.extend(low)
        got = parts.setdefault(part, ([], []))
        got[0].extend(port_numbers)
        got[1].extend(low)

    for run_ in rec.runs.kept:
        ref, ref_chain = _follow(cfg, seed, pairs, run_, rig, table, device, False)
        chain = np.eye(4)
        for rcd in run_:
            chain = chain @ np.asarray(rcd[4], np.float64)
        both("front end", judge.run_numbers([_port_frame(r) for r in run_], chain, ref,
                                            ref_chain),
             lambda: judge.run_numbers(*_follow(cfg, seed, pairs, run_, rig, table, device,
                                                True), ref, ref_chain))
    missing = {"edges": ("temporal", "pose"), "pg": ("trajectory",), "ba": ("points", "pose")}
    for what, names in missing.items():
        if rec.kept[what] is None:
            print(f"the window ran no {what}: it reads NaN", file=sys.stderr, flush=True)
            readings.append({k: float("nan") for k in names})
    e = rec.kept["edges"]
    if e is not None:
        keys = [ref_le.edge_keys(e["first"] + i, rc["num_hypotheses"], fe["num_features"],
                                 device) for i in range(len(e["src"]))]
        src, dst = ([t.to(device) for t in side] for side in e["banks"])
        ref = ref_le.edges(src, dst, keys, rig, fe, rc)
        both("loop edges", _edge_numbers(e["out"], ref),
             lambda: _edge_numbers(_stack_edges(ref_le.edges(src, dst, keys, rig, fe, rc,
                                                             True)), ref))
    g = rec.kept["pg"]
    if g is not None:
        linear = judge_spec["pose_graph"]
        ref_poses = _pg_solve(g, torch.float64, linear)
        world, n = g["world"], g["n"]
        port_poses = g["poses"][:n].to(ref_poses.device)
        both(f"pose graph ({n} vertices)",
             [{"trajectory": _pg_gap(port_poses, ref_poses, world, n, rig)}],
             lambda: [{"trajectory": _pg_gap(_pg_solve(g, torch.float32, linear), ref_poses,
                                             world, n, rig)}])
        # Not a reading: how far the program's solve stops from the exact
        # solve of the same steps (`pose_graph` "pcg", the workload's stopgap).
        exact = _pg_solve(g, torch.float64, "cholesky")
        print(f"the pose graph ({n} vertices) from its exact solve: port "
              f"{_pg_gap(port_poses, exact, world, n, rig)} m, the reference's CG "
              f"{_pg_gap(ref_poses, exact, world, n, rig)} m, its start "
              f"{_pg_gap(g['prob'].poses[:n].to(exact.device), exact, world, n, rig)} m",
              file=sys.stderr, flush=True)
    b = rec.kept["ba"]
    if b is not None:
        ref = _ba_solve(b, torch.float64)
        st, flat = b["setup"], b["flat"]
        C, P = st.num_cams, st.num_points
        port = (flat[:st.C_pad * 6].reshape(st.C_pad, 6)[:C],
                flat[st.C_pad * 6:st.C_pad * 6 + st.P_pad * 3].reshape(st.P_pad, 3)[:P])
        both("window BA", [_ba_numbers(port, ref, b)],
             lambda: [_ba_numbers(_ba_solve(b, torch.float32), ref, b)])
    def shown(rs):
        return json.dumps({k: v for k, v in judge.worst(rs).items() if v is not None})

    for part, (port, low) in parts.items():
        print(f"readings of the {part}: port {shown(port)}"
              + (f", control {shown(low)}" if control else ""), file=sys.stderr, flush=True)
    return readings, control_readings


def _stack_edges(edges: list):
    """Reference edges as the port's outputs (Z, idx, inlier mask)."""
    return ([r["T"].cpu().numpy() for r in edges], [r["idx"].cpu().numpy() for r in edges],
            [r["inliers"].cpu().numpy() for r in edges])

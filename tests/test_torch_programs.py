"""The captured programs (stereo_orb_slam_torch/utils/programs.py) against
the eager functions they replace, and the program cache.

Every unit's program must equal its eager function BIT FOR BIT: a replay
runs the same kernels in the same order on the same data, and on the CPU
the program runs its in-place bodies in the order the card replays them.
So any difference is a stale or aliased static tensor, never float noise.
The units: `pg_solve` (a 40-vertex graph with 2 loop edges; padded to its
bucket, and graphs of two real sizes in one bucket sharing one program),
`ba_solve` on the dense, banded and matrix-free paths and the chunked `lm_init` +
`ba_resume` (a 64-camera banded problem), `frontend_step`,
`frontend_chain` and `frontend_chain_bow` over 5 rectified PlaneScene
frames and over 5 frames of the distorted rig (tests/synth_distorted.py:
the undistort and the batched DLT inside the step), and the
multi-sequence step at S = 2 on stacked rectified and stacked distorted
rigs. The cases marked `cuda`
repeat them with real graphs on the card and skip without one:

    python -m pytest -q --noconftest -m cuda tests/test_torch_programs.py

The cache keys on shape, dtype, device and configuration, gives back one
program per key and evicts the least recently used; a replay adds the
kernel launches its capture took back. This file imports neither JAX nor
the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402
from synth_ba import banded_problem  # noqa: E402
from synth_distorted import DistortedPlaneScene  # noqa: E402

from stereo_orb_slam_torch.backend import ba, pose_graph as pg  # noqa: E402
from stereo_orb_slam_torch.config import (  # noqa: E402
    BAConfig, FrontendConfig, PoseGraphConfig, RansacConfig,
)
from stereo_orb_slam_torch.frontend import odometer as odo, ransac  # noqa: E402
from stereo_orb_slam_torch.geometry import camera as cam  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import hamming  # noqa: E402
from stereo_orb_slam_torch.parallel import multi_seq  # noqa: E402
from stereo_orb_slam_torch.utils import programs  # noqa: E402

torch.set_num_threads(1)
N_FEAT, K_HYP, FRAMES = 128, 16, 5
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured only on the card")
    return torch.device(request.param)


@pytest.fixture
def cache():
    c = programs.ProgramCache()
    yield c
    c.clear()


def _equal(a, b):
    """Bitwise equality of two tensors or (nested) tuples of them."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


# -- the pose graph ---------------------------------------------------------

def _pose_graph(device, n=40):
    """A chain of n vertices 0.5 m apart, perturbed by 5 cm, with odometry
    edges and two loop edges (0-39, 5-30); vertex 0 fixed."""
    rng = np.random.default_rng(0)
    truth = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    truth[:, 0, 3] = 0.5 * np.arange(n)
    noisy = truth.copy()
    noisy[1:, :3, 3] += rng.normal(0, 0.05, (n - 1, 3)).astype(np.float32)
    a = list(range(n - 1)) + [0, 5]
    b = list(range(1, n)) + [n - 1, 30]
    meas = np.stack([np.linalg.inv(truth[i]) @ truth[j] for i, j in zip(a, b)])
    vmask = np.ones(n, np.float32)
    vmask[0] = 0.0

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return pg.PoseGraphProblem(t(noisy), t(a, torch.int64), t(b, torch.int64),
                               t(meas, torch.float32), torch.ones(len(a), device=device),
                               t(vmask))


def test_pose_graph_program_equals_eager(device, cache):
    prob, cfg = _pose_graph(device), PoseGraphConfig()
    want = pg.pg_solve(prob, cfg)
    for _ in range(2):   # a capture, then a program found in the cache
        got = pg.pg_solve_program(prob, cfg, cache=cache)
        assert _equal(got[0].poses, want[0].poses) and _equal(got[1:], want[1:])
    assert float(want[2]) < float(want[1])
    assert cache.builds == 1 and cache.hits == 1


def _bucketed_graph(device, n):
    """_pose_graph's chain of n vertices padded to its bucket, as the
    optimizer pads it."""
    prob = _pose_graph("cpu", n)
    return pg.bucketed_problem(prob.poses.numpy(), prob.edge_a.numpy(), prob.edge_b.numpy(),
                               prob.edge_meas.numpy(), device)


def test_graphs_of_one_bucket_share_one_program(device, cache):
    """Graphs of 40 and 50 vertices (41 and 51 edges) both pad to the
    (64, 64) bucket: one GNProgram is built, and each solve through it is
    bit for bit the eager pg_solve of its padded problem."""
    for n in (40, 50, 40):
        prob, cfg = _bucketed_graph(device, n), PoseGraphConfig()
        assert (prob.poses.shape[0], prob.edge_a.shape[0]) == (64, 64)
        want = pg.pg_solve(prob, cfg)
        got = pg.pg_solve_program(prob, cfg, cache=cache)
        assert _equal(got[0].poses, want[0].poses) and _equal(got[1:], want[1:])
    assert (cache.builds, cache.hits) == (1, 2)


@pytest.mark.parametrize("graph", ["exact", "bucketed", "bucketed_wide", "all_padding"])
def test_pose_graph_program_plan_has_the_edge_plans_shapes(graph):
    """GNProgram sizes its static edge plan from the problem's shapes
    (2E rows; 2N segments and the weight-0 rows' spread): each tensor has
    the shape of `edge_plan`'s for the same problem, at its own size, at a
    bucket, at a bucket of more than SPREAD_ROWS padded rows, and for the
    all-padding problem the prewarm solves."""
    if graph == "exact":
        prob = _pose_graph("cpu")
    elif graph == "all_padding":
        none = np.zeros((0, 4, 4), np.float32)
        prob = pg.pad_problem(none, [], [], none, 64, 128, "cpu")
    else:
        prob = _bucketed_graph("cpu", 40 if graph == "bucketed" else 200)
    got = pg.GNProgram(prob, PoseGraphConfig()).plan
    want = pg.edge_plan(prob)
    assert [t.shape for t in (got.ends, *got.seg)] == [t.shape for t in (want.ends, *want.seg)]


def test_pose_graph_optimizer_runs_the_program(monkeypatch):
    from stereo_orb_slam_torch.worldmap import WorldMap

    world = WorldMap()
    for _ in range(6):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.3
        world.add_frame(T)
    calls = []
    real = pg.pg_solve_program
    monkeypatch.setattr(pg, "pg_solve_program", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(pg, "pg_solve", None)   # the optimizer must not need it
    monkeypatch.setattr(programs, "PROGRAMS", programs.ProgramCache())
    pgo = pg.PoseGraphOptimizer(world, device="cpu")
    stats = pgo.optimize(run_global_ba=False)
    assert calls == [1] and stats["num_edges"] == 5
    # The first solve builds its bucket's program, the second finds it; the
    # CPU captures nothing.
    again = pgo.optimize(run_global_ba=False)
    assert (stats["program_built"], again["program_built"]) == (True, False)
    assert stats["pg_capture_ms"] == again["pg_capture_ms"] == 0.0


# -- bundle adjustment ------------------------------------------------------

@pytest.fixture(scope="module")
def ba_case():
    prob, slots, band = banded_problem(np.random.default_rng(0), C=64, P=2048)
    assert band is not None
    return prob, slots[0].shape[1], band


def _ba_kwargs(path, K, band):
    if path == "matrix-free":
        return {}
    if path == "dense":
        return dict(dense_K=K)
    return dict(dense_K=K, band_bases=band[0], band_B=band[1], band_Pc=band[2])


@pytest.mark.parametrize("path", ["dense", "banded", "matrix-free"])
def test_ba_program_equals_eager(device, cache, ba_case, path):
    prob, K, band = ba_case
    prob = prob.to(device)
    cfg = BAConfig()
    kw = _ba_kwargs(path, K, band)
    want = ba.ba_solve(prob, 4, cfg, **kw)
    got = ba.ba_solve_program(prob, 4, cfg, cache=cache, **kw)
    assert _equal(got, want)
    assert int(got[1]) == 4 and float(got[0].cost) < float(got[2])


def test_ba_chunked_program_equals_resume(device, cache, ba_case):
    """BundleAdjuster's chunked path: lm_init, then ba_resume in chunks (the
    program's `start`, then `iterate` in the same chunks), with camera-run
    slot maps in place of the one-hot."""
    prob, K, _ = ba_case
    prob = prob.to(device)
    cfg = BAConfig(function_tolerance=0.0)
    ds = ba.build_slots_device(prob.obs_point, prob.obs_cam, prob.obs_weight,
                               prob.points.shape[0], K)
    cam_red = ba.build_cam_slots_device(prob.obs_cam, prob.obs_weight, prob.pose6.shape[0],
                                        128)
    carry = ba.lm_init(prob, cfg, dense_slots=ds, cam_red=cam_red)
    ran = 0
    for k in (1, 2):
        carry, r, _ = ba.ba_resume(carry, k, cfg, dense_slots=ds, cam_red=cam_red)
        ran += int(r)
    prog = ba.lm_program(prob, cfg, K, 128, None, True, cache)
    prog.load(prob)
    prog.run("start", prog.start)
    prog.iterate(1)
    prog.iterate(2)
    assert int(prog.iters) == ran == 3
    assert _equal(prog.carry, carry)


def test_lm_program_is_found_again_for_a_new_problem_of_its_shape(cache, ba_case):
    """The window solves' case: one program serves every problem of its
    padded shape and path, its state reloaded per solve."""
    prob, K, _ = ba_case
    cfg = BAConfig()
    other = prob._replace(points=prob.points * 1.001)
    for p in (prob, other):
        assert _equal(ba.ba_solve_program(p, 3, cfg, dense_K=K, cache=cache),
                      ba.ba_solve(p, 3, cfg, dense_K=K))
    assert (cache.builds, cache.hits) == (1, 1)


def test_lm_program_serves_every_band_plan_of_its_shape(device, cache, ba_case):
    """A banded solve's chunk bases are data: another plan of the same
    chunk count, width and chunk size (here each chunk's band moved as far
    down as its last camera allows) reuses the program, and each solve
    equals the eager one with its own plan."""
    prob, K, (bases, B, Pc) = ba_case
    prob = prob.to(device)
    cam, pt = prob.obs_cam.cpu().numpy(), prob.obs_point.cpu().numpy()
    last = np.zeros(len(bases), np.int64)
    np.maximum.at(last, pt // Pc, cam)
    lowered = np.maximum(last - B + 1, 0).astype(np.int32)
    assert not np.array_equal(lowered, bases)
    cfg = BAConfig()
    for plan in (bases, lowered):
        kw = dict(dense_K=K, band_bases=plan, band_B=B, band_Pc=Pc)
        assert _equal(ba.ba_solve_program(prob, 3, cfg, cache=cache, **kw),
                      ba.ba_solve(prob, 3, cfg, **kw))
    assert (cache.builds, cache.hits) == (1, 1)



def test_banded_schur_adds_device_bases_as_slices():
    """The captured path's chunk bases (a device tensor: one index_add_ a
    chunk) give the Schur complement bit for bit as the eager path's host
    bases (slices), overlapping bands included."""
    from stereo_orb_slam_torch.backend import schur_dense

    prob, (_sto, scam, smask), (bases, B, Pc) = banded_problem(np.random.default_rng(1), C=32,
                                                               P=1024)
    assert len(set(bases.tolist())) < len(bases) and bases.max() > 0
    gen = torch.Generator().manual_seed(1)
    C, (P, K) = 32, scam.shape
    H = torch.randn((C, 6, 6), generator=gen)
    Hpp_inv = torch.randn((P, 3, 3), generator=gen)
    Wg = torch.randn((P, K, 6, 3), generator=gen) * smask[..., None, None]
    args = (H @ H.transpose(1, 2), Hpp_inv, scam, smask, prob.cam_mask, Wg)
    host = schur_dense.assemble_schur_banded(*args, bases, B, Pc)
    dev = schur_dense.assemble_schur_banded(*args, torch.as_tensor(bases, dtype=torch.int64),
                                            B, Pc)
    assert _equal(dev, host)


def test_rings_are_handed_to_one_live_holder_at_a_time(cache):
    """The live loop's feature rings belong to the program cache: a holder
    takes a set no live holder writes, and a dropped holder's set goes to
    the next one (so its captured front end replays); another capacity or
    feature count is another set."""
    class Holder:
        pass

    a, b = Holder(), Holder()
    rings_a = odo.take_rings(8, 4, "cpu", a, cache)
    assert [r.shape for r in rings_a] == [(9, 4, 8), (9, 4), (9, 4, 4)]
    rings_b = odo.take_rings(8, 4, "cpu", b, cache)
    assert rings_b[0] is not rings_a[0]
    del a
    rings_c = odo.take_rings(8, 4, "cpu", Holder(), cache)
    assert all(x is y for x, y in zip(rings_c, rings_a))
    assert cache.builds == 2
    other = (odo.take_rings(16, 4, "cpu", b, cache), odo.take_rings(8, 2, "cpu", b, cache))
    assert all(o[0] is not r for o in other for r in (rings_a[0], rings_b[0]))
    assert cache.builds == 4


# -- the front end, rectified and general ----------------------------------

def _rig(scene, device):
    right = np.eye(4, dtype=np.float32)
    right[0, 3] = scene.baseline
    return cam.StereoRig.create(
        cam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, device=device),
        cam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, pose=right, device=device),
        True, scene.baseline)


@pytest.fixture(scope="module")
def frames():
    scene = PlaneScene(np.random.default_rng(11))
    imgs = [(scene.render(0.2 * i), scene.render(0.2 * i, right=True)) for i in range(FRAMES)]
    return scene, np.stack([a for a, _ in imgs]), np.stack([b for _, b in imgs])


@pytest.fixture(scope="module")
def general_frames():
    """tests/synth_distorted.py's scene (fx 220, k1 -0.15, k2 0.03, baseline
    0.4 m, the plane at 11 m) moving 4 whole pixels a frame in undistorted
    coordinates, and its distorted rig (rectified False)."""
    scene = DistortedPlaneScene(np.random.default_rng(11), depth=11.0)
    step = 4 * scene.depth / scene.fx
    imgs = [(scene.render(step * i), scene.render(step * i, right=True)) for i in range(FRAMES)]
    return scene, np.stack([a for a, _ in imgs]), np.stack([b for _, b in imgs])


def _samplers(seed, k, device):
    out = []
    for i in range(k):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + i)
        out.append(ransac.gumbel_sampler(gen, K_HYP))
    return out


FE, RC = FrontendConfig(num_features=N_FEAT), RansacConfig(num_hypotheses=K_HYP)


def _step_and_chain_equal_eager(device, cache, rig, il, ir, min_inliers):
    rectified = rig.rectified
    il, ir = torch.as_tensor(il, device=device), torch.as_tensor(ir, device=device)
    prev, md = odo.empty_slots(N_FEAT, device), rig.max_sensible_distance()
    want = odo.frontend_chain(il, ir, prev, False, _samplers(7, FRAMES, device), rig, md, FE, RC,
                              rectified)
    got = odo.frontend_chain_program(il, ir, prev, False, _samplers(7, FRAMES, device), rig, md,
                                     FE, RC, cache=cache)
    assert _equal(got, want)
    assert [int(x) for x in want[1].num_inliers[1:]] and \
        min(want[1].num_inliers[1:]) > min_inliers
    # The step alone, from the chain's carry: one replay of the same program
    # in a K = 1 shape.
    (carry, init), _ = want
    one = _samplers(99, 1, device)
    step = odo.frontend_step(il[0], ir[0], carry, init, one[0], rig, md, FE, RC, rectified)
    again = odo.frontend_step_program(il[0], ir[0], carry, init, _samplers(99, 1, device)[0],
                                      rig, md, FE, RC, cache=cache)
    assert _equal(again, step)


def test_frontend_step_and_chain_programs_equal_eager(device, cache, frames):
    scene, il, ir = frames
    _step_and_chain_equal_eager(device, cache, _rig(scene, device), il, ir, 20)


def test_general_frontend_step_and_chain_programs_equal_eager(device, cache, general_frames):
    """The distorted rig through the same program: the undistort and the
    batched DLT (on the card the sync-free kernel) inside the step."""
    scene, il, ir = general_frames
    rig = scene.make_rig(device)
    assert not rig.rectified
    _step_and_chain_equal_eager(device, cache, rig, il, ir, 10)
    key = next(iter(cache._programs))
    assert False in key   # the rig's path is part of the program's key


def _chain_bow_equal_eager(device, cache, rig, il, ir):
    il, ir = torch.as_tensor(il, device=device), torch.as_tensor(ir, device=device)
    gen = torch.Generator().manual_seed(3)
    centroids = torch.randint(-2 ** 31, 2 ** 31 - 1, (64, 8), generator=gen,
                              dtype=torch.int32).to(device)
    idf = (torch.rand(64, generator=gen) + 0.5).to(device)
    database = torch.zeros((16, 64), device=device)
    database[:2] = torch.rand((2, 64), generator=gen).to(device)
    database[:2] /= database[:2].sum(1, keepdim=True)

    def run(fn, **kw):
        banks = odo.empty_banks(16, N_FEAT, device)
        return fn(il, ir, odo.empty_slots(N_FEAT, device), False, _samplers(5, FRAMES, device),
                  rig, rig.max_sensible_distance(), FE, RC, *(() if kw else (rig.rectified,)),
                  None, centroids, idf, database, torch.tensor(2, device=device), 3, banks,
                  **kw)

    want = run(odo.frontend_chain_bow)
    got = run(odo.frontend_chain_bow_program, cache=cache)
    assert _equal(got, want)
    assert int(want[5]) == 2 + FRAMES and int(want[2][-1, 0]) >= 0
    assert got[4] is not database   # a new database, as the eager function returns


def test_frontend_chain_bow_program_equals_eager(device, cache, frames):
    scene, il, ir = frames
    _chain_bow_equal_eager(device, cache, _rig(scene, device), il, ir)


def test_general_frontend_chain_bow_program_equals_eager(device, cache, general_frames):
    scene, il, ir = general_frames
    _chain_bow_equal_eager(device, cache, scene.make_rig(device), il, ir)


def _multi_sequence_equal_eager(device, cache, rigs, il, ir):
    rig = multi_seq.stack_rigs(rigs)
    md = torch.stack([r.max_sensible_distance() for r in rigs])
    imgs_l = torch.as_tensor(il[:2], device=device)
    imgs_r = torch.as_tensor(ir[:2], device=device)
    prev = multi_seq.batch_slots([odo.empty_slots(N_FEAT, device)] * 2)
    usable = torch.tensor([False, False], device=device)
    step = multi_seq.batched_frontend_step(FE, RC, rig.rectified)
    for frame in range(2):
        want = step(imgs_l, imgs_r, prev, usable, _samplers(20 + frame, 2, device), rig, md,
                    None)
        got = odo.batched_frontend_step_program(imgs_l, imgs_r, prev, usable,
                                                _samplers(20 + frame, 2, device), rig, md,
                                                FE, RC, cache=cache)
        assert _equal(got, want)
        prev, usable = want.slots, torch.tensor([True, True], device=device)
        imgs_l, imgs_r = torch.as_tensor(il[2:4], device=device), torch.as_tensor(
            ir[2:4], device=device)
    assert cache.builds == 1 and cache.hits == 1


def test_multi_sequence_step_program_equals_eager(device, cache, frames):
    scene, il, ir = frames
    rigs = [_rig(scene, device), _rig(PlaneScene(np.random.default_rng(11), fx=210.0), device)]
    _multi_sequence_equal_eager(device, cache, rigs, il, ir)


def test_general_multi_sequence_step_program_equals_eager(device, cache, general_frames):
    """Two distorted rigs stacked (their own intrinsics and baselines): the
    DLT takes each sequence's projections by its batch index."""
    scene, il, ir = general_frames
    other = DistortedPlaneScene(np.random.default_rng(11), fx=210.0, baseline=0.35, k1=-0.1)
    _multi_sequence_equal_eager(device, cache, [scene.make_rig(device),
                                                other.make_rig(device)], il, ir)


def test_multi_sequence_slam_runs_the_program_on_distorted_rigs(monkeypatch, general_frames):
    """MultiSequenceSLAM steps stacked distorted rigs through the captured
    step, as it steps rectified ones."""
    scene, il, ir = general_frames
    calls = []
    real = odo.batched_frontend_step_program
    monkeypatch.setattr(odo, "batched_frontend_step_program",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    multi = multi_seq.MultiSequenceSLAM([scene.make_rig("cpu")] * 2, FE, RC)
    for i in range(2):
        poses = multi.process(np.stack([il[i]] * 2), np.stack([ir[i]] * 2))
        assert np.isfinite(np.stack(poses)).all()
    assert calls == [1, 1]


def test_captured_front_end_needs_keyed_samplers(cache, frames):
    scene, il, ir = frames
    rig = _rig(scene, "cpu")
    with pytest.raises(TypeError, match="KeyedSampler"):
        odo.frontend_step_program(torch.as_tensor(il[0]), torch.as_tensor(ir[0]),
                                  odo.empty_slots(N_FEAT, "cpu"), False,
                                  lambda valid: torch.zeros((K_HYP, 3), dtype=torch.long), rig,
                                  rig.max_sensible_distance(), FE, RC, cache=cache)


def test_keyed_sampler_draws_what_the_gumbel_sampler_drew():
    """The split into keys and selection keeps the sampler's draws: the
    Gumbel top-3 of the same generator state."""
    valid = torch.rand(300, generator=torch.Generator().manual_seed(0)) > 0.3
    smp = ransac.gumbel_sampler(torch.Generator().manual_seed(4), K_HYP)
    u = torch.rand((K_HYP, 300), generator=torch.Generator().manual_seed(4))
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    want = torch.sort(torch.where(valid[None], g, -torch.inf), dim=1, descending=True,
                      stable=True).indices[:, :3]
    assert torch.equal(smp(valid), want)


# -- the cache and the counters ----------------------------------------------

class _Unit(programs.Program):
    def __init__(self, x):
        super().__init__(x.device)
        self.x = torch.zeros_like(x)
        self.released = False

    def release(self):
        self.released = True
        super().release()


def test_cache_keys_on_shape_dtype_device_and_config():
    a = torch.zeros(3, 2)
    base = programs.tensor_key(a)
    assert programs.tensor_key(torch.zeros(3, 2)) == base
    assert programs.tensor_key(torch.zeros(2, 3)) != base
    assert programs.tensor_key(torch.zeros(3, 2, dtype=torch.float64)) != base
    assert programs.tensor_key(torch.zeros(3, 2, device="meta")) != base
    prob = _pose_graph("cpu")
    k = pg.GNProgram.key(prob, PoseGraphConfig())
    assert pg.GNProgram.key(_pose_graph("cpu"), PoseGraphConfig()) == k
    assert pg.GNProgram.key(prob, PoseGraphConfig(cg_iterations=50)) != k
    assert pg.GNProgram.key(_pose_graph("cpu", n=41), PoseGraphConfig()) != k


def test_cache_gives_back_one_program_per_key_and_evicts_when_full():
    cache = programs.ProgramCache(capacity=2)
    units = {k: cache.get(k, lambda: _Unit(torch.zeros(1))) for k in ("a", "b")}
    assert cache.get("a", lambda: pytest.fail("built again")) is units["a"]
    c = cache.get("c", lambda: _Unit(torch.zeros(1)))   # evicts b, the least recently used
    assert units["b"].released and not units["a"].released
    assert "b" not in cache and "a" in cache and "c" in cache and len(cache) == 2
    assert (cache.builds, cache.hits) == (3, 1)
    cache.clear()
    assert units["a"].released and c.released and len(cache) == 0
    with pytest.raises(ValueError):
        programs.ProgramCache(capacity=0)


def test_cache_counts_the_programs_built_again_after_eviction():
    """A key built again after its program was evicted is a rebuild (its
    bodies are captured again); a new key and a found key are not; the
    default capacity holds 64 programs."""
    cache = programs.ProgramCache(capacity=2)
    for key in ("a", "b", "c", "a", "a", "d", "b"):
        cache.get(key, lambda: _Unit(torch.zeros(1)))
    assert (cache.builds, cache.hits, cache.rebuilds) == (6, 1, 2)
    assert cache.summary()["rebuilds"] == 2
    cache.clear()
    assert programs.ProgramCache().capacity == 64


class _FakeGraph:
    """A graph's replay: the device work of the body, with none of its
    Python side effects."""

    def __init__(self, work):
        self.work = work

    def replay(self):
        self.work()

    def reset(self):
        pass


class _Captured(_Unit):
    """A Program that captures on the CPU with fake graphs, to test the
    capture and replay bookkeeping that only the card reaches."""

    fail_capture = False

    @property
    def captures(self):
        return True

    def _warm_up(self, body):
        body()

    def _record(self, body):
        body()   # a capture runs the Python, launches nothing
        if self.fail_capture:
            raise RuntimeError("operation not permitted when stream is capturing")
        return _FakeGraph(lambda: self.x.add_(1))

    def body(self):
        hamming.LAUNCHES += 2   # a wrapper's counter: two kernel launches
        self.x.add_(1)


def test_replays_count_the_launches_their_capture_took_back(monkeypatch):
    monkeypatch.setattr(hamming, "LAUNCHES", 0)
    unit = _Captured(torch.zeros(1))
    unit.stats = {}
    for _ in range(5):
        unit.run("body", unit.body)
    assert hamming.LAUNCHES == 10          # 2 per call: the warm-up and 4 replays
    # The warm-up, the fake capture's own run of the body, 4 replays.
    assert int(unit.x) == 1 + 1 + 4
    stat = unit.stats["_Captured.body"]
    assert (stat["captures"], stat["replays"]) == (1, 4) and stat["capture_ms"] >= 0


def test_cache_sums_the_capture_ms_of_its_programs(monkeypatch):
    monkeypatch.setattr(hamming, "LAUNCHES", 0)
    cache = programs.ProgramCache()
    unit = cache.get("u", lambda: _Captured(torch.zeros(1)))
    assert cache.capture_ms == 0.0
    unit.run("body", unit.body)            # the capture
    captured = cache.capture_ms
    assert captured == unit.stats["_Captured.body"]["capture_ms"] > 0.0
    unit.run("body", unit.body)            # a replay captures nothing
    assert cache.capture_ms == captured


def test_a_failed_capture_raises_and_keeps_no_graph(monkeypatch):
    monkeypatch.setattr(hamming, "LAUNCHES", 0)
    unit = _Captured(torch.zeros(1))
    unit.fail_capture = True
    with pytest.raises(RuntimeError, match="capturing"):
        unit.run("body", unit.body)
    assert unit._graphs == {} and hamming.LAUNCHES == 2   # the warm-up's launches only

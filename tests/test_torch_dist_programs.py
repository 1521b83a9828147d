"""The distributed solves as captured programs (parallel/dist_ba.py,
parallel/dist_pose_graph.py), as the JAX package compiles each sharded
solve into one program with `jax.jit(shard_map(...))`.

- With no process group (one process), every entry point runs through its
  program (`LMProgram`, `LMStepProgram`, `GNProgram`) and equals its eager
  body BIT FOR BIT: the point-aligned solve (matrix-free and `dense_K`),
  the "obs" solve, `sharded_lm_step`, `sharded_lm_step_point_aligned`,
  the pose-graph solve and its GN step (tests/dist_program_workers.py's
  `cases`). On the CPU a program runs its bodies as they are, so any
  difference is a stale or aliased static tensor.
- With no group, `DistributedBundleAdjuster` (point-aligned, through its
  program) against the JAX package's on a one-device CPU mesh, within
  tests/test_torch_dist_ba.py's bounds.
- At 2 gloo ranks: `mesh.capturable` is True for no group and False for
  gloo; `all_reduce_many` equals one all_reduce per tensor bit for bit
  (a + b commutes) and counts as one call of the buffer's bytes; the
  entry points run their eager bodies (no program built) and the programs
  themselves with the gloo group, run on the CPU, equal those bodies bit
  for bit with the same collectives; a replay adds the collectives its
  capture took back. The counts, each beside the one before the build's
  sums were combined:
    - a BA build: 1 all_reduce on either layout (was 3 on "obs": camera
      blocks, point blocks, cost; 2 point-aligned: camera blocks, cost);
    - a Gauss-Newton step: 1 + cg_iterations (was 3 + cg_iterations:
      gradient, block diagonal, cost, one per CG matvec);
    - an LM step: 4 on the point-aligned dense path (was 5), 4 + 2
      cg_iterations on "obs" (was 6 + 2 cg_iterations);
  and a program on the card refuses a gloo group.
- `cuda` (skips without a card): at 1 NCCL rank in this process, each
  entry point's captured program equals its eager body with the group
  and the no-group program bit for bit (a one-rank sum is the identity),
  with the same collective counts on its capture and on its replay:

    python -m pytest -q --noconftest -m cuda tests/test_torch_dist_programs.py

Only the JAX comparison imports JAX (inside its test), so the card case
runs where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_program_workers as dpw  # noqa: E402
import dist_workers  # noqa: E402

from stereo_orb_slam_torch.apps.scaling_bench import make_problem  # noqa: E402
from stereo_orb_slam_torch.backend import ba  # noqa: E402
from stereo_orb_slam_torch.parallel import dist_ba, multihost  # noqa: E402
from stereo_orb_slam_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from stereo_orb_slam_torch.utils import programs  # noqa: E402

torch.set_num_threads(1)
NAMES = ("point_aligned", "point_aligned_dense", "obs", "lm_step", "lm_step_point_aligned",
         "pose_graph", "gn_step")
C = 12   # cameras of the BA problems


def _problems(n_ranks):
    """The "obs" problem (arrays), the point-aligned host problem for
    `n_ranks`, its meta and dense_K, and a pose graph (poses, edge ends,
    measurements): a chain of 24 vertices with two loop edges."""
    prob = make_problem(C=C, P=256, obs_per_cam=48, device="cpu")
    ba_np = ba.BAProblem(*(x.numpy() for x in prob))
    order = np.argsort(ba_np.obs_point, kind="stable")
    host, meta = dist_ba.build_point_aligned(
        ba_np.pose6, ba_np.points, ba_np.obs_cam[order], ba_np.obs_point[order],
        ba_np.obs_uv[order], ba_np.cam_mask, ba_np.P_l, ba_np.P_r, n_ranks)
    kmax = int(np.bincount(ba_np.obs_point).max())
    dense_K = 1 << (kmax - 1).bit_length()

    rng = np.random.default_rng(3)
    n = 24
    truth = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    truth[:, 0, 3] = 0.5 * np.arange(n)
    truth[:, 1, 3] = 0.2 * np.sin(np.arange(n) / 3.0)
    ea = np.array(list(range(n - 1)) + [0, 4])
    eb = np.array(list(range(1, n)) + [n - 1, 18])
    meas = np.stack([np.linalg.inv(truth[a]) @ truth[b] for a, b in zip(ea, eb)])
    poses = truth.copy()
    poses[1:, :3, 3] += rng.normal(0, 0.05, (n - 1, 3)).astype(np.float32)
    return ba_np, host, meta, dense_K, (poses, ea, eb, meas.astype(np.float32))


def _equal(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)
                                    for x, y in zip(a, b))


PROGRAM_OF = {"point_aligned": "LMProgram", "point_aligned_dense": "LMProgram",
              "obs": "LMProgram", "lm_step": "LMStepProgram",
              "lm_step_point_aligned": "LMStepProgram", "pose_graph": "GNProgram",
              "gn_step": "GNProgram"}


@pytest.mark.parametrize("name", NAMES)
def test_no_group_entry_point_equals_its_eager_body_through_its_program(monkeypatch, name):
    cache = programs.ProgramCache()
    monkeypatch.setattr(programs, "PROGRAMS", cache)
    entry, body = dpw.cases(Mesh(None, 0, 1, torch.device("cpu")), *_problems(1))[name]
    got, counted = dpw.run(entry)
    want, _ = dpw.run(body)
    assert cache.builds == 1, f"{name} did not run through a program"
    assert [type(p).__name__ for p in cache._programs.values()] == [PROGRAM_OF[name]]
    assert _equal(got, want)
    assert counted == (0, 0, [])   # no group: no collective
    again, _ = dpw.run(entry)      # the program found again, for the same problem
    assert cache.hits == 1 and _equal(again, want)


def test_no_group_point_aligned_program_against_jax_one_device_mesh(monkeypatch):
    jax = pytest.importorskip("jax")
    from test_torch_ba import port_world
    from test_torch_dist_ba import ITERS, _assert_close, perturbed, rig_np

    from stereo_orb_slam_tpu.config import BAConfig as JBA
    from stereo_orb_slam_tpu.parallel import dist_ba as jdist
    from stereo_orb_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from stereo_orb_slam_torch import convert
    from stereo_orb_slam_torch.config import BAConfig

    monkeypatch.setattr(programs, "PROGRAMS", programs.ProgramCache())
    world, rig = perturbed()
    w = port_world(world)
    stats = dist_ba.DistributedBundleAdjuster(
        w, convert.rig_from_numpy(rig_np(rig), "cpu"), Mesh(None, 0, 1, torch.device("cpu")),
        BAConfig(max_iterations=ITERS)).optimize(0, w.num_frames)
    assert stats["program_built"] and not stats["captured"]   # the CPU runs the bodies
    assert stats["iterations"] == ITERS and stats["scheme"] == "point_aligned"
    w_ref = port_world(world)
    ref = jdist.DistributedBundleAdjuster(w_ref, rig, jmake_mesh(1, devices=jax.devices()[:1]),
                                          JBA(max_iterations=ITERS)).optimize(0, w.num_frames)
    _assert_close("point_aligned program vs JAX x1",
                  (stats, w.pose_global[:w.num_frames], w.points[:w.num_points]),
                  (ref, w_ref.pose_global[:w.num_frames], w_ref.points[:w.num_points]))


@pytest.fixture(scope="module")
def two_gloo_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks running dist_program_workers.two_ranks."""
    store = "file://" + str(tmp_path_factory.mktemp("two_ranks") / "store")
    return dist_workers.spawn(dpw.two_ranks, 2, store, *_problems(2))


def test_capturable_is_true_without_a_group_and_false_for_gloo(two_gloo_ranks):
    assert all(out["capturable"] == (True, False) for out in two_gloo_ranks)


def test_all_reduce_many_equals_one_all_reduce_per_tensor_at_two_ranks(two_gloo_ranks):
    for out in two_gloo_ranks:
        separate, combined, (count, nbytes, shapes) = out["many"]
        assert _equal(combined, separate)
        assert [a.shape for a in combined] == [(5, 7), (3,), ()]
        assert (count, nbytes, shapes) == (1, 4 * (35 + 3 + 1), [(39,)])


def test_a_build_makes_one_all_reduce_and_a_gn_step_one_plus_cg(two_gloo_ranks):
    for out in two_gloo_ranks:
        # A build: 1 all_reduce (was 3 on "obs", 2 point-aligned).
        assert out["build_obs"][0] == 1 and out["build_obs"][2] == [(C * 42 + 256 * 12 + 1,)]
        assert out["build_point_aligned"][0] == 1
        assert out["build_point_aligned"][2] == [(C * 42 + 1,)]
        entries = out["entries"]
        # A Gauss-Newton step: 1 + cg_iterations (was 3 + cg_iterations).
        assert entries["gn_step"][1][1][0] == 1 + dpw.CG
        assert entries["pose_graph"][1][1][0] == dpw.PG_ITERS * (1 + dpw.CG)
        # A point-aligned LM step on the dense path: 4 (was 5).
        assert entries["lm_step_point_aligned"][1][1][0] == 4
        # An "obs" LM step: 4 + 2 cg_iterations (was 6 + 2 cg_iterations:
        # the build's 3, rhs, a point and a camera sum per CG matvec, the
        # back-substitution's point sum, the trial cost).
        assert entries["lm_step"][1][1][0] == 4 + 2 * dpw.CG


def test_gloo_entry_points_build_no_program(two_gloo_ranks):
    for out in two_gloo_ranks:
        assert out["entry_programs"] == 0   # chosen by the backend: no program
        assert out["program_groups"] and out["left_after_release"] == 0


@pytest.mark.parametrize("name", NAMES)
def test_gloo_entry_point_runs_eagerly_and_its_program_equals_it(two_gloo_ranks, name):
    for out in two_gloo_ranks:
        (got, counted), (want, want_counted) = out["entries"][name]
        assert _equal(got, want) and counted == want_counted
        prog, prog_counted = out["programs"][name]
        assert _equal(prog, want)
        assert prog_counted == want_counted and want_counted[0] > 0
    # Every replica holds the same cameras (poses).
    assert _equal(two_gloo_ranks[0]["programs"][name][0][:1],
                  two_gloo_ranks[1]["programs"][name][0][:1])


def test_replays_add_the_collectives_their_capture_took_back(two_gloo_ranks):
    for out in two_gloo_ranks:
        # The warm-up's call, the capture's taken back, 3 replays.
        assert out["replayed"] == (4, [(6,)] * 4)
        assert out["card_program_refuses_gloo"]


def test_release_groups_drops_only_the_programs_of_a_group():
    class Group:
        pass

    cache = programs.ProgramCache()
    cache.get("alone", lambda: programs.Program("cpu"))
    cache.get("grouped", lambda: programs.Program("cpu", group=Group()))
    cache.release_groups()
    assert "alone" in cache and "grouped" not in cache and len(cache) == 1


@pytest.mark.cuda
def test_nccl_one_rank_programs_equal_eager_and_no_group(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and graph capture run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    problems = _problems(1)
    cache = programs.ProgramCache()
    saved, programs.PROGRAMS = programs.PROGRAMS, cache
    multihost.initialize(init_method="file://" + str(tmp_path / "store"), num_processes=1,
                         process_id=0, backend="nccl")
    try:
        mesh = make_mesh(device=dev)
        alone = dpw.cases(Mesh(None, 0, 1, dev), *problems)
        for name, (entry, body) in dpw.cases(mesh, *problems).items():
            eager, eager_counted = dpw.run(body)
            first, first_counted = dpw.run(entry)     # the warm-up and the capture
            replay, replay_counted = dpw.run(entry)   # a replay
            no_group, _ = dpw.run(alone[name][0])
            assert _equal(first, eager) and _equal(replay, eager), name
            assert _equal(replay, no_group), name
            assert first_counted == eager_counted == replay_counted, name
            assert eager_counted[0] > 0, name
    finally:
        programs.PROGRAMS = saved
        multihost.shutdown()
    # shutdown released the group's programs; the no-group ones stay.
    assert len(cache) == 6 and all(p.group is None for p in cache._programs.values())

"""The port's process groups and collectives: the counterparts of
tests/test_multihost.py and tests/test_scaling.py.

- Two spawned gloo ranks join through `multihost.initialize` (as
  `multihost.launch` starts them), report rank, count and devices, agree
  on `is_primary`, and sum with the port's counted `all_reduce`; a group
  of one joins from torchrun's environment variables in this process.
- Observation shards are balanced 1/N at 2 and 8 ranks (host only, no
  spawn): replicated state stays camera- and point-sized.
- 1 rank against 2: the observation-sharded LM step equals the
  single-process step within tests/test_scaling.py's bounds (c0 rtol
  1e-5, c1 rtol 2e-3, pose6 atol 2e-3: the float32 sums run in another
  order and the CG amplifies it).
- The point-aligned LM step all-reduces only camera-sized tensors
  ([C, ...] rows, the [6, C, 6, C] dense system, the scalar cost, and the
  build's camera blocks and cost in one flat [C * 42 + 1] sum), counted
  through `parallel.mesh.recording`: 4 per step on the dense path (JAX's
  test allows 6), 3 + cg_iterations matrix-free (JAX:
  tests/test_scaling.py:71-93 reads them off the compiled program).

- `apps.refine --distributed` on 2 ranks (gloo, CPU) against the same
  command as a group of one: the same iterations, final cost within rtol
  1e-3 / atol 1e-4 and poses within 5e-3 (tests/test_dist_ba.py's
  bounds), the refined dump written by rank 0 only.

JAX-free; the ranks run tests/dist_workers.py with a join timeout.
"""

import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_workers  # noqa: E402
from dist_workers import file_store  # noqa: E402,F401 (fixture)

from stereo_orb_slam_torch.apps import refine  # noqa: E402
from stereo_orb_slam_torch.apps.scaling_bench import make_problem  # noqa: E402
from stereo_orb_slam_torch.backend import ba  # noqa: E402
from stereo_orb_slam_torch.config import BAConfig  # noqa: E402
from stereo_orb_slam_torch.io import export  # noqa: E402
from stereo_orb_slam_torch.parallel import dist_ba, multihost  # noqa: E402
from stereo_orb_slam_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402

from test_torch_ba_oracles import _write_calib, perturb, synth_ba_world  # noqa: E402

torch.set_num_threads(1)


def _numpy_problem(prob):
    return ba.BAProblem(*(x.numpy() for x in prob))


def test_two_process_initialize_and_all_reduce(file_store):
    infos = dist_workers.spawn(dist_workers.group_info, 2, file_store)
    for rank, info in enumerate(infos):
        assert info["process_index"] == rank
        assert info["process_count"] == info["global_devices"] == 2
        assert info["local_devices"] == 1 and info["backend"] == "gloo"
        assert info["primary"] == (rank == 0)
        assert info["sum"] == [3.0, 3.0, 3.0] and info["counted"] == 1
        assert info["mesh"] == (rank, 2)


def test_initialize_from_the_torchrun_environment(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        info = multihost.initialize(backend="gloo")
        assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                        "global_devices": 1, "backend": "gloo"}
        assert multihost.is_primary()
        assert make_mesh(device="cpu").size == 1
    finally:
        multihost.shutdown()
    for k in env:
        monkeypatch.delenv(k)
    assert multihost.initialize()["process_count"] == 1   # no group: one process
    assert os.environ.get("WORLD_SIZE") is None


@pytest.mark.parametrize("n_ranks", [2, 8])
def test_obs_shards_balanced(n_ranks):
    prob = make_problem(C=16, P=512, obs_per_cam=64, device="cpu")
    O = prob.obs_uv.shape[0]
    shards = [dist_ba.shard_problem(Mesh(None, r, n_ranks, torch.device("cpu")), prob)
              for r in range(n_ranks)]
    assert {s.obs_uv.shape[0] for s in shards} == {O // n_ranks}
    # The shards tile the observations in order.
    np.testing.assert_array_equal(torch.cat([s.obs_uv for s in shards]).numpy(),
                                  prob.obs_uv.numpy())
    # Replicated state (the collective payload) is O(C + P), not O(O).
    assert all(s.pose6.shape[0] == 16 and s.points.shape[0] == 512 for s in shards)


def test_one_and_two_ranks_agree_and_collectives_are_camera_sized(file_store):
    C, cg = 12, 10
    prob = make_problem(C=C, P=256, obs_per_cam=48, device="cpu")
    cfg = BAConfig(cg_iterations=cg)
    p1, _, _, c0_1, c1_1 = ba.lm_step(prob, torch.tensor(1e-4), cfg)

    pa = make_problem(C=40, P=2000, obs_per_cam=100, device="cpu")
    order = np.argsort(pa.obs_point.numpy(), kind="stable")
    host, meta = dist_ba.build_point_aligned(
        pa.pose6.numpy(), pa.points.numpy(), pa.obs_cam.numpy()[order],
        pa.obs_point.numpy()[order], pa.obs_uv.numpy()[order], pa.cam_mask.numpy(),
        pa.P_l.numpy(), pa.P_r.numpy(), 2)
    kmax = int(np.bincount(pa.obs_point.numpy()).max())
    dense_K = 1 << (kmax - 1).bit_length()
    outs = dist_workers.spawn(dist_workers.lm_steps, 2, file_store, _numpy_problem(prob),
                              host, meta, dense_K, cg)

    pose6_2, _, c0_2, c1_2 = outs[0]["obs"]
    np.testing.assert_allclose(c0_2, float(c0_1), rtol=1e-5)
    np.testing.assert_allclose(c1_2, float(c1_1), rtol=2e-3)
    np.testing.assert_allclose(pose6_2, p1.pose6.numpy(), atol=2e-3)
    for name in ("obs", "matrix_free", "dense"):   # both ranks hold the same state
        np.testing.assert_array_equal(outs[0][name][0], outs[1][name][0])

    # Per step: the build's camera blocks and cost in one flat sum
    # ([C * 42 + 1]), rhs, one [C, 6] sum per CG iteration (matrix-free) or
    # S (dense), the trial cost.
    flat = (40 * 42 + 1,)
    for name, count in (("matrix_free", 3 + cg), ("dense", 4)):
        shapes = outs[0][name][3]
        assert len(shapes) == count, (name, shapes)
        for shape in shapes:
            assert shape in ((), flat, (6, 40, 6, 40)) or shape[0] == 40, (name, shapes)
    # The dense step's reductions: camera blocks with the cost, rhs, S, trial cost.
    assert sorted(outs[0]["dense"][3]) == sorted([(), flat, (40, 6), (6, 40, 6, 40)])


def test_refine_distributed_on_two_ranks(tmp_path, file_store):
    rng = np.random.default_rng(4)
    world, rig, _, _ = synth_ba_world(rng, n_frames=6, n_points=200)
    perturb(world, rng)
    dump, calib = str(tmp_path / "dump"), str(tmp_path / "calib.txt")
    export.dump_world(dump, world)
    _write_calib(calib, rig)

    def argv(out):
        return ["--input_dir", dump, "--camera", calib, "--output_dir", str(tmp_path / out),
                "--iterations", "10", "--device", "cpu", "--distributed", "--backend", "gloo"]

    one = refine.main(argv("one"))
    outs = dist_workers.spawn(dist_workers.refine_rank, 2, file_store, argv("two"))
    (stats, poses), (_, poses_1) = outs
    assert stats["num_devices"] == 2 and one["num_devices"] == 1
    assert stats["iterations"] == one["iterations"] == 10
    assert np.isclose(stats["cost_final"], one["cost_final"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(poses, one["world"].pose_global[:6], atol=5e-3)
    np.testing.assert_array_equal(poses, poses_1)
    refined = export.read_poses_txt(str(tmp_path / "two" / "poses.txt"))
    np.testing.assert_allclose(refined, poses, atol=1e-5)

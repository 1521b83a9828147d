"""The port's distributed pose graph (`parallel/dist_pose_graph.py`) on 2
and 4 gloo ranks, against the port's single-process `pg_solve` and the
JAX package's `dist_pose_graph.solve` on its virtual CPU mesh.

The graph is tests/test_dist_pose_graph.py's: the square loop of
tests/test_pose_graph.py with 0.02 drift and a loop edge back to frame 0
(21 vertices, 21 edges, padded to the ranks with zero-weight edges). Its
edge residuals stay out of the band where the JAX package's se3_log is
NaN (1e-4 to 3.4e-4 rad, ROADMAP queue 3): the reference's own
distributed test runs on it. Tolerances:
- one Gauss-Newton step: rotations within 1e-5, translations within 1e-4
  m against both (tests/test_torch_pose_graph.py's one-step bounds); costs
  within rtol 1e-5;
- ten steps: within 2e-3 (tests/test_dist_pose_graph.py's bound) of both,
  and each within 1e-4 rad / 2e-3 m of the port's float64 solve (past the
  first step the graph is solved to float32 noise and the summation order
  decides the last digits); the cost must fall.
Every rank returns the same poses, and `sharded_gn_step` on the padded
graph gives the one-step solve's poses and cost bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_workers  # noqa: E402
from dist_workers import file_store  # noqa: E402,F401 (fixture)
from test_pose_graph import square_loop_world  # noqa: E402

from stereo_orb_slam_tpu.config import PoseGraphConfig as JPGConfig  # noqa: E402
from stereo_orb_slam_tpu.parallel import dist_pose_graph as jdpg  # noqa: E402
from stereo_orb_slam_tpu.parallel.mesh import make_mesh  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.backend import pose_graph as tpg  # noqa: E402
from stereo_orb_slam_torch.config import PoseGraphConfig  # noqa: E402

torch.set_num_threads(1)
STEPS = (1, 10)


def _graph():
    world, gt = square_loop_world(drift=0.02)
    n = world.num_frames
    Z = (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32)
    ea = np.array(list(range(n - 1)) + [n - 1])
    eb = np.array(list(range(1, n)) + [0])
    meas = np.stack([world.pose_rel[i] for i in range(1, n)] + [Z]).astype(np.float32)
    return world.pose_global[:n].copy(), ea, eb, meas


def _single(poses, ea, eb, meas, iterations, dtype=torch.float32):
    vm = np.ones(len(poses), np.float32)
    vm[0] = 0.0
    prob = convert.pose_graph_problem_from_numpy(
        {"poses": poses, "edge_a": ea, "edge_b": eb, "edge_meas": meas,
         "edge_weight": np.ones(len(ea), np.float32), "vertex_mask": vm}, "cpu")
    prob = prob._replace(poses=prob.poses.to(dtype), edge_meas=prob.edge_meas.to(dtype),
                         edge_weight=prob.edge_weight.to(dtype),
                         vertex_mask=prob.vertex_mask.to(dtype))
    out, c0, c1 = tpg.pg_solve(prob, PoseGraphConfig(iterations=iterations))
    return out.poses.double().numpy(), [float(c0), float(c1)]


def _gaps(P, R):
    return (float(np.abs(P[:, :3, :3] - R[:, :3, :3]).max()),
            float(np.abs(P[:, :3, 3] - R[:, :3, 3]).max()))


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dist_pose_graph_matches_single_and_reference(file_store, n_ranks):
    poses, ea, eb, meas = _graph()
    outs = dist_workers.spawn(dist_workers.pose_graph_solves, n_ranks, file_store, poses, ea,
                              eb, meas, STEPS)
    for other in outs[1:]:
        for (p_other, _), (p0, _) in zip(other[0], outs[0][0]):
            np.testing.assert_array_equal(p_other, p0)
    (one_step, one_costs), (stepped, step_cost) = outs[0][0][0], outs[0][1]
    np.testing.assert_array_equal(stepped, one_step)
    assert step_cost == one_costs[0]
    mesh = make_mesh(n_ranks, devices=jax.devices()[:n_ranks])
    p64, _ = _single(poses, ea, eb, meas, STEPS[1], torch.float64)
    for iterations, (got, costs) in zip(STEPS, outs[0][0]):
        got = got.astype(np.float64)
        single, single_costs = _single(poses, ea, eb, meas, iterations)
        ref, ref_costs = jdpg.solve(jnp.asarray(poses), ea, eb, meas, mesh,
                                    JPGConfig(iterations=iterations))
        ref = np.asarray(ref, np.float64)
        g_single, g_ref = _gaps(got, single), _gaps(got, ref)
        print(f"x{n_ranks}, {iterations} steps: vs single rot/trans {g_single}, "
              f"vs JAX x{n_ranks} {g_ref}")
        assert np.isfinite(got).all() and costs[1] <= costs[0]
        if iterations == 1:
            for rot, trans in (g_single, g_ref):
                assert rot <= 1e-5 and trans <= 1e-4, (rot, trans)
            np.testing.assert_allclose(costs, single_costs, rtol=1e-5)
            np.testing.assert_allclose(costs, ref_costs, rtol=1e-5)
        else:
            np.testing.assert_allclose(got, single, atol=2e-3)
            np.testing.assert_allclose(got, ref, atol=2e-3)
            for P in (got, ref):
                rot, trans = _gaps(P, p64)
                assert rot <= 1e-4 and trans <= 2e-3, (rot, trans)

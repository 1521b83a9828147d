"""The loop-edge batch as a captured program per bucket
(`apps/slam.py::EdgeProgram`, `measure_edges_program`), against the eager
`measure_edges` it runs, on the rectified and the general rig.

A batch of E edges runs padded to its bucket E_pad (the next power of
two, at least 2), as the JAX package compiles one program per bucket.
Padding must change nothing: every real edge's transform, idx, inlier
mask, success and inlier count equal those of `measure_edges` at the exact
E BIT FOR BIT, at E = 1, 3, 5 and 8, and every padded row reports
success False. The worlds are 16 frames out and back over tests/synth.py's
`PlaneScene` and tests/synth_distorted.py's `DistortedPlaneScene` (256
features, 32 hypotheses), edges (i, 15 - i) and their neighbours.

Also: the matcher runs the program for keyed samplers and the eager body
for any other (the same bits either way); it counts one batch per call and
reads the rings it is handed on each call, so rings replaced between two
batches of one bucket are read afresh; the CUDA cases (marker `cuda`,
skipped without a card) repeat everything with real graphs and check the
kernel launches: one `hamming_top2` per batch, two `triangulate_dlt` per
batch on the general rig:

    python -m pytest -q --noconftest -m cuda tests/test_torch_loop_program.py

This file imports neither JAX nor the JAX package.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import PlaneScene  # noqa: E402
from synth_distorted import DistortedPlaneScene  # noqa: E402

from stereo_orb_slam_torch.apps import slam  # noqa: E402
from stereo_orb_slam_torch.config import FrontendConfig, RansacConfig, SlamConfig  # noqa: E402
from stereo_orb_slam_torch.frontend import odometer, ransac  # noqa: E402
from stereo_orb_slam_torch.geometry import camera as cam  # noqa: E402
from stereo_orb_slam_torch.ops.kernels import dlt, hamming  # noqa: E402
from stereo_orb_slam_torch.utils import programs  # noqa: E402

torch.set_num_threads(1)
N_FEAT, K_HYP = 256, 32
CFG = SlamConfig(frontend=FrontendConfig(num_features=N_FEAT),
                 ransac=RansacConfig(num_hypotheses=K_HYP), refine_interval=10 ** 6,
                 per_frame_ba=False)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
# Edges of the out-and-back: the same place seen twice (i, 15 - i), and
# one frame off (i, 14 - i); a batch of E takes the first E.
EDGES = [(0, 15), (1, 14), (2, 13), (3, 12), (0, 14), (1, 13), (2, 12), (4, 11)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured only on the card")
    return torch.device(request.param)


def _rectified_rig(scene, device):
    right = np.eye(4, dtype=np.float32)
    right[0, 3] = scene.baseline
    return cam.StereoRig.create(
        cam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, device=device),
        cam.Pinhole.create(scene.fx, scene.fx, scene.cx, scene.cy, pose=right, device=device),
        True, scene.baseline)


def _world(scene, rig, step):
    system = slam.SlamSystem(rig, CFG, vocab_train_frames=10 ** 9)
    for x in [i * step for i in range(8)] + [(7 - i) * step for i in range(8)]:
        system.process(scene.render(x), scene.render(x, right=True))
    assert system.world.num_frames == 16
    return system.world


@pytest.fixture(scope="module")
def worlds():
    """Each rig's 16-frame world, tracked once on the CPU, and a function
    giving the rig on a device."""
    plane = PlaneScene(np.random.default_rng(0))
    distorted = DistortedPlaneScene(np.random.default_rng(0), depth=11.0)
    return {
        "rectified": (_world(plane, _rectified_rig(plane, "cpu"), 0.2),
                      lambda dev: _rectified_rig(plane, dev)),
        "general": (_world(distorted, distorted.make_rig("cpu"), 4 * 11.0 / distorted.fx),
                    distorted.make_rig),
    }


def _samplers(E, device, seed=5):
    out = []
    for e in range(E):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + e)
        out.append(ransac.gumbel_sampler(gen, K_HYP))
    return out


def _host_banks(world, ids, device):
    return (torch.from_numpy(world.frame_desc[ids].view(np.int32)).to(device),
            torch.from_numpy(world.frame_feat_valid[ids]).to(device),
            torch.from_numpy(world.frame_feat_uv[ids]).to(device))


def _eager(world, rig, edges, samplers):
    """measure_edges at the exact E, on the host: (T, idx, inl, ok, n_inl)."""
    src, dst = ([e[i] for e in edges] for i in (0, 1))
    (d_s, v_s, uv_s), (d_d, v_d, uv_d) = (_host_banks(world, ids, rig.device)
                                          for ids in (src, dst))
    outs = slam.measure_edges(d_s, d_d, v_s, v_d, uv_s, uv_d, samplers, rig, CFG.frontend,
                              CFG.ransac, bool(rig.rectified))
    return tuple(x.cpu().numpy() for x in outs)


def _assert_bits(got, want):
    for name, g, w in zip(("transform", "idx", "inlier_mask", "success", "num_inliers"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("rig_kind", ["rectified", "general"])
@pytest.mark.parametrize("E", [1, 3, 5, 8])
def test_padding_to_the_bucket_leaves_every_real_edge_bit_for_bit(device, worlds, rig_kind,
                                                                   E):
    """E real edges measured at E_pad (the program) against `measure_edges`
    at E, the same keys: the first E rows equal bit for bit, and the
    padded rows of the program's table report success False."""
    world, make_rig = worlds[rig_kind]
    rig = make_rig(device)
    edges = EDGES[:E]
    want = _eager(world, rig, edges, _samplers(E, device))
    cache = programs.ProgramCache()
    try:
        src, dst = [s for s, _ in edges], [d for _, d in edges]
        for _ in range(2):   # a capture, then a replay of the cached program
            got = slam.measure_edges_program(src, dst, _samplers(E, device), rig,
                                             CFG.frontend, CFG.ransac, world=world,
                                             cache=cache)
            _assert_bits(got, want)
        assert any(want[3])
        (prog,) = cache._programs.values()
        E_pad = slam.edge_bucket(E)
        assert prog.packed.shape[0] == E_pad and E_pad >= max(2, E)
        assert not prog.packed[E:, -2].any()   # padded rows: success False
        assert not prog.packed[E:, 16 + N_FEAT:16 + 2 * N_FEAT].any()   # and no inlier
    finally:
        cache.clear()


def test_edge_bucket_is_the_next_power_of_two_from_two():
    assert [slam.edge_bucket(e) for e in (1, 2, 3, 4, 5, 8, 9, 127, 128, 129)] == \
        [2, 2, 4, 4, 8, 8, 16, 128, 128, 256]


@pytest.mark.parametrize("rig_kind", ["rectified", "general"])
def test_matcher_runs_the_program_for_keyed_samplers_and_counts_exactly(device, worlds,
                                                                        rig_kind):
    """Batches of 3, 1 and 5 edges with keyed samplers (buckets 4, 2, 8) and
    the same batches with plain callables that draw the same sets (the
    eager body at E): the same flags, transforms, inlier counts and merges
    bit for bit; `batches` counts each call once; on the card one
    `hamming_top2` launch per batch and, on the general rig, two
    `triangulate_dlt` launches."""
    world, make_rig = worlds[rig_kind]
    rig = make_rig(device)

    def keyed(i):
        gen = torch.Generator(device=device)
        gen.manual_seed(100 + i)
        return ransac.gumbel_sampler(gen, K_HYP)

    def plain(i):
        smp = keyed(i)
        return lambda valid: smp(valid)

    runs = {}
    for name, sampler_for in (("program", keyed), ("eager", plain)):
        w = copy.deepcopy(world)
        m = slam.make_loop_matcher(w, rig, CFG, sampler_for_edge=sampler_for)
        h0, d0 = hamming.LAUNCHES, dlt.LAUNCHES
        res, pads = [], []
        for lo, hi in ((0, 3), (3, 4), (0, 5)):
            res += m.batch(EDGES[lo:hi])
            pads.append(m.last["edges_padded"])
        runs[name] = (res, w.point_parent[: w.num_points].copy(), pads)
        assert m.batches == 3
        if device.type == "cuda":
            assert hamming.LAUNCHES - h0 == 3
            assert dlt.LAUNCHES - d0 == (0 if rig.rectified else 6)
    (got, parent_g, pads_g), (want, parent_w, pads_w) = runs["program"], runs["eager"]
    assert pads_g == [4, 2, 8] and pads_w == [3, 1, 5]
    assert [ok for _, ok in got] == [ok for _, ok in want] and any(ok for _, ok in got)
    for (Zg, _), (Zw, _) in zip(got, want):
        np.testing.assert_array_equal(Zg, Zw)
    np.testing.assert_array_equal(parent_g, parent_w)


def test_matcher_reads_the_rings_it_is_handed_on_each_call(device, worlds):
    """The live loop's rings feed the batch (a gather by frame id outside the
    graph): a batch from the rings equals one from the host mirrors, and
    when the rings are replaced by grown copies (as SlamSystem grows them)
    the next batch of the same bucket reads the new rings, not the old
    storage, whose rows are scrambled first."""
    world, make_rig = worlds["rectified"]
    rig = make_rig(device)
    rings = odometer.empty_banks(20, N_FEAT, device)
    for ring, vals in zip(rings, _host_banks(world, list(range(16)), device)):
        ring[:16] = vals
    current = [rings]
    edges = EDGES[:3]

    def keyed(i):
        gen = torch.Generator(device=device)
        gen.manual_seed(7 + i % 3)   # each batch of 3 draws the same sets
        return ransac.gumbel_sampler(gen, K_HYP)

    host_m = slam.make_loop_matcher(copy.deepcopy(world), rig, CFG, sampler_for_edge=keyed)
    want = host_m.batch(edges)
    ring_m = slam.make_loop_matcher(copy.deepcopy(world), rig, CFG, sampler_for_edge=keyed,
                                    bank_getter=lambda: current[0])
    first = ring_m.batch(edges)
    grown = odometer.empty_banks(40, N_FEAT, device)
    for new, old in zip(grown, rings):
        new[:20] = old[:20]
        old[:16] = old[:16].flip(0)   # the old storage no longer holds these frames
    current[0] = grown
    second = ring_m.batch(edges)
    assert ring_m.last["edges_padded"] == 4
    for res in (first, second):
        assert [ok for _, ok in res] == [ok for _, ok in want] and any(ok for _, ok in res)
        for (Zg, _), (Zw, _) in zip(res, want):
            np.testing.assert_array_equal(Zg, Zw)

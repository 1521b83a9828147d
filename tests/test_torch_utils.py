"""The port's `utils/profiling.py` and `utils/viz.py`, and the VO app's
`--debug_viz`, against the JAX package where it has the same function.

- `StageTimers`: the same summary as the JAX package's for the same stage
  calls, and `reset` zeroes it; a span of the port's tracer names a
  torch.profiler region only while tracing is on.
- `save_frame_debug` (tests/test_viz.py:13 in the port): both packages'
  step results for the same two PlaneScene frames, with the port's RANSAC
  sets injected from the JAX key, write the same file set (`stereo_`,
  `tracking_`, `temporal_` PNGs) at the same image sizes and modes.
- `--debug_viz DIR --debug_viz_every 2` on 5 frames writes the stereo and
  tracking views of frames 0, 2 and 4 and the temporal views of 2 and 4
  (frame 0 has no previous frame), as the JAX app's rule gives.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from synth import PlaneScene  # noqa: E402
from test_torch_vo_app import _write_sequence  # noqa: E402

from stereo_orb_slam_tpu.frontend import ransac as rransac  # noqa: E402
from stereo_orb_slam_tpu.frontend.odometer import (  # noqa: E402
    VisualOdometer as RVO, frontend_step as rstep,
)
from stereo_orb_slam_tpu.utils import profiling as rprof, viz as rviz  # noqa: E402
from stereo_orb_slam_tpu.worldmap import WorldMap as RWorld  # noqa: E402
from stereo_orb_slam_torch import convert  # noqa: E402
from stereo_orb_slam_torch.apps import visual_odometry  # noqa: E402
from stereo_orb_slam_torch.frontend.odometer import VisualOdometer, frontend_step  # noqa: E402
from stereo_orb_slam_torch.utils import profiling, viz  # noqa: E402
from stereo_orb_slam_torch.worldmap import WorldMap  # noqa: E402

torch.set_num_threads(1)


def _drive(timers):
    for name, n in (("vo.track", 3), ("ba.window", 1)):
        for _ in range(n):
            with timers.time(name):
                pass


def test_stage_timers_reset_and_summary_match_reference():
    port, ref = profiling.StageTimers(), rprof.StageTimers()
    _drive(port)
    _drive(ref)
    got, want = port.summary(), ref.summary()
    assert list(got) == list(want) == ["ba.window", "vo.track"]
    for name in want:
        assert got[name]["count"] == want[name]["count"]
        assert set(got[name]) == set(want[name])
    assert port.report().count("\n") == ref.report().count("\n") == 1
    port.reset()
    ref.reset()
    assert port.summary() == ref.summary() == {}
    assert port.report() == ""
    _drive(port)
    assert port.summary()["vo.track"]["count"] == 3


@pytest.mark.parametrize("enabled", [True, False])
def test_trace_names_a_profiler_region_only_when_enabled(enabled):
    from torch.profiler import ProfilerActivity, profile

    tracer = profiling.Tracer()
    tracer.enable(enabled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("vo.frame"):
            torch.ones(8).add_(1.0)
    names = {e.key for e in prof.key_averages()}
    assert ("vo.frame" in names) == enabled
    assert "aten::add_" in names


def _image_set(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with Image.open(os.path.join(folder, name)) as im:
            out[name] = (im.size, im.mode)
    return out


def test_save_frame_debug_matches_reference(tmp_path):
    scene = PlaneScene(np.random.default_rng(0))
    img0 = (scene.render(0.0), scene.render(0.0, right=True))
    img1 = (scene.render(0.2), scene.render(0.2, right=True))
    key = jax.random.key(1)

    ref_vo = RVO(RWorld(), scene.make_rig(), seed=0)
    ref_vo.track(*img0)
    ref_prev = ref_vo.prev
    ref_res = rstep(jnp.asarray(img1[0]), jnp.asarray(img1[1]), ref_prev, jnp.asarray(True),
                    key, ref_vo.rig, jnp.float32(ref_vo.max_distance), ref_vo.fe, ref_vo.rc)

    rig = convert.rig_from_numpy(jax.tree.map(np.asarray, scene.make_rig()), "cpu")
    vo = VisualOdometer(WorldMap(), rig, seed=0)
    vo.track(*img0)
    prev = vo.prev

    def sample(valid):
        sets = rransac._sample_minimal_sets(key, jnp.asarray(valid.numpy()),
                                            vo.rc.num_hypotheses)
        return torch.from_numpy(np.array(sets))

    res = frontend_step(torch.from_numpy(img1[0]), torch.from_numpy(img1[1]), prev,
                        torch.tensor(True), sample, rig, vo.max_distance, vo.fe, vo.rc,
                        rectified=True)
    assert int(res.num_inliers) == int(ref_res.num_inliers) > 50

    rviz.save_frame_debug(str(tmp_path / "ref"), 1, img1[0], img1[1], ref_res,
                          prev_img=img0[0], prev_slots=ref_prev)
    viz.save_frame_debug(str(tmp_path / "port"), 1, img1[0], img1[1], res,
                         prev_img=img0[0], prev_slots=prev)
    want = _image_set(tmp_path / "ref")
    assert list(want) == ["stereo_000001.png", "temporal_000001.png", "tracking_000001.png"]
    assert _image_set(tmp_path / "port") == want


def test_vo_app_debug_viz_every_n_frames(tmp_path):
    seq, _ = _write_sequence(str(tmp_path), n=5)
    viz_dir = tmp_path / "viz"
    summary = visual_odometry.main([
        "--dataset", "kitti", "--folder", seq, "--camera", os.path.join(seq, "calib.txt"),
        "--output_dir", str(tmp_path / "out"), "--device", "cpu",
        "--debug_viz", str(viz_dir), "--debug_viz_every", "2",
    ])
    assert summary["frames"] == 5
    images = _image_set(viz_dir)
    expected = sorted([f"{kind}_{i:06d}.png" for i in (0, 2, 4) for kind in ("stereo", "tracking")]
                      + [f"temporal_{i:06d}.png" for i in (2, 4)])
    assert sorted(images) == expected
    with Image.open(os.path.join(seq, "image_0", "000000.png")) as im:
        w, h = im.size
    assert images["tracking_000002.png"] == ((w, h), "RGB")
    assert images["stereo_000002.png"][0] == (2 * w, h)

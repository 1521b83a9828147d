"""The PyTorch port stands alone: it loads neither JAX nor the JAX package,
and its entry points default to the CUDA device."""

import inspect
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import stereo_orb_slam_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
             or k.startswith("stereo_orb_slam_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_in_a_fresh_interpreter():
    # A subprocess, because this test process has JAX loaded already.
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert "stereo_orb_slam_torch.frontend.odometer" in report["modules"]
    assert "stereo_orb_slam_torch.ops.kernels.hamming" in report["modules"]
    for name in ("backend.ba", "backend.schur_dense", "backend.residuals",
                 "geometry.se3_np", "io.checkpoint", "apps.refine",
                 "loop", "loop.vocab", "loop.detector", "backend.pose_graph",
                 "apps.slam", "apps.train_vocab", "utils.viz", "utils.profiling",
                 "parallel", "parallel.mesh", "parallel.multihost", "parallel.multi_seq",
                 "parallel.dist_ba", "parallel.dist_pose_graph", "apps.scaling_bench"):
        assert "stereo_orb_slam_torch." + name in report["modules"]


def _sources(with_smoke):
    # With the smoke: also the JAX-free test helpers that spawned ranks and
    # the smoke import.
    files = ([os.path.join(ROOT, name) for name in
              ("chip_smoke.py", "tests/dist_workers.py", "tests/synth_ba.py",
               "tests/synth_distorted.py", "tests/synth_canyon.py")]
             if with_smoke else [])
    for dirpath, _, names in os.walk(os.path.join(ROOT, "stereo_orb_slam_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith((".py", ".cu"))]
    return [(f, open(f, encoding="utf-8").read()) for f in files]


def test_port_sources_do_not_import_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|stereo_orb_slam_tpu)\b", re.M)
    assert [f for f, text in _sources(True) if pattern.search(text)] == []


def test_smoke_and_its_helpers_load_no_jax_in_a_fresh_interpreter():
    # chip_smoke.py and the JAX-free test helpers it and the spawned ranks
    # import (synth_canyon also renders the canyon tree in a child process).
    probe = ("import json, sys; sys.path[:0] = ['tests', '.']; "
             "import chip_smoke, dist_workers, synth, synth_ba, synth_canyon, synth_distorted; "
             "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' or "
             "k.startswith(('jax.', 'jaxlib', 'stereo_orb_slam_tpu')))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_package_does_not_name_the_jax_package():
    # chip_smoke.py names the TPU kernels' files as data ("replaces").
    assert [f for f, text in _sources(False) if "stereo_orb_slam_tpu" in text] == []


def test_entry_points_default_to_cuda():
    from stereo_orb_slam_torch import convert
    from stereo_orb_slam_torch.apps import scaling_bench
    from stereo_orb_slam_torch.frontend import odometer
    from stereo_orb_slam_torch.geometry import camera
    from stereo_orb_slam_torch.io import calib, datasets
    from stereo_orb_slam_torch.loop import OrbVocabulary
    from stereo_orb_slam_torch.ops import orb

    for fn in (camera.Pinhole.create, calib.load_camera, calib.load_kitti_calib,
               calib.load_reference_format, odometer.empty_slots, orb.steer_table,
               convert.ba_problem_from_numpy, odometer.empty_banks,
               datasets.DeviceBatchReader, OrbVocabulary, OrbVocabulary.train,
               OrbVocabulary.load, convert.vocabulary_from_numpy,
               convert.loop_database_from_numpy, convert.point_aligned_from_numpy,
               convert.pose_graph_problem_from_numpy, scaling_bench.make_problem,
               scaling_bench.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn

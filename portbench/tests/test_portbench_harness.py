"""The harness finds a cell's parts by name, loads nothing of JAX or the JAX
package, keeps the plain reference apart from the program, and writes a
BENCHMARK.json within the contract's limits."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from portbench import harness

REPO = harness.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_parts_added_as_files_are_found(tmp_path):
    """A configuration, a cell and a per-layer metric that exist only as new
    files are found by their names."""
    for d in ("configs", "workloads", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "new_rig.json").write_text(json.dumps({"name": "new_rig"}))
    (tmp_path / "workloads" / "new_cell.json").write_text(
        json.dumps({"name": "new_cell", "config": "new_rig", "entry": "vo"}))
    (tmp_path / "metrics" / "new.metric.py").write_text(
        'UNIT = "ms"\n\ndef read(trace):\n    return trace.get("x")\n')
    cell, cfg = harness.cell_files("new_cell", root=tmp_path)
    assert cfg["name"] == "new_rig" and cell["entry"] == "vo"
    mod = harness.reader("new.metric", root=tmp_path)
    assert mod.UNIT == "ms" and mod.read({"x": 2.0}) == 2.0 and mod.read({}) is None
    assert hasattr(harness.entry(cell["entry"]), "run")


def test_every_listed_part_exists():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell, cfg = harness.cell_files(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"]["name"] == w["traffic"]
        assert hasattr(harness.entry(cell["entry"]), "run")
    for m in bench["per_layer"]:
        assert harness.reader(m["name"]).UNIT == m["unit"]
    for c in bench["configs"]:
        assert os.path.exists(REPO / c["file"])


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxy", "stereo_orb_slam_tpux", "stereo_orb_slam_torch.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stereo_orb_slam_tpu.ops", object())
    assert harness.forbidden_modules() == ["stereo_orb_slam_tpu.ops"]


def test_a_run_loads_no_jax():
    """A whole small run of each entry on the CPU, then the modules the
    process holds: the port is there, JAX and the JAX package are not."""
    out = _run("""
        import json, sys
        import portbench.run, portbench.control
        from portbench import harness
        from portbench.tests.tiny import tiny
        for name in ("euroc_vo",):
            cell, cfg = tiny(name)
            harness.entry(cell["entry"]).run(cfg, cell, 2**31 + 5, 0.5, True, device="cpu")
        print(json.dumps([harness.forbidden_modules(),
                          "stereo_orb_slam_torch" in sys.modules]))
    """)
    assert json.loads(out) == [[], True]


def test_reference_loads_nothing_of_the_program():
    out = _run("""
        import json, sys
        import portbench.reference.frontend, portbench.reference.judge
        import portbench.roofline.hamming_top2, portbench.roofline.orb_describe
        import portbench.roofline.triangulate_dlt, portbench.traffic
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules
                                 if m.split(".")[0].startswith("stereo_orb_slam")
                                 or m.split(".")[0] in ("jax", "jaxlib", "flax")})))
    """)
    assert json.loads(out) == []


def test_benchmark_json_keeps_to_the_contract():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = []
    for part, want in keys.items():
        for e in bench[part]:
            assert set(e) - {"workloads"} == want, (part, e)
            names.append(e["name"])
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    assert len(json.dumps(bench)) < 64 * 1024


def test_without_a_card_no_result(tmp_path):
    """Without a CUDA device the run exits with 2 and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "euroc_vo",
                          "--seed", str(2**32 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["euroc_vo"])
def test_a_short_run_on_the_card(name):
    """On a card, a short run of each cell prints a correct result line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", str(2**32 + 11), "--seconds", "3", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_judged_runs_are_drawn_over_the_whole_window():
    """The reservoir keeps complete runs of consecutive frames, the same for
    one seed, and draws them from the whole window: over seeds, a run of the
    last quarter is kept about as often as one of the first."""
    from portbench.entries.vo import Runs

    def kept(seed, frames=1000):
        runs = Runs(seed, 3, 10)
        for pos in range(frames):
            runs.add(pos)
        return runs.kept

    for seed in (1, 2**33 + 5):
        assert kept(seed) == kept(seed)
        for run in kept(seed):
            assert run == list(range(run[0], run[0] + 10)) and run[0] % 10 == 0
    firsts = [run[0] for seed in range(400) for run in kept(seed)]
    early = sum(f < 250 for f in firsts)
    late = sum(f >= 750 for f in firsts)
    assert len(firsts) == 1200 and 0.8 < late / early < 1.25
    assert len(kept(3, frames=25)) == 2

"""`correct` separates: the port reads within every limit, the control (the
plain reference one precision step below the configuration's, put in the
port's place) reads beyond them, and a run whose timed path is broken
underneath comes out not correct.

Small copies of the cells on the CPU (portbench/tests/tiny.py); on the chip
the same readings come from `python3 -m portbench.control` at the cells'
own sizes (PERF.md gives them)."""

import numpy as np
import pytest

from portbench import harness
from portbench import run as bench_run
from portbench.reference.judge import NUMBERS, worst
from portbench.tests.tiny import tiny

CELLS = ("euroc_vo",)
SEED = 2**31 + 17


def _outcome(name, control=False, seconds=1.5):
    cell, cfg = tiny(name)
    out = harness.entry(cell["entry"]).run(cfg, cell, SEED, seconds, False, device="cpu",
                                           control=control)
    return cell, out


@pytest.mark.parametrize("name", CELLS)
def test_port_passes_and_control_fails(name):
    cell, out = _outcome(name, control=True)
    assert len(out["readings"]) == cell["judge"]["runs"] * cell["judge"]["frames"]
    assert bench_run.is_correct(bench_run.checks_of(cell, worst(out["readings"])))
    control = bench_run.checks_of(cell, worst(out["control_readings"]))
    assert not bench_run.is_correct(control)
    # The control fails every number the cell compares.
    assert all(v > lim for v, lim in control.values()), control


def _track_unchanged(self, img_l, img_r):
    """A step that returns its state unchanged: no front end, the last
    result and the map kept, the identity pose."""
    self._frame_counter += 1
    return np.eye(4, dtype=np.float32)


def _altered(orig):
    """The pose answer altered where it is produced: 5 mm along x."""
    def step(*args, **kwargs):
        res = orig(*args, **kwargs)
        T = res.transform.clone()
        T[0, 3] += 0.005
        return res._replace(transform=T)
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """The run's correct comes out false with the timed path broken. Half
    of a batch left out and the exchange between chips do not apply: the
    cells hand over one frame a call, on one chip."""
    from stereo_orb_slam_torch.frontend import odometer

    cell, cfg = tiny(name)
    entry = harness.entry(cell["entry"])
    warm = cell["warmup_frames"]
    if fault == "state_unchanged":
        orig = odometer.VisualOdometer.track

        def track(self, img_l, img_r):
            if self._frame_counter < warm:
                return orig(self, img_l, img_r)
            return _track_unchanged(self, img_l, img_r)

        monkeypatch.setattr(odometer.VisualOdometer, "track", track)
    else:
        monkeypatch.setattr(odometer, "frontend_step_program",
                            _altered(odometer.frontend_step_program))
    out = entry.run(cfg, cell, SEED, 1.5, False, device="cpu")
    checks = bench_run.checks_of(cell, worst(out["readings"]))
    assert out["readings"] and not bench_run.is_correct(checks)


def test_numbers_are_the_limits():
    for name in CELLS:
        cell, _ = harness.cell_files(name)
        assert set(cell["limits"]) == set(NUMBERS)

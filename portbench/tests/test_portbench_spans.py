"""`portbench.spans`: the clock check and the idle split on hand-made
profiler events, and a whole small run of the `vo` entry on the CPU with
the port's tracer on and off."""

import pytest

from portbench import spans
from portbench.tests.tiny import tiny


def _frame(t, launch_end=2.0, readback_end=4.0):
    """A frame's program spans from time t: uploads, launch, readback, map."""
    return [("vo.track", t, t + 5.0), ("vo.upload", t, t + 0.5),
            ("vo.launch", t + 0.5, t + launch_end), ("program.replay", t + 1.0, t + 1.5),
            ("vo.readback", t + launch_end, t + readback_end),
            ("vo.map", t + readback_end, t + 5.0)]


def test_clock_check_counts_the_frames_whose_kernels_lie_inside_their_spans():
    evs = _frame(0.0) + _frame(10.0)
    device = [("Memcpy HtoD (Pageable -> Device)", 0.1, 0.4),   # an upload: not a kernel
              ("kernel_a", 1.0, 1.2), ("kernel_b", 2.5, 3.9),     # frame 0, inside
              ("kernel_a", 10.6, 10.8), ("kernel_b", 13.5, 14.2)]  # frame 1 ends after its readback
    got = spans.clock_check(sorted(evs, key=lambda s: s[1]), device)
    assert got == pytest.approx({"frames": 2, "hold": 1, "kernels": 4, "before_first_frame": 0,
                                 "before_launch_ms": 0.0, "after_readback_ms": 200.0})
    early = spans.clock_check(sorted(evs, key=lambda s: s[1]), [("kernel_a", -1.0, -0.5)])
    assert early["before_first_frame"] == 1 and early["hold"] == 2


def test_idle_is_split_by_the_innermost_open_span():
    evs = sorted(_frame(0.0), key=lambda s: s[1])
    device = [("kernel_a", 1.0, 1.5), ("kernel_b", 2.5, 3.0)]
    got = spans.idle_by_span(evs, device)
    assert got["wall_s"] == 5.0
    assert got["idle_s"] == pytest.approx({"vo.upload": 0.5, "vo.launch": 1.0,
                                           "vo.readback": 1.5, "vo.map": 1.0})
    assert spans.idle_by_span([], device) == {"wall_s": 0.0, "idle_s": {}}


@pytest.mark.parametrize("tracing", [True, False])
def test_a_small_run_on_the_cpu(tracing):
    cell, cfg = tiny("euroc_vo")
    line = spans.measure(cfg, cell, 2**31 + 9, 0.5, tracing, device="cpu")
    assert line["correct"] and line["tracing"] == int(tracing)
    assert line["timed_frames"] == line["frames"] - (cell["trace"]["frames"] if tracing else 0)
    if not tracing:
        assert line["spans_recorded"] == 0 and "span_ms" not in line
        return
    assert set(line["span_ms"]) == set(spans.REPORTED)
    assert all(line["span_ms"][k] > 0 for k in spans.FRAME_SPANS + ("vo.track",))
    assert line["span_ms"]["program.replay"] == 0   # the CPU runs the eager bodies
    assert 0.9 <= line["children_share"] <= 1.0
    assert line["captures"] == {"setup": 0, "setup_ms": 0, "window": 0}
    assert line["clock"]["frames"] == cell["trace"]["frames"]
    assert line["slice_idle"]["share"] is not None


"""``bench_torch/idle.py`` on synthetic traces: each idle piece charged to
the innermost host range over it, exactly, and the readers of the three
idle metrics."""
import types

import pytest

from bench_torch import idle
from bench_torch import trace as tracing
from bench_torch.metrics import (
    cnn_input_idle_ms,
    depth_tail_idle_ms,
    launch_idle_ms,
)


def make_trace(ranges, device, window=(0, 100)):
    """A ``Trace`` of host ranges (name, start, end) and device intervals
    (start, end), in microseconds."""
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
                "dur": e - s} for n, s, e in ranges]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": s,
                "dur": e - s} for s, e in device]
    return tracing.Trace(events)


def us(by):
    """{name: microseconds}, rounded against float noise."""
    return {k: round(v * 1e6, 6) for k, v in by.items()}


def test_nested_ranges_charge_the_innermost():
    t = make_trace([("pass", 0, 100), ("phase", 10, 60), ("span", 20, 30)],
                   [(0, 15), (40, 50)])
    # idle [15, 40) and [50, 100)
    assert us(idle.idle_by_range(t)) == {
        "phase": 5 + 10 + 10, "span": 10, "pass": 40}


def test_a_gap_over_two_sibling_spans_is_split_between_them():
    t = make_trace([("pass", 0, 100), ("depth.download", 10, 20),
                    ("depth.scatter", 20, 35)], [(0, 12), (30, 100)])
    # one gap, [12, 30): the label at its start would take all 18 us
    assert us(idle.idle_by_range(t)) == {"depth.download": 8,
                                         "depth.scatter": 10}
    assert t.idle_gaps() == [["depth.download (1 gaps)",
                              pytest.approx(18e-6)]]


def test_a_gap_under_no_range_is_charged_to_no_range():
    t = make_trace([("pass", 20, 100)], [(0, 5), (30, 100)])
    assert us(idle.idle_by_range(t)) == {idle.NO_RANGE: 15, "pass": 10}


def test_ranges_past_the_window_are_clipped_and_ties_go_to_the_shorter():
    t = make_trace([("outer", -50, 150), ("inner", 40, 60),
                    ("same_start", 40, 50)], [(10, 20)], window=(0, 100))
    # idle [0, 10) and [20, 100)
    assert us(idle.idle_by_range(t)) == {
        "outer": 10 + 20 + 40, "same_start": 10, "inner": 10}
    assert idle.idle_intervals(t) == [(0, 10), (20, 100)]


def test_the_charges_sum_to_the_window_idle_time():
    ranges = [("pass", 0, 50), ("pass", 50, 100)]
    ranges += [("cnn.upload", s, s + 3) for s in range(2, 98, 7)]
    t = make_trace(ranges, [(s, s + 2) for s in range(0, 100, 5)])
    total = sum(idle.idle_by_range(t).values())
    assert total == pytest.approx(t.window_s - t.busy_s())


def test_counts_take_the_ranges_that_start_in_the_window():
    t = make_trace([("a", -5, 3), ("a", 10, 20), ("a", 99, 120),
                    ("a", 100, 110), ("b", 30, 40)], [], window=(0, 100))
    assert idle.count(t, "a") == 2
    assert idle.count(t, "b") == 1
    assert idle.count(t, "c") == 0


def _run(ranges, device):
    return types.SimpleNamespace(trace=make_trace(ranges, device))


def test_readers_divide_by_their_own_spans():
    ranges = [("bench.pass", 0, 50), ("bench.pass", 50, 100),
              ("cnn.pad", 0, 4), ("Features computation", 4, 10),
              ("cnn.upload", 4, 6), ("cnn.net", 6, 10),
              ("rays.index", 10, 12), ("rays.upload", 12, 14),
              ("rays.segments", 14, 20), ("voxel_depth", 20, 30),
              ("depth.download", 30, 32), ("depth.scatter", 32, 40),
              ("cnn.pad", 50, 54), ("cnn.upload", 54, 56),
              ("depth.scatter", 90, 95)]
    device = [(5, 6), (8, 9), (16, 17), (22, 31), (60, 90)]
    run = _run(ranges, device)
    # cnn.pad 4 + 4, cnn.upload 1 + 2: 11 us over 2 uploads
    assert cnn_input_idle_ms.read(run) == pytest.approx(11e-3 / 2)
    # rays.index 2, rays.upload 2, depth.download 1, depth.scatter 8 + 5
    assert depth_tail_idle_ms.read(run) == pytest.approx(18e-3 / 2)
    # cnn.net 3, rays.segments 5, voxel_depth 2, over 2 passes
    assert launch_idle_ms.read(run) == pytest.approx(10e-3 / 2)


def test_readers_read_nothing_without_the_spans_or_a_device():
    # the parent's program: phases and passes, no span
    parent = _run([("bench.pass", 0, 100), ("Features computation", 0, 10),
                   ("Per-pixel depth estimation", 20, 40)], [(5, 25)])
    no_device = _run([("bench.pass", 0, 100), ("cnn.upload", 1, 2),
                      ("depth.scatter", 3, 4), ("cnn.net", 5, 6)], [])
    untraced = types.SimpleNamespace(trace=None)
    for reader in (cnn_input_idle_ms, depth_tail_idle_ms, launch_idle_ms):
        for run in (parent, no_device, untraced):
            assert reader.read(run) is None

"""The reader of ``view_set_idle_ms`` on synthetic traces: idle under
``views.stack`` and ``views.cameras``, charged by overlap through
``bench_torch/idle.py``, per view set built; nothing without the spans or
a device."""
import types

import pytest

from bench_torch import idle
from bench_torch import trace as tracing
from bench_torch.metrics import view_set_idle_ms


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


def _run(ranges, device):
    return types.SimpleNamespace(trace=make_trace(ranges, device))


def test_reader_divides_by_the_stacks():
    # two view sets built in one pass, a third cached (no span); the
    # pass's own idle outside the spans is not charged to them
    ranges = [("bench.pass", 0, 100),
              ("Features computation", 2, 10), ("cnn.upload", 2, 4),
              ("views.stack", 10, 12), ("views.cameras", 12, 20),
              ("views.stack", 40, 41), ("views.cameras", 41, 50)]
    device = [(0, 11), (13, 14), (16, 17), (40, 45), (60, 100)]
    run = _run(ranges, device)
    # views.stack 1 + 0, views.cameras 1 + 2 + 3 and 5: 12 us over 2 sets
    assert view_set_idle_ms.read(run) == pytest.approx(12e-3 / 2)
    by_range = idle.idle_by_range(run.trace)
    assert round(by_range["bench.pass"] * 1e6, 6) == 20 + 10


def test_reader_reads_nothing_without_the_spans_or_a_device():
    # the parent's program: phases and passes, no view-set span
    parent = _run([("bench.pass", 0, 100), ("Features computation", 0, 10),
                   ("cnn.upload", 1, 2)], [(5, 25)])
    no_device = _run([("bench.pass", 0, 100), ("views.stack", 1, 2),
                      ("views.cameras", 2, 4)], [])
    untraced = types.SimpleNamespace(trace=None)
    for run in (parent, no_device, untraced):
        assert view_set_idle_ms.read(run) is None

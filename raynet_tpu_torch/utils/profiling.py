"""Phase timers, host spans and ``torch.profiler`` traces.

Port of ``raynet_tpu/utils/profiling.py``, with the same phase labels
("Features computation", "Message passing", "Per-pixel depth estimation").
On a CUDA device a phase's time lies between two timing events recorded
on the current stream at its edges, resolved when ``totals`` or
``summary()`` is read, so a phase never waits for the device; on the CPU
it is ``time.perf_counter`` between its edges.

``span(label)`` names a step inside a phase or a pass: while a
``torch.profiler`` records, a ``record_function`` range, which the Chrome
trace puts on the clock of the device's kernels and copies; otherwise one
shared null context that records nothing. Every phase opens its range
through it, so an untraced pass opens no range at all.

``PhaseTimer.layer(label)`` times one layer of a network inside a phase:
while a profiler records it is a phase of that label, else the same null
context, so an untraced pass creates no event and no count for it.

``trace(log_dir)`` is the counterpart of the reference's ``jax.profiler``
hook: it writes a Chrome trace (``<log_dir>/trace.json``) that
``read_trace``, ``device_intervals`` and ``device_busy_share`` read back.
"""
import contextlib
import json
import os
import time

import torch

TRACE_NAME = "trace.json"
# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_UNTRACED = contextlib.nullcontext()


def span(label):
    """A ``record_function`` range named ``label`` while a profiler
    records, else a null context. Labels carry no image index, so a
    trace sums them over images and passes; a span is closed before its
    pass yields, so the consumer's work is never charged to it."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(label)
    return _UNTRACED


class PhaseTimer:
    """Accumulating named timers: ``totals`` (seconds) and ``counts`` by
    label. Work a phase queues on another stream must be joined to the
    current stream before the phase ends."""

    def __init__(self, device=None):
        self._totals = {}
        self.counts = {}
        self._pending = []  # (label, start, end) CUDA events not yet read
        self.device = None if device is None else torch.device(device)

    @property
    def totals(self):
        """Seconds by label; on a card, reading it waits for the end of the
        last phase's work."""
        for label, start, end in self._pending:
            end.synchronize()
            self._totals[label] += start.elapsed_time(end) * 1e-3
        self._pending = []
        return self._totals

    @contextlib.contextmanager
    def phase(self, label):
        with span(label):
            if self.device is None or self.device.type != "cuda":
                t0 = time.perf_counter()
                yield
                self.add(label, time.perf_counter() - t0)
                return
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._pending.append((label, start, end))
            self.add(label, 0.0)  # the count now, the time when read

    def layer(self, label):
        """A phase named ``label`` while a ``torch.profiler`` records, else
        the shared null context: no range, no event, no count."""
        if torch.autograd._profiler_enabled():
            return self.phase(label)
        return _UNTRACED

    def add(self, label, dt):
        """Record an externally measured duration."""
        self._totals[label] = self._totals.get(label, 0.0) + dt
        self.counts[label] = self.counts.get(label, 0) + 1

    def summary(self):
        return {
            k: {"total_s": v, "count": self.counts[k]}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the host and, where there is a card, the
    device; on exit writes the Chrome trace to ``<log_dir>/trace.json``.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def read_trace(path):
    """The complete ("ph": "X") events of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [ev for ev in events if ev.get("ph") == "X"]


def device_intervals(events):
    """(name, start_us, end_us) of every kernel, copy and memset on the
    device."""
    return [(ev["name"], ev["ts"], ev["ts"] + ev["dur"]) for ev in events
            if ev.get("cat") in DEVICE_CATEGORIES]


def annotation_window(events, label):
    """(start_us, end_us) of the first host ``record_function`` range named
    ``label``."""
    for ev in events:
        if ev.get("cat") == "user_annotation" and ev["name"] == label:
            return ev["ts"], ev["ts"] + ev["dur"]
    raise KeyError("no record_function range %r in the trace" % (label,))


def device_busy_share(intervals, window):
    """Share of ``window`` = (start, end) covered by the union of
    ``intervals`` (start, end), each clipped to the window: overlapping
    work (kernels on several streams) counts once."""
    lo, hi = window
    busy, reach = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        s = max(s, reach)
        if e > s:
            busy += e - s
            reach = e
    return busy / (hi - lo)

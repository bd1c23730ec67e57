"""Per-phase wall-clock timers and ``torch.profiler`` traces.

Port of ``raynet_tpu/utils/profiling.py``, with the same phase labels
("Features computation", "Message passing", "Per-pixel depth estimation")
and the reference's print format. On a CUDA device every phase edge calls
``torch.cuda.synchronize``, so a phase's time includes the device work it
queued instead of only the time to enqueue it. Each phase is also a
``torch.profiler.record_function`` range, so it shows in a ``trace``.

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


class PhaseTimer:
    """Accumulating named timers."""

    def __init__(self, verbose=True, device=None):
        self.totals = {}
        self.counts = {}
        self.verbose = verbose
        self.device = None if device is None else torch.device(device)

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, label):
        with torch.profiler.record_function(label):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            dt = time.perf_counter() - t0
        self.add(label, dt)
        if self.verbose:
            print("%s - %s" % (label, dt))

    def add(self, label, dt):
        """Record an externally measured duration."""
        self.totals[label] = self.totals.get(label, 0.0) + dt
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

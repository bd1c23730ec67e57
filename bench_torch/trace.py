"""Reading a ``torch.profiler`` trace of the measured window.

The profiler records the host's ``record_function`` ranges (the program's
phases and the benchmark's own spans) and the device's kernels, copies and
memsets on one clock. From the Chrome trace this module takes the window
(the benchmark's "bench.window" range), the union of device intervals
inside it (busy time: overlapping work counts once), the device time by
operation name, and the idle gaps between device intervals, each labelled
by the innermost host range open at its start. The union arithmetic is
the port's ``utils/profiling.device_busy_share``, copied.
"""
import bisect
import json
import os
import tempfile

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def profile():
    """A profiler over the host and, where there is one, the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def events_of(prof):
    """The complete ("ph": "X") events of ``prof``'s trace, written to a
    temporary file and read back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [ev for ev in events if ev.get("ph") == "X"]


class Trace:
    """The window's device work and host ranges, in microseconds."""

    def __init__(self, events):
        ranges = [(ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                  for ev in events if ev.get("cat") == "user_annotation"]
        windows = [r for r in ranges if r[2] == WINDOW]
        if not windows:
            raise KeyError("no %r range in the trace" % WINDOW)
        self.lo, self.hi = windows[0][:2]
        self.ranges = sorted(r for r in ranges if r[2] != WINDOW)
        self.device = sorted(
            (max(ev["ts"], self.lo), min(ev["ts"] + ev["dur"], self.hi),
             ev["name"])
            for ev in events if ev.get("cat") in DEVICE_CATEGORIES
            and ev["ts"] < self.hi and ev["ts"] + ev["dur"] > self.lo)

    @property
    def window_s(self):
        return (self.hi - self.lo) * 1e-6

    def merged(self):
        """The union of the device intervals as sorted disjoint
        (start, end)."""
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.merged()) * 1e-6

    def device_seconds(self, match):
        """Device seconds of the operations whose name contains
        ``match``."""
        return sum(e - s for s, e, name in self.device if match in name) * 1e-6

    def top_operations(self, n=10):
        """[[name, seconds]] of the n operations with most device time."""
        by = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def label_at(self, t, reach=256):
        """The innermost host range open at time ``t``: of those that
        contain it, the one that started last (among the ``reach`` ranges
        that started last before it: the ranges of one pass nest)."""
        i = bisect.bisect_right(self.ranges, (t, float("inf"), ""))
        for s, e, name in reversed(self.ranges[max(0, i - reach):i]):
            if s <= t < e:
                return name
        return "(no range)"

    def idle_gaps(self, n=10):
        """[[label, seconds]]: the device's idle time inside the window,
        summed by the host range open at the start of each gap, the n
        largest, each label with its number of gaps."""
        merged = self.merged()
        edges = [self.lo] + [x for s, e in merged for x in (s, e)] + [self.hi]
        by, count = {}, {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                label = self.label_at(a)
                by[label] = by.get(label, 0.0) + (b - a) * 1e-6
                count[label] = count.get(label, 0) + 1
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [["%s (%d gaps)" % (k, count[k]), v] for k, v in top]

"""Per-phase wall-clock timers.

Port of ``raynet_tpu/utils/profiling.py:15-42``, with the same phase labels
("Features computation", "Message passing", "Per-pixel depth estimation")
and the reference's print format. On a CUDA device every phase edge calls
``torch.cuda.synchronize``, so a phase's time includes the device work it
queued instead of only the time to enqueue it.
"""
import contextlib
import time

import torch


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

"""launch_idle_ms: milliseconds a pass in which the device sat idle under
the program's spans that only launch device work: ``cnn.net``,
``rays.segments``, ``scores`` (K1), ``messages.alloc``, ``sweep.first``,
``sweep.message``, ``sweep.depth`` (K2) and ``voxel_depth`` (K1 and K3),
charged by overlap (``bench_torch/idle.py``), per pass of the benchmark
(its ``bench.pass`` range). Layer: the host's launch path (the op wrappers,
``ops/sampling.py``)."""
from bench_torch import idle
from bench_torch.drivers.scene_pass import PASS

SPANS = ("cnn.net", "rays.segments", "scores", "messages.alloc",
         "sweep.first", "sweep.message", "sweep.depth", "voxel_depth")


def read(run):
    return idle.idle_ms_per(run, SPANS, PASS)

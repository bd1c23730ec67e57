"""patch_host_idle_ms: milliseconds a pass in which the device sat idle
under the Hartmann pass's host steps: ``patch.sample`` (the points of
every (ray, plane) on the host), ``patch.pad`` (the view stack's upload
and zero border), ``depth.download`` (the argmax planes to the host) and
``patch.depth`` (the points of the best planes and their distances),
charged by overlap (``bench_torch/idle.py``), per pass of the benchmark
(its ``bench.pass`` range). Layer: the patch pass's host path
(``inference/forward_pass.py::HartmannForwardPass``,
``common/sampling_schemes.py``)."""
from bench_torch import idle
from bench_torch.drivers.scene_pass import PASS

SPANS = ("patch.sample", "patch.pad", "depth.download", "patch.depth")


def read(run):
    return idle.idle_ms_per(run, SPANS, PASS)

"""depth_tail_idle_ms: milliseconds a reference view in which the device
sat idle under the program's per-view host steps: ``rays.index`` (the
view's ray indices), ``rays.upload`` (them to the device),
``depth.download`` (the view's depths to the host) and ``depth.scatter``
(their scatter into the (H, W) map), charged by overlap
(``bench_torch/idle.py``), per ``depth.scatter`` span. Layer: the per-view
host tail (``inference/forward_pass.py``)."""
from bench_torch import idle

SPANS = ("rays.index", "rays.upload", "depth.download", "depth.scatter")


def read(run):
    return idle.idle_ms_per(run, SPANS, "depth.scatter")

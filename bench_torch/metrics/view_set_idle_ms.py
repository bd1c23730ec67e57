"""view_set_idle_ms: milliseconds a view set built in which the device sat
idle under the program's ``views.stack`` (the stack of a reference view's
cached feature maps) and ``views.cameras`` (the view set's cameras, three
pageable uploads that each wait for the stream), charged by overlap
(``bench_torch/idle.py``), per ``views.stack`` span. Layer: the view set's
assembly (``inference/forward_pass.py::ForwardPass._features_and_cameras``),
in the raynet and voxel-space passes."""
from bench_torch import idle

SPANS = ("views.stack", "views.cameras")


def read(run):
    return idle.idle_ms_per(run, SPANS, "views.stack")

"""cnn_input_idle_ms: milliseconds a featurised image in which the device
sat idle under the program's ``cnn.pad`` and ``cnn.upload`` spans (the
image's zero padding on the host and its upload to the device), charged
by overlap (``bench_torch/idle.py``), per ``cnn.upload`` span. Layer: the
CNN's input (``models/feature_extractor.py::zeropad_images``, the upload
in ``inference/forward_pass.py``)."""
from bench_torch import idle

SPANS = ("cnn.pad", "cnn.upload")


def read(run):
    return idle.idle_ms_per(run, SPANS, "cnn.upload")

"""cas_host_idle_ms: milliseconds a pass in which the device sat idle
under the CasMVSNet pass's host steps: ``cnn.pad`` and ``cnn.upload`` (an
image's crop and its upload), ``mvs.planes`` (a stage's cameras,
homographies and hypotheses on the host and their upload),
``cas.hypotheses`` (the hand-off between stages: the previous depth's
resampling and the hypotheses' build), ``mvs.regress`` (the depth
regression's launches) and ``depth.download`` (the host's wait for a map),
charged by overlap (``bench_torch/idle.py``), per pass of the benchmark
(its ``bench.pass`` range). Layer: the CasMVSNet pass's host path
(``inference/forward_pass.py::CasMVSNetForwardPass``)."""
from bench_torch import idle
from bench_torch.drivers.scene_pass import PASS

SPANS = ("cnn.pad", "cnn.upload", "mvs.planes", "cas.hypotheses",
         "mvs.regress", "depth.download")


def read(run):
    return idle.idle_ms_per(run, SPANS, PASS)

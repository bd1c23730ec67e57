"""patch_net_roofline: the share of the Hartmann net's time that its
bound takes: the bound of the window's net work (``patch_roofline``: 2 x
the convolutions' multiply-accumulates of every quintuple, over the
float32 peak), over the program's "Patch net" phase summed over the
window's passes (the device time between CUDA events at the edges of
each chunk's ``predict``), in %. Layer: the patch net
(``models/cnn.py::HartmannSimilarityNet``, cuDNN)."""
from bench_torch import roofline

PHASE = "Patch net"


def read(run):
    # the phase's device time exists only on the card
    if run.work is None or run.device["platform"] != "gpu":
        return None
    seconds = sum(p.phases[PHASE]["total_s"] for p in run.passes
                  if PHASE in p.phases)
    if seconds <= 0:
        return None
    bound = roofline.bound_seconds(run.work["net"], run.config["precision"])
    return 100.0 * bound * len(run.passes) / seconds

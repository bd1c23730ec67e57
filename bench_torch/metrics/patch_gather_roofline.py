"""patch_gather_roofline: the share of the patch gather's time that its
bound takes: the window's gather bytes (``patch_roofline``: per view and
patch pixel of every quintuple the int64 index, the texels read and the
patch values written) over 3.35 TB/s, over the program's "Patch gather"
phase summed over the window's passes (device time between CUDA events),
in %. Layer: the patch gather (``common/image.py::gather_patches``)."""
from bench_torch import roofline

PHASE = "Patch gather"


def read(run):
    # the phase's device time exists only on the card
    if run.work is None or run.device["platform"] != "gpu":
        return None
    seconds = sum(p.phases[PHASE]["total_s"] for p in run.passes
                  if PHASE in p.phases)
    if seconds <= 0:
        return None
    bound = roofline.bound_seconds(run.work["gather"])
    return 100.0 * bound * len(run.passes) / seconds

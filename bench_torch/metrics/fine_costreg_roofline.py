"""fine_costreg_roofline: the share of CasMVSNet's last-stage U-Net's
time that its bound takes: the window's last-stage U-Net operations
(``cas_roofline``: 2 x the 3D convolutions' multiply-accumulates of every
full-resolution cost volume) over the float32 peak, over the program's
"Fine regularization" phase summed over the window's passes (the device
time between CUDA events at the edges of each last-stage U-Net), in %.
Layer: the cost regularisation (``models/mvsnet.py``'s U-Net as
``models/casmvsnet.py`` runs it: cuDNN and K5) at 8 hypotheses over the
crop's full resolution."""
from bench_torch import roofline

PHASE = "Fine regularization"


def read(run):
    # the phase's device time exists only on the card
    if run.work is None or "fine_unet" not in run.work \
            or run.device["platform"] != "gpu":
        return None
    seconds = sum(p.phases[PHASE]["total_s"] for p in run.passes
                  if PHASE in p.phases)
    if seconds <= 0:
        return None
    bound = roofline.bound_seconds(run.work["fine_unet"],
                                   run.config["precision"])
    return 100.0 * bound * len(run.passes) / seconds

"""prob_conv_roofline: the share of the U-Nets' ``prob`` conv's time that
its bound takes: the bound of the window's ``prob`` convs (8 -> 1
channels, 3x3x3, at each volume's size; ``unet_layers``: bytes, the input
read and the logits written, or operations, whichever is larger) over the
program's ``unet.prob`` layer timer summed over the window's passes (the
device time between CUDA events at the edges of each volume's ``prob``
conv, its bias add where it has one included), in %. Layer: the cost
regularisation (``models/mvsnet.py``'s U-Net, cuDNN), in the MVSNet and
CasMVSNet passes."""
from bench_torch import unet_layers


def read(run):
    return unet_layers.roofline_share(run, ("prob",))

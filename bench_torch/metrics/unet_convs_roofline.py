"""unet_convs_roofline: the share of the time of the U-Nets' forward convs
conv1 to conv6 (3x3x3, between the entry conv and the upsampling layers)
that their bounds take: the sum of the bounds of the window's conv1 to
conv6 (``unet_layers``, each layer of each volume on its own) over the
program's ``unet.conv1`` ... ``unet.conv6`` layer timers summed over the
window's passes (the device time between CUDA events at the edges of each
layer, its bias add and ReLU included), in %. Layer: the cost regularisation
(``models/mvsnet.py``'s U-Net, cuDNN), in the MVSNet and CasMVSNet passes."""
from bench_torch import unet_layers


def read(run):
    return unet_layers.roofline_share(run, unet_layers.CONVS)

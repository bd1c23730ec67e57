"""Operations, bytes and bounds of each layer of the MVSNet and CasMVSNet
U-Nets, counted from the network's equations, not from any kernel.

A layer's Cost is ``mvs_roofline.stack_cost`` over that layer alone, at the
size its input has in the U-Net: 2 x its multiply-accumulates; bytes, its
input read and its output written (the skip sums, biases and ReLUs left
out, as the whole U-Net's count leaves them out). The layers of a
``cost_regularization`` list, taken in order, pass each its output's size
to the next, as the U-Net's wiring does (conv0 at the volume's size, conv1
to conv6 down to an eighth, conv7 to conv11 back up, ``prob`` at the
volume's size), so their operations sum to the whole U-Net's.

A pass of a cell builds one volume per reference view (MVSNet, at ``(D, H /
4, W / 4)`` of the crop) or three (CasMVSNet, one a stage at
``cas_roofline.stage_shapes``); ``pass_bound`` sums the bounds of the named
layers over them, each layer of each volume bounded on its own.
"""
from bench_torch import cas_roofline, roofline
from bench_torch.mvs_roofline import stack_cost
from bench_torch.reference.mvsnet import crop

# the forward convs between the entry conv and the upsampling layers
CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6")


def layer_costs(layers, size):
    """{name: Cost} of each layer of ``layers`` [name, in, out, kernel,
    stride, kind] on a volume of ``size`` (D, H, W)."""
    out = {}
    for layer in layers:
        out[layer[0]], size = stack_cost([layer], size, 3)
    return out


def pass_volumes(config, traffic):
    """[(layers, (D, h, w))] of the U-Net volumes of one pass of a cell of
    ``config`` (the ``mvsnet`` or ``casmvsnet`` configuration) and
    ``traffic``."""
    refs = len(range(*traffic["images_range"]))
    crop_shape = crop(traffic["height"], traffic["width"])[2:]
    if config["factory"] == "casmvsnet":
        stages = [(layers, (D, h, w)) for layers, (_, D, h, w) in zip(
            config["cost_regularization"],
            cas_roofline.stage_shapes(config, crop_shape))]
        return stages * refs
    h, w = (n // 4 for n in crop_shape)
    return [(config["cost_regularization"],
             (config["depth_planes"], h, w))] * refs


def pass_bound(config, traffic, names):
    """Seconds: the sum of the bounds of the layers ``names`` over the
    volumes of one pass."""
    precision = config["precision"]
    return sum(roofline.bound_seconds(cost, precision)
               for layers, size in pass_volumes(config, traffic)
               for name, cost in layer_costs(layers, size).items()
               if name in names)


def roofline_share(run, names):
    """The bound of the window's layers ``names`` over their summed
    ``unet.<name>`` timers in the window's passes, in %; None off the card
    or where no pass has the timers (a program without them)."""
    if run.device["platform"] != "gpu":
        return None
    labels = ["unet." + name for name in names]
    timed = [p for p in run.passes if all(lb in p.phases for lb in labels)]
    seconds = sum(p.phases[lb]["total_s"] for p in timed for lb in labels)
    if not timed or seconds <= 0:
        return None
    bound = pass_bound(run.config, run.traffic, names)
    return 100.0 * bound * len(timed) / seconds

"""CasMVSNet (Gu, Fan, Zhu, Dai, Tan and Tan, "Cascade Cost Volume for
High-Resolution Multi-View Stereo and Stereo Matching", CVPR 2020): its FPN
feature net, its three cost-regularisation U-Nets and the depth hypotheses
of its cascade.

The layers follow the authors' code, cascade-stereo
(``CasMVSNet/models/module.py``: ``FeatureNet`` in its "fpn" mode,
``CostRegNet``, ``Conv2d``, ``Conv3d``, ``Deconv3d``;
``CasMVSNet/models/cas_mvsnet.py``: ``CasMVSNet``), with its parameter
names, so that its state dicts load:

- ``FPNFeatureNet``, base width 8, "same" padding: conv0 = [3 -> 8, 8 -> 8]
  at 3x3; conv1 = [8 -> 16 at 5x5 / 2, 16 -> 16, 16 -> 16]; conv2 = [16 ->
  32 at 5x5 / 2, 32 -> 32, 32 -> 32]; each conv without a bias, then
  BatchNorm and ReLU. Stage 1's map is out1(conv2) (1x1, 32 -> 32, no
  bias) at a quarter of the image's resolution; f = nearest x2(conv2) +
  inner1(conv1) (1x1, 16 -> 32, with a bias) and stage 2's map out2(f)
  (3x3, 32 -> 16, no bias) at a half; f = nearest x2(f) + inner2(conv0)
  (1x1, 8 -> 32, with a bias) and stage 3's map out3(f) (3x3, 32 -> 8, no
  bias) at full resolution.
- ``cost_regularization``: one ``mvsnet.CostRegNet`` a stage, of 32, 16
  and 8 input channels, base 8, with cascade-stereo's ``Deconv3d`` (a
  transposed conv and its BatchNorm as ``.conv`` and ``.bn``) and a
  ``prob`` conv without a bias.

The cascade: stage s takes ``NDEPTHS[s]`` = 48 / 32 / 8 hypotheses
``INTERVAL_RATIOS[s]`` = 4 / 2 / 1 base intervals apart, the base interval
the depth range over ``NUM_DEPTH`` = 192, on feature maps ``STRIDES[s]`` =
4 / 2 / 1 pixels apart. Stage 1's hypotheses are planes uniform over the
depth range. A later stage's follow cascade-stereo's sequence: the
previous depth bilinearly up to the image's size, the hypotheses around it
(``get_cur_depth_range_samples``: ``cur - D / 2 i + k (D i / (D - 1))``),
then trilinearly down to the stage's maps, ``align_corners`` False. The
hypotheses are each pixel's depth plus offsets that every pixel shares, and
the trilinear resampling keeps the hypothesis axis and weighs pixels by
weights that sum to 1, so it resamples the depth alone: ``centre_depth``
(the depth up to the image, then down to the stage) and
``hypothesis_offsets`` give the same hypotheses up to rounding, without the
(D, H, W) volume at the image's size.

BatchNorm's eps is 1e-5. ``CasMVSNetModel`` binds the network to its
parameters for inference and runs every conv with its eval-mode BatchNorm
folded in (``mvsnet.fold``), each U-Net's entry conv as K6, each
transposed conv as K5 and each ``prob`` as K7; training and the network's
own ``forward`` keep the norms.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.generic_utils import resolve_device
from .cnn import FoldCache
from .feature_extractor import _as_float_tensor
from .mvsnet import (BN_EPS, ConvBnReLU, CostRegNet, fold, reset_parameters,
                     unet)

NDEPTHS = (48, 32, 8)
INTERVAL_RATIOS = (4, 2, 1)
STRIDES = (4, 2, 1)
NUM_DEPTH = 192


class Deconv3d(nn.Module):
    """cascade-stereo's ``Deconv3d``: a 3x3x3 transposed conv of stride 2
    without a bias (``.conv``), BatchNorm (``.bn``), ReLU: twice the
    input's size in every dim."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = nn.BatchNorm3d(cout, eps=BN_EPS)

    def layers(self):
        return self.conv, self.bn

    def forward(self, x, skip):
        """The layer, then the U-Net's skip sum, made in place."""
        return torch.relu(self.bn(self.conv(x))).add_(skip)


class FPNFeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8), ConvBnReLU(8, 8))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2),
                                   ConvBnReLU(16, 16), ConvBnReLU(16, 16))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2),
                                   ConvBnReLU(32, 32), ConvBnReLU(32, 32))
        self.out1 = nn.Conv2d(32, 32, 1, bias=False)
        self.inner1 = nn.Conv2d(16, 32, 1, bias=True)
        self.inner2 = nn.Conv2d(8, 32, 1, bias=True)
        self.out2 = nn.Conv2d(32, 16, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(32, 8, 3, padding=1, bias=False)

    def stages(self):
        """The layers in ``fpn``'s order: the 8 conv, norm, ReLU blocks,
        then out1, inner1, out2, inner2, out3."""
        return [*self.conv0, *self.conv1, *self.conv2, self.out1,
                self.inner1, self.out2, self.inner2, self.out3]

    def forward(self, x):
        return fpn(x, self.stages())


def fpn(x, layer):
    """The FPN's wiring over ``layer``, its 13 layers in ``stages()`` order
    as callables: (stage 1, stage 2, stage 3) maps of a (N, 3, H, W)
    batch."""
    c0 = layer[1](layer[0](x))
    c1 = layer[4](layer[3](layer[2](c0)))
    c2 = layer[7](layer[6](layer[5](c1)))
    out1 = layer[8](c2)
    f = layer[9](c1).add_(F.interpolate(c2, scale_factor=2, mode="nearest"))
    del c1, c2
    out2 = layer[10](f)
    f = layer[11](c0).add_(F.interpolate(f, scale_factor=2, mode="nearest"))
    del c0
    return out1, out2, layer[12](f)


class CasMVSNet(nn.Module):
    """The FPN and the three U-Nets under cascade-stereo's names
    (``feature.*``, ``cost_regularization.<stage>.*``); its optional
    refinement net is not part of it."""

    def __init__(self):
        super().__init__()
        self.feature = FPNFeatureNet()
        self.cost_regularization = nn.ModuleList(
            CostRegNet(c, prob_bias=False, deconv=Deconv3d)
            for c in (32, 16, 8))

    def reset_parameters(self, generator):
        reset_parameters(self, generator)


def hypothesis_offsets(depth_min, depth_max, stage):
    """(D,) float64 offsets of stage ``stage``'s (1 or 2) hypotheses from a
    pixel's centre depth: ``-D / 2 i + k (D i / (D - 1))``, k < D, i the
    stage's interval (``INTERVAL_RATIOS`` base intervals of
    (``depth_max`` - ``depth_min``) / ``NUM_DEPTH``)."""
    D = NDEPTHS[stage]
    interval = INTERVAL_RATIOS[stage] * (depth_max - depth_min) / NUM_DEPTH
    k = torch.arange(D, dtype=torch.float64)
    return -D / 2 * interval + k * (D * interval / (D - 1))


def centre_depth(depth, image_shape, stage):
    """(H / s, W / s) float32 centre depths of stage ``stage``'s
    hypotheses, s its stride: the previous stage's (h, w) ``depth``
    bilinearly up to the image's (H, W), then down to the stage's maps,
    ``align_corners`` False."""
    x = F.interpolate(depth[None, None], size=tuple(image_shape),
                      mode="bilinear", align_corners=False)
    s = STRIDES[stage]
    if s != 1:
        x = F.interpolate(x, size=(image_shape[0] // s, image_shape[1] // s),
                          mode="bilinear", align_corners=False)
    return x[0, 0]


class CasMVSNetModel:
    """``CasMVSNet`` bound to parameters for inference.

    ``state_dict``: the network's parameters (cascade-stereo's names);
    without it they are drawn from a ``torch.Generator`` seeded with
    ``seed``, on the CPU. ``predict`` gives the three feature maps of
    images, channels last; ``regularize`` a stage's logits of a cost
    volume. Both run the folded layers, kept as a ``cnn.FoldCache`` of
    every parameter and floating buffer of the network. Counters, over the
    object's calls: ``folded_layers``, layers run with a folded norm (8 an
    image, 10 a volume); ``fold_builds``, builds of the cache.
    """

    def __init__(self, state_dict=None, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.model = CasMVSNet()
        if state_dict is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.eval().to(self.device)
        self.folded_layers = 0
        self._fold = FoldCache()
        self._folded()

    @property
    def fold_builds(self):
        return self._fold.builds

    def _folded(self):
        """(the FPN's callables, [each stage's U-Net's callables])."""
        net = self.model
        tensors = list(net.parameters()) + [
            b for b in net.buffers() if b.is_floating_point()]
        return self._fold.get(tensors, lambda: (
            fold(net.feature.stages()),
            [fold(u.stages()) for u in net.cost_regularization]))

    @torch.no_grad()
    def predict(self, images):
        """images: (N, H, W, 3) uint8 (divided by 255 in float32 on the
        device) or float in [0, 1], H and W multiples of 4 -> the (N, H /
        4, W / 4, 32), (N, H / 2, W / 2, 16) and (N, H, W, 8) float32
        feature maps of the three stages on this model's device, channels
        last."""
        x = _as_float_tensor(images, self.device).permute(0, 3, 1, 2)
        x = x.contiguous()
        self.folded_layers += 8 * x.shape[0]
        return [m.permute(0, 2, 3, 1).contiguous()
                for m in fpn(x, self._folded()[0])]

    @torch.no_grad()
    def regularize(self, volume, stage, timer=None):
        """(1, 1, D, H, W) logits of stage ``stage``'s (1, C, D, H, W) cost
        volume; D, H and W multiples of 8; ``timer`` times each layer
        (``mvsnet.unet``)."""
        layers = self._folded()[1][stage]
        self.folded_layers += len(layers) - 1
        return unet(volume, layers, timer)


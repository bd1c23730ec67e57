"""MVSNet (Yao, Luo, Li, Fang and Quan, "MVSNet: Depth Inference for
Unstructured Multi-view Stereo", ECCV 2018): its feature net, its 3D
cost-regularisation U-Net and its soft-argmin depth regression.

The layers follow section 3 of the paper as the public PyTorch
reimplementation MVSNet_pytorch (``models/mvsnet.py``: ``FeatureNet``,
``CostRegNet``, ``depth_regression``) writes them, with its parameter
names, so that its state dicts load:

- ``MVSNetFeatureNet``, shared by the views, "same" padding: conv3x3 8,
  conv3x3 8, conv5x5/2 16, conv3x3 16, conv3x3 16, conv5x5/2 32,
  conv3x3 32, each conv without a bias and followed by BatchNorm and ReLU,
  then conv3x3 32 with a bias and neither: a 32-channel map at a quarter
  of the image's resolution.
- ``CostRegNet``, every layer 3x3x3 with BatchNorm and ReLU: c0 = conv(32
  -> 8); c2 = conv(16 -> 16)(conv/2(8 -> 16)(c0)); c4 = conv(32 -> 32)(
  conv/2(16 -> 32)(c2)); x = conv(64 -> 64)(conv/2(32 -> 64)(c4));
  x = c4 + deconv/2(64 -> 32)(x); x = c2 + deconv/2(32 -> 16)(x);
  x = c0 + deconv/2(16 -> 8)(x); then conv(8 -> 1) with a bias and
  neither: one logit per (plane, pixel).
- ``soft_argmin``: the softmax over the planes and the expected depth.

BatchNorm's eps is 1e-5. ``MVSNetModel`` binds the network to its
parameters for inference and runs every conv with its eval-mode BatchNorm
folded in (``cnn.fold_conv_norm``), so that no norm kernel runs. The
U-Net's entry conv c0 runs with its ReLU as one op, K6
(``ops.entry_conv3d``); its last conv ``prob`` with its bias (if any) as
one op, K7 (``ops.prob_conv3d``); another forward conv's ReLU stays its
own op; each transposed conv runs with its ReLU and skip sum as one op, K5
(``ops.transposed_conv3d``), which writes the result over the skip.
Training, and the network's own ``forward``, keep the norms.
"""
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.entry_conv3d import CHANNELS as K6_CHANNELS, entry_conv3d
from ..ops.prob_conv3d import CHANNELS as K7_CHANNELS, prob_conv3d
from ..ops.transposed_conv3d import transposed_conv3d
from ..utils.generic_utils import resolve_device
from .cnn import FoldCache, fold_conv_norm
from .feature_extractor import _as_float_tensor

BN_EPS = 1e-5


class ConvBnReLU(nn.Module):
    """A 2D or 3D conv without a bias ("same" padding), BatchNorm, ReLU."""

    def __init__(self, cin, cout, kernel=3, stride=1, dims=2):
        super().__init__()
        conv, norm = ((nn.Conv2d, nn.BatchNorm2d) if dims == 2
                      else (nn.Conv3d, nn.BatchNorm3d))
        self.conv = conv(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = norm(cout, eps=BN_EPS)

    def layers(self):
        return self.conv, self.bn

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class DeconvBnReLU(nn.Sequential):
    """A 3x3x3 transposed conv of stride 2 without a bias, BatchNorm, ReLU:
    twice the input's size in every dim (MVSNet_pytorch's ``nn.Sequential``
    of the three, hence the indices in its parameter names)."""

    def __init__(self, cin, cout):
        super().__init__(
            nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            nn.BatchNorm3d(cout, eps=BN_EPS), nn.ReLU())

    def layers(self):
        return self[0], self[1]

    def forward(self, x, skip):
        """The layer, then the U-Net's skip sum, made in place."""
        return super().forward(x).add_(skip)


class MVSNetFeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8)
        self.conv1 = ConvBnReLU(8, 8)
        self.conv2 = ConvBnReLU(8, 16, 5, 2)
        self.conv3 = ConvBnReLU(16, 16)
        self.conv4 = ConvBnReLU(16, 16)
        self.conv5 = ConvBnReLU(16, 32, 5, 2)
        self.conv6 = ConvBnReLU(32, 32)
        self.feature = nn.Conv2d(32, 32, 3, 1, 1)

    def stages(self):
        """The layers in order: the conv, norm, ReLU blocks, then the last
        conv."""
        return [self.conv0, self.conv1, self.conv2, self.conv3, self.conv4,
                self.conv5, self.conv6, self.feature]

    def forward(self, x):
        for layer in self.stages():
            x = layer(x)
        return x


class CostRegNet(nn.Module):
    """The U-Net of a volume of ``in_channels``; ``prob_bias``: whether its
    last conv has a bias; ``deconv``: the class of its upsampling blocks,
    ``deconv(cin, cout)``. The defaults are MVSNet's."""

    def __init__(self, in_channels=32, prob_bias=True, deconv=DeconvBnReLU):
        super().__init__()
        self.conv0 = ConvBnReLU(in_channels, 8, dims=3)
        self.conv1 = ConvBnReLU(8, 16, stride=2, dims=3)
        self.conv2 = ConvBnReLU(16, 16, dims=3)
        self.conv3 = ConvBnReLU(16, 32, stride=2, dims=3)
        self.conv4 = ConvBnReLU(32, 32, dims=3)
        self.conv5 = ConvBnReLU(32, 64, stride=2, dims=3)
        self.conv6 = ConvBnReLU(64, 64, dims=3)
        self.conv7 = deconv(64, 32)
        self.conv9 = deconv(32, 16)
        self.conv11 = deconv(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, stride=1, padding=1, bias=prob_bias)

    def stages(self):
        return [self.conv0, self.conv1, self.conv2, self.conv3, self.conv4,
                self.conv5, self.conv6, self.conv7, self.conv9, self.conv11,
                self.prob]

    def forward(self, x):
        return unet(x, self.stages())


# the U-Net's layers in ``stages()`` order under MVSNet_pytorch's module
# names: the labels of their timers
UNET_LABELS = tuple("unet." + name for name in (
    "conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "conv7",
    "conv9", "conv11", "prob"))


def _timed(timer, label, call):
    def timed(*args):
        with timer.layer(label):
            return call(*args)

    return timed


def unet(x, layer, timer=None):
    """The U-Net's wiring over ``layer``, its 11 layers in ``stages()``
    order as callables: (1, 1, D, H, W) logits of a (1, 32, D, H, W) cost
    volume. The three upsampling layers (7-9) take the skip too, ``(x,
    skip)``, and return their output plus the skip, made in place (the
    modules in their output, the folded layers over the skip). With a
    ``utils.profiling.PhaseTimer``, each layer runs under its
    ``timer.layer`` of ``UNET_LABELS``."""
    if timer is not None:
        layer = [_timed(timer, label, call)
                 for label, call in zip(UNET_LABELS, layer)]
    c0 = layer[0](x)
    del x
    c2 = layer[2](layer[1](c0))
    c4 = layer[4](layer[3](c2))
    x = layer[6](layer[5](c4))
    x = layer[7](x, c4)
    del c4
    x = layer[8](x, c2)
    del c2
    x = layer[9](x, c0)
    del c0
    return layer[10](x)


class MVSNet(nn.Module):
    """The feature net and the cost regularisation, under MVSNet_pytorch's
    names (``feature.*``, ``cost_regularization.*``); the refinement net of
    the paper's section 3.4 is not part of it."""

    def __init__(self):
        super().__init__()
        self.feature = MVSNetFeatureNet()
        self.cost_regularization = CostRegNet()

    def reset_parameters(self, generator):
        reset_parameters(self, generator)


def reset_parameters(net, generator):
    """He-uniform kernels (bound sqrt(6 / fan_in), the fan-in of a stride-2
    transposed conv's output taken as in x 27 / 8), zero biases and
    BatchNorm at its defaults, drawn from ``generator``, for every layer
    of ``net``."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                w = m.weight
                fan_in = math.prod(w.shape[1:])
                if m.transposed:
                    fan_in = w.shape[0] * math.prod(w.shape[2:]) / 8
                bound = math.sqrt(6.0 / fan_in)
                w.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()


def soft_argmin(logits, depths):
    """(H, W) expected depth of (1, 1, D, H, W) logits: the softmax over
    the D hypotheses, then the sum of ``depths`` weighted by it, (D,) plane
    depths or (D, H, W) depths of each pixel's own hypotheses."""
    prob = torch.softmax(logits[0, 0], dim=0)
    if depths.dim() == 1:
        depths = depths[:, None, None]
    return (prob * depths).sum(dim=0)


def _folded_call(module, weight, bias):
    """A callable that runs ``module`` (a conv, norm, ReLU block or a plain
    conv) with the folded ``weight`` and ``bias``: the conv, then the ReLU
    where the block has a norm. A transposed conv's block (``DeconvBnReLU``:
    3x3x3, stride 2, padding 1, output padding 1) runs as K5,
    ``call(x, skip)``, its ReLU and skip sum in the kernel. A 3D block of a
    3x3x3 conv of stride 1 from one of K6's channel pairs
    (``entry_conv3d.CHANNELS``: the U-Net's c0, and no other layer of
    either U-Net) runs as K6, its ReLU in the kernel. A plain 3x3x3 conv of
    stride 1 from K7's channel pair (``prob_conv3d.CHANNELS``: 8 -> 1, the
    U-Net's prob, and no other layer of either network) runs as K7, its
    bias, if any, in the kernel."""
    conv = module.layers()[0] if hasattr(module, "layers") else module
    relu = conv is not module
    if conv.transposed:
        def upsample(x, skip):
            return transposed_conv3d(x, weight, bias, skip)

        return upsample
    same = (conv.kernel_size == (3, 3, 3) and conv.stride == (1, 1, 1)
            and conv.padding == (1, 1, 1))
    pair = (conv.in_channels, conv.out_channels)
    if relu and same and pair in K6_CHANNELS:
        def entry(x):
            return entry_conv3d(x, weight, bias)

        return entry
    if not relu and same and pair in K7_CHANNELS:
        def prob(x):
            return prob_conv3d(x, weight, bias)

        return prob
    op = functools.partial(F.conv2d if weight.dim() == 4 else F.conv3d,
                           stride=conv.stride, padding=conv.padding)

    def call(x):
        y = op(x, weight, bias)
        return torch.relu_(y) if relu else y

    return call


def fold(stages):
    """One callable per layer of ``stages``, each block's eval-mode
    BatchNorm folded into its conv (``cnn.fold_conv_norm``); a plain conv
    keeps its own weight and bias (or none)."""
    out = []
    for m in stages:
        if hasattr(m, "layers"):
            weight, bias = fold_conv_norm(*m.layers())
        else:
            weight = m.weight.detach()
            bias = None if m.bias is None else m.bias.detach()
        out.append(_folded_call(m, weight, bias))
    return out


class MVSNetModel:
    """``MVSNet`` bound to parameters for inference.

    ``state_dict``: the network's parameters (MVSNet_pytorch's names);
    without it they are drawn from a ``torch.Generator`` seeded with
    ``seed``, on the CPU. ``predict`` gives the features of images,
    channels last; ``regularize`` the plane logits of a cost volume. Both
    run the folded layers (``fold``), kept as a ``cnn.FoldCache`` of every
    parameter and floating buffer of the network. Counters, over the
    object's calls: ``folded_layers``, layers run with a folded norm (7 an
    image, 10 a volume); ``fold_builds``, builds of the cache.
    """

    def __init__(self, state_dict=None, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.model = MVSNet()
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
        """(feature net's callables, U-Net's callables)."""
        net = self.model
        tensors = list(net.parameters()) + [
            b for b in net.buffers() if b.is_floating_point()]
        return self._fold.get(tensors, lambda: (
            fold(net.feature.stages()),
            fold(net.cost_regularization.stages())))

    @torch.no_grad()
    def predict(self, images):
        """images: (N, H, W, 3) uint8 (divided by 255 in float32 on the
        device) or float in [0, 1], H and W multiples of 4 -> (N, H / 4,
        W / 4, 32) float32 features on this model's device, channels
        last."""
        x = _as_float_tensor(images, self.device).permute(0, 3, 1, 2)
        x = x.contiguous()
        layers = self._folded()[0]
        for call in layers:
            x = call(x)
        self.folded_layers += (len(layers) - 1) * x.shape[0]
        return x.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def regularize(self, volume, timer=None):
        """(1, 1, D, H, W) plane logits of a (1, 32, D, H, W) cost volume;
        D, H and W multiples of 8; ``timer`` times each layer (``unet``)."""
        layers = self._folded()[1]
        self.folded_layers += len(layers) - 1
        return unet(volume, layers, timer)

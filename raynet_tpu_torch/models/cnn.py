"""Multi-view CNN feature extractors and similarity heads, as torch modules.

Port of ``raynet_tpu/models/cnn.py``: all-VALID conv stacks with 32 filters
and a normalisation after every conv (BatchNorm with eps 1e-3, or the
package's LayerNormalization); the LAST layer has no activation. Receptive
fields:

    simple_cnn / simple_cnn_ln          5 x (3x3)            rf = 11
    dilated_cnn_receptive_field_25(*)   5,5,5(d=2),3,3,3,3   rf = 25
    hartmann_cnn                        conv5-tanh-pool x 2

and the similarity heads of pretraining (``:135-236``): ``Reducer``,
``MultiViewSimilarityNet`` and ``HartmannSimilarityNet``, with ``get_nn``.
The modules take and return NCHW (one patch or image per batch entry);
FeatureExtractor, HartmannModel and the training steps keep the JAX
layout, channels last, at their public interfaces.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNormalization


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's training semantics; eval mode is torch's.

    In training it normalises with the batch's biased variance, computed
    as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), and updates the
    running statistics with that same biased variance:
    ``stat = momentum * stat + (1 - momentum) * batch`` with flax's momentum
    0.99. ``nn.BatchNorm2d`` would store the unbiased variance, n / (n - 1)
    times larger.

    ``sum_over_ranks``: where a batch is split over the ranks of a ray
    group, a callable that sums a tensor over the ranks with its gradient
    (``parallel.sharding.all_reduce_sum``); the statistics are then those
    of all ranks' inputs: the per-channel sums of x and x^2 and the count,
    summed in float64 over the ranks.
    """

    sum_over_ranks = None

    def __init__(self, channels, eps=1e-3, flax_momentum=0.99):
        super().__init__(channels, eps=eps, momentum=1.0 - flax_momentum)
        self.flax_momentum = flax_momentum

    def _global_moments(self, x):
        """(E[x], E[x^2]) per channel over every rank's x."""
        c = x.shape[1]
        sums = self.sum_over_ranks(torch.cat([
            x.sum(dim=(0, 2, 3)).double(), (x * x).sum(dim=(0, 2, 3)).double(),
            x.new_full((1,), x.numel() // c, dtype=torch.float64)]))
        return ((sums[:c] / sums[-1]).to(x.dtype),
                (sums[c:2 * c] / sums[-1]).to(x.dtype))

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sum_over_ranks is None:
            mean = x.mean(dim=(0, 2, 3))
            sq = (x * x).mean(dim=(0, 2, 3))
        else:
            mean, sq = self._global_moments(x)
        var = torch.clamp(sq - mean * mean, min=0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


def lecun_normal_(weight, generator):
    """flax's default conv kernel initialiser, drawn from ``generator``: a
    normal truncated at two standard deviations, variance 1 / fan_in."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    # 0.8796...: the standard deviation of a unit normal truncated at +-2
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class ConvBNStack(nn.Module):
    """Conv -> norm (-> activation) stack; no activation after the last."""

    def __init__(self, layer_specs, in_channels=3, activation="relu",
                 norm="batch"):
        super().__init__()
        self.activation = activation
        convs, norms = [], []
        c = in_channels
        for filters, kernel, dilation in layer_specs:
            convs.append(
                nn.Conv2d(c, filters, kernel, padding=0, dilation=dilation)
            )
            if norm == "batch":
                norms.append(BatchNorm2d(filters))
            elif norm == "layer":
                norms.append(LayerNormalization(filters))
            else:
                raise ValueError("unknown norm %r" % (norm,))
            c = filters
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def reset_parameters(self, generator):
        """Glorot-uniform kernels and zero biases, as flax initialises
        them, drawn from ``generator``."""
        with torch.no_grad():
            for conv in self.convs:
                nn.init.xavier_uniform_(conv.weight, generator=generator)
                conv.bias.zero_()

    def forward(self, x):
        act = torch.relu if self.activation == "relu" else torch.tanh
        n = len(self.convs)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = norm(conv(x))
            if i < n - 1:
                x = act(x)
        return x

    def forward_folded(self, x, params):
        """The stack from ``fold_batch_norm(self)``'s (weight, bias) pairs:
        each conv with its norm folded in, then the activation (none after
        the last); no norm runs."""
        act = torch.relu if self.activation == "relu" else torch.tanh
        n = len(params)
        for i, (conv, (weight, bias)) in enumerate(zip(self.convs, params)):
            x = F.conv2d(x, weight, bias, conv.stride, conv.padding,
                         conv.dilation, conv.groups)
            if i < n - 1:
                x = act(x)
        return x


def folds(module):
    """Whether ``fold_batch_norm`` takes ``module``: an eval-mode ConvBNStack
    whose norms are all BatchNorm2d. LayerNormalization, and a norm in
    training mode, take statistics of each input and do not fold."""
    return (isinstance(module, ConvBNStack) and not module.training
            and all(isinstance(n, BatchNorm2d) for n in module.norms))


def fold_inputs(stack):
    """The tensors ``fold_batch_norm`` reads, six a layer: the conv's weight
    and bias, the norm's weight, bias, running mean and running variance."""
    return [t for conv, norm in zip(stack.convs, stack.norms)
            for t in (conv.weight, conv.bias, norm.weight, norm.bias,
                      norm.running_mean, norm.running_var)]


def fold_batch_norm(stack):
    """One (weight, bias) per layer of a stack that ``folds``, its
    eval-mode BatchNorm folded into the conv.

    With s = gamma / sqrt(running_var + eps): W' = W s and
    b' = (b - running_mean) s + beta, computed in float64 and cast to the
    conv's dtype."""
    tensors = fold_inputs(stack)
    params = []
    with torch.no_grad():
        for i, norm in enumerate(stack.norms):
            w, b, gamma, beta, mean, var = (
                t.double() for t in tensors[6 * i:6 * i + 6])
            scale = gamma * torch.rsqrt(var + norm.eps)
            weight = w * scale[:, None, None, None]
            bias = (b - mean) * scale + beta
            dtype = tensors[6 * i].dtype
            params.append((weight.to(dtype), bias.to(dtype)))
    return params


class HartmannCNN(nn.Module):
    """conv5(32)-tanh-maxpool2, conv5(64)-tanh-maxpool2, VALID: the Hartmann
    et al. baseline's feature net (``raynet_tpu/models/cnn.py:98``)."""

    def __init__(self, in_channels=3):
        super().__init__()
        self.convs = nn.ModuleList(
            [nn.Conv2d(in_channels, 32, 5), nn.Conv2d(32, 64, 5)]
        )

    def reset_parameters(self, generator):
        """flax's defaults (lecun-normal kernels, zero biases), drawn from
        ``generator``."""
        with torch.no_grad():
            for conv in self.convs:
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()

    def forward(self, x):
        for conv in self.convs:
            x = F.max_pool2d(torch.tanh(conv(x)), 2, 2)
        return x


_SIMPLE_SPECS = [(32, 3, 1)] * 5
_DILATED_SPECS = [
    (32, 5, 1),
    (32, 5, 1),
    (32, 5, 2),
    (32, 3, 1),
    (32, 3, 1),
    (32, 3, 1),
    (32, 3, 1),
]

_CNN_FACTORIES = {
    "simple_cnn": dict(layer_specs=_SIMPLE_SPECS),
    "simple_cnn_ln": dict(layer_specs=_SIMPLE_SPECS, norm="layer"),
    "dilated_cnn_receptive_field_25": dict(layer_specs=_DILATED_SPECS),
    "dilated_cnn_receptive_field_25_with_tanh": dict(
        layer_specs=_DILATED_SPECS, activation="tanh"
    ),
    "hartmann_cnn": None,
}

# Receptive field minus 1: how much a VALID stack shrinks each spatial dim.
CNN_SHRINKAGE = {
    "simple_cnn": 10,
    "simple_cnn_ln": 10,
    "dilated_cnn_receptive_field_25": 24,
    "dilated_cnn_receptive_field_25_with_tanh": 24,
    "hartmann_cnn": None,  # pooling: not a pure shrink
}

# the JAX package's flax class of each factory: the name of its subtree in
# a flax parameter tree
FLAX_CLASS = {
    "simple_cnn": "SimpleCNN",
    "simple_cnn_ln": "SimpleCNNLN",
    "dilated_cnn_receptive_field_25": "DilatedCNN25",
    "dilated_cnn_receptive_field_25_with_tanh": "DilatedCNN25Tanh",
    "hartmann_cnn": "HartmannCNN",
}


def cnn_factory(name):
    """A constructor ``(in_channels=3) -> nn.Module`` for ``name``: a
    ConvBNStack, or HartmannCNN for ``hartmann_cnn``."""
    if name not in _CNN_FACTORIES:
        raise KeyError("unknown cnn %r (have: %s)"
                       % (name, ", ".join(sorted(_CNN_FACTORIES))))
    spec = _CNN_FACTORIES[name]
    if spec is None:
        return HartmannCNN

    def make(in_channels=3):
        return ConvBNStack(in_channels=in_channels, **spec)

    return make


def cnn_output_padding(name):
    """Receptive-field shrink of a stack; the ``padding`` generation
    parameter must equal shrink + 1 for the feature-map indexing to line
    up."""
    return CNN_SHRINKAGE[name]


class Reducer(nn.Module):
    """Reduce the pair axis (last) of (B, D, N) similarity scores: the
    average, the max, or the average of the top ``k``."""

    def __init__(self, kind="average", k=3):
        super().__init__()
        if kind not in ("average", "max", "topK"):
            raise ValueError("unknown reducer %r" % (kind,))
        self.kind = kind
        self.k = k

    def forward(self, x):
        if self.kind == "average":
            return x.mean(dim=-1)
        if self.kind == "max":
            return x.max(dim=-1).values
        return torch.sort(x, dim=-1).values[..., -self.k:].mean(dim=-1)


class MultiViewSimilarityNet(nn.Module):
    """Siamese patch-similarity network of MVCNN pretraining.

    ``x1``, ``x2``: (B, D, N, C, Hp, Wp) patch stacks (D depth hypotheses,
    N view pairs). Both go through one shared CNN, are flattened channels
    last as the JAX package flattens them, dotted per pair (or compared by
    cosine similarity), reduced over N and softmaxed over D -> (B, D).
    """

    def __init__(self, cnn_name="simple_cnn", reducer="average",
                 merge_layer="dot-product", top_k=3, in_channels=3):
        super().__init__()
        if merge_layer not in ("dot-product", "cosine-similarity"):
            raise ValueError("unknown merge layer %r" % (merge_layer,))
        self.cnn_name = cnn_name
        self.merge_layer = merge_layer
        self.cnn = cnn_factory(cnn_name)(in_channels)
        self.reducer = Reducer(reducer, top_k)

    def reset_parameters(self, generator):
        self.cnn.reset_parameters(generator)

    def _embed(self, x):
        b, d, n = x.shape[:3]
        f = self.cnn(x.reshape((-1,) + x.shape[3:]))
        if f.shape[2] * f.shape[3] == 0:
            raise ValueError("patch %r is smaller than the %s receptive field"
                             % (tuple(x.shape[4:6]), self.cnn_name))
        return f.permute(0, 2, 3, 1).reshape(b, d, n, -1)

    def forward(self, x1, x2):
        f1, f2 = self._embed(x1), self._embed(x2)
        if self.merge_layer == "cosine-similarity":
            f1 = f1 / torch.linalg.norm(f1, dim=-1, keepdim=True)
            f2 = f2 / torch.linalg.norm(f2, dim=-1, keepdim=True)
        sims = (f1 * f2).sum(dim=-1)
        return torch.softmax(self.reducer(sims), dim=-1)


class HartmannSimilarityNet(nn.Module):
    """Hartmann et al. baseline: the mean of the V patch embeddings, then
    conv5(2048), relu, conv1(2048), relu, conv1(2) and a softmax over the
    channels.

    ``patches``: (B, V, C, ph, pw) -> (B, 2, h', w') match probabilities.
    Patches under 32x32 leave the head no 5x5 input and raise.
    """

    def __init__(self, in_channels=3):
        super().__init__()
        self.cnn = HartmannCNN(in_channels)
        self.head = nn.ModuleList([
            nn.Conv2d(64, 2048, 5), nn.Conv2d(2048, 2048, 1),
            nn.Conv2d(2048, 2, 1),
        ])

    def reset_parameters(self, generator):
        self.cnn.reset_parameters(generator)
        with torch.no_grad():
            for conv in self.head:
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()

    def forward(self, patches):
        b, v = patches.shape[:2]
        f = self.cnn(patches.reshape((b * v,) + patches.shape[2:]))
        f = f.reshape((b, v) + f.shape[1:]).mean(dim=1)
        if f.shape[2] < 5 or f.shape[3] < 5:
            raise ValueError(
                "hartmann patches must be at least 32x32 (similarity head "
                "got %r feature maps)" % (tuple(f.shape[2:4]),)
            )
        x = torch.relu(self.head[0](f))
        x = torch.relu(self.head[1](x))
        return torch.softmax(self.head[2](x), dim=1)


def get_nn(name):
    """The network constructor registered under ``name``."""
    nets = {
        "simple_cnn": lambda **kw: cnn_factory(
            kw.pop("cnn_name", "simple_cnn")
        )(**kw),
        "simple_nn_for_training": MultiViewSimilarityNet,
        "hartmann": HartmannSimilarityNet,
    }
    return nets[name]

"""Multi-view CNN feature extractors, as torch modules.

Port of ``raynet_tpu/models/cnn.py:24-95``: all-VALID conv stacks with 32
filters and a normalisation after every conv (BatchNorm in eval mode with
eps 1e-3, or the package's LayerNormalization); the LAST layer has no
activation. Receptive fields:

    simple_cnn / simple_cnn_ln          5 x (3x3)            rf = 11
    dilated_cnn_receptive_field_25(*)   5,5,5(d=2),3,3,3,3   rf = 25

The modules take and return NCHW; FeatureExtractor keeps the JAX layout
(V, H, W, C) at its public interface. ``hartmann_cnn`` is not ported yet.
"""
import torch
from torch import nn

from .layers import LayerNormalization


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
                # flax momentum 0.99 on the running stats = torch 0.01
                norms.append(nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01))
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
}

# Receptive field minus 1: how much a VALID stack shrinks each spatial dim.
CNN_SHRINKAGE = {
    "simple_cnn": 10,
    "simple_cnn_ln": 10,
    "dilated_cnn_receptive_field_25": 24,
    "dilated_cnn_receptive_field_25_with_tanh": 24,
}


def cnn_factory(name):
    """A constructor ``(in_channels=3) -> ConvBNStack`` for ``name``."""
    if name not in _CNN_FACTORIES:
        raise KeyError("cnn %r is not ported (have: %s)"
                       % (name, ", ".join(sorted(_CNN_FACTORIES))))
    spec = _CNN_FACTORIES[name]

    def make(in_channels=3):
        return ConvBNStack(in_channels=in_channels, **spec)

    return make

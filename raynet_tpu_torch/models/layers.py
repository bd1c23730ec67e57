"""The JAX package's LayerNormalization, as a torch module.

Port of ``raynet_tpu/models/layers.py:11-30`` (itself raynet/layers.py):
statistics over every axis except the batch axis, denominator
``std + eps`` (NOT ``sqrt(var + eps)``), a scalar gamma and a per-channel
bias. It is not ``nn.LayerNorm``, which differs in all three.
"""
import torch
from torch import nn


class LayerNormalization(nn.Module):
    """Per-sample normalisation of NCHW tensors over (C, H, W)."""

    def __init__(self, channels, epsilon=1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(1, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        axes = tuple(range(1, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        std = x.std(dim=axes, keepdim=True, unbiased=False) + self.epsilon
        return self.gamma * (x - mean) / std + self.bias[None, :, None, None]

"""The JAX package's LayerNormalization, as a torch module, and its masked
softmax.

Port of ``raynet_tpu/models/layers.py`` (itself raynet/layers.py). The
layer norm takes statistics over every axis except the batch axis, divides
by ``std + eps`` (NOT ``sqrt(var + eps)``), and has a scalar gamma and a
per-channel bias. It is not ``nn.LayerNorm``, which differs in all three.
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


def masked_softmax(x, valid_counts):
    """Softmax over the first ``valid_counts[i]`` entries of each row of
    ``x`` (B, M); entries past the count get probability 0. Port of
    ``raynet_tpu/models/layers.py:33``."""
    m = x.shape[-1]
    mask = (torch.arange(m, device=x.device)[None, :]
            < valid_counts.to(x.device)[:, None])
    masked = torch.where(mask, x, torch.finfo(x.dtype).min)
    mx = masked.max(dim=-1, keepdim=True).values
    e = torch.exp(x - mx) * mask
    return e / e.sum(dim=-1, keepdim=True)

"""K6: the U-Net's entry layer, and its plain version.

``entry_conv3d(x, weight, bias)`` computes

    relu(conv3d(x, weight, bias, stride=1, padding=1))

for a 3x3x3 kernel from Cin channels to 8, the cost-regularisation
U-Net's conv0 (c0) in MVSNet and in each CasMVSNet stage, with its
eval-mode BatchNorm folded into ``weight`` and ``bias``
(``models.cnn.fold_conv_norm``). The output is a new tensor.

CUDA tensors run the CUDA kernel ``csrc/entry_conv3d.cu``, CPU tensors
``entry_conv3d_reference``: plain PyTorch that takes the kernel's steps in
the kernel's order. Each output sums, input channel by input channel, its
27 taps in (kd, kh, kw) order on the input padded by one zero in every
dim; then the bias and the ReLU follow. The kernel sums by fused
multiply-adds, the plain version by a product and an add, so the two
differ by float32 rounding.

The kernel is built for the (Cin, Cout) pairs of the U-Nets' entry layers
alone (``CHANNELS``), on contiguous float32 tensors; both versions refuse
anything else, so the CPU and the card take the same layers.
"""
import itertools

import torch
import torch.nn.functional as F

from . import cuda_build

# the (Cin, Cout) pairs of the entry layers: MVSNet's and CasMVSNet's first
# stage, its second, its third
CHANNELS = ((32, 8), (16, 8), (8, 8))


def _check(x, weight, bias):
    """Raise ValueError unless the shapes are a layer the kernel takes;
    (Cin, Cout, D, H, W)."""
    op = "entry_conv3d"
    if x.dim() != 5 or x.shape[0] != 1:
        raise ValueError("%s: x must be (1, Cin, D, H, W), got %s"
                         % (op, tuple(x.shape)))
    _, cin, D, H, W = x.shape
    if weight.dim() != 5 or tuple(weight.shape[2:]) != (3, 3, 3) \
            or weight.shape[1] != cin:
        raise ValueError("%s: weight must be (Cout, %d, 3, 3, 3), got %s"
                         % (op, cin, tuple(weight.shape)))
    cout = weight.shape[0]
    if (cin, cout) not in CHANNELS:
        raise ValueError("%s: no kernel for %d -> %d channels (it takes %s)"
                         % (op, cin, cout, ", ".join(
                             "%d -> %d" % p for p in CHANNELS)))
    if tuple(bias.shape) != (cout,):
        raise ValueError("%s: bias must be (%d,), got %s"
                         % (op, cout, tuple(bias.shape)))
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise ValueError("%s: %s must be float32, got %s"
                             % (op, name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (op, name))
    return cin, cout, D, H, W


def entry_conv3d_reference(x, weight, bias):
    """Plain PyTorch K6: each output's sums, input channel by input
    channel and tap by tap, then the bias and the ReLU."""
    cin, cout, D, H, W = _check(x, weight, bias)
    xp = F.pad(x[0], (1, 1, 1, 1, 1, 1))
    acc = x.new_zeros((cout, D, H, W))
    for ci in range(cin):
        for kd, kh, kw in itertools.product(range(3), repeat=3):
            acc += (weight[:, ci, kd, kh, kw, None, None, None]
                    * xp[ci, kd:kd + D, kh:kh + H, kw:kw + W])
    return torch.relu_(acc.add_(bias[:, None, None, None]))[None]


def _entry_conv3d_cuda(x, weight, bias):
    cin, cout, D, H, W = _check(x, weight, bias)
    op = "entry_conv3d"
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device:
            raise ValueError("%s: %s is on %s, x on %s"
                             % (op, name, t.device, x.device))
    if H * W >= 1 << 31:
        raise ValueError("%s: a plane must hold fewer than 2**31 values" % op)
    y = torch.empty((1, cout, D, H, W), dtype=torch.float32, device=x.device)
    cuda_build.launch("raynet_entry_conv3d", x, x.data_ptr(),
                      weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                      cin, cout, D, H, W)
    entry_conv3d.launches += 1
    return y


def entry_conv3d(x, weight, bias):
    """The U-Net's entry layer with its ReLU.

    Arguments
    ---------
        x: (1, Cin, D, H, W) float32 input, NCDHW
        weight: (Cout, Cin, 3, 3, 3) float32 conv weight, the BatchNorm
            folded in; (Cin, Cout) one of ``CHANNELS``
        bias: (Cout,) float32

    Returns (1, Cout, D, H, W) float32.
    """
    if cuda_build.on_cuda("entry_conv3d", x):
        return _entry_conv3d_cuda(x, weight, bias)
    return entry_conv3d_reference(x, weight, bias)


# Kernel launches since the last reset (the plain path never counts).
entry_conv3d.launches = 0

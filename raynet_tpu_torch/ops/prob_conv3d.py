"""K7: the U-Net's last layer, and its plain version.

``prob_conv3d(x, weight, bias)`` computes

    conv3d(x, weight, bias, stride=1, padding=1)

for a 3x3x3 kernel from 8 channels to 1, the cost-regularisation U-Net's
``prob`` in MVSNet (with a bias) and in each CasMVSNet stage (without):
one logit per (plane, pixel). No activation follows. The output is a new
tensor.

CUDA tensors run the CUDA kernel ``csrc/prob_conv3d.cu``, CPU tensors
``prob_conv3d_reference``: plain PyTorch that takes the kernel's steps in
the kernel's order. The kernel streams the volume along D, so each output
sums its taps input plane by input plane (kd), in each plane channel by
channel, in each channel in (kh, kw) order, on the input padded by one
zero in every dim; then the bias follows. The kernel sums by fused
multiply-adds, the plain version by a product and an add, so the two
differ by float32 rounding.

The kernel is built for 8 input channels and 1 output channel alone
(``CHANNELS``), on contiguous float32 tensors whose W is a multiple of 4
(the U-Nets' volumes are 8 times as wide as their deepest level); both
versions refuse anything else, so the CPU and the card take the same
layers. The card also wants x to start on 16 bytes, as every fresh
tensor does.
"""
import itertools

import torch
import torch.nn.functional as F

from . import cuda_build

# the (Cin, Cout) pair of the U-Nets' prob layer
CHANNELS = ((8, 1),)


def _check(x, weight, bias):
    """Raise ValueError unless the shapes are a layer the kernel takes;
    (Cin, Cout, D, H, W)."""
    op = "prob_conv3d"
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
    if W % 4:
        raise ValueError("%s: W must be a multiple of 4 (the kernel copies "
                         "rows by float4s), got %d" % (op, W))
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError("%s: bias must be (%d,), got %s"
                         % (op, cout, tuple(bias.shape)))
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError("%s: %s must be float32, got %s"
                             % (op, name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (op, name))
    return cin, cout, D, H, W


def prob_conv3d_reference(x, weight, bias=None):
    """Plain PyTorch K7: each output's sums, tap plane by tap plane,
    channel by channel and tap by tap, then the bias."""
    cin, cout, D, H, W = _check(x, weight, bias)
    xp = F.pad(x[0], (1, 1, 1, 1, 1, 1))
    acc = x.new_zeros((D, H, W))
    for kd in range(3):
        for ci in range(cin):
            for kh, kw in itertools.product(range(3), repeat=2):
                acc += (weight[0, ci, kd, kh, kw]
                        * xp[ci, kd:kd + D, kh:kh + H, kw:kw + W])
    if bias is not None:
        acc += bias[0]
    return acc[None, None]


def _prob_conv3d_cuda(x, weight, bias):
    cin, cout, D, H, W = _check(x, weight, bias)
    op = "prob_conv3d"
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError("%s: %s is on %s, x on %s"
                             % (op, name, t.device, x.device))
    if H * W >= 1 << 31:
        raise ValueError("%s: a plane must hold fewer than 2**31 values" % op)
    if x.data_ptr() % 16:
        raise ValueError("%s: x must start on 16 bytes" % op)
    y = torch.empty((1, cout, D, H, W), dtype=torch.float32, device=x.device)
    cuda_build.launch("raynet_prob_conv3d", x, x.data_ptr(),
                      weight.data_ptr(),
                      0 if bias is None else bias.data_ptr(), y.data_ptr(),
                      cin, cout, D, H, W)
    prob_conv3d.launches += 1
    return y


def prob_conv3d(x, weight, bias=None):
    """The U-Net's last layer: one logit per (plane, pixel).

    Arguments
    ---------
        x: (1, 8, D, H, W) float32 input, NCDHW
        weight: (1, 8, 3, 3, 3) float32 conv weight
        bias: (1,) float32, or None for none

    Returns (1, 1, D, H, W) float32.
    """
    if cuda_build.on_cuda("prob_conv3d", x):
        return _prob_conv3d_cuda(x, weight, bias)
    return prob_conv3d_reference(x, weight, bias)


# Kernel launches since the last reset (the plain path never counts).
prob_conv3d.launches = 0

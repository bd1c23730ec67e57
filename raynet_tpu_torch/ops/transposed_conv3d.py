"""K5: MVSNet's upsampling layer, and its plain version.

``transposed_conv3d(x, weight, bias, skip)`` computes

    skip <- relu(conv_transpose3d(x, weight, bias, stride=2, padding=1,
                                  output_padding=1)) + skip

for a 3x3x3 kernel, the U-Net's conv7, conv9 and conv11 with their
eval-mode BatchNorm folded into ``weight`` and ``bias``
(``models.cnn.fold_conv_norm``), and the skip sum that follows each of
them. The result is written over the skip tensor's storage, which the U-Net
drops right after, and ``skip`` is returned: no output is allocated.

CUDA tensors run the CUDA kernel ``csrc/transposed_conv3d.cu``, CPU tensors
``transposed_conv3d_reference``: plain PyTorch that takes the kernel's
steps in the kernel's order. Per dim, an even output 2m takes tap 1 of
input m, an odd output 2m + 1 takes tap 0 of input m + 1 (none past the
input's last) and tap 2 of input m (``TAPS``). So the outputs fall into 8
parity classes; each sums, input channel by input channel, its taps in
``TAPS`` order, and then the bias, the ReLU and the skip follow. The kernel
sums by fused multiply-adds, the plain version by a product and an add, so
the two differ by float32 rounding.

The kernel is built for the (Cin, Cout) pairs of MVSNet's U-Net alone
(``CHANNELS``); both versions refuse any other pair, so the CPU and the
card take the same layers.
"""
import itertools

import torch
import torch.nn.functional as F

from . import cuda_build

# the (Cin, Cout) pairs of the U-Net's upsampling layers, c7, c9 and c11
CHANNELS = ((64, 32), (32, 16), (16, 8))
# per output parity (even, odd): its (input offset, tap) pairs, in the
# order the sums take them
TAPS = (((0, 1),), ((1, 0), (0, 2)))


def _check(x, weight, bias, skip):
    """Raise ValueError unless the shapes are a layer the kernel takes;
    (Cin, Cout, D, H, W)."""
    op = "transposed_conv3d"
    if x.dim() != 5 or x.shape[0] != 1:
        raise ValueError("%s: x must be (1, Cin, D, H, W), got %s"
                         % (op, tuple(x.shape)))
    _, cin, D, H, W = x.shape
    if weight.dim() != 5 or tuple(weight.shape[2:]) != (3, 3, 3) \
            or weight.shape[0] != cin:
        raise ValueError("%s: weight must be (%d, Cout, 3, 3, 3), got %s"
                         % (op, cin, tuple(weight.shape)))
    cout = weight.shape[1]
    if (cin, cout) not in CHANNELS:
        raise ValueError("%s: no kernel for %d -> %d channels (it takes %s)"
                         % (op, cin, cout, ", ".join(
                             "%d -> %d" % p for p in CHANNELS)))
    if tuple(bias.shape) != (cout,):
        raise ValueError("%s: bias must be (%d,), got %s"
                         % (op, cout, tuple(bias.shape)))
    want = (1, cout, 2 * D, 2 * H, 2 * W)
    if tuple(skip.shape) != want:
        raise ValueError("%s: skip must be %s, got %s"
                         % (op, want, tuple(skip.shape)))
    return cin, cout, D, H, W


def transposed_conv3d_reference(x, weight, bias, skip):
    """Plain PyTorch K5, written over ``skip``: the 8 parity classes'
    sums, input channel by input channel, then the bias, the ReLU and the
    skip."""
    cin, cout, D, H, W = _check(x, weight, bias, skip)
    # a zero plane, row and column past the far edges: the odd outputs'
    # taps beyond the input
    xp = F.pad(x[0], (0, 1, 0, 1, 0, 1))
    acc = x.new_zeros((cout, 2, 2, 2, D, H, W))
    for ci in range(cin):
        for pd, ph, pw in itertools.product((0, 1), repeat=3):
            out = acc[:, pd, ph, pw]
            for (dd, kd), (dh, kh), (dw, kw) in itertools.product(
                    TAPS[pd], TAPS[ph], TAPS[pw]):
                out += (weight[ci, :, kd, kh, kw, None, None, None]
                        * xp[ci, dd:dd + D, dh:dh + H, dw:dw + W])
    # (co, pd, ph, pw, a, b, c) -> (co, 2a + pd, 2b + ph, 2c + pw)
    y = acc.permute(0, 4, 1, 5, 2, 6, 3).reshape(cout, 2 * D, 2 * H, 2 * W)
    y = torch.relu_(y + bias[:, None, None, None])
    return skip.add_(y[None])


def _transposed_conv3d_cuda(x, weight, bias, skip):
    cin, cout, D, H, W = _check(x, weight, bias, skip)
    op = "transposed_conv3d"
    cuda_build.check_tensor(op, "x", x, torch.float32)
    cuda_build.check_tensor(op, "weight", weight, torch.float32)
    cuda_build.check_tensor(op, "bias", bias, torch.float32)
    cuda_build.check_tensor(op, "skip", skip, torch.float32)
    for name, t in (("weight", weight), ("bias", bias), ("skip", skip)):
        if t.device != x.device:
            raise ValueError("%s: %s is on %s, x on %s"
                             % (op, name, t.device, x.device))
    if skip.data_ptr() % 8:
        raise ValueError("%s: skip must be 8-byte aligned" % op)
    if skip.numel() >= 1 << 31:
        raise ValueError("%s: the output must hold fewer than 2**31 values"
                         % op)
    cuda_build.launch("raynet_transposed_conv3d", x, x.data_ptr(),
                      weight.data_ptr(), bias.data_ptr(), skip.data_ptr(),
                      cin, cout, D, H, W)
    transposed_conv3d.launches += 1
    return skip


def transposed_conv3d(x, weight, bias, skip):
    """MVSNet's upsampling layer with its ReLU and skip sum, written over
    ``skip``.

    Arguments
    ---------
        x: (1, Cin, D, H, W) float32 input, NCDHW
        weight: (Cin, Cout, 3, 3, 3) float32 transposed-conv weight, the
            BatchNorm folded in; (Cin, Cout) one of ``CHANNELS``
        bias: (Cout,) float32
        skip: (1, Cout, 2D, 2H, 2W) float32, overwritten with the result

    Returns ``skip``.
    """
    if cuda_build.on_cuda("transposed_conv3d", x):
        return _transposed_conv3d_cuda(x, weight, bias, skip)
    return transposed_conv3d_reference(x, weight, bias, skip)


# Kernel launches since the last reset (the plain path never counts).
transposed_conv3d.launches = 0

"""K5's plain version (``ops/transposed_conv3d.py``) on the CPU: MVSNet's
upsampling layer, relu(conv_transpose3d(x, W, b, stride 2, padding 1,
output padding 1)) + skip, written over the skip.

Tolerance: against the float64 layer, 2**-20 of the sum of the absolute
terms of each output (|b| + sum |x| |w| + |skip|); a float32 sum of a few
hundred terms is off by a few float32 ulps (2**-24) of it, and a tap taken
from the wrong input or weight by about the whole of it.
"""
import functools

import pytest
import torch
import torch.nn.functional as F

from raynet_tpu_torch.models import mvsnet
from raynet_tpu_torch.models.mvsnet import MVSNetModel, unet
from raynet_tpu_torch.ops import transposed_conv3d as tc

torch.set_num_threads(2)

UP = functools.partial(F.conv_transpose3d, stride=2, padding=1,
                       output_padding=1)
BAR = 2.0 ** -20


def _layer(cin, cout, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, cin) + shape, generator=g)
    w = torch.randn((cin, cout, 3, 3, 3), generator=g) * 0.2
    b = torch.randn((cout,), generator=g) * 0.5
    skip = torch.randn((1, cout) + tuple(2 * n for n in shape), generator=g)
    return x, w, b, skip


def _exact(x, w, b, skip):
    """The float64 layer, and the sum of its terms' magnitudes."""
    x, w, b, skip = (t.double() for t in (x, w, b, skip))
    want = torch.relu(UP(x, w, b)) + skip
    scale = UP(x.abs(), w.abs(), b.abs()) + skip.abs()
    return want, scale


@pytest.mark.parametrize("cin, cout", tc.CHANNELS)
@pytest.mark.parametrize("shape", [(2, 4, 6), (3, 37, 5), (1, 1, 1),
                                   (5, 3, 7)])
def test_plain_version_equals_the_layer(cin, cout, shape):
    """Each published channel pair, at even and odd sizes (37: c7's H),
    against the float64 conv_transpose3d, bias, ReLU and skip, and the
    result written over the skip."""
    x, w, b, skip = _layer(cin, cout, shape, seed=cin + sum(shape))
    want, scale = _exact(x, w, b, skip)
    before = skip.clone()
    got = tc.transposed_conv3d(x, w, b, skip)
    assert got is skip and got.dtype == torch.float32
    assert got.shape == (1, cout) + tuple(2 * n for n in shape)
    assert ((got.double() - want).abs() <= BAR * scale).all()
    # the float32 library layer agrees with it within twice that
    lib = torch.relu(UP(x, w, b)) + before
    assert ((got - lib).double().abs() <= 2 * BAR * scale).all()


def test_the_last_odd_output_takes_one_tap_a_dim():
    """An odd output past the input's last voxel (where the output padding
    ends) takes tap 2 of the last input alone in each dim; the even output
    before it tap 1."""
    x, w, b, skip = _layer(16, 8, (3, 4, 5), seed=7)
    want = torch.relu(torch.einsum("c,co->o", x[0, :, -1, -1, -1].double(),
                                   w[:, :, 2, 2, 2].double()) + b.double())
    want = want + skip[0, :, -1, -1, -1].double()
    even = torch.relu(torch.einsum("c,co->o", x[0, :, -1, -1, -1].double(),
                                   w[:, :, 1, 1, 1].double()) + b.double())
    even = even + skip[0, :, -2, -2, -2].double()
    got = tc.transposed_conv3d(x, w, b, skip)
    torch.testing.assert_close(got[0, :, -1, -1, -1].double(), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[0, :, -2, -2, -2].double(), even,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin, cout", [(8, 16), (64, 64), (32, 8)])
def test_an_unsupported_channel_pair_raises(cin, cout):
    x = torch.zeros((1, cin, 2, 2, 2))
    w = torch.zeros((cin, cout, 3, 3, 3))
    with pytest.raises(ValueError, match="no kernel for %d -> %d channels"
                       % (cin, cout)):
        tc.transposed_conv3d(x, w, torch.zeros(cout),
                             torch.zeros((1, cout, 4, 4, 4)))


def test_a_skip_of_another_shape_raises():
    x, w, b, skip = _layer(16, 8, (2, 3, 4), seed=2)
    with pytest.raises(ValueError, match="skip must be"):
        tc.transposed_conv3d(x, w, b, skip[:, :, :-1])


def test_the_plain_path_counts_no_launch():
    x, w, b, skip = _layer(32, 16, (2, 2, 2), seed=3)
    before = tc.transposed_conv3d.launches
    tc.transposed_conv3d(x, w, b, skip)
    assert tc.transposed_conv3d.launches == before


def _library_layers(model):
    """The folded U-Net as it ran before K5: conv_transpose3d with the
    folded weight and bias, then the ReLU, then the skip sum."""
    out = []
    for m in model.model.cost_regularization.stages():
        if isinstance(m, mvsnet.DeconvBnReLU):
            weight, bias = mvsnet.fold_conv_norm(*m.layers())

            def call(x, skip, weight=weight, bias=bias):
                return torch.relu_(UP(x, weight, bias)).add_(skip)
        else:
            (call,) = mvsnet.fold([m])
        out.append(call)
    return out


def test_regularize_gives_the_logits_of_the_library_layers(monkeypatch):
    """``regularize`` on the CPU (K5's plain version) against the folded
    U-Net through conv_transpose3d: within float32 rounding of the logits'
    largest value, K5 entered 3 times, once a skip."""
    model = MVSNetModel(seed=11, device="cpu")
    x = torch.rand((1, 32, 16, 16, 24),
                   generator=torch.Generator().manual_seed(5)) * 0.1
    skips = []

    def counted(x, weight, bias, skip):
        skips.append(tuple(skip.shape))
        return tc.transposed_conv3d(x, weight, bias, skip)

    monkeypatch.setattr(mvsnet, "transposed_conv3d", counted)
    got = model.regularize(x)
    with torch.no_grad():
        want = unet(x, _library_layers(model))
    assert skips == [(1, 32, 4, 4, 6), (1, 16, 8, 8, 12), (1, 8, 16, 16, 24)]
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 1e-6 * scale

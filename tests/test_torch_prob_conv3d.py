"""K7's plain version (``ops/prob_conv3d.py``) on the CPU: the U-Net's
last layer, conv3d(x, W, b, stride 1, padding 1) from 8 channels to 1, with
or without a bias, and the fold's routing of exactly that layer to it.

Tolerance: against the float64 layer, 2**-20 of the sum of the absolute
terms of each output (|b| + sum |x| |w|); a float32 sum of 216 terms is off
by a few float32 ulps (2**-24) of it, and a tap taken from the wrong input
or weight, or a border read as anything but 0, by about the whole of it.
"""
import pytest
import torch
import torch.nn.functional as F

from raynet_tpu_torch.models import casmvsnet, mvsnet
from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel
from raynet_tpu_torch.models.mvsnet import MVSNetModel
from raynet_tpu_torch.ops import prob_conv3d as pc

torch.set_num_threads(2)

BAR = 2.0 ** -20


def _layer(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 8) + shape, generator=g)
    w = torch.randn((1, 8, 3, 3, 3), generator=g) * 0.2
    b = torch.randn((1,), generator=g) * 0.5
    return x, w, b


def _exact(x, w, b):
    """The float64 layer, and the sum of its terms' magnitudes."""
    x, w = x.double(), w.double()
    b = None if b is None else b.double()
    want = F.conv3d(x, w, b, padding=1)
    scale = F.conv3d(x.abs(), w.abs(), None if b is None else b.abs(),
                     padding=1)
    return want, scale


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", [(3, 67, 36), (1, 5, 8), (2, 9, 36),
                                   (5, 1, 4), (4, 8, 8), (7, 13, 68)])
def test_plain_version_equals_the_layer(shape, with_bias):
    """At sizes off the kernel's 32-column and 64-row tiles, at D = 1 and
    D = 2 (every output reads the zero planes), with MVSNet's bias and
    without (CasMVSNet's), against the float64 conv3d."""
    x, w, b = _layer(shape, seed=sum(shape))
    b = b if with_bias else None
    want, scale = _exact(x, w, b)
    got = pc.prob_conv3d(x, w, b)
    assert got.dtype == torch.float32 and got.shape == (1, 1) + shape
    assert ((got.double() - want).abs() <= BAR * scale).all()
    # the float32 library layer agrees with it within twice that
    lib = F.conv3d(x, w, b, padding=1)
    assert ((got - lib).double().abs() <= 2 * BAR * scale).all()


def test_the_bias_is_added_last():
    """With the bias the output is the output without it plus the bias."""
    x, w, b = _layer((3, 6, 12), seed=9)
    torch.testing.assert_close(pc.prob_conv3d(x, w, b),
                               pc.prob_conv3d(x, w) + b[0], rtol=0, atol=0)


def test_the_borders_read_zeros():
    """A corner output takes only the taps inside the volume: at (0, 0, 0)
    the taps kd, kh, kw >= 1 of the inputs (0..1, 0..1, 0..1), at the far
    corner the taps <= 1."""
    x, w, b = _layer((2, 3, 4), seed=5)
    got = pc.prob_conv3d(x, w, b)[0, 0]
    xd, wd, bd = x[0].double(), w[0].double(), b.double()
    near = torch.einsum("cdhw,cdhw->", xd[:, :2, :2, :2],
                        wd[:, 1:, 1:, 1:]) + bd[0]
    far = torch.einsum("cdhw,cdhw->", xd[:, -2:, -2:, -2:],
                       wd[:, :2, :2, :2]) + bd[0]
    torch.testing.assert_close(got[0, 0, 0].double(), near,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[-1, -1, -1].double(), far,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin, cout", [(8, 8), (16, 1), (8, 2), (32, 8)])
def test_an_unsupported_channel_pair_raises(cin, cout):
    x = torch.zeros((1, cin, 2, 2, 2))
    w = torch.zeros((cout, cin, 3, 3, 3))
    with pytest.raises(ValueError, match="no kernel for %d -> %d channels"
                       % (cin, cout)):
        pc.prob_conv3d(x, w, torch.zeros(cout))


@pytest.mark.parametrize("shape", [(3, 67, 37), (1, 5, 9), (2, 9, 34),
                                   (5, 1, 1)])
def test_a_width_off_a_multiple_of_4_raises(shape):
    """The kernel copies rows by float4s; the U-Nets' volumes are 8 times
    as wide as their deepest level, so no pass meets another width."""
    x, w, b = _layer(shape, seed=1)
    with pytest.raises(ValueError, match="W must be a multiple of 4"):
        pc.prob_conv3d(x, w, b)


def test_what_the_kernel_cannot_take_raises():
    x, w, b = _layer((2, 4, 8), seed=2)
    with pytest.raises(ValueError, match="x must be contiguous"):
        pc.prob_conv3d(x.transpose(3, 4).contiguous().transpose(3, 4), w, b)
    with pytest.raises(ValueError, match="x must be float32"):
        pc.prob_conv3d(x.double(), w, b)
    with pytest.raises(ValueError, match="weight must be float32"):
        pc.prob_conv3d(x, w.double(), b)
    with pytest.raises(ValueError, match="bias must be float32"):
        pc.prob_conv3d(x, w, b.double())
    with pytest.raises(ValueError, match="weight must be"):
        pc.prob_conv3d(x, w[:, :, :2], b)
    with pytest.raises(ValueError, match="bias must be"):
        pc.prob_conv3d(x, w, torch.zeros(2))
    with pytest.raises(ValueError, match="x must be"):
        pc.prob_conv3d(torch.zeros((2, 8, 2, 2, 2)), w, b)


def test_the_plain_path_counts_no_launch():
    x, w, b = _layer((2, 2, 4), seed=3)
    before = pc.prob_conv3d.launches
    pc.prob_conv3d(x, w, b)
    pc.prob_conv3d(x, w)
    assert pc.prob_conv3d.launches == before


@pytest.fixture
def probs(monkeypatch):
    """The input shapes, and whether a bias came, of every call the folded
    layers make to K7."""
    calls = []

    def counted(x, weight, bias=None):
        calls.append((tuple(x.shape), bias is not None))
        return pc.prob_conv3d(x, weight, bias)

    monkeypatch.setattr(mvsnet, "prob_conv3d", counted)
    return calls


def test_mvsnet_runs_prob_alone_on_k7(probs):
    """``regularize`` enters K7 once, at prob on the whole volume with its
    bias, and gives the logits of the folded U-Net with prob through
    conv3d within float32 rounding; ``predict`` (2D layers) never enters
    it."""
    model = MVSNetModel(seed=11, device="cpu")
    with torch.no_grad():
        model.model.cost_regularization.prob.bias.fill_(0.25)
    model.predict(torch.randint(0, 256, (1, 32, 48, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(1)))
    assert probs == []
    x = torch.rand((1, 32, 16, 16, 24),
                   generator=torch.Generator().manual_seed(5)) * 0.1
    got = model.regularize(x)
    assert probs == [((1, 8, 16, 16, 24), True)]
    stages = model.model.cost_regularization.stages()
    layers = mvsnet.fold(stages)
    prob = stages[-1]
    layers[-1] = lambda v: F.conv3d(v, prob.weight, prob.bias, padding=1)
    with torch.no_grad():
        want = mvsnet.unet(x, layers)
    assert len(probs) == 1
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 4e-6 * scale


def test_casmvsnet_runs_each_stage_prob_alone_on_k7(probs):
    """Each stage's ``regularize`` enters K7 once, at its prob, with no
    bias, and gives the logits of the folded U-Net with prob through
    conv3d within float32 rounding; the FPN never enters it."""
    model = CasMVSNetModel(seed=7, device="cpu")
    model.predict(torch.randint(0, 256, (1, 32, 48, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(2)))
    assert probs == []
    g = torch.Generator().manual_seed(3)
    for stage, cin in enumerate((32, 16, 8)):
        volume = torch.rand((1, cin, 8, 8, 16), generator=g)
        logits = model.regularize(volume, stage)
        assert logits.shape == (1, 1, 8, 8, 16)
        assert probs[stage:] == [((1, 8, 8, 8, 16), False)]
        stages = model.model.cost_regularization[stage].stages()
        layers = mvsnet.fold(stages)
        weight = stages[-1].weight
        layers[-1] = lambda v: F.conv3d(v, weight, None, padding=1)
        with torch.no_grad():
            want = mvsnet.unet(volume, layers)
        scale = want.abs().max().item()
        assert scale > 0
        assert (logits - want).abs().max().item() <= 4e-6 * scale
    assert len(probs) == len(casmvsnet.NDEPTHS)

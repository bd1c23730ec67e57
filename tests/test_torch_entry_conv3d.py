"""K6's plain version (``ops/entry_conv3d.py``) on the CPU: the U-Net's
entry layer, relu(conv3d(x, W, b, stride 1, padding 1)) from Cin to 8
channels, and the fold's routing of exactly that layer to it.

Tolerance: against the float64 layer, 2**-20 of the sum of the absolute
terms of each output (|b| + sum |x| |w|); a float32 sum of 27 Cin (at most
864) terms is off by a few float32 ulps (2**-24) of it, and a tap taken
from the wrong input or weight, or a border read as anything but 0, by
about the whole of it.
"""
import pytest
import torch
import torch.nn.functional as F

from raynet_tpu_torch.models import casmvsnet, mvsnet
from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel
from raynet_tpu_torch.models.mvsnet import MVSNetModel
from raynet_tpu_torch.ops import entry_conv3d as ec

torch.set_num_threads(2)

BAR = 2.0 ** -20


def _layer(cin, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, cin) + shape, generator=g)
    w = torch.randn((8, cin, 3, 3, 3), generator=g) * 0.2
    b = torch.randn((8,), generator=g) * 0.5
    return x, w, b


def _exact(x, w, b):
    """The float64 layer, and the sum of its terms' magnitudes."""
    x, w, b = (t.double() for t in (x, w, b))
    want = torch.relu(F.conv3d(x, w, b, padding=1))
    scale = F.conv3d(x.abs(), w.abs(), b.abs(), padding=1)
    return want, scale


@pytest.mark.parametrize("cin, cout", ec.CHANNELS)
@pytest.mark.parametrize("shape", [(3, 67, 37), (1, 5, 9), (2, 9, 33),
                                   (5, 1, 1), (4, 8, 8)])
def test_plain_version_equals_the_layer(cin, cout, shape):
    """Each published channel pair, at sizes off the kernel's 32-column and
    64-row tiles, at D = 1 and D = 2 (every output reads the zero planes),
    against the float64 conv3d, bias and ReLU."""
    x, w, b = _layer(cin, shape, seed=cin + sum(shape))
    want, scale = _exact(x, w, b)
    got = ec.entry_conv3d(x, w, b)
    assert got.dtype == torch.float32 and got.shape == (1, cout) + shape
    assert ((got.double() - want).abs() <= BAR * scale).all()
    # the float32 library layer agrees with it within twice that
    lib = torch.relu(F.conv3d(x, w, b, padding=1))
    assert ((got - lib).double().abs() <= 2 * BAR * scale).all()


def test_the_borders_read_zeros():
    """A corner output takes only the taps inside the volume: at (0, 0, 0)
    the taps kd, kh, kw >= 1 of the inputs (0..1, 0..1, 0..1), at the far
    corner the taps <= 1."""
    x, w, b = _layer(8, (2, 3, 4), seed=5)
    got = ec.entry_conv3d(x, w, b)[0]
    xd, wd, bd = x[0].double(), w.double(), b.double()
    near = torch.einsum("cdhw,ocdhw->o", xd[:, :2, :2, :2],
                        wd[:, :, 1:, 1:, 1:]) + bd
    far = torch.einsum("cdhw,ocdhw->o", xd[:, -2:, -2:, -2:],
                       wd[:, :, :2, :2, :2]) + bd
    torch.testing.assert_close(got[:, 0, 0, 0].double(), torch.relu(near),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[:, -1, -1, -1].double(), torch.relu(far),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin, cout", [(32, 16), (8, 16), (64, 8), (16, 1)])
def test_an_unsupported_channel_pair_raises(cin, cout):
    x = torch.zeros((1, cin, 2, 2, 2))
    w = torch.zeros((cout, cin, 3, 3, 3))
    with pytest.raises(ValueError, match="no kernel for %d -> %d channels"
                       % (cin, cout)):
        ec.entry_conv3d(x, w, torch.zeros(cout))


def test_what_the_kernel_cannot_take_raises():
    x, w, b = _layer(16, (2, 4, 6), seed=2)
    with pytest.raises(ValueError, match="x must be contiguous"):
        ec.entry_conv3d(x.transpose(3, 4).contiguous().transpose(3, 4), w, b)
    with pytest.raises(ValueError, match="x must be float32"):
        ec.entry_conv3d(x.double(), w, b)
    with pytest.raises(ValueError, match="weight must be float32"):
        ec.entry_conv3d(x, w.double(), b)
    with pytest.raises(ValueError, match="weight must be"):
        ec.entry_conv3d(x, w[:, :, :2], b)
    with pytest.raises(ValueError, match="bias must be"):
        ec.entry_conv3d(x, w, b[:4])


def test_the_plain_path_counts_no_launch():
    x, w, b = _layer(32, (2, 2, 2), seed=3)
    before = ec.entry_conv3d.launches
    ec.entry_conv3d(x, w, b)
    assert ec.entry_conv3d.launches == before


@pytest.fixture
def entries(monkeypatch):
    """The input shapes of every call the folded layers make to K6."""
    calls = []

    def counted(x, weight, bias):
        calls.append(tuple(x.shape))
        return ec.entry_conv3d(x, weight, bias)

    monkeypatch.setattr(mvsnet, "entry_conv3d", counted)
    return calls


def test_mvsnet_runs_c0_alone_on_k6(entries):
    """``regularize`` enters K6 once, at c0 on the whole volume, and gives
    the logits of the folded U-Net with c0 through conv3d within float32
    rounding; ``predict`` (2D layers) never enters it."""
    model = MVSNetModel(seed=11, device="cpu")
    model.predict(torch.randint(0, 256, (1, 32, 48, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(1)))
    assert entries == []
    x = torch.rand((1, 32, 16, 16, 24),
                   generator=torch.Generator().manual_seed(5)) * 0.1
    got = model.regularize(x)
    assert entries == [(1, 32, 16, 16, 24)]
    stages = model.model.cost_regularization.stages()
    layers = mvsnet.fold(stages)
    weight, bias = mvsnet.fold_conv_norm(*stages[0].layers())
    layers[0] = lambda v: torch.relu_(F.conv3d(v, weight, bias, padding=1))
    with torch.no_grad():
        want = mvsnet.unet(x, layers)
    assert len(entries) == 1
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 4e-6 * scale


def test_casmvsnet_runs_each_stage_c0_alone_on_k6(entries):
    """Each stage's ``regularize`` enters K6 once, at its c0 (32, 16 and 8
    input channels); the FPN never enters it."""
    model = CasMVSNetModel(seed=7, device="cpu")
    model.predict(torch.randint(0, 256, (1, 32, 48, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(2)))
    assert entries == []
    g = torch.Generator().manual_seed(3)
    for stage, cin in enumerate((32, 16, 8)):
        volume = torch.rand((1, cin, 8, 8, 16), generator=g)
        logits = model.regularize(volume, stage)
        assert logits.shape == (1, 1, 8, 8, 16)
        assert entries[stage:] == [(1, cin, 8, 8, 16)]
    assert len(entries) == len(casmvsnet.NDEPTHS)

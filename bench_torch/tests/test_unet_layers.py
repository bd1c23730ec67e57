"""The per-layer costs of the MVSNet and CasMVSNet U-Nets
(``bench_torch/unet_layers.py``) against values worked out by hand, and
the readers of ``prob_conv_roofline`` and ``unet_convs_roofline`` on runs
made up here: the bound over the layer timers, nothing off the card or
where no pass has the timers (a program without them)."""
import math
import types

import pytest

from bench_torch import harness, mvs_roofline, roofline, unet_layers
from bench_torch.metrics import prob_conv_roofline, unet_convs_roofline
from raynet_tpu_torch.models.mvsnet import UNET_LABELS

BENCH = harness.Benchmark()
TRAFFIC = BENCH.traffic("ring8_framed")


def _stages(name):
    """Each U-Net layer list of a configuration: one, or one a stage."""
    layers = BENCH.config(name)["cost_regularization"]
    return [layers] if name == "mvsnet" else layers


def _ms(cost):
    return round(1e3 * roofline.bound_seconds(cost), 4)


def test_counts_by_hand():
    n = 256 * 296 * 400
    costs = unet_layers.layer_costs(
        BENCH.config("mvsnet")["cost_regularization"], (256, 296, 400))
    # prob, 8 -> 1 at the volume's size: 13.1 GFLOP; 1.091 GB, the 8
    # channels read and the logits written; bound by bytes
    assert costs["prob"] == roofline.Cost(4 * 9 * n, 2 * n * 8 * 27)
    assert costs["prob"] == roofline.Cost(1_091_174_400, 13_094_092_800)
    assert roofline.bound_by(costs["prob"]) == "bytes"
    assert _ms(costs["prob"]) == 0.3257
    # conv1 (8 -> 16, /2), conv2 (16 -> 16), conv3 (16 -> 32, /4), conv4
    # (32 -> 32), conv5 (32 -> 64, /8), conv6 (64 -> 64): each bound by
    # its operations
    per = {"conv1": n / 8 * 16 * 8, "conv2": n / 8 * 16 * 16,
           "conv3": n / 64 * 32 * 16, "conv4": n / 64 * 32 * 32,
           "conv5": n / 512 * 64 * 32, "conv6": n / 512 * 64 * 64}
    for name, macs in per.items():
        assert costs[name].ops == 2 * 27 * macs
        assert roofline.bound_by(costs[name]) == "operations"
    bounds = sum(roofline.bound_seconds(costs[c]) for c in unet_layers.CONVS)
    assert round(1e3 * bounds, 4) == 2.0521
    # a pass: 8 volumes
    mvs = BENCH.config("mvsnet")
    assert unet_layers.pass_bound(mvs, TRAFFIC, ("prob",)) == pytest.approx(
        8 * roofline.bound_seconds(costs["prob"]))
    # CasMVSNet's stages, a view: prob 0.0611 / 0.1629 / 0.1629 ms, conv1
    # to conv6 0.3848 / 1.0260 / 1.0260 ms
    cas = BENCH.config("casmvsnet")
    volumes = unet_layers.pass_volumes(cas, TRAFFIC)
    assert [size for _, size in volumes[:3]] == [
        (48, 296, 400), (32, 592, 800), (8, 1184, 1600)]
    assert len(volumes) == 3 * 8
    probs, convs = [], []
    for layers, size in volumes[:3]:
        c = unet_layers.layer_costs(layers, size)
        probs.append(_ms(c["prob"]))
        convs.append(round(1e3 * sum(roofline.bound_seconds(c[k])
                                     for k in unet_layers.CONVS), 4))
    assert probs == [0.0611, 0.1629, 0.1629]
    assert convs == [0.3848, 1.0260, 1.0260]


@pytest.mark.parametrize("name", ["mvsnet", "casmvsnet"])
def test_layers_operations_sum_to_the_whole_unet(name):
    config = BENCH.config(name)
    for layers, size in unet_layers.pass_volumes(config, TRAFFIC)[:3]:
        costs = unet_layers.layer_costs(layers, size)
        whole, out = mvs_roofline.stack_cost(layers, size, 3)
        assert out == size
        assert sum(c.ops for c in costs.values()) == whole.ops
        assert list(costs) == [layer[0] for layer in layers]


@pytest.mark.parametrize("name", ["mvsnet", "casmvsnet"])
def test_the_program_s_timers_are_the_configuration_s_layers(name):
    for layers in _stages(name):
        assert UNET_LABELS == tuple("unet." + layer[0] for layer in layers)


def _run(name, platform="gpu", seconds=None):
    """A run of ``name``'s cell with two passes, whose layer timers read
    ``seconds`` ({layer: s}) each; none without."""
    phases = {"Cost regularization": {"total_s": 1.0, "count": 8}}
    for layer, s in (seconds or {}).items():
        phases["unet." + layer] = {"total_s": s, "count": 8}
    return types.SimpleNamespace(
        config=BENCH.config(name), traffic=TRAFFIC,
        device={"platform": platform},
        passes=[types.SimpleNamespace(phases=dict(phases))
                for _ in range(2)])


@pytest.mark.parametrize("name", ["mvsnet", "casmvsnet"])
def test_readers_give_the_bound_over_the_timers(name):
    seconds = {"prob": 0.125}
    seconds.update({c: 0.01 * (k + 1)
                    for k, c in enumerate(unet_layers.CONVS)})
    run = _run(name, seconds=seconds)
    config = BENCH.config(name)
    prob = unet_layers.pass_bound(config, TRAFFIC, ("prob",))
    assert prob_conv_roofline.read(run) == pytest.approx(
        100 * 2 * prob / (2 * 0.125))
    convs = unet_layers.pass_bound(config, TRAFFIC, unet_layers.CONVS)
    assert unet_convs_roofline.read(run) == pytest.approx(
        100 * 2 * convs / (2 * 0.21))
    # MVSNet: 8 volumes of 0.3257 ms a pass over 125 ms
    if name == "mvsnet":
        assert math.isclose(prob_conv_roofline.read(run),
                            100 * 8 * 0.32572 / 125, rel_tol=1e-3)


@pytest.mark.parametrize("reader", [prob_conv_roofline, unet_convs_roofline])
def test_readers_read_nothing_without_the_timers_or_a_card(reader):
    seconds = dict.fromkeys(("prob",) + unet_layers.CONVS, 0.1)
    # the parent's program: the phase, no layer timer
    assert reader.read(_run("mvsnet")) is None
    # off the card
    assert reader.read(_run("mvsnet", "cpu", seconds)) is None
    assert reader.read(_run("casmvsnet", "gpu", seconds)) is not None

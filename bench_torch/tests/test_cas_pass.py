"""The ``casmvsnet`` cell on the CPU: a tiny cell of its own (a framed ring
of 128x96 views, 3 views a reference, the published widths and
hypotheses) runs correct, traced and untraced; the check catches the
faults planted in the timed path (a later stage fed planes over the whole
depth range in place of its per-pixel hypotheses, a source view dropped
from the variance, nearest taps for bilinear ones); the counts of its work
against values worked out by hand."""
import time

import pytest
import torch

from bench_torch import cas_roofline, harness, mvs_roofline
from conftest import add_cell, tiny_config

CELL = "tiny_casmvsnet.tiny_framed96"
TINY_FRAMED = {
    "name": "tiny_framed96", "kind": "ring",
    "why": "4 views of 128x96 whose rays all cross the bbox",
    "n_images": 4, "height": 96, "width": 128, "focal": 220.0,
    "radius": 20.0, "angle_step": 0.04, "bbox_half": 6.5,
    "images_range": [0, 2, 1],
}


@pytest.fixture
def cas_checkout(checkout):
    config = dict(tiny_config("casmvsnet"), neighbors=2, views=3)
    add_cell(checkout, config, TINY_FRAMED)
    return checkout


def _run(root, trace=False, seed=2**31 + 21):
    return harness.run_cell(CELL, seed, 0.2, trace, "cpu",
                            time.perf_counter(), root=root)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(cas_checkout, trace):
    result = _run(cas_checkout, trace)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    names = set(result["metrics"])
    if trace:
        # no card, so no share of it and no device idle: only the CNN's
        # span, as in the mvsnet cell
        assert names == {"cnn_ms_per_image"}
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert names == {"px_per_s", "pass_p90_s", "peak_mem_GB", "setup_s"}


def _planes_in_later_stages(monkeypatch):
    from raynet_tpu_torch.inference.forward_pass import CasMVSNetForwardPass
    from raynet_tpu_torch.models import casmvsnet
    from raynet_tpu_torch.ops import cost_volume

    whole = CasMVSNetForwardPass._stage_planes

    def planes(self, scene, views, stage):
        # a later stage's hypotheses as planes over the whole range, the
        # way stage 1 spans it, around a centre of 0
        depths, homs = whole(self, scene, views, stage)
        if stage:
            P = cost_volume.feature_cameras(
                [scene.get_image(views[0]).camera.P], *self._crop[:2])
            depths = torch.as_tensor(cost_volume.plane_depths(
                P[0], scene.bbox, casmvsnet.NDEPTHS[stage]))
        return depths, homs

    def zero(depth, shape, stage):
        s = casmvsnet.STRIDES[stage]
        return torch.zeros((shape[0] // s, shape[1] // s))

    monkeypatch.setattr(CasMVSNetForwardPass, "_stage_planes", planes)
    monkeypatch.setattr(casmvsnet, "centre_depth", zero)


def _source_view_dropped(monkeypatch):
    from raynet_tpu_torch.ops import cost_volume

    whole = cost_volume.cost_volume_reference

    def dropped(features, homs, *rest):
        # the last source view never enters the variance
        return whole(features[:-1], homs[:-1], *rest)

    monkeypatch.setattr(cost_volume, "cost_volume_reference", dropped)


def _nearest_taps(monkeypatch):
    from raynet_tpu_torch.ops import cost_volume

    bilinear = cost_volume._bilinear

    def nearest(feats, x, y):
        return bilinear(feats, torch.round(x), torch.round(y))

    monkeypatch.setattr(cost_volume, "_bilinear", nearest)


@pytest.mark.parametrize("plant", [_planes_in_later_stages,
                                   _source_view_dropped, _nearest_taps])
def test_a_planted_fault_is_not_correct(cas_checkout, monkeypatch, plant):
    plant(monkeypatch)
    assert _run(cas_checkout)["correct"] is False


def test_counts_by_hand():
    config = harness.Benchmark().config("casmvsnet")
    H, W = 1184, 1600
    px = H * W
    # the FPN: the bottom-up convs, then out1, inner1, out2, inner2, out3
    fpn = cas_roofline.fpn_cost(config, (H, W))
    macs = (px * (8 * 3 + 8 * 8) * 9 + px // 4 * 16 * 8 * 25
            + px // 4 * 2 * 16 * 16 * 9 + px // 16 * 32 * 16 * 25
            + px // 16 * 2 * 32 * 32 * 9
            + px // 16 * 32 * 32 + px // 4 * 16 * 32 + px // 4 * 32 * 16 * 9
            + px * 8 * 32 + px * 32 * 8 * 9)
    assert fpn.ops == 2 * macs == 2 * 16_291_840_000
    assert fpn.nbytes == 4 * (3 * px + 32 * px // 16 + 16 * px // 4 + 8 * px)
    assert cas_roofline.stage_shapes(config, (H, W)) == [
        (32, 48, 296, 400), (16, 32, 592, 800), (8, 8, 1184, 1600)]
    stages = cas_roofline.stage_costs(config, (H, W))
    for (C, D, h, w), (k4, unet) in zip(
            cas_roofline.stage_shapes(config, (H, W)), stages):
        n = D * h * w
        # the U-Net: conv0 from the stage's C channels, the rest as MVSNet's
        per = 27 * (8 * C + (16 * 8 + 16 * 16) / 8
                    + (32 * 16 + 32 * 32) / 64 + (64 * 32 + 64 * 64) / 512
                    + 64 * 32 / 512 + 32 * 16 / 64 + 16 * 8 / 8 + 8)
        assert unet.ops == 2 * n * per
        # K4: five maps read, the volume written; a per-pixel stage also
        # reads its centre depths
        centre = 0 if C == 32 else h * w
        assert k4.nbytes == 4 * (C * n + 5 * h * w * C + D + 48 + centre)
        assert k4.ops == C * n * 45 + n * 4 * 20
    # the stages' U-Nets: 115.4, 203.0 and 150.6 GFLOP a view
    assert [round(u.ops / 1e9, 1) for _, u in stages] == [115.4, 203.0,
                                                          150.6]
    assert stages[0][1] == mvs_roofline.stack_cost(
        config["cost_regularization"][0], (48, 296, 400), 3)[0]

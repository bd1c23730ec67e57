"""The CasMVSNet pass (``inference/forward_pass.py::CasMVSNetForwardPass``),
K4's per-pixel plain path, the cascade's hypotheses and the folded FPN
against the benchmark's plain reference (``bench_torch/reference/
casmvsnet.py``) on the CPU, at a small size with the published layers and
hypotheses: 3 views of 128x96 (stage maps 32x24, 64x48 and 128x96; D 48,
32, 8), on the weights the benchmark seeds.

Tolerances, each with its reason:

- the pass's last-stage depths within 5e-3 of the last stage's interval
  of the reference's (measured: 2.5e-4 and 4.7e-4 on the two seeds): the
  fold rounds every weight once more, the plain K4 samples at the pixel
  coordinates where ``grid_sample`` rescales them to [-1, 1] and back,
  the program builds the hypotheses from the resampled centre depth where
  the reference resamples the hypotheses, and the first two stages' depth
  errors, in intervals 4 and 2 times as wide, carry into the last stage's
  hypotheses; each stage run on the pass's own previous map within 1e-3
  of its interval of the reference's stage on that map (measured: 1.4e-4
  and 1.9e-4), none of it carried from an earlier stage;
- the plain K4 in its per-pixel mode within rtol 1e-4, atol 1e-5 of the
  reference's ``grid_sample`` volume, as the plane mode's test holds it
  (``tests/test_torch_mvsnet.py``), and bit for bit the plane mode where
  every pixel's hypotheses are the planes;
- the fused hypotheses within 1e-12 of the depth of cascade-stereo's
  sequence in float64 (both are sums of a few float64 terms of ~20);
- the folded FPN within rtol = atol = 1e-5 of the unfolded one, and no
  farther from a float64 unfolded forward than the float32 unfolded one
  plus 1e-6 of the output's largest value (the fold only rounds its
  weights once more), as MVSNet's feature net is held.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import scene as generator
from bench_torch.drivers.casmvs_pass import casmvsnet_weights
from bench_torch.reference import casmvsnet as reference
from raynet_tpu_torch.inference import (
    CasMVSNetForwardPass,
    forward_pass,
    get_forward_pass_factory,
)
from raynet_tpu_torch.models import casmvsnet
from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel
from raynet_tpu_torch.models.mvsnet import CostRegNet, soft_argmin
from raynet_tpu_torch.ops import cost_volume as cv
from raynet_tpu_torch.scripts import forward_pass as port_cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TRAFFIC = {"name": "small", "kind": "ring", "n_images": 4, "height": 96,
           "width": 128, "focal": 220.0, "radius": 20.0, "angle_step": 0.04,
           "bbox_half": 6.5, "images_range": [0, 3, 1]}
GP = type("GP", (), dict(depth_planes=32, neighbors=2))()


def _config():
    config = json.loads((REPO / "bench_torch" / "configs"
                         / "casmvsnet.json").read_text())
    config.update(neighbors=2, views=3)
    return config


def _pass(scene, model):
    fp = CasMVSNetForwardPass(model, GP, None, scene.image_shape, device=CPU)
    return fp, np.stack(list(fp.forward_pass(scene, (0, 3, 1))))


def test_casmvsnet_is_a_factory():
    assert forward_pass._FACTORIES["casmvsnet"] is CasMVSNetForwardPass
    assert get_forward_pass_factory("casmvsnet") is CasMVSNetForwardPass


def test_the_configuration_is_the_model_s():
    config = _config()
    assert tuple(config["ndepths"]) == casmvsnet.NDEPTHS
    assert tuple(config["depth_interval_ratios"]) \
        == casmvsnet.INTERVAL_RATIOS
    assert tuple(config["stage_strides"]) == casmvsnet.STRIDES
    assert config["numdepth"] == casmvsnet.NUM_DEPTH


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_pass_matches_the_reference(seed):
    config = _config()
    scene = generator.make_scene(TRAFFIC, seed, CPU)
    weights = casmvsnet_weights(config, seed, CPU)
    fp, maps = _pass(scene, CasMVSNetModel(state_dict=weights, device=CPU))
    assert maps.shape == (3, 96, 128) and maps.dtype == np.float32
    staged = [[d.numpy() for d in fp.stage_depths(scene, i)]
              for i in range(3)]
    assert [m.shape for m in staged[0]] == [(24, 32), (48, 64), (96, 128)]
    assert np.array_equal(np.stack([m[-1] for m in staged]), maps)
    judge = reference.run(scene, weights, config, TRAFFIC,
                          [staged, list(maps)], CPU)
    ref = np.stack([m[-1] for m in judge.reference_maps(96, 128)])
    gap = np.abs(maps - ref) / np.array(judge.intervals)[:, None, None]
    assert gap.max() <= 5e-3
    readings = judge.readings()
    for r in readings:
        assert r["chain_gap"] == pytest.approx(gap.max(), rel=1e-3)
        assert r["scaled_gap"] <= gap.max()
        # each stage on its own input
        assert r["depth_gap"] <= 1e-3 and r["mismatch_share"] == 0
    # the reference's depths move over most of the depth range (192 of
    # the last stage's intervals): not a flat map
    assert judge.spread()["range_max"] > 192 / 2


def _stage_inputs(seed=9, stage=1):
    """The features, the homographies and the depth range of view 1's view
    set at stage ``stage``'s maps."""
    scene = generator.make_scene(TRAFFIC, seed, CPU)
    model = CasMVSNetModel(state_dict=casmvsnet_weights(_config(), seed, CPU),
                           device=CPU)
    views = scene.get_view_idxs(1, 2)
    images = np.stack([scene.get_image(j).image_u8 for j in views])
    feats = model.predict(images)[stage]
    Ps = [scene.get_image(j).camera.P for j in views]
    s = casmvsnet.STRIDES[stage]
    P = cv.feature_cameras(Ps, 0, 0, s)
    return scene, feats, Ps, P, cv.depth_range(P[0], scene.bbox)


def test_per_pixel_plain_cost_volume_equals_grid_sample_volume():
    scene, feats, Ps, P, (near, far) = _stage_inputs(stage=1)
    h, w = feats.shape[1:3]
    # centre depths that vary over the map, across the depth range
    g = torch.Generator().manual_seed(3)
    centre = (near + (far - near) * torch.rand((h, w), generator=g)) \
        .to(torch.float32)
    offsets = casmvsnet.hypothesis_offsets(near, far, 1)
    homs = torch.as_tensor(cv.homographies(P))
    got = cv.cost_volume(feats, homs, offsets, centre)
    projs = np.stack([reference.projection(p, 0, 0, 2) for p in Ps])
    z = centre.to(torch.float64) + offsets[:, None, None]
    want = reference.cost_volume(feats.permute(0, 3, 1, 2), projs, z)
    assert got.shape == want.shape == (1, 16, 32, 48, 64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_per_pixel_mode_at_the_planes_is_the_plane_mode():
    """Every pixel's hypotheses at the planes (a centre of 0 and the plane
    depths as offsets, or a constant centre and the offsets from it): the
    per-pixel path gives the plane path's volume bit for bit."""
    scene, feats, _, P, (near, far) = _stage_inputs(stage=0)
    h, w = feats.shape[1:3]
    depths = torch.as_tensor(cv.plane_depths(P[0], scene.bbox, 16))
    homs = torch.as_tensor(cv.homographies(P))
    planes = cv.cost_volume(feats, homs, depths)
    zero = torch.zeros((h, w), dtype=torch.float32)
    assert torch.equal(cv.cost_volume(feats, homs, depths, zero), planes)
    # a constant centre c: the planes c + offsets
    middle = torch.full((h, w), float(np.float32((near + far) / 2)))
    offsets = casmvsnet.hypothesis_offsets(near, far, 1)
    planes = cv.cost_volume(feats, homs, middle[0, 0].double() + offsets)
    assert torch.equal(cv.cost_volume(feats, homs, offsets, middle), planes)


def test_fused_hypotheses_follow_cascade_stereo_s_sequence():
    """``centre_depth`` plus ``hypothesis_offsets`` against the reference's
    sequence (up to the crop, the range, trilinearly down) in float64, for
    both later stages, on a depth map with detail at every pixel."""
    config = _config()
    near, far = 14.0, 27.5
    g = torch.Generator().manual_seed(5)
    shape = (96, 128)
    for stage, prev in ((1, (24, 32)), (2, (48, 64))):
        depth = (near + (far - near) * torch.rand(prev, generator=g,
                                                  dtype=torch.float64))
        want = reference.hypotheses(depth, config, stage, shape, near, far,
                                    CPU)
        got = casmvsnet.centre_depth(depth, shape, stage)[None] \
            + casmvsnet.hypothesis_offsets(near, far, stage)[:, None, None]
        s = casmvsnet.STRIDES[stage]
        assert got.shape == want.shape == (casmvsnet.NDEPTHS[stage],
                                           96 // s, 128 // s)
        assert (got - want).abs().max().item() <= 1e-12
    # stage 1: the planes, uniform over the range
    want = reference.hypotheses(None, config, 0, shape, near, far, CPU)
    planes = near + (far - near) / 47 * torch.arange(48, dtype=torch.float64)
    torch.testing.assert_close(want, planes[:, None, None].expand(48, 24, 32),
                               rtol=0, atol=1e-12)


def _float(module, dtype):
    return copy.deepcopy(module).eval().to(dtype)


def test_folded_fpn_equals_the_unfolded_one():
    model = CasMVSNetModel(state_dict=casmvsnet_weights(_config(), 13, CPU),
                           device=CPU)
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (2, 64, 96, 3), dtype=torch.uint8,
                           generator=g)
    got = model.predict(images)
    x = images.permute(0, 3, 1, 2).to(torch.float64) / 255.0
    net = model.model.feature
    with torch.no_grad():
        want = _float(net, torch.float32)(x.to(torch.float32))
        exact = _float(net, torch.float64)(x)
    assert [tuple(m.shape) for m in got] == [(2, 16, 24, 32), (2, 32, 48, 16),
                                             (2, 64, 96, 8)]
    for g_, w_, e_ in zip(got, want, exact):
        w_, e_ = w_.permute(0, 2, 3, 1), e_.permute(0, 2, 3, 1)
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
        fold_err = (g_.double() - e_).abs().max().item()
        plain_err = (w_.double() - e_).abs().max().item()
        assert fold_err <= plain_err + 1e-6 * e_.abs().max().item()
    assert model.fold_builds == 1


def test_counters_count_three_volumes_a_view():
    scene = generator.make_scene(TRAFFIC, 17, CPU)
    model = CasMVSNetModel(seed=17, device=CPU)
    launches = (cv.cost_volume.launches, cv.cost_volume.per_pixel_launches)
    fp, maps = _pass(scene, model)
    assert fp.volumes == 9 and len(maps) == 3
    # the three views' view sets hold images 0-3, each featurised once
    assert model.folded_layers == 8 * 4 + 10 * 9
    assert model.fold_builds == 1
    # the plain path never counts a launch
    assert (cv.cost_volume.launches,
            cv.cost_volume.per_pixel_launches) == launches
    counts = fp.timer.counts
    assert counts["Cost volume"] == counts["Cost regularization"] \
        == counts["Depth regression"] == 9
    assert counts["Fine regularization"] == 3
    assert counts["Features computation"] == 4
    assert fp.overlapped_views == 2
    # each cached image holds its three maps
    cached = next(iter(fp._image_feature_cache.values()))
    assert [tuple(m.shape) for m in cached] == [(24, 32, 32), (48, 64, 16),
                                                (96, 128, 8)]


# cascade-stereo's names of one stage's U-Net (CostRegNet with Conv3d and
# Deconv3d blocks, prob without a bias) and of the FPN's own layers
UNET_NAMES = (
    ["conv%d.conv.weight" % i for i in (0, 1, 2, 3, 4, 5, 6, 7, 9, 11)]
    + ["conv%d.bn.%s" % (i, k) for i in (0, 1, 2, 3, 4, 5, 6, 7, 9, 11)
       for k in ("weight", "bias", "running_mean", "running_var",
                 "num_batches_tracked")]
    + ["prob.weight"])
FPN_NAMES = ["out1.weight", "inner1.weight", "inner1.bias", "inner2.weight",
             "inner2.bias", "out2.weight", "out3.weight"] + [
    "conv%d.%d.%s" % (g, i, k) for g, n in ((0, 2), (1, 3), (2, 3))
    for i in range(n) for k in ("conv.weight", "bn.weight", "bn.bias",
                                "bn.running_mean", "bn.running_var",
                                "bn.num_batches_tracked")]


def test_a_state_dict_under_cascade_stereo_s_names_loads():
    names = {"feature." + n for n in FPN_NAMES} | {
        "cost_regularization.%d.%s" % (s, n) for s in range(3)
        for n in UNET_NAMES}
    weights = casmvsnet_weights(_config(), 29, CPU)
    assert set(weights) == names
    model = CasMVSNetModel(state_dict=weights, device=CPU)
    assert set(model.model.state_dict()) == names
    for name, t in model.model.state_dict().items():
        assert torch.equal(t, weights[name])
    shapes = {n: tuple(t.shape) for n, t in weights.items()}
    assert shapes["cost_regularization.0.conv0.conv.weight"] \
        == (8, 32, 3, 3, 3)
    assert shapes["cost_regularization.2.conv0.conv.weight"] \
        == (8, 8, 3, 3, 3)
    assert shapes["cost_regularization.1.conv7.conv.weight"] \
        == (64, 32, 3, 3, 3)
    assert shapes["feature.conv1.0.conv.weight"] == (16, 8, 5, 5)


def test_mvsnet_s_unet_keeps_its_names_and_outputs():
    """The generalised ``CostRegNet`` at its defaults is MVSNet's (the
    names of MVSNet_pytorch, ``prob`` with a bias), and ``soft_argmin``
    over (D, H, W) depths equal at every pixel gives the (D,) planes'
    depth bit for bit."""
    names = set(CostRegNet().state_dict())
    assert "conv7.0.weight" in names and "conv7.1.running_var" in names
    assert "prob.bias" in names and not any(".conv.weight" in n and
                                            n.startswith("conv7")
                                            for n in names)
    assert "prob.bias" not in CostRegNet(8, prob_bias=False).state_dict()
    g = torch.Generator().manual_seed(1)
    logits = torch.randn((1, 1, 16, 5, 7), generator=g) * 10
    depths = torch.linspace(3.0, 9.0, 16)
    assert torch.equal(soft_argmin(logits, depths),
                       soft_argmin(logits, depths[:, None, None]
                                   .expand(16, 5, 7).contiguous()))


def test_cli_runs_casmvsnet_from_a_saved_state_dict(mock_scene_dir,
                                                    tmp_path):
    from raynet_tpu_torch.scripts.arguments import build_dataset

    weights = tmp_path / "casmvsnet.pt"
    model = CasMVSNetModel(
        state_dict=casmvsnet_weights(_config(), 23, CPU), device=CPU)
    torch.save(model.model.state_dict(), weights)
    out = tmp_path / "out"
    port_cli.main([
        str(mock_scene_dir.parent), str(out), "--scene_idx", "0",
        "--forward_pass_factory", "casmvsnet", "--start_end", "0,2",
        "--weight_file", str(weights), "--device", "cpu"])
    scene = build_dataset("restrepo", str(mock_scene_dir.parent), "max",
                          device="cpu").get_scene(0)
    fp = CasMVSNetForwardPass(model, type("GP", (), dict(neighbors=4))(),
                              None, scene.image_shape, device=CPU)
    want = list(fp.forward_pass(scene, (0, 2, 1)))
    for i in range(2):
        got = np.load(out / ("depth_%03d.npy" % i))
        # the 36x48 mock views crop to 32x32, full-resolution maps
        assert got.shape == (32, 32) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want[i])

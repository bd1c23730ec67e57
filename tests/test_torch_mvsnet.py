"""The MVSNet pass (``inference/forward_pass.py::MVSNetForwardPass``), K4's
plain version and the folded network against the benchmark's plain
reference (``bench_torch/reference/mvsnet.py``) on the CPU, at a small
size with the published layer structure: 3 views of 128x96 -> 32x24
feature maps, D = 16 (so that every U-Net level divides), on the weights
the benchmark seeds.

Tolerances, each with its reason:

- the pass's depths within 1e-3 of a plane interval of the reference's
  (measured: ~6e-5): the fold rounds every weight once more, the plain
  K4 samples at the pixel coordinates where ``grid_sample`` rescales
  them to [-1, 1] and back, and the convolutions sum in other orders;
- the plain K4 within rtol 1e-4, atol 1e-5 of the reference's
  ``grid_sample`` volume: the same bilinear weights, but ``grid_sample``'s
  coordinates round twice more (~1e-6 of a pixel), and the variance's
  difference of two sums magnifies an absolute error of the sums;
- the folded 2D and 3D stacks, transposed convolutions included, within
  4e-6 of the output's largest value of the unfolded ones (each float32
  stack is a rounding of the float64 one, and the U-Net's outputs reach
  ~21, where an absolute 1e-5 is a few ulps), and no farther from a
  float64 unfolded forward than the float32 unfolded one plus 1e-6 of the
  output's largest value (the fold only rounds its weights once more);
- after a change of the weights, the folded and the unfolded U-Net each
  within 4e-6 of the output's largest value of the float64 U-Net (its
  outputs reach ~46, where the two float32 nets are ~2e-5 from it).
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import scene as generator
from bench_torch.drivers.mvs_pass import mvsnet_weights
from bench_torch.reference import mvsnet as reference
from raynet_tpu_torch.inference import (
    MVSNetForwardPass,
    forward_pass,
    get_forward_pass_factory,
)
from raynet_tpu_torch.models.mvsnet import MVSNetModel, soft_argmin
from raynet_tpu_torch.ops import cost_volume as cv
from raynet_tpu_torch.scripts import forward_pass as port_cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
D = 16
TRAFFIC = {"name": "small", "kind": "ring", "n_images": 4, "height": 96,
           "width": 128, "focal": 220.0, "radius": 20.0, "angle_step": 0.04,
           "bbox_half": 6.5, "images_range": [0, 3, 1]}


def _config():
    config = json.loads((REPO / "bench_torch" / "configs"
                         / "mvsnet.json").read_text())
    config.update(depth_planes=D, neighbors=2, views=3)
    return config


def _params():
    return type("GP", (), dict(depth_planes=D, neighbors=2))()


def _pass(scene, model):
    fp = MVSNetForwardPass(model, _params(), None, scene.image_shape,
                           device=CPU)
    return fp, np.stack(list(fp.forward_pass(scene, (0, 3, 1))))


def test_mvsnet_is_a_factory():
    assert forward_pass._FACTORIES["mvsnet"] is MVSNetForwardPass
    assert get_forward_pass_factory("mvsnet") is MVSNetForwardPass


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_pass_matches_the_reference(seed):
    config = _config()
    scene = generator.make_scene(TRAFFIC, seed, CPU)
    weights = mvsnet_weights(config, seed, CPU)
    _, maps = _pass(scene, MVSNetModel(state_dict=weights, device=CPU))
    assert maps.shape == (3, 24, 32) and maps.dtype == np.float32
    judge = reference.run(scene, weights, config, TRAFFIC, [list(maps)], CPU)
    ref = np.stack(judge.reference_maps(96, 128))
    gap = np.abs(maps - ref) / np.array(judge.intervals)[:, None, None]
    assert gap.max() <= 1e-3
    assert judge.readings()[0]["depth_gap"] == pytest.approx(gap.max(),
                                                             rel=1e-3)
    assert judge.readings()[0]["scaled_gap"] <= gap.max()
    # the reference's depths move over most of the planes: not a flat map
    assert judge.spread()["range_max"] > D / 2


def test_scaled_gap_divides_by_the_spread_and_the_logit_scale():
    """scaled_gap: the gap in intervals over the pixel's spread (one
    interval where it is narrower) and the view's largest |logit|; the
    softmax's spread of the plane depths is what ``depth_map`` gives."""
    planes = torch.arange(4, dtype=torch.float32)
    # pixel 0 all on plane 1; pixel 1 halved between planes 0 and 3
    logits = torch.tensor([[-50.0, 0.0], [50.0, -50.0], [-50.0, -50.0],
                           [-50.0, 0.0]]).reshape(1, 1, 4, 1, 2)
    depth, spread = reference.depth_map(logits, planes)
    torch.testing.assert_close(depth, torch.tensor([[1.0, 1.5]]))
    torch.testing.assert_close(spread, torch.tensor([[0.0, 1.5]]))
    interval = 0.5
    got = depth + torch.tensor([[0.01, 0.06]])
    judge = reference.Judge([[got.numpy()]], 4)
    judge.add(0, depth, spread, interval, 50.0)
    (r,) = judge.readings()
    # in intervals 0.02 and 0.12; spreads 0 -> 1 interval, 3 intervals
    assert r["depth_gap"] == pytest.approx(0.12, rel=1e-5)
    assert r["scaled_gap"] == pytest.approx(max(0.02 / 1, 0.12 / 3) / 50,
                                            rel=1e-5)
    assert r["mismatch_share"] == 1.0
    assert judge.spread()["logit_scale_max"] == 50.0


def _features_and_cameras(seed=9):
    scene = generator.make_scene(TRAFFIC, seed, CPU)
    model = MVSNetModel(state_dict=mvsnet_weights(_config(), seed, CPU),
                        device=CPU)
    views = scene.get_view_idxs(1, 2)
    images = np.stack([scene.get_image(j).image_u8 for j in views])
    feats = model.predict(images)
    Ps = [scene.get_image(j).camera.P for j in views]
    return scene, feats, Ps


def test_plain_cost_volume_equals_grid_sample_volume():
    scene, feats, Ps = _features_and_cameras()
    P = cv.feature_cameras(Ps, 0, 0)
    depths = torch.as_tensor(cv.plane_depths(P[0], scene.bbox, D))
    homs = torch.as_tensor(cv.homographies(P))
    got = cv.cost_volume(feats, homs, depths)
    projs = np.stack([reference.projection(p, 0, 0) for p in Ps])
    want = reference.cost_volume(feats.permute(0, 3, 1, 2), projs, depths)
    assert got.shape == want.shape == (1, 32, D, 24, 32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # warps that leave the maps (zero taps) are part of the comparison
    uv1 = np.stack(np.meshgrid(np.arange(32.0), np.arange(24.0),
                               [1.0]), -1).reshape(-1, 3)
    h = cv.homographies(P)
    x = [(z * uv1 @ h[k, :9].reshape(3, 3).T + h[k, 9:]) for k in range(2)
         for z in depths.numpy()]
    x = np.concatenate([p[:, 0] / p[:, 2] for p in x])
    assert (x < 0).any() or (x > 31).any()


def test_planes_and_homographies_follow_the_cameras():
    scene, _, Ps = _features_and_cameras()
    top, left, h, w = cv.crop_window(1200, 1600)
    assert (top, left, h, w) == (8, 0, 1184, 1600)
    P = cv.feature_cameras(Ps, 4, 8)
    z = cv.plane_depths(P[0], scene.bbox, D)
    lo, hi = scene.bbox.reshape(2, 3).astype(np.float64)
    corners = np.array([[x, y, c, 1.0] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for c in (lo[2], hi[2])])
    # camera z: the depth along the optical axis of the camera's centre
    centre = -np.linalg.solve(P[0, :, :3], P[0, :, 3])
    axis = P[0, 2, :3]
    cz = (corners[:, :3] - centre) @ axis
    np.testing.assert_allclose([z[0], z[-1]], [cz.min(), cz.max()],
                               rtol=1e-12)
    np.testing.assert_allclose(np.diff(z), (z[-1] - z[0]) / (D - 1))
    # a pixel at depth z lands where the source camera sees the 3D point
    homs = cv.homographies(P)
    u, v, d = 7.25, 3.5, z[5]
    X = np.linalg.solve(P[0, :, :3], d * np.array([u, v, 1.0]) - P[0, :, 3])
    for k in range(2):
        A, b = homs[k, :9].reshape(3, 3), homs[k, 9:]
        p = d * A @ np.array([u, v, 1.0]) + b
        q = P[k + 1] @ np.append(X, 1.0)
        np.testing.assert_allclose(p[:2] / p[2], q[:2] / q[2], rtol=1e-9)


def _float(module, dtype):
    return copy.deepcopy(module).eval().to(dtype)


# the float32 nets' largest error against the float64 one, over its
# largest |output|: ~10x the 2.0e-5 / 2.3e-5 at 46.5 measured on the CPU
FOLD_FOLLOWS_RTOL = 4e-6


@pytest.mark.parametrize("part", ["feature", "cost_regularization"])
def test_folded_stack_equals_the_unfolded_one(part):
    model = MVSNetModel(state_dict=mvsnet_weights(_config(), 13, CPU),
                        device=CPU)
    g = torch.Generator().manual_seed(2)
    if part == "feature":
        images = torch.randint(0, 256, (2, 64, 96, 3), dtype=torch.uint8,
                               generator=g)
        got = model.predict(images)
        x = images.permute(0, 3, 1, 2).to(torch.float64) / 255.0
        permute = (0, 2, 3, 1)
    else:
        x = torch.rand((1, 32, 16, 16, 24), dtype=torch.float64,
                       generator=g) * 0.1
        got = model.regularize(x.to(torch.float32))
        permute = (0, 1, 2, 3, 4)
    net = getattr(model.model, part)
    with torch.no_grad():
        want = _float(net, torch.float32)(x.to(torch.float32))
        exact = _float(net, torch.float64)(x)
    want, exact = want.permute(*permute), exact.permute(*permute)
    # the folded and the unfolded float32 stacks, each a float32 rounding
    # of the float64 one, held to each other at the scale of the output's
    # largest value (the U-Net's reach ~21, where an ulp is 1.9e-6)
    bar = FOLD_FOLLOWS_RTOL * exact.abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= bar
    fold_err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    assert fold_err <= plain_err + 1e-6 * exact.abs().max().item()
    assert model.fold_builds == 1


def test_fold_follows_a_change_of_the_weights():
    model = MVSNetModel(seed=1, device=CPU)
    x = torch.rand((1, 32, 8, 8, 8),
                   generator=torch.Generator().manual_seed(4))
    first = model.regularize(x)
    model.model.load_state_dict(mvsnet_weights(_config(), 4, CPU))
    second = model.regularize(x)
    assert model.fold_builds == 2
    assert not torch.equal(first, second)
    net = model.model.cost_regularization
    with torch.no_grad():
        unfolded = net(x)
        exact = _float(net, torch.float64)(x.double())
    # both float32 nets against the float64 one: the outputs reach ~46,
    # where an ulp is 3.8e-6, and each float32 net is ~2e-5 from the
    # float64 one, so the two are not held to each other at an absolute
    # 1e-5; a fold of the wrong weights is off by O(1)
    bar = FOLD_FOLLOWS_RTOL * exact.abs().max().item()
    for got in (second, unfolded):
        assert (got.double() - exact).abs().max().item() <= bar


def test_counters_count_a_volume_a_view():
    scene = generator.make_scene(TRAFFIC, 17, CPU)
    model = MVSNetModel(seed=17, device=CPU)
    launches = cv.cost_volume.launches
    fp, maps = _pass(scene, model)
    assert fp.volumes == 3 and len(maps) == 3
    # the three views' view sets hold images 0-3, each featurised once
    assert model.folded_layers == 7 * 4 + 10 * 3
    assert model.fold_builds == 1
    # the plain path never counts a launch
    assert cv.cost_volume.launches == launches
    counts = fp.timer.counts
    assert counts["Cost volume"] == counts["Cost regularization"] \
        == counts["Depth regression"] == 3
    assert counts["Features computation"] == 4
    assert fp.overlapped_views == 2


def test_soft_argmin_is_the_expected_depth():
    depths = torch.linspace(2.0, 9.5, 16)
    logits = torch.full((1, 1, 16, 2, 3), -1e4)
    logits[0, 0, 5, 0] = 0.0
    logits[0, 0, [3, 4], 1] = 0.0
    got = soft_argmin(logits, depths)
    torch.testing.assert_close(got[0], depths[5].expand(3))
    torch.testing.assert_close(got[1], ((depths[3] + depths[4]) / 2)
                               .expand(3))


def test_depth_planes_must_divide_by_eight():
    scene = generator.make_scene(TRAFFIC, 1, CPU)
    fp = MVSNetForwardPass(MVSNetModel(seed=0, device=CPU),
                           type("GP", (), dict(depth_planes=12,
                                               neighbors=2))(),
                           None, scene.image_shape, device=CPU)
    with pytest.raises(ValueError, match="multiple of 8"):
        next(fp.forward_pass(scene, (0, 1, 1)))


def test_cli_runs_mvsnet_from_a_saved_state_dict(mock_scene_dir, tmp_path):
    from raynet_tpu_torch.scripts.arguments import build_dataset

    weights = tmp_path / "mvsnet.pt"
    model = MVSNetModel(state_dict=mvsnet_weights(_config(), 23, CPU),
                        device=CPU)
    torch.save(model.model.state_dict(), weights)
    out = tmp_path / "out"
    port_cli.main([
        str(mock_scene_dir.parent), str(out), "--scene_idx", "0",
        "--forward_pass_factory", "mvsnet", "--depth_planes", str(D),
        "--start_end", "0,2", "--weight_file", str(weights),
        "--device", "cpu"])
    scene = build_dataset("restrepo", str(mock_scene_dir.parent), "max",
                          device="cpu").get_scene(0)
    fp = MVSNetForwardPass(model, type("GP", (), dict(
        depth_planes=D, neighbors=4))(), None, scene.image_shape,
        device=CPU)
    want = list(fp.forward_pass(scene, (0, 2, 1)))
    for i in range(2):
        got = np.load(out / ("depth_%03d.npy" % i))
        # the 36x48 mock views crop to 32x32: 8x8 maps
        assert got.shape == (8, 8) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want[i])

"""The yardstick's counts at tiny shapes, against values worked out by
hand, and the closed-form visits against the reference's march."""
import pytest
import torch

from bench_torch import roofline, scene
from bench_torch.reference import plain


def test_conv_stack_flops():
    # a 4x5 image padded by 1 is 6x7; one VALID 3x3 conv of 2 filters over
    # 1 channel gives 4x5x2 outputs of 9 multiply-accumulates each
    assert roofline.conv_stack_flops([[2, 3, 1]], 4, 5, 1, 1) == 2 * 4 * 5 * 2 * 9
    # a second conv of 3 filters over the 2 channels: 2x3x3 outputs of 18
    assert roofline.conv_stack_flops([[2, 3, 1], [3, 3, 1]], 4, 5, 1, 1) \
        == 720 + 2 * 2 * 3 * 3 * 18
    # dilation 2 spans 5 pixels: 6x7 -> 2x3
    assert roofline.conv_stack_flops([[1, 3, 2]], 4, 5, 1, 1) == 2 * 2 * 3 * 9


def test_plane_sweep_cost():
    c = roofline.plane_sweep_cost(n_rays=2, planes=3, views=3, feature_dim=4,
                                  feature_rows=5)
    # endpoints 2x24, 3 projections of 48, 5 rows of 4 floats, 2x3 scores
    assert c.nbytes == 48 + 144 + 80 + 24
    # per (ray, plane): point 7, 3 projections of 20, 3 pairs of 2x4, 4
    assert c.ops == 2 * 3 * (7 + 60 + 24 + 4)


def test_sweep_costs():
    m = roofline.bp_sweep_cost("message", n_rays=2, planes=3, visits=10,
                               grid_cells=100)
    assert m.nbytes == 2 * (24 + 12) + 2 * 4 + 2 * 10 * 4 + 2 * 10 * 4
    assert m.ops == 10 * (6 + 32 + 9 + 18 + 1)
    f = roofline.bp_sweep_cost("first", 2, 3, 10, 4)
    assert f.nbytes == 72 + 8 + 40 + 16 and f.ops == 10 * (6 + 32 + 18 + 1)
    d = roofline.bp_sweep_cost("depth", 2, 3, 10, 100)
    assert d.nbytes == 72 + 8 + 40 + 40 + 8 and d.ops == 10 * (6 + 32 + 9 + 7)
    v = roofline.voxel_depth_cost(2, 3, 10)
    assert v.nbytes == 72 + 16 + 36 and v.ops == 10 * 39
    work = {"images": [{"rays": 2, "visits": 10, "feature_rows": 5}] * 2,
            "views": 3, "planes": 3, "feature_dim": 4, "grid_cells": 100,
            "cnn_flops": 1000}
    sweeps = roofline.pass_sweeps({"factory": "raynet", "bp_iterations": 3})
    assert sweeps == [["first", 1], ["message", 2], ["depth", 1]]
    assert roofline.pass_sweeps({"factory": "multi_view_cnn_voxel_space"}) \
        == [["voxel_depth", 1]]
    assert len(roofline.sweep_costs(work, sweeps)) == 8
    assert len(roofline.sweep_costs(work, sweeps, ("message",))) == 4
    assert roofline.pass_flops(work, sweeps) == 1000 + 2 * 570 + 2 * (
        f.ops + 2 * m.ops + d.ops)


def test_bound():
    c = roofline.Cost(nbytes=3.35e12, ops=67e12 / 2)
    assert roofline.bound_seconds(c) == pytest.approx(1.0)
    assert roofline.bound_by(c) == "bytes"


def _seg(*pts):
    return torch.tensor([pts], dtype=torch.float32)


def test_closed_form_visits_by_hand():
    bbox = torch.tensor([0, 0, 0, 4, 4, 4], dtype=torch.float32)
    grid = (4, 4, 4)

    def visits(a, b, m=64):
        return int(roofline.closed_form_visits(_seg(*a), _seg(*b), bbox,
                                               grid, m)[0])

    assert visits((0.5, 0.5, 0.5), (2.5, 0.5, 0.5)) == 3
    assert visits((0.5, 0.5, 0.5), (2.5, 1.5, 3.5)) == 1 + 2 + 1 + 3
    assert visits((0.5, 0.5, 0.5), (2.5, 1.5, 3.5), m=5) == 5
    assert visits((5, 5, 5), (6, 6, 6)) == 0
    # an endpoint on a cell face is nudged into the segment
    assert visits((0.0, 0.5, 0.5), (4.0, 0.5, 0.5)) == 4
    # a segment of no length (a ray that touches the box) visits nothing,
    # also where it lies on a min face, which the nudges would put a cell
    # apart
    assert visits((0.0, 2.0, 1.5), (0.0, 2.0, 1.5)) == 0
    assert visits((1.5, 2.5, 4.0), (1.5, 2.5, 4.0)) == 0


@pytest.mark.parametrize("point", [(0.0, 2.0, 1.5), (1.5, 0.0, 0.0),
                                   (1.5, 2.5, 4.0)])
def test_a_segment_of_no_length_is_marched_through_no_voxel(point):
    bbox = torch.tensor([0, 0, 0, 4, 4, 4], dtype=torch.float32)
    flat, counts = plain.march(bbox, _seg(*point), _seg(*point), (4, 4, 4), 8)
    assert int(counts[0]) == 0 and not flat.any()


def test_closed_form_visits_match_the_march():
    # the rays of a ring view through the bbox, as a pass marches them: the
    # closed form takes no account of a march cut short where float32
    # crossing times disagree with the endpoints' cells, so a few rays
    # differ, and the totals by a few in ten thousand
    traffic = dict(kind="ring", n_images=2, height=60, width=80,
                   focal=137.5, radius=20.0, angle_step=0.04, bbox_half=3.0)
    sc = scene.make_scene(traffic, 1, "cpu")
    bbox = plain.f32(sc.bbox.reshape(-1), "cpu")
    cam = sc.get_image(0).camera
    a, b = plain.segments(60, 80, plain.f32(cam.P_pinv, "cpu"),
                          plain.f32(cam.center[:3, 0], "cpu"), bbox)
    grid = (32, 32, 16)
    _, counts = plain.march(bbox, a, b, grid, 100)
    closed = roofline.closed_form_visits(a, b, bbox, grid, 100)
    assert (closed == counts.long()).float().mean() >= 0.98
    assert abs(int(closed.sum()) / int(counts.sum()) - 1) < 2e-3


def test_touched_feature_rows_by_hand():
    # a camera whose pixel is (x, y): rows x, y and the homogeneous 1
    P = torch.tensor([[[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]]],
                     dtype=torch.float32)
    start = torch.tensor([[1.0, 1.0, 0.0]])
    end = torch.tensor([[3.0, 1.0, 0.0]])
    # 3 planes at x = 1, 2, 3: cells (x + 1, 2), three distinct rows
    assert roofline.touched_feature_rows(P, start, end, 3, 1, 10, 10,
                                         (1, 12, 12, 8)) == 3
    # 5 planes at x = 1, 1.5, 2, 2.5, 3 round half to even: 1, 2, 2, 2, 3
    assert roofline.touched_feature_rows(P, start, end, 5, 1, 10, 10,
                                         (1, 12, 12, 8)) == 3

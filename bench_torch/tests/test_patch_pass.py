"""The ``hartmann_fp`` cell on the CPU: a tiny cell of its own (a framed
ring of 16x12 views, so that every ray crosses the bbox, D = 4, the
published widths) runs correct, traced and untraced; the check catches
its faults; the counts of its work against values worked out by hand."""
import time

import numpy as np
import pytest
import torch

from bench_torch import harness, patch_roofline
from conftest import add_cell, tiny_config

CELL = "tiny_hartmann_fp.tiny_framed"
TINY_FRAMED = {
    "name": "tiny_framed", "kind": "ring",
    "why": "4 views of 16x12 whose rays all cross the bbox",
    "n_images": 4, "height": 12, "width": 16, "focal": 27.5, "radius": 20.0,
    "angle_step": 0.04, "bbox_half": 6.5, "images_range": [1, 2, 1],
}


@pytest.fixture
def patch_checkout(checkout):
    config = dict(tiny_config("hartmann_fp"), depth_planes=4, neighbors=2)
    add_cell(checkout, config, TINY_FRAMED)
    return checkout


def _run(root, trace=False, seed=2**31 + 9):
    return harness.run_cell(CELL, seed, 0.2, trace, "cpu",
                            time.perf_counter(), root=root)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(patch_checkout, trace):
    result = _run(patch_checkout, trace)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    names = set(result["metrics"])
    if trace:
        # no card: no phase device time, no device in the trace, no peak
        assert names == set()
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert names == {"px_per_s", "pass_p90_s", "peak_mem_GB", "setup_s"}


def test_one_depth_altered(patch_checkout, monkeypatch):
    from raynet_tpu_torch.inference import forward_pass

    whole = forward_pass.HartmannForwardPass.forward_pass

    def altered(self, scene, images_range):
        for depth in whole(self, scene, images_range):
            depth = depth.copy()
            k = np.unravel_index(np.argmax(depth), depth.shape)
            depth[k] *= 1.001
            yield depth

    monkeypatch.setattr(forward_pass.HartmannForwardPass, "forward_pass",
                        altered)
    assert _run(patch_checkout)["correct"] is False


def test_half_of_the_rays_left_out(patch_checkout, monkeypatch):
    from raynet_tpu_torch.inference import forward_pass

    scores = forward_pass.HartmannForwardPass.image_scores

    def half(self, images, points):
        # the second half of the rays (column-major) is never scored
        out = scores(self, images, points[:, :points.shape[1] // 2])
        rest = out.new_zeros((points.shape[1] - out.shape[0], out.shape[1]))
        return torch.cat([out, rest])

    monkeypatch.setattr(forward_pass.HartmannForwardPass, "image_scores",
                        half)
    assert _run(patch_checkout)["correct"] is False


def test_net_flops_by_hand():
    import chip_smoke

    # 32x32x3, V = 5: conv5 to 32 on 28x28 outputs, pool to 14x14, conv5
    # to 64 on 10x10, pool to 5x5, per view; then on the mean conv5 to
    # 2048 on 1x1, conv1 2048 -> 2048, conv1 2048 -> 2
    branch = 5 * (28 * 28 * 32 * 5 * 5 * 3 + 10 * 10 * 64 * 5 * 5 * 32)
    head = 2048 * 5 * 5 * 64 + 2048 * 2048 + 2 * 2048
    assert 2 * branch == 70_016_000 and 2 * head == 14_950_400
    flops = patch_roofline.net_flops((32, 32, 3), 5, [[32, 5], [64, 5]],
                                     [[2048, 5], [2048, 1], [2, 1]])
    assert flops == 2 * (branch + head) == 84_966_400
    assert flops == chip_smoke.hartmann_flops((32, 32, 3), 5)


def test_pass_work_of_the_cell():
    bench = harness.Benchmark()
    cell = bench.workload("hartmann_fp.ring8_eighth")
    config = bench.config(cell["config"])
    work = patch_roofline.pass_work(config, bench.traffic(cell["traffic"]))
    # one reference view of 200x150 at D = 32
    assert work["quintuples"] == 960_000
    assert work["net"].ops == 960_000 * 84_966_400
    # per quintuple: 5 patches of 32x32x3 float32 read, one score written
    assert work["net"].nbytes == 960_000 * (5 * 1024 * 12 + 4)
    # per view and patch pixel: an int64 index, 3 texels read, 3 written
    assert work["gather"] == (960_000 * 5 * 1024 * 32, 0)

"""The check of ``correct`` catches the faults a cell can have: a run of a
tiny cell on the CPU, the harness's look for a card skipped, with the
program's timed path broken underneath, comes out not correct.

One chip, so no exchange between chips to leave out. The faults: a BP
sweep that returns its state unchanged (raynet); half of each view's rays
left out; one depth altered where it is produced.
"""
import time

import pytest
import torch

from bench_torch import harness

CELLS = ["tiny_raynet.tiny", "tiny_mvcnn_voxel.tiny"]


def _run(checkout, workload):
    return harness.run_cell(workload, 11, 0.2, False, "cpu",
                            time.perf_counter(), root=checkout)


def test_sound_runs_are_correct(checkout):
    for workload in CELLS:
        assert _run(checkout, workload)["correct"] is True


def test_bp_sweep_leaving_its_state_unchanged(checkout, monkeypatch):
    from raynet_tpu_torch.ops import fused

    def unchanged(messages, scores, scatter_total, grid_acc, *args, **kw):
        return messages, scatter_total

    monkeypatch.setattr(fused, "raynet_image_update", unchanged)
    assert _run(checkout, "tiny_raynet.tiny")["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_rays_left_out(checkout, monkeypatch, workload):
    from raynet_tpu_torch.inference import forward_pass

    whole = forward_pass.ForwardPass.get_valid_rays_per_image

    def half(self, scene, i):
        idxs = whole(self, scene, i)
        return idxs[: len(idxs) // 2]

    monkeypatch.setattr(forward_pass.ForwardPass, "get_valid_rays_per_image",
                        half)
    assert _run(checkout, workload)["correct"] is False


@pytest.mark.parametrize("workload,name", [
    ("tiny_raynet.tiny", "raynet_image_depth"),
    ("tiny_mvcnn_voxel.tiny", "mvcnn_voxel_image_depth"),
])
def test_one_depth_altered(checkout, monkeypatch, workload, name):
    from raynet_tpu_torch.ops import fused

    produce = getattr(fused, name)

    def altered(*args, **kw):
        depth = produce(*args, **kw).clone()
        k = int(torch.argmax(depth))
        depth[k] = depth[k] * 1.001
        return depth

    monkeypatch.setattr(fused, name, altered)
    assert _run(checkout, workload)["correct"] is False

"""The launch path every kernel wrapper shares (``ops/cuda_build``), on the
CPU: each of the six wrappers (K1, K2, K3 rows, K3 depth, P1, P2) refuses a
device that is neither CUDA nor the CPU, and ``launch`` hands a fake
library the current stream's handle last, raises on a nonzero return and
switches no device when the tensor's is current."""
import contextlib

import pytest
import torch

from raynet_tpu_torch.ops import bp_sweep, cuda_build, planesweep
from raynet_tpu_torch.ops import ray_marching, voxel_depth
from raynet_tpu_torch.tools import probe_dma_align as probes

N, D, M = 4, 8, 8
GRID = (4, 4, 4)


def _meta(*shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype, device="meta") for s in shapes]


def _k1():
    feats, P, rs, re = _meta((2, 12, 12, 8), (2, 3, 4), (N, 3), (N, 3))
    planesweep.plane_sweep_scores(feats, P, rs, re, 1, 10, 10, D)


def _k2():
    rs, re, S, grid, c, bbox = _meta((N, 3), (N, 3), (N, D), (64,), (3,),
                                     (6,))
    bp_sweep.bp_sweep(rs, re, S, None, None, grid, c, bbox, GRID, M, 0.0,
                      "first")


def _k3_rows():
    bbox, rs, re = _meta((6,), (N, 3), (N, 3))
    ray_marching.voxel_traversal_flat(bbox, rs, re, GRID, M)


def _k3_depth():
    bbox, rs, re, S, c = _meta((6,), (N, 3), (N, 3), (N, D), (3,))
    voxel_depth.voxel_argmax_depth(bbox, rs, re, S, c, GRID, M)


def _p1():
    (src,) = _meta((probes.WG, probes.HF, probes.WIDTH),
                   dtype=torch.bfloat16)
    probes.tma_box_rows(src, 0, 0, 0)


def _p2():
    x, e = _meta((16, 8), (8, 8))
    probes.tensor_core_dot(x, e, "raw")


@pytest.mark.parametrize("op", [_k1, _k2, _k3_rows, _k3_depth, _p1, _p2],
                         ids=["K1", "K2", "K3-rows", "K3-depth", "P1", "P2"])
def test_wrapper_refuses_an_unsupported_device(op):
    with pytest.raises(ValueError, match="unsupported device meta"):
        op()


class _FakeLibrary:
    def __init__(self, err):
        self.err, self.calls = err, []

    def raynet_fake_entry(self, *args):
        self.calls.append(args)
        return self.err


class _OnDevice:
    """What ``launch`` reads of a CUDA tensor: its device index."""

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


def test_launch_passes_the_stream_last_and_raises_on_error(monkeypatch):
    guards, device_guard = [], cuda_build.device_guard

    def guard(index):
        # the guard for a runtime whose current device is 0, recorded; a
        # CPU build cannot enter a switch, so the launch runs without it
        guards.append(device_guard(index, current=0))
        return contextlib.nullcontext()

    monkeypatch.setattr(cuda_build, "device_guard", guard)
    monkeypatch.setattr(cuda_build, "raw_stream", lambda index: 7000 + index)
    lib = _FakeLibrary(0)
    cuda_build.launch("raynet_fake_entry", _OnDevice(0), 11, None, 2.5,
                      lib=lib)
    assert lib.calls == [(11, None, 2.5, 7000)]
    # the current device: a context that switches nothing
    assert isinstance(guards[0], contextlib.nullcontext)

    lib = _FakeLibrary(719)
    with pytest.raises(RuntimeError,
                       match="raynet_fake_entry: CUDA error 719 at launch"):
        cuda_build.launch("raynet_fake_entry", _OnDevice(1), 3, lib=lib)
    assert lib.calls == [(3, 7001)]
    assert isinstance(guards[1], torch.cuda.device) and guards[1].idx == 1

"""The per-view host tail of the port's passes on the CPU: each yielded
depth map is, bit for bit, the numpy scatter of that view's depths into a
zeroed (H, W) map (same dtype, shape and strides), in every pass and
store and with ``filter_out_rays``; ``overlapped_views`` counts the views
waited for after a later view's work was queued; a generator closed after
its first map leaves no span open, and the object's next call yields the
same maps. The card's half (page-locked maps, no synchronising copy in a
cached call) is in ``tests/test_torch_cuda_kernels.py``."""
import numpy as np
import pytest
import torch

from raynet_tpu_torch.ops import fused
from raynet_tpu_torch.utils import profiling
from test_torch_profiling import PASS, RAYNET, VIEWS, VOXEL, _pass, _ranges

MVCNN = "multi_view_cnn"
# the op each pass takes a view's depths from
DEPTH_OPS = {RAYNET: "raynet_image_depth", VOXEL: "mvcnn_voxel_image_depth",
             MVCNN: "mvcnn_image_depth"}
SETUPS = {
    "raynet": (RAYNET, dict()),
    "raynet-host-store": (RAYNET, dict(host_store=True)),
    "raynet-filter": (RAYNET, dict(filter_out_rays=True)),
    "voxel": (VOXEL, dict()),
    "mvcnn": (MVCNN, dict()),
}
N_VIEWS = len(range(*VIEWS))


def _masked(scene):
    """Give the ring scene ground-truth depth maps with ~30% zeros, a
    pattern of its own for each view."""
    H, W = scene.image_shape

    def get_depth_map(i):
        rng = np.random.RandomState(100 + i)
        return np.where(rng.rand(H, W) < 0.3, 0.0, 20.0).astype(np.float32)

    scene.get_depth_map = get_depth_map
    return scene


def _setup(name):
    factory, kw = SETUPS[name]
    fp, scene = _pass(factory, **kw)
    if kw.get("filter_out_rays"):
        _masked(scene)
    return factory, fp, scene


def _record_depths(monkeypatch, factory):
    """The depths (as float32 numpy) the pass's depth op returns, in call
    order."""
    name = DEPTH_OPS[factory]
    produce = getattr(fused, name)
    out = []

    def recorded(*args, **kw):
        depth = produce(*args, **kw)
        out.append(depth.detach().cpu().numpy().copy())
        return depth

    monkeypatch.setattr(fused, name, recorded)
    return out


def _numpy_scatter(depth, ray_idxs, H, W):
    out = np.zeros(H * W, dtype=np.float32)
    out[ray_idxs] = depth
    return out.reshape(W, H).T


def _assert_bit_equal(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.strides == want.strides
    assert np.array_equal(np.ascontiguousarray(got).view(np.uint32),
                          np.ascontiguousarray(want).view(np.uint32))


@pytest.mark.parametrize("name", list(SETUPS))
def test_each_map_is_the_numpy_scatter_of_its_depths(name, monkeypatch):
    factory, fp, scene = _setup(name)
    depths = _record_depths(monkeypatch, factory)
    maps = list(fp.forward_pass(scene, VIEWS))
    H, W = scene.image_shape
    assert len(maps) == len(depths) == N_VIEWS
    for i, m, d in zip(range(*VIEWS), maps, depths):
        ray_idxs = fp.get_valid_rays_per_image(scene, i)
        if SETUPS[name][1].get("filter_out_rays"):
            assert 0 < len(ray_idxs) < H * W
        assert len(d) == len(ray_idxs)
        _assert_bit_equal(m, _numpy_scatter(d, ray_idxs, H, W))
        assert (m > 0).sum() > 0
    if name == "raynet-host-store":
        assert fp.message_store != "device"


@pytest.mark.parametrize("name", ["raynet", "raynet-host-store", "voxel",
                                  "mvcnn"])
def test_overlapped_views_counts_n_minus_one_a_call(name):
    _, fp, scene = _setup(name)
    assert fp.overlapped_views == 0
    for call in (1, 2):
        maps = list(fp.forward_pass(scene, VIEWS))
        assert len(maps) == N_VIEWS
        assert fp.overlapped_views == call * (N_VIEWS - 1)
    list(fp.forward_pass(scene, (1, 2, 1)))
    assert fp.overlapped_views == 2 * (N_VIEWS - 1)


@pytest.mark.parametrize("factory", [RAYNET, VOXEL, MVCNN])
def test_a_generator_closed_early_leaves_no_span_open(factory, tmp_path):
    fp, scene = _pass(factory)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function(PASS):
            gen = fp.forward_pass(scene, VIEWS)
            first = next(gen)
            with torch.profiler.record_function("consumer"):
                pass
            gen.close()
    ranges = _ranges(profiling.read_trace(
        str(tmp_path / profiling.TRACE_NAME)))
    consumer = next(r for r in ranges if r[2] == "consumer")
    # every range the program opened had closed when its map was handed
    # over; nothing ran after the close
    for s, e, name in ranges:
        if name not in (PASS, "consumer"):
            assert e <= consumer[0], name
    again = list(fp.forward_pass(scene, VIEWS))
    fresh, _ = _pass(factory)
    want = list(fresh.forward_pass(scene, VIEWS))
    assert len(again) == len(want) == N_VIEWS
    _assert_bit_equal(first, want[0])
    for got, w in zip(again, want):
        _assert_bit_equal(got, w)

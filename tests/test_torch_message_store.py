"""The port's raynet pass with its messages in the host store, against the
JAX package's pass with the matching store, on the mock scene (D=8, grid
12^3, M=24, 3 reference views).

The store is forced by a lowered ``messages_device_budget`` (the messages
of 3 views no longer fit beside their scores and segments). Bars: a float32 store >= 0.999 of the pixels within 1e-4
relative of the JAX package's float32 pass (and bit for bit the port's own
device-store pass); a float16 store >= 0.995 within rtol = atol = 1e-3 of
the JAX package's float16 pass (the JAX package's own float16 bar,
``tests/test_forward_pass.py::test_raynet_float16_messages``).
"""
import glob
import os
import tempfile

import numpy as np
import pytest
import torch

from raynet_tpu.common.generation_parameters import GenerationParameters
from raynet_tpu.common.sampling_schemes import get_sampling_scheme
from raynet_tpu.common.scene import RestrepoScene
from raynet_tpu.inference import get_forward_pass_factory as jax_factory
from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
)
from raynet_tpu_torch.inference import RayNetForwardPass
from raynet_tpu_torch.inference import message_store
from raynet_tpu_torch.models.convert import state_dict_from_flax
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.ops import bp_sweep, fused
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

M, D, VIEWS = 24, 8, (0, 3, 1)
# 3 views of H*W rays: scores, segments and the march sums 331,776 bytes,
# with all messages on the device 829,440
BUDGET = 700_000
SPILL_PREFIX = "raynet_tpu_torch_msgs_"
STORES = {
    # kind: (messages_dtype, messages_memmap_threshold)
    "host_f32": (None, 2 ** 28),
    "host_f16": (np.float16, 2 ** 28),
    "memmap": (None, 100),
    "memmap_f16": (np.float16, 100),
}


@pytest.fixture(scope="module")
def setup(mock_scene_dir):
    scene = RestrepoScene(str(mock_scene_dir))
    gp = GenerationParameters(
        depth_planes=D, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array([12, 12, 12], dtype=np.int32),
        max_number_of_marched_voxels=M, padding=11,
        sampling_type="sample_points_in_bbox", gamma_mrf=0.05,
    )
    jfe = JaxFeatureExtractor("simple_cnn", seed=0)
    tfe = FeatureExtractor(
        "simple_cnn", state_dict=state_dict_from_flax(jfe.variables),
        device="cpu",
    )
    return scene, gp, jfe, tfe, {}


def _jax_maps(setup, dtype, memmap_threshold):
    scene, gp, jfe, _, cache = setup
    key = (str(dtype), memmap_threshold)
    if key not in cache:
        fp = jax_factory("raynet")(
            jfe, gp, get_sampling_scheme("sample_in_bbox")(gp),
            scene.image_shape, H * W,
        )
        fp.messages_dtype = dtype
        fp.messages_memmap_threshold = memmap_threshold
        cache[key] = np.stack(list(fp.forward_pass(scene, VIEWS)))
    return cache[key]


def _port(setup, budget=BUDGET, dtype=None, memmap_threshold=2 ** 28,
          rays_batch=700, bp_iterations=None):
    scene, gp, _, tfe, _ = setup
    fp = RayNetForwardPass(tfe, gp, None, scene.image_shape, rays_batch,
                           device="cpu")
    fp.messages_device_budget = budget
    fp.messages_dtype = dtype
    fp.messages_memmap_threshold = memmap_threshold
    if bp_iterations is not None:
        fp.bp_iterations = bp_iterations
    return fp


def _spill_dirs(root):
    return glob.glob(os.path.join(str(root), SPILL_PREFIX + "*"))


@pytest.fixture
def spill_root(tmp_path, monkeypatch):
    """Spill directories go under this test's tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("kind", sorted(STORES))
def test_host_store_matches_jax(setup, spill_root, kind):
    dtype, threshold = STORES[kind]
    bp_sweep.bp_sweep.launches = 0
    fp = _port(setup, dtype=dtype, memmap_threshold=threshold)
    maps = np.stack(list(fp.forward_pass(setup[0], VIEWS)))
    assert fp.message_store == ("memmap" if kind.startswith("memmap")
                                else kind)
    assert bp_sweep.bp_sweep.launches == 0  # the plain version on the CPU
    assert _spill_dirs(spill_root) == []
    jmaps = _jax_maps(setup, dtype, threshold)
    assert maps.shape == jmaps.shape == (3, H, W)
    assert np.isfinite(maps).all()
    assert np.array_equal(maps > 0, jmaps > 0)
    if dtype is None:
        close = np.abs(maps - jmaps) <= 1e-4 * np.abs(jmaps)
        assert close.mean() >= 0.999, close.mean()
        # the float32 store is the device store, staged: the same bits
        ref = _port(setup, budget=RayNetForwardPass.messages_device_budget)
        ref_maps = np.stack(list(ref.forward_pass(setup[0], VIEWS)))
        assert ref.message_store == "device" and ref.staged_bytes == 0
        assert np.array_equal(maps, ref_maps)
    else:
        close = np.isclose(maps, jmaps, rtol=1e-3, atol=1e-3)
        assert close.mean() >= 0.995, close.mean()
    # the first sweep downloads, each message sweep uploads and downloads,
    # the depth sweep uploads: 2 * bp_iterations copies of every block
    itemsize = np.dtype(dtype or np.float32).itemsize
    assert fp.staged_bytes == (2 * fp.bp_iterations * 3 * H * W * M
                               * itemsize)


def test_f16_store_is_f32_store_rounded(setup, monkeypatch):
    """After one BP sweep the float16 store holds exactly np.float16 of the
    float32 store's messages (the sweep reads no messages), and every
    entry past a ray's count is zero in both."""
    kept = []
    close = message_store.HostMessageStore.close

    def keep_and_close(self):
        if self.arrays:
            kept.append({i: np.array(a) for i, a in self.arrays.items()})
        close(self)

    monkeypatch.setattr(message_store.HostMessageStore, "close",
                        keep_and_close)
    for dtype in (np.float32, np.float16):
        fp = _port(setup, dtype=dtype, bp_iterations=1)
        list(fp.forward_pass(setup[0], VIEWS))
    f32, f16 = kept
    assert sorted(f32) == sorted(f16) == [0, 1, 2]
    for i in f32:
        assert f32[i].dtype == np.float32 and f16[i].dtype == np.float16
        np.testing.assert_array_equal(f16[i], f32[i].astype(np.float16))
        nonzero = (f32[i] != 0).sum(axis=1)
        tail = np.arange(M)[None, :] >= nonzero[:, None]
        assert not f32[i][tail].any() and not f16[i][tail].any()
        assert nonzero.max() > 1


def test_spill_dir_removed_on_completion_close_and_error(setup, spill_root,
                                                         monkeypatch):
    # completion
    fp = _port(setup, memmap_threshold=100)
    assert len(list(fp.forward_pass(setup[0], VIEWS))) == 3
    assert fp.message_store == "memmap" and _spill_dirs(spill_root) == []

    # the caller closes the generator after the first map
    gen = _port(setup, memmap_threshold=100).forward_pass(setup[0], VIEWS)
    assert next(gen).shape == (H, W)
    gen.close()
    assert _spill_dirs(spill_root) == []

    # a sweep raises half way, with the spill files in place
    calls, seen = [], []
    update = fused.raynet_image_update

    def failing_update(*args, **kwargs):
        calls.append(1)
        seen.append(len(_spill_dirs(spill_root)))
        if len(calls) == 5:
            raise RuntimeError("injected sweep failure")
        return update(*args, **kwargs)

    monkeypatch.setattr(fused, "raynet_image_update", failing_update)
    gen = _port(setup, memmap_threshold=100).forward_pass(setup[0], VIEWS)
    with pytest.raises(RuntimeError, match="injected"):
        next(gen)
    assert seen == [1] * 5
    assert _spill_dirs(spill_root) == []


def test_store_choice_by_size(setup):
    """The store follows the sizes alone: the device while everything fits,
    else the JAX package's dtype rule and memmap threshold."""
    from raynet_tpu.inference.forward_pass import (
        RayNetForwardPass as JaxRayNet,
    )

    jfp = JaxRayNet.__new__(JaxRayNet)
    for total in (0, 1 << 20, (1 << 28) - 1, 1 << 28, (1 << 28) + 1, 1 << 34):
        for dtype in (None, np.float32, np.float16):
            jfp.messages_dtype = dtype
            assert message_store.host_messages_dtype(
                dtype, total, 1 << 30) == np.dtype(jfp._host_msgs_dtype(total))
    assert (RayNetForwardPass.messages_dtype,
            RayNetForwardPass.messages_f16_threshold,
            RayNetForwardPass.messages_memmap_threshold) == (
        JaxRayNet.messages_dtype, JaxRayNet.messages_f16_threshold,
        JaxRayNet.messages_memmap_threshold)

    scene = setup[0]
    for budget, f16_threshold, expect in (
        (RayNetForwardPass.messages_device_budget, 1 << 30, "device"),
        (BUDGET, 1 << 30, "host_f32"),
        (BUDGET, 1000, "host_f16"),
    ):
        fp = _port(setup, budget=budget)
        fp.messages_f16_threshold = f16_threshold
        fp.bp_iterations = 1
        list(fp.forward_pass(scene, VIEWS))
        assert fp.message_store == expect


# kind: (dtype, memmap threshold) of a host store; None: the device store
ROUND_TRIPS = {
    "device": None,
    "host_f32": (np.float32, 10 ** 6),
    "host_f16": (np.float16, 10 ** 6),
    "memmap": (np.float16, 20),
}


@pytest.mark.parametrize("kind", list(ROUND_TRIPS))
def test_store_blocks_round_trip(tmp_path, monkeypatch, kind):
    """Either store alone: ``blocks`` yields every image once, in the order
    given, as a (rows, M) float32 block, zero on a first sweep; what was
    written comes back (rounded to float16 in a float16 store); memmap
    files per image over the threshold and none under it; ``close``, twice,
    leaves no spill directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rows = {3: 5, 7: 9}
    rng = np.random.RandomState(0)
    if ROUND_TRIPS[kind] is None:
        dtype, itemsize = np.float32, 0  # nothing is staged
        store = message_store.DeviceMessageStore(rows, 6, "cpu")
    else:
        dtype, threshold = ROUND_TRIPS[kind]
        itemsize = np.dtype(dtype).itemsize
        store = message_store.HostMessageStore(rows, 6, dtype, threshold,
                                               "cpu")
    assert store.kind == kind
    if kind == "memmap":
        files = os.listdir(store.spill_dir)
        assert sorted(files) == ["messages_pon_3.dat", "messages_pon_7.dat"]
    written = {}
    for i, block in store.blocks([7, 3], upload=False, download=True):
        assert block.dtype == torch.float32 and block.shape == (rows[i], 6)
        assert not block.any()
        written[i] = rng.randn(rows[i], 6).astype(np.float32)
        block.copy_(torch.from_numpy(written[i]))
    assert list(written) == [7, 3]
    read = []
    for i, block in store.blocks([3, 7], upload=True, download=False):
        read.append(i)
        np.testing.assert_array_equal(
            block.numpy(), written[i].astype(dtype).astype(np.float32))
    assert read == [3, 7]
    assert store.staged_bytes == 2 * 14 * 6 * itemsize
    store.close()
    store.close()
    assert os.listdir(str(tmp_path)) == []

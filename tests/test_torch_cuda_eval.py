"""The raynet pass through the host message store, the ground-truth
raycaster and the evaluation layer on the card, against the device store
and the CPU.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the test conftest, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_eval.py

Tolerances: the store's blocks come back bit for bit (float32) or as
``Tensor.half()`` of what was written (float16, equal to ``np.float16``);
the staged pass against the device-store pass: zero masks identical and
>= 0.999 of the pixels within 1e-5 relative with a float32 store (K2's
float atomics add the grid in a run-dependent order, so two device-store
runs differ in the last bits too), >= 0.995 within rtol = atol = 1e-3 with
a float16 store (the JAX package's float16 bar); the raycaster's hit masks
identical to the CPU's and depths within 1e-5 relative; K3's rows mode
through ``ops.backends`` exact; the depth->voxel mappings within rtol
1e-5, atol 1e-7 of the CPU, and one sweep of the PyTorch BP backend within
rtol 1e-4, atol 1e-5 (the card adds the grid in another order).
"""
import glob
import tempfile

import numpy as np
import pytest
import torch

from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.common.scene import mesh_depth_map
from raynet_tpu_torch.inference import RayNetForwardPass
from raynet_tpu_torch.inference.message_store import HostMessageStore
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.ops import backends, bp_inference
from raynet_tpu_torch.ops import bp_sweep as bp
from raynet_tpu_torch.ops import planesweep as ps
from raynet_tpu_torch.ops import ray_marching as rm
from raynet_tpu_torch.utils.raycast import ray_mesh_first_hit

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the module "
                    "docstring)")
    return torch.device("cuda", 0)


@pytest.fixture
def spill_root(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("dtype, threshold", [
    (np.float32, 10 ** 9), (np.float16, 10 ** 9), (np.float16, 100)])
def test_store_blocks_round_trip_on_the_card(cuda, spill_root, dtype,
                                             threshold):
    rows = {0: 1000, 1: 37, 2: 513, 3: 1000}
    M = 24
    store = HostMessageStore(rows, M, dtype, threshold, cuda)
    assert store.kind == ("memmap" if threshold == 100 else
                          "host_f16" if dtype == np.float16 else "host_f32")
    rng = np.random.RandomState(0)
    written = {}
    for i, block in store.blocks(list(rows), upload=False, download=True):
        assert block.device == cuda and block.dtype == torch.float32
        assert not bool(block.any())
        written[i] = torch.as_tensor(rng.randn(rows[i], M) * 30,
                                     dtype=torch.float32, device=cuda)
        block.copy_(written[i])
    # a message sweep: read, update in place, write back, in another order
    for i, block in store.blocks([3, 1, 0, 2], upload=True, download=True):
        rounded = written[i].half().float() if dtype == np.float16 \
            else written[i]
        assert torch.equal(block, rounded)
        block.mul_(2)
    for i, block in store.blocks([2, 0, 1, 3], upload=True, download=False):
        rounded = written[i].half().float() if dtype == np.float16 \
            else written[i]
        assert torch.equal(block, 2 * rounded)
    for i in rows:
        ref = (2 * written[i]).cpu().numpy().astype(dtype)
        np.testing.assert_array_equal(np.asarray(store.arrays[i]), ref)
    # one download, one upload and download, one upload
    assert store.staged_bytes == 4 * sum(rows.values()) * M \
        * np.dtype(dtype).itemsize
    store.close()
    assert glob.glob(str(spill_root / "*")) == []


def _small_rig(cuda):
    scene = RingScene(6, 36, 48, 400.0, angle_step=0.05)
    gp = type("GP", (), dict(
        depth_planes=8, neighbors=4, padding=11,
        grid_shape=np.array([12, 12, 12], np.int32),
        max_number_of_marched_voxels=24, gamma_mrf=0.05,
    ))()
    return scene, gp, FeatureExtractor("simple_cnn", seed=0, device=cuda)


@pytest.mark.parametrize("dtype, threshold", [
    (np.float32, 2 ** 28), (np.float16, 2 ** 28), (np.float16, 100)])
def test_staged_pass_matches_device_store(cuda, spill_root, dtype,
                                          threshold):
    scene, gp, model = _small_rig(cuda)
    views = (0, 3, 1)
    ref = RayNetForwardPass(model, gp, None, scene.image_shape, 700,
                            device=cuda)
    device_maps = np.stack(list(ref.forward_pass(scene, views)))
    assert ref.message_store == "device"

    fp = RayNetForwardPass(model, gp, None, scene.image_shape, 700,
                           device=cuda)
    fp.messages_device_budget = 700_000  # scores fit, messages do not
    fp.messages_dtype = dtype
    fp.messages_memmap_threshold = threshold
    ps.plane_sweep_scores.launches = bp.bp_sweep.launches = 0
    maps = np.stack(list(fp.forward_pass(scene, views)))
    assert ps.plane_sweep_scores.launches == 3
    assert bp.bp_sweep.launches == 3 * 4
    assert fp.message_store == ("memmap" if threshold == 100 else
                                "host_f16" if dtype == np.float16 else
                                "host_f32")
    n = 3 * 36 * 48 * 24
    assert fp.staged_bytes == 2 * 3 * n * np.dtype(dtype).itemsize
    assert glob.glob(str(spill_root / "*")) == []
    assert np.array_equal(maps > 0, device_maps > 0)
    if dtype == np.float32:
        close = np.abs(maps - device_maps) <= 1e-5 * np.abs(device_maps)
        assert close.mean() >= 0.999, close.mean()
    else:
        close = np.isclose(maps, device_maps, rtol=1e-3, atol=1e-3)
        assert close.mean() >= 0.995, close.mean()


def test_ray_mesh_first_hit_on_the_card_matches_the_cpu(cuda):
    rng = np.random.RandomState(1)
    tris = ((rng.rand(3000, 3, 3) - 0.5) * 6).astype(np.float32)
    d = rng.randn(20000, 3)
    d[:, 2] = np.abs(d[:, 2]) + 3
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    origin = np.array([0.1, -0.2, -20.0], np.float32)
    cpu = ray_mesh_first_hit(*(torch.from_numpy(a) for a in (origin, d,
                                                             tris))).numpy()
    for pairs in (None, 12345):
        gpu = ray_mesh_first_hit(*(torch.as_tensor(a, device=cuda)
                                   for a in (origin, d, tris)),
                                 pairs_per_chunk=pairs).cpu().numpy()
        assert np.array_equal(gpu > 0, cpu > 0)
        hit = cpu > 0
        assert 0.05 < hit.mean() < 0.95
        np.testing.assert_allclose(gpu[hit], cpu[hit], rtol=1e-5, atol=0)


def test_mesh_depth_map_on_the_card_matches_the_cpu(cuda):
    scene = RingScene(2, 30, 40, 60.0)
    rng = np.random.RandomState(2)
    tris = ((rng.rand(500, 3, 3) - 0.5) * 6).astype(np.float32)
    cam = scene.get_image(0).camera
    gpu = mesh_depth_map(cam, 30, 40, tris, cuda)
    cpu = mesh_depth_map(cam, 30, 40, tris, "cpu")
    assert gpu.shape == (30, 40) and gpu.dtype == np.float32
    assert np.array_equal(gpu > 0, cpu > 0) and (cpu > 0).any()
    np.testing.assert_allclose(gpu[cpu > 0], cpu[cpu > 0], rtol=1e-5)


def test_backends_launch_the_rows_kernel(cuda):
    rng = np.random.RandomState(3)
    bbox = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    starts = rng.uniform(-0.95, 0.95, (777, 3)).astype(np.float32)
    starts[:, 2] = -0.99
    ends = rng.uniform(-0.95, 0.95, (777, 3)).astype(np.float32)
    ends[:, 2] = 0.99
    grid, M, D = (8, 8, 8), 20, 16
    rm.voxel_traversal_flat.launches = 0
    vox, cnt = backends.get_ray_voxel_indices(bbox, grid, starts, ends, M,
                                              device=cuda)
    assert rm.voxel_traversal_flat.launches == 1
    cvox, ccnt = backends.get_ray_voxel_indices(bbox, grid, starts, ends, M,
                                                device="cpu")
    assert rm.voxel_traversal_flat.launches == 1
    np.testing.assert_array_equal(vox, cvox)
    np.testing.assert_array_equal(cnt, ccnt)

    S = rng.uniform(0.01, 1.0, (777, D)).astype(np.float32)
    for name in ("li", "quadratic", "kde"):
        a = backends.depth_to_voxels(S, vox, cnt, starts, ends, bbox, grid, D,
                                     interpolation=name, device=cuda)
        b = backends.depth_to_voxels(S, vox, cnt, starts, ends, bbox, grid, D,
                                     interpolation=name, device="cpu")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # one sweep: later ones amplify the float32 rounding of the grid sums,
    # which the card adds in another order
    S_vox = b
    outs = [bp_inference.get_bp_backend(
        "cuda", bp_iterations=1, device=dev).mrf_inference(S_vox, vox, cnt,
                                                           grid)
        for dev in (cuda, "cpu")]
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

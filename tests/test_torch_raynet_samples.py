"""The port's RayNet samples and batches against the JAX package's, on the
mock scene and the CPU.

Both packages' sample generators, seeded alike, draw the same pixels in the
same order; the JAX package traverses each ray on the host with its native
DDA (or its XLA march), the port all of a batch's rays in one
``voxel_traversal_flat`` call. Those traversals differ on a few rays
(``test_port_traversal_against_the_native_dda``), so the comparisons point
``raynet_tpu.native.voxel_traversal_batch`` at the port's plain traversal
with pytest's ``monkeypatch``. Batches are then compared exactly: X,
points, indices, counts, y and camera centres, and the generators'
schedule counters afterwards.
"""
import numpy as np
import pytest
import torch

import raynet_tpu.native
from raynet_tpu.common.dataset import RestrepoDataset as JaxRestrepoDataset
from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
    get_target_distribution_factory as jax_tdf,
)
from raynet_tpu.common.sampling_schemes import (
    get_sampling_scheme as jax_scheme,
)
from raynet_tpu.train import batch_provider as jbp
from raynet_tpu.train import sample as jsample
from raynet_tpu_torch.common.dataset import RestrepoDataset
from raynet_tpu_torch.common.generation_parameters import (
    GenerationParameters,
    get_target_distribution_factory,
)
from raynet_tpu_torch.common.sampling_schemes import get_sampling_scheme
from raynet_tpu_torch.ops.ray_marching import (
    unflatten_voxel_indices,
    voxel_traversal_flat_reference,
)
from raynet_tpu_torch.train import batch_provider, sample

torch.set_num_threads(2)
M = 16
GRID = (8, 8, 8)
KEYS = ("X", "points", "ray_voxel_indices", "ray_voxel_count", "y",
        "camera_centers", "bbox")


def _gps():
    out = []
    for cls, tdf in ((GenerationParameters, get_target_distribution_factory),
                     (JaxGenerationParameters, jax_tdf)):
        out.append(cls(
            depth_planes=4, neighbors=4, patch_shape=(11, 11, 3),
            grid_shape=np.array(GRID, dtype=np.int32),
            max_number_of_marched_voxels=M, padding=11,
            sampling_type="sample_points_in_bbox",
            target_distribution_factory=tdf("dirac"), gamma_mrf=0.031))
    return out


def _shapes(gp):
    return [(gp.depth_planes, 10) + tuple(gp.patch_shape)] * 2, [
        (gp.depth_planes,)]


def plain_native(bbox, grid_shape, starts, ends, max_voxels):
    """``raynet_tpu.native.voxel_traversal_batch`` computed with the port's
    plain traversal."""
    grid_shape = tuple(int(g) for g in np.asarray(grid_shape).reshape(3))
    flat, counts = voxel_traversal_flat_reference(
        torch.as_tensor(np.asarray(bbox, np.float32).reshape(6)),
        torch.as_tensor(np.asarray(starts, np.float32)),
        torch.as_tensor(np.asarray(ends, np.float32)),
        grid_shape, max_voxels)
    vox = unflatten_voxel_indices(flat, grid_shape).to(torch.int32)
    return vox.numpy(), counts.numpy()


@pytest.fixture
def equal_traversals(monkeypatch):
    monkeypatch.setattr(raynet_tpu.native, "is_available", lambda: True)
    monkeypatch.setattr(raynet_tpu.native, "voxel_traversal_batch",
                        plain_native)


def _generators(root, cls_name, seed, n_rays, window=2):
    gp, jgp = _gps()
    sg = getattr(sample, cls_name)(
        get_sampling_scheme("sample_in_bbox")(gp), gp, [0], *_shapes(gp),
        n_rays=n_rays, window=window, rng=np.random.RandomState(seed),
        device="cpu")
    jsg = getattr(jsample, cls_name)(
        jax_scheme("sample_in_bbox")(jgp), jgp, [0], *_shapes(jgp),
        n_rays=n_rays, window=window, rng=np.random.RandomState(seed))
    return (sg, RestrepoDataset(root, device="cpu")), (
        jsg, JaxRestrepoDataset(root))


def _counters(sg):
    return (sg._rays_cnt, sg._scene_idx, sg._img_idx,
            sg._rng.randint(0, 2 ** 31 - 1))


def assert_batches_equal(got, want):
    assert got["scene_idx"] == want["scene_idx"]
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cls_name", ["RayNetRandomSampleGenerator",
                                      "RayNetSampleGenerator"])
def test_batches_equal_jax(mock_scene_dir, equal_traversals, cls_name):
    """Five batches of 4 rays with n_rays 5: the schedule moves four times
    (the random generator draws its next scene from its rng each time)."""
    root = str(mock_scene_dir.parent)
    (sg, ds), (jsg, jds) = _generators(root, cls_name, 5, n_rays=5)
    provider = batch_provider.RayNetBatchProvider(ds, sg)
    jprovider = jbp.RayNetBatchProvider(jds, jsg)
    for _ in range(5):
        got = provider.get_batch_of_rays(4)
        assert_batches_equal(got, jprovider.get_batch_of_rays(4))
        assert provider.timings["finishes"] == 1
        assert (got["ray_voxel_count"] >= 1).all()
        np.testing.assert_array_equal(got["y"].sum(-1), 1.0)
    assert _counters(sg) == _counters(jsg)


def test_get_sample_equals_jax(mock_scene_dir, equal_traversals):
    """Single samples, rejections included, through ``get_sample``."""
    root = str(mock_scene_dir.parent)
    (sg, ds), (jsg, jds) = _generators(root, "RayNetRandomSampleGenerator",
                                       9, n_rays=3)
    kept = 0
    for _ in range(20):
        s, j = sg.get_sample(ds), jsg.get_sample(jds)
        assert (s.scene_idx, s.img_idx, s.patch_x, s.patch_y, s.Nr) == (
            j.scene_idx, j.img_idx, j.patch_x, j.patch_y, j.Nr)
        for a, b in ((s.points, j.points), (s.X, j.X), (s.y, j.y),
                     (s.ray_voxel_indices, j.ray_voxel_indices),
                     (s.camera_center, j.camera_center)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        kept += s.X is not None
    assert kept > 0
    assert _counters(sg) == _counters(jsg)


def _kept_starts(root, seed, n):
    """The start points of the first ``n`` rays a seeded generator keeps
    on the host."""
    (sg, ds), _ = _generators(root, "RayNetRandomSampleGenerator", seed,
                              n_rays=5)
    out = []
    while len(out) < n:
        d = sg.draw(ds)
        if d.X is not None:
            out.append(np.asarray(d.points[0, :-1], np.float32))
    return out


@pytest.mark.parametrize("which", [0, 2, 5])
def test_rejection_at_finish_equals_jax(mock_scene_dir, equal_traversals,
                                        monkeypatch, which):
    """A drawn ray that visits no voxel: both packages are made to report a
    count of 0 for the same ray (matched by its start point). The port
    drops the candidates after it, restores its generator and draws again;
    batches and counters equal the JAX package's."""
    root = str(mock_scene_dir.parent)
    target = _kept_starts(root, 5, which + 1)[which]

    def hit(starts):
        return np.all(np.asarray(starts, np.float32) == target, axis=-1)

    def jax_side(bbox, grid_shape, starts, ends, max_voxels):
        vox, counts = plain_native(bbox, grid_shape, starts, ends,
                                   max_voxels)
        miss = hit(starts)
        vox[miss], counts[miss] = 0, 0
        return vox, counts

    real = sample.voxel_traversal_flat
    calls = []

    def port_side(bbox, ray_start, ray_end, grid_shape, max_voxels):
        flat, counts = real(bbox, ray_start, ray_end, grid_shape, max_voxels)
        miss = torch.as_tensor(hit(ray_start.numpy()))
        calls.append(int(miss.sum()))
        flat[miss], counts[miss] = 0, 0
        return flat, counts

    monkeypatch.setattr(raynet_tpu.native, "voxel_traversal_batch", jax_side)
    monkeypatch.setattr(sample, "voxel_traversal_flat", port_side)
    (sg, ds), (jsg, jds) = _generators(root, "RayNetRandomSampleGenerator",
                                       5, n_rays=5)
    provider = batch_provider.RayNetBatchProvider(ds, sg)
    jprovider = jbp.RayNetBatchProvider(jds, jsg)
    for _ in range(3):
        assert_batches_equal(provider.get_batch_of_rays(4),
                             jprovider.get_batch_of_rays(4))
    assert sum(calls) == 1 and len(calls) == 4  # one batch finished twice
    assert _counters(sg) == _counters(jsg)


def test_one_traversal_call_per_batch(mock_scene_dir, monkeypatch):
    """The provider finishes a whole batch with one traversal call, on the
    generator's device."""
    root = str(mock_scene_dir.parent)
    (sg, ds), _ = _generators(root, "RayNetRandomSampleGenerator", 3,
                              n_rays=100)
    real = sample.voxel_traversal_flat
    sizes = []

    def spy(bbox, ray_start, ray_end, grid_shape, max_voxels):
        sizes.append((ray_start.shape[0], ray_start.device.type))
        return real(bbox, ray_start, ray_end, grid_shape, max_voxels)

    monkeypatch.setattr(sample, "voxel_traversal_flat", spy)
    batch = batch_provider.RayNetBatchProvider(ds, sg).get_batch_of_rays(7)
    assert sizes == [(7, "cpu")]
    assert batch["X"].shape == (5, 7, 4, 11, 11, 3)
    assert batch["ray_voxel_indices"].shape == (7, M, 3)


def test_port_traversal_against_the_native_dda():
    """A delta inside the reference, recorded: at the JAX CLI's grid
    (256x256x128, M = 650) the port's traversal (closed-form crossing
    times, as the Pallas kernel and K3) and the JAX package's native DDA
    (the one its sample generator uses) visit different voxel sequences on
    a few of 2,000 random segments inside the +-3 bbox; the counts agree.
    The share stays under 1%."""
    if not raynet_tpu.native.is_available():
        pytest.skip("the JAX package's native library is not built")
    rng = np.random.RandomState(0)
    n, grid, m = 2000, (256, 256, 128), 650
    bbox = np.array([-3, -3, -3, 3, 3, 3], np.float32)
    starts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    ends = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    vox, counts = raynet_tpu.native.voxel_traversal_batch(
        bbox, grid, starts, ends, m)
    pvox, pcounts = plain_native(bbox, grid, starts, ends, m)
    differ = (pvox != vox).any(axis=(1, 2)) | (pcounts != counts)
    assert (counts > 0).all()
    assert differ.mean() < 0.01, differ.sum()


def test_multithread_provider_layout_and_scene(mock_scene_dir):
    """The multi-thread provider (as ``tests/test_training.py`` checks the
    JAX package's): layout, one scene, one finish for the batch, and the
    shared schedule advanced by the accepted samples."""
    root = str(mock_scene_dir.parent)
    (sg, ds), _ = _generators(root, "RayNetRandomSampleGenerator", 6,
                              n_rays=100)
    provider = batch_provider.MultiThreadRayNetBatchProvider(ds, sg,
                                                             n_workers=3)
    batch = provider.get_batch_of_rays(6)
    assert batch["X"].shape == (5, 6, 4, 11, 11, 3)
    assert batch["ray_voxel_indices"].shape == (6, M, 3)
    assert np.all(batch["ray_voxel_count"] >= 1)
    np.testing.assert_allclose(batch["y"].sum(-1), 1.0)
    assert batch["scene_idx"] == 0
    assert provider.timings["finishes"] == 1
    assert sg._rays_cnt == 6
    assert batch_provider.SingleThreadRayNetBatchProvider is (
        batch_provider.RayNetBatchProvider)


def test_generator_device_without_a_card_raises(mock_scene_dir):
    gp, _ = _gps()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sample.RayNetSampleGenerator(
            get_sampling_scheme("sample_in_bbox")(gp), gp, [0], *_shapes(gp),
            rng=np.random.RandomState(0), device="cuda")

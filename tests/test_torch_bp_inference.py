"""The port's BP facade, backends, depth->voxel mappings and voxel-space
depth export against the JAX package on the CPU (mirroring
``tests/test_bp_inference.py``, ``tests/test_planes_voxels.py`` and
``tests/test_mrf_utils.py``).

Tolerances: the PyTorch backend against the JAX backend rtol = atol = 1e-5
(the same float32 operations; sums in another order), and against the
numpy oracle at the JAX test's 3e-4; the mappings within rtol 1e-5, atol
1e-7 of the JAX mappings; traversal indices and counts exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.ops import backends as jbackends
from raynet_tpu.ops.bp_inference import get_bp_backend as jax_bp_backend
from raynet_tpu.ops.mrf import belief_propagation as jax_bp
from raynet_tpu.ops.mrf_utils import (
    export_depth_map_from_voxel_indices as jax_export,
)
from raynet_tpu.ops.planes_voxels import (
    get_planes_voxels_mapping as jax_mapping,
)
from raynet_tpu_torch.common.scene import RestrepoScene
from raynet_tpu_torch.ops import backends, bp_inference, mrf, ray_marching
from raynet_tpu_torch.ops.mrf_utils import export_depth_map_from_voxel_indices
from raynet_tpu_torch.ops.planes_voxels import get_planes_voxels_mapping
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

GRID = (5, 4, 3)


def _random_problem(rng, n=6, m=8, grid=GRID):
    idx = np.stack(
        [rng.randint(0, g, (n, m)) for g in grid], axis=-1
    ).astype(np.int32)
    counts = rng.randint(2, m + 1, (n,)).astype(np.int32)
    counts[0] = 1  # a ray BP skips
    S = rng.uniform(0.01, 1.0, (n, m)).astype(np.float32)
    for r in range(n):
        S[r, counts[r]:] = 0
        idx[r, counts[r]:] = 0
    return S, idx, counts


def test_get_bp_backend_names():
    for name in ("xla", "jax", "tf", "cuda"):
        backend = bp_inference.get_bp_backend(name, device="cpu")
        assert type(backend) is bp_inference.TorchBPInference
        assert backend.device == torch.device("cpu")
    assert bp_inference.XLABPInference is bp_inference.TorchBPInference
    assert type(bp_inference.get_bp_backend("numpy")) is \
        bp_inference.NPBPInference
    with pytest.raises(KeyError):
        bp_inference.get_bp_backend("opencl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            bp_inference.get_bp_backend("cuda")


@pytest.mark.parametrize("iterations", [1, 3])
def test_torch_backend_matches_jax_and_numpy(rng, iterations):
    S, idx, counts = _random_problem(rng)
    port = bp_inference.get_bp_backend("xla", gamma=0.05,
                                       bp_iterations=iterations, device="cpu")
    S_t, grid_t, msgs_t = port.mrf_inference(S, idx, counts, GRID)
    S_j, grid_j, msgs_j = jax_bp_backend(
        "xla", gamma=0.05, bp_iterations=iterations
    ).mrf_inference(S, idx, counts, GRID)
    S_n, grid_n, _ = bp_inference.get_bp_backend(
        "numpy", gamma=0.05, bp_iterations=iterations
    ).mrf_inference(S, idx, counts, GRID)
    assert grid_t.shape == GRID and msgs_t.shape == S.shape
    for a, b in ((S_t, S_j), (grid_t, grid_j), (msgs_t, msgs_j)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S_t, S_n, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(grid_t, grid_n, rtol=3e-4, atol=3e-4)
    # the skipped ray and the entries past each count stay zero
    assert not S_t[0].any() and not msgs_t[0].any()
    tail = np.arange(S.shape[1])[None, :] >= counts[:, None]
    assert not S_t[tail].any() and not msgs_t[tail].any()


def test_belief_propagation_matches_jax(rng):
    S, idx, counts = _random_problem(rng, n=40, m=12, grid=(6, 6, 6))
    grid_t, msgs_t = mrf.belief_propagation(
        torch.from_numpy(S), torch.from_numpy(idx), torch.from_numpy(counts),
        (6, 6, 6), gamma=0.1, bp_iterations=4,
    )
    grid_j, msgs_j = jax_bp(jnp.asarray(S), jnp.asarray(idx),
                            jnp.asarray(counts), (6, 6, 6), gamma=0.1,
                            bp_iterations=4)
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(msgs_t.numpy(), np.asarray(msgs_j), rtol=1e-5,
                               atol=1e-5)


def _traversal_setup(rng, d, m, n, grid_shape=(8, 8, 8)):
    bbox = np.array([-1, -1, -1, 1, 1, 1], dtype=np.float32)
    starts = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    starts[:, 2] = -0.99
    ends = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    ends[:, 2] = 0.99
    vox, counts = backends.get_ray_voxel_indices(bbox, grid_shape, starts,
                                                 ends, m, device="cpu")
    S = rng.uniform(0.01, 1.0, size=(n, d)).astype(np.float32)
    S = S / S.sum(axis=1, keepdims=True)
    return bbox, grid_shape, starts, ends, vox, counts, S


def test_voxel_traversal_backend_matches_jax(rng):
    bbox, grid_shape, starts, ends, vox, counts, _ = _traversal_setup(
        rng, 8, 20, 30)
    jvox, jcounts = jbackends.get_ray_voxel_indices(bbox, grid_shape, starts,
                                                    ends, 20)
    assert vox.dtype == counts.dtype == np.int32
    np.testing.assert_array_equal(vox, jvox)
    np.testing.assert_array_equal(counts, jcounts)
    assert counts.min() > 1

    for name in ("cython", "cuda", "xla", "jax"):
        assert backends.get_voxel_traversal_backend(name) is \
            backends.get_ray_voxel_indices
    with pytest.raises(KeyError):
        backends.get_voxel_traversal_backend("numba")
    # the facade of the JAX test: 4 cells along x
    trav = backends.get_voxel_traversal_backend("cython")
    box = np.array([[0, 0, 0, 4, 4, 4]], dtype=np.float32)
    s = np.array([[0.1, 2.0, 2.0]], dtype=np.float32)
    e = np.array([[3.9, 2.0, 2.0]], dtype=np.float32)
    vox, cnt = trav(box, (4, 4, 4), s, e, 8, device="cpu")
    assert cnt[0] == 4


class _Scene:
    bbox = np.array([[-1, -1, -1, 1, 1, 1]], dtype=np.float32)
    device = "cpu"


def test_perform_ray_marching_uses_the_scene_device(rng):
    _, grid_shape, starts, ends, vox, counts, _ = _traversal_setup(
        rng, 8, 20, 5)
    out = backends.perform_ray_marching(_Scene(), grid_shape, starts, ends,
                                        20)
    np.testing.assert_array_equal(out[0], vox)
    np.testing.assert_array_equal(out[1], counts)


@pytest.mark.parametrize("name", ["li", "li_2", "quadratic", "kde"])
def test_depth_to_voxels_matches_jax(rng, name):
    d, m, n = 16, 20, 10
    bbox, grid_shape, starts, ends, vox, counts, S = _traversal_setup(
        rng, d, m, n)
    d2v = backends.get_depth_to_voxels_backend("numpy")
    out = d2v(S, vox, counts, starts, ends, bbox, grid_shape, d,
              interpolation=name, device="cpu")
    ref = jbackends.get_depth_to_voxels_backend("numpy")(
        S, vox, counts, starts, ends, bbox, grid_shape, d, interpolation=name)
    assert out.shape == (n, m) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    tail = np.arange(m)[None, :] >= counts[:, None]
    assert not out[tail].any()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)

    # the factory of the mappings, on tensors
    op = get_planes_voxels_mapping(name)
    t = op(torch.from_numpy(S), torch.from_numpy(vox),
           torch.from_numpy(counts), torch.from_numpy(starts),
           torch.from_numpy(ends), torch.from_numpy(bbox), grid_shape, d)
    j = jax_mapping(name)(jnp.asarray(S), jnp.asarray(vox),
                          jnp.asarray(counts), jnp.asarray(starts),
                          jnp.asarray(ends), jnp.asarray(bbox), grid_shape, d)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-7)


def test_mapping_names_and_errors():
    for name in ("numpy", "cuda", "xla", "jax"):
        assert backends.get_depth_to_voxels_backend(name) is \
            backends.depth_to_voxels
    with pytest.raises(KeyError):
        backends.get_depth_to_voxels_backend("tf")
    with pytest.raises(KeyError):
        get_planes_voxels_mapping("cubic")
    S = np.full((1, 4), 0.25, dtype=np.float32)
    vox = np.zeros((1, 2, 3), np.int32)
    seg = np.zeros((1, 3), np.float32)
    with pytest.raises(KeyError):
        backends.depth_to_voxels(S, vox, np.array([2], np.int32), seg,
                                 seg + 1, np.zeros(6, np.float32), (4, 4, 4),
                                 4, interpolation="cubic", device="cpu")


def test_export_depth_map_matches_jax(mock_scene_dir, rng):
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    jscene = JaxRestrepoScene(str(mock_scene_dir))
    grid_shape = (8, 8, 8)
    n, m = 16, 5
    S = rng.rand(n, m).astype(np.float32)
    vox = rng.randint(0, 8, (n, m, 3)).astype(np.int32)
    ray_idxs = rng.choice(H * W, size=n, replace=False).astype(np.int32)
    D = export_depth_map_from_voxel_indices(scene, 0, S, vox, ray_idxs,
                                            grid_shape)
    assert D.shape == (H, W) and D.dtype == np.float32
    assert (D > 0).sum() == n
    np.testing.assert_array_equal(
        D, jax_export(jscene, 0, S, vox, ray_idxs, grid_shape))


def test_reconstruct_scene(tmp_path):
    class _Pass:
        def forward_pass(self, scene, images_range):
            for i in range(*images_range):
                yield np.full((3, 4), i, np.float64)

    backend = bp_inference.get_bp_backend("numpy")
    paths = backend.reconstruct_scene(None, _Pass(), (1, 5, 2),
                                      str(tmp_path / "out"))
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "depth_mrf_001.npy", "depth_mrf_003.npy"]
    for i, p in zip((1, 3), paths):
        dm = np.load(p)
        assert dm.dtype == np.float32 and (dm == i).all()


def test_flatten_round_trip(rng):
    vox = rng.randint(0, 5, (7, 9, 3)).astype(np.int32)
    vox[..., 1] %= 4
    vox[..., 2] %= 3
    flat = ray_marching.flatten_voxel_indices(torch.from_numpy(vox), GRID)
    back = ray_marching.unflatten_voxel_indices(flat, GRID)
    np.testing.assert_array_equal(back.numpy(), vox)

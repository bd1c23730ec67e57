"""The port's small public helpers against the JAX package's, on the same
numpy inputs made from a seed: ``utils/checks``, ``utils/visualize``,
``utils/geometry.{rays_aabbox_intersection, rays_entry_exit,
is_collinear}``, ``utils/generic_utils.{pixel_to_ray, ray_to_pixel,
voxel_to_world_coordinates}``, ``utils/training_utils.get_triangles``,
``scripts/arguments.get_actual_sampling_policy`` and
``Scene.get_random_image``.

Bars: integers and booleans exactly, float64 within rtol 1e-6; the same
exception type and message where the JAX function raises; each plot
written to a file whose pixels equal the JAX package's plot's.
"""
import numpy as np
import pytest
import torch

from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.scripts import arguments as jax_arguments
from raynet_tpu.utils import checks as jax_checks
from raynet_tpu.utils import generic_utils as jax_generic
from raynet_tpu.utils import geometry as jax_geometry
from raynet_tpu.utils import training_utils as jax_training
from raynet_tpu.utils import visualize as jax_visualize
from raynet_tpu_torch.common.scene import RestrepoScene
from raynet_tpu_torch.scripts import arguments
from raynet_tpu_torch.utils import checks, generic_utils, geometry
from raynet_tpu_torch.utils import training_utils, visualize


def _outcome(fn, *args):
    """("ok", result) or (exception type, message)."""
    try:
        return "ok", fn(*args)
    except (AssertionError, ValueError, NotImplementedError) as e:
        return type(e), str(e)


def _same_outcome(port, jax_fn, *args):
    got, want = _outcome(port, *args), _outcome(jax_fn, *args)
    assert got[0] == want[0]
    if got[0] != "ok":
        assert got[1] == want[1]
    return got, want


_COLUMNS = [
    (np.zeros((3, 1)), np.ones((3, 1))),
    (np.zeros((3, 1)), np.ones((4, 1))),
    (np.zeros((3,)), np.ones((3, 1))),
    (np.zeros((3, 1)), np.ones((3, 2))),
]


@pytest.mark.parametrize("a, b", _COLUMNS)
def test_assert_col_vectors(a, b):
    _same_outcome(checks.assert_col_vectors, jax_checks.assert_col_vectors,
                  a, b)


@pytest.mark.parametrize("size", [3, 4])
def test_assert_vector_with_wrong_size(size):
    _same_outcome(checks.assert_vector_with_wrong_size,
                  jax_checks.assert_vector_with_wrong_size,
                  np.arange(3), size)


def _rays(seed=0, n=64):
    rng = np.random.RandomState(seed)
    origins = rng.uniform(-10, 10, (n, 3))
    directions = rng.randn(n, 3)
    directions[::7, 0] = 0.0  # axis-parallel rays: 1/0 slabs
    directions[::11, 1] = 0.0
    return origins, directions, np.array([-3.0, -2.0, -1.0]), np.array(
        [3.0, 2.0, 1.0])


def test_rays_aabbox_intersection():
    args = _rays()
    got = geometry.rays_aabbox_intersection(*args)
    want = jax_geometry.rays_aabbox_intersection(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-6)
    assert np.array_equal(got[0] <= got[1], want[0] <= want[1])


def test_rays_entry_exit():
    args = _rays(seed=1)
    for g, w in zip(geometry.rays_entry_exit(*args),
                    jax_geometry.rays_entry_exit(*args)):
        assert g.shape == w.shape == (64, 3)
        np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 1.0])
def test_is_collinear(scale):
    rng = np.random.RandomState(2)
    p1, d = rng.randn(3, 1), rng.randn(3, 1)
    p3 = p1 + 2.5 * d + scale * rng.randn(3, 1)
    got = geometry.is_collinear(p1, p1 + d, p3)
    assert got == jax_geometry.is_collinear(p1, p1 + d, p3)
    assert got == (scale <= 1e-7)


@pytest.mark.parametrize("order", ["columns", "rows", "diagonal"])
def test_pixel_to_ray_and_back(order):
    rng = np.random.RandomState(3)
    y, x = rng.randint(0, 36, 50), rng.randint(0, 48, 50)
    got, want = _same_outcome(generic_utils.pixel_to_ray,
                              jax_generic.pixel_to_ray, y, x, 36, order)
    if order == "diagonal":
        return
    assert np.array_equal(got[1], want[1])
    if order == "columns":
        back = generic_utils.ray_to_pixel(got[1], 36)
        assert all(np.array_equal(a, b) for a, b in zip(
            back, jax_generic.ray_to_pixel(got[1], 36)))
        assert np.array_equal(back[0], x) and np.array_equal(back[1], y)


def test_voxel_to_world_coordinates():
    rng = np.random.RandomState(4)
    bbox = np.array([[-3.0, -2.0, -1.0, 3.0, 2.0, 1.5]])
    grid = np.array([12, 8, 5])
    idx = np.stack([rng.randint(0, g, 40) for g in grid], axis=1)
    got = generic_utils.voxel_to_world_coordinates(idx, bbox, grid)
    want = jax_generic.voxel_to_world_coordinates(idx, bbox, grid)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_get_triangles():
    rng = np.random.RandomState(5)
    points = rng.randn(20, 3)
    faces = rng.randint(0, 20, (30, 3))
    got = training_utils.get_triangles(points, faces)
    assert got.shape == (30, 3, 3)
    np.testing.assert_allclose(
        got, jax_training.get_triangles(points, faces), rtol=1e-6)


@pytest.mark.parametrize("name", [
    "sample_in_bbox", "sample_in_range", "tf_sample_in_bbox",
    "full_tf_sample_in_range", "sample_in_disparity",
    "sample_in_voxel_space",
])
def test_get_actual_sampling_policy(name):
    got, want = _same_outcome(arguments.get_actual_sampling_policy,
                              jax_arguments.get_actual_sampling_policy, name)
    assert got == want


def test_get_random_image(mock_scene_dir):
    port = RestrepoScene(str(mock_scene_dir), device="cpu")
    ref = JaxRestrepoScene(str(mock_scene_dir))
    rng_p, rng_j = np.random.RandomState(6), np.random.RandomState(6)
    for _ in range(4):
        a, b = port.get_random_image(rng_p), ref.get_random_image(rng_j)
        assert np.array_equal(a.image, b.image)
        np.testing.assert_allclose(a.camera.P, b.camera.P, rtol=1e-6)
    assert rng_p.randint(1 << 30) == rng_j.randint(1 << 30)


def _plots():
    rng = np.random.RandomState(7)
    image = rng.rand(12, 16, 3).astype(np.float32)
    pixels = rng.rand(9, 2) * [16, 12]
    s, target = rng.rand(8), np.eye(8)[3]
    patches = rng.rand(5, 6, 6, 3)
    depth = rng.rand(12, 16)
    return [
        ("plot_image", (image,), {"title": "view"}),
        ("plot_depth_map", (depth,), {}),
        ("plot_image_with_projected_points", (image, pixels), {}),
        ("plot_depth_distribution", (s, target), {}),
        ("plot_batch_of_patches", (patches,), {}),
    ]


@pytest.mark.parametrize("case", range(5))
def test_plots_write_the_jax_package_s_pixels(tmp_path, case):
    pytest.importorskip("matplotlib")
    from PIL import Image

    name, args, kwargs = _plots()[case]
    port_file, jax_file = tmp_path / "port.png", tmp_path / "jax.png"
    # the port takes tensors
    tensors = [torch.as_tensor(a) for a in args]
    getattr(visualize, name)(*tensors, output_file=str(port_file), **kwargs)
    getattr(jax_visualize, name)(*args, output_file=str(jax_file), **kwargs)
    got = np.asarray(Image.open(port_file))
    assert got.size > 0
    assert np.array_equal(got, np.asarray(Image.open(jax_file)))

"""The port's sampling schemes, sampling ops, host patch gathers of
``Image`` and the depth-map converters against the JAX package's, on the
mock scene on the CPU.

Tolerances: the host schemes, the patch gathers and random pixels bit for
bit (the same float64 numpy code); the device schemes and ops rtol 1e-6 /
atol 1e-5 (float32 tensor ops evaluated by XLA and by PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
)
from raynet_tpu.common.sampling_schemes import (
    get_sampling_scheme as jax_scheme,
)
from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.inference.forward_pass import ForwardPass as JaxForwardPass
from raynet_tpu.ops import sampling as jsampling
from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.sampling_schemes import (
    DummySamplingScheme,
    get_sampling_scheme,
    make_sampling_scheme,
)
from raynet_tpu_torch.common.scene import RestrepoScene
from raynet_tpu_torch.inference import ForwardPass
from raynet_tpu_torch.ops import sampling
from conftest import MOCK_H as H, MOCK_W as W

OPS = dict(rtol=1e-6, atol=1e-5)
PIXELS = [(0, 0), (5, 17), (18, 24), (35, 47), (20, 3)]


def _gps():
    kw = dict(depth_planes=5, neighbors=2, patch_shape=(11, 11, 3),
              padding=11, grid_shape=np.array([6, 6, 6], dtype=np.int32),
              max_number_of_marched_voxels=20, depth_range=(15.0, 25.0),
              sampling_type="sample_points_in_bbox")
    return GenerationParameters(**kw), JaxGenerationParameters(**kw)


@pytest.fixture(scope="module")
def scenes(mock_scene_dir):
    return (RestrepoScene(str(mock_scene_dir), device="cpu"),
            JaxRestrepoScene(str(mock_scene_dir)))


@pytest.mark.parametrize("name", ["sample_in_bbox", "sample_in_range",
                                  "sample_in_disparity",
                                  "sample_in_voxel_space"])
def test_per_ray_schemes_equal_jax(scenes, name):
    scene, jscene = scenes
    gp, jgp = _gps()
    s, js = get_sampling_scheme(name)(gp), jax_scheme(name)(jgp)
    for y, x in PIXELS:
        a = s.sample_points_across_ray(scene, 1, y, x)
        b = js.sample_points_across_ray(jscene, 1, y, x)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["sample_in_bbox", "sample_in_range"])
def test_all_ray_schemes_equal_jax(scenes, name):
    scene, jscene = scenes
    gp, jgp = _gps()
    s, js = get_sampling_scheme(name)(gp), jax_scheme(name)(jgp)
    a, b = s.sample_points_across_rays(scene, 2), js.sample_points_across_rays(
        jscene, 2)
    assert a.shape == (4, H * W, 5)
    np.testing.assert_array_equal(a, b)
    batch = np.array([3, 700, 1727])
    np.testing.assert_array_equal(
        s.sample_points_across_rays_batched(scene, 2, batch),
        js.sample_points_across_rays_batched(jscene, 2, batch))


@pytest.mark.parametrize("name", ["tf_sample_in_bbox", "tf_sample_in_range"])
def test_device_schemes_match_jax(scenes, name):
    scene, jscene = scenes
    gp, jgp = _gps()
    s = make_sampling_scheme(name, gp, device="cpu")
    a = s.sample_points_across_rays(scene, 0)
    b = jax_scheme(name)(jgp).sample_points_across_rays(jscene, 0)
    assert a.shape == b.shape == (3, H * W, 5)
    np.testing.assert_allclose(a, b, **OPS)
    assert isinstance(make_sampling_scheme("full_tf_sample_in_bbox", gp),
                      DummySamplingScheme)


def test_sampling_ops_match_jax(scenes):
    scene, _ = scenes
    im = scene.get_image(3)
    idx = np.arange(0, H * W, 7, dtype=np.int32)
    args = (im.camera.P_pinv, im.camera.center[:3, 0])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def j(a):
        return jnp.asarray(np.asarray(a, np.float32))

    bbox = scene.bbox.reshape(-1)
    a = sampling.sample_points_in_bbox(t(idx).int(), *map(t, args), t(bbox),
                                       H, 6)
    b = jsampling.sample_points_in_bbox(j(idx).astype(jnp.int32),
                                        *map(j, args), j(bbox), H, 6)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPS)
    a = sampling.sample_points_in_range(t(idx).int(), *map(t, args),
                                        t([14.0, 26.0]), H, 6)
    b = jsampling.sample_points_in_range(j(idx).astype(jnp.int32),
                                         *map(j, args), j([14.0, 26.0]), H, 6)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPS)
    assert sampling.get_sampling_scheme_op("tf_sample_in_bbox") is (
        sampling.sample_points_in_bbox)
    assert sampling.get_sampling_scheme_op("sample_in_range") is (
        sampling.sample_points_in_range)
    with pytest.raises(KeyError):
        sampling.get_sampling_scheme_op("sample_in_disparity")


def test_image_patch_gathers_equal_jax(scenes):
    scene, jscene = scenes
    im, jim = scene.get_image(1), jscene.get_image(1)
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(5):
        np.testing.assert_array_equal(im.random_pixel(rng),
                                      jim.random_pixel(jrng))
    np.testing.assert_array_equal(im.rgb2gray().image, jim.rgb2gray().image)
    for center in ([[24], [18], [1]], [[2], [3], [1]], [[47], [35], [1]],
                   [[-9], [40], [1]]):
        c = np.array(center)
        for expand in (True, False):
            np.testing.assert_array_equal(im.patch(c, (11, 11), expand),
                                          jim.patch(c, (11, 11), expand))
    point = np.array([[0.5], [-0.3], [0.0], [1.0]])
    np.testing.assert_array_equal(im.patch_from_3d(point, (7, 9)),
                                  jim.patch_from_3d(point, (7, 9)))
    points = np.array([[0.1, 0.2, 0.0, 1.0], [-0.4, 0.3, 0.0, 1.0],
                       [0.0, -0.5, 0.5, 1.0], [0.7, 0.7, -0.2, 1.0],
                       [-1.0, 0.0, 0.3, 1.0]])
    a = im.patches_from_3d_points(points, (5, 5))
    np.testing.assert_array_equal(a, jim.patches_from_3d_points(points,
                                                                (5, 5)))
    assert a.shape == (5, 5, 5, 3)
    # any patch outside the image: None
    far = np.vstack([points, [[40.0, 0.0, 0.0, 1.0]]])
    assert im.patches_from_3d_points(far, (5, 5)) is None
    assert jim.patches_from_3d_points(far, (5, 5)) is None


def test_depth_map_converters_match_jax(scenes):
    scene, jscene = scenes
    rng = np.random.RandomState(4)
    S = rng.rand(H * W, 6).astype(np.float32)
    a = ForwardPass.create_depth_map_from_distribution(scene, 0, S,
                                                        device="cpu")
    b = JaxForwardPass.create_depth_map_from_distribution(jscene, 0, S)
    assert a.shape == (H, W)
    np.testing.assert_allclose(a, b, **OPS)
    points = np.concatenate([rng.rand(3, H * W, 6),
                             np.ones((1, H * W, 6))]).astype(np.float32)
    a = ForwardPass.create_depth_map_from_distribution_with_voting(
        scene, 0, points, S, truncate=1.5)
    b = JaxForwardPass.create_depth_map_from_distribution_with_voting(
        jscene, 0, points, S, truncate=1.5)
    np.testing.assert_allclose(a, b, **OPS)

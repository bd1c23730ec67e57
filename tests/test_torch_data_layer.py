"""The port's data layer (``raynet_tpu_torch/common`` and ``utils``) against
the JAX package's on the mock Restrepo scene and on the DTU fixture of
``tests/test_dtu.py``: images, cameras (K, R, t, P, P_pinv, centre), bbox,
view indices, depth maps, the dataset wrappers, the generation parameters
and the numpy helpers behind them. Everything is numpy on both sides, so
every comparison is exact, except the GT depth of a Restrepo scene against
the JAX package's native raycaster (a float32 C++ kernel, which the port
does not have; see the test).
"""
import argparse
import shutil

import numpy as np
import pytest

from raynet_tpu import native
from raynet_tpu.common import dataset as jds
from raynet_tpu.common import generation_parameters as jgp
from raynet_tpu.common import scene as jsc
from raynet_tpu.utils import generic_utils as jgu
from raynet_tpu.utils import geometry as jgeo
from raynet_tpu.utils import oct_tree as jot
from raynet_tpu.utils import training_utils as jtu
from raynet_tpu_torch.common import dataset as tds
from raynet_tpu_torch.common import generation_parameters as tgp
from raynet_tpu_torch.common import scene as tsc
from raynet_tpu_torch.scripts import arguments as targs
from raynet_tpu_torch.utils import generic_utils as tgu
from raynet_tpu_torch.utils import geometry as tgeo
from raynet_tpu_torch.utils import oct_tree as tot
from raynet_tpu_torch.utils import training_utils as ttu
from conftest import MOCK_H as H, MOCK_W as W
from test_dtu import SCAN, dtu_root  # noqa: F401  (the DTU fixture)


def _same_scene(t, j, neighbors=(2, 4)):
    """Every image, camera, bbox and neighbour list of two scenes equal."""
    assert t.n_images == j.n_images
    assert t.image_shape == j.image_shape
    np.testing.assert_array_equal(t.bbox, j.bbox)
    assert t.bbox.dtype == j.bbox.dtype
    for i in range(j.n_images):
        ti, ji = t.get_image(i), j.get_image(i)
        np.testing.assert_array_equal(ti.image, ji.image)
        assert ti.image.dtype == ji.image.dtype
        np.testing.assert_array_equal(ti.image_u8, ji.image_u8)
        assert (ti.height, ti.width, ti.channels) == (
            ji.height, ji.width, ji.channels)
        for attr in ("K", "R", "t", "P", "P_pinv", "center"):
            a, b = getattr(ti.camera, attr), getattr(ji.camera, attr)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        for n in neighbors:
            assert t.get_view_idxs(i, n) == j.get_view_idxs(i, n)
        pixel = np.array([[5, 7, 1]]).T
        for a, b in zip(ti.ray(pixel), ji.ray(pixel)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ti.rays(), ji.rays()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ti.project(ji.ray(pixel)[1]),
                                      ji.project(ji.ray(pixel)[1]))


@pytest.mark.parametrize("policy", ["filesystem", "distance"])
def test_restrepo_scene_matches_jax(mock_scene_dir, policy):
    t = tsc.RestrepoScene(str(mock_scene_dir), policy)
    j = jsc.RestrepoScene(str(mock_scene_dir), policy)
    _same_scene(t, j)
    np.testing.assert_array_equal(t.voxel_grid((4, 5, 6)),
                                  j.voxel_grid((4, 5, 6)))
    assert t.observation_mask is None and j.observation_mask is None


def test_restrepo_depth_maps_match_jax(mock_scene_dir, tmp_path):
    t = tsc.RestrepoScene(str(mock_scene_dir), device="cpu")
    j = jsc.RestrepoScene(str(mock_scene_dir))
    for y, x in ((H // 2 + 2, W // 2 + 3), (0, 0), (H - 1, W - 1), (3, 40)):
        assert t.get_depth_for_pixel(0, y, x) == j.get_depth_for_pixel(
            0, y, x)
    # the per-pixel loops of the two packages are the same
    loop = tsc.Scene.get_depth_map(t, 1)
    assert loop.shape == (H, W) and loop.dtype == np.float32
    np.testing.assert_array_equal(loop, jsc.Scene.get_depth_map(j, 1))
    # without a cached map both raycast the GT mesh in batch, the port with
    # its float32 raycaster: the JAX package's native one exactly where it
    # is built, its loop elsewhere up to rounding, except on the quad's
    # shared diagonal, which the loop's float64 test rejects
    dm = t.get_depth_map(1)
    assert dm.shape == (H, W) and dm.dtype == np.float32
    assert (dm > 0).mean() > 0.9 and 19.0 < dm.max() < 21.0
    batched = j.get_depth_map(1)
    if native.is_available():
        np.testing.assert_array_equal(dm > 0, batched > 0)
        np.testing.assert_allclose(dm[dm > 0], batched[dm > 0], rtol=1e-6)
    same = (dm > 0) == (loop > 0)
    assert same.mean() >= 0.95
    np.testing.assert_allclose(dm[same & (dm > 0)], loop[same & (dm > 0)],
                               rtol=1e-5)
    # a cached gt/gt_depth_%d.npy wins in both
    scene_dir = tmp_path / "scene"
    shutil.copytree(mock_scene_dir, scene_dir)
    (scene_dir / "gt").mkdir()
    cached = np.random.RandomState(0).rand(H, W).astype(np.float32)
    np.save(scene_dir / "gt" / "gt_depth_0.npy", cached)
    t = tsc.RestrepoScene(str(scene_dir))
    j = jsc.RestrepoScene(str(scene_dir))
    assert t.get_depthmap_file(0) == j.get_depthmap_file(0)
    assert t.get_depthmap_file(1) is None and j.get_depthmap_file(1) is None
    np.testing.assert_array_equal(t.get_depth_map(0), cached)
    np.testing.assert_array_equal(j.get_depth_map(0), cached)


def test_dtu_scene_matches_jax(dtu_root):  # noqa: F811
    t = tds.DTUDataset(str(dtu_root), illumination="max").get_scene(SCAN)
    j = jds.DTUDataset(str(dtu_root), illumination="max").get_scene(SCAN)
    assert isinstance(t, tsc.DTUScene)
    _same_scene(t, j)
    np.testing.assert_array_equal(t.observation_mask, j.observation_mask)
    for i in range(j.n_images):
        np.testing.assert_array_equal(t.get_depth_map(i), j.get_depth_map(i))
    h, w = j.image_shape
    for y, x in ((0, 5), (h // 2, w // 2), (h // 2, 2), (h - 1, w - 1)):
        assert t.get_depth_for_pixel(1, y, x) == j.get_depth_for_pixel(
            1, y, x)
    assert t.gt_depth_range == j.gt_depth_range


def test_datasets_match_jax(mock_scene_dir, dtu_root):  # noqa: F811
    t = tds.RestrepoDataset(str(mock_scene_dir.parent))
    j = jds.RestrepoDataset(str(mock_scene_dir.parent))
    assert (t.n_scenes, t.scenes) == (j.n_scenes, j.scenes)
    assert isinstance(t.get_scene(0), tsc.RestrepoScene)
    assert t.get_scene(0) is t.get_scene(0)
    with pytest.raises(ValueError):
        t.get_scene(12)
    t = tds.DTUDataset(str(dtu_root))
    j = jds.DTUDataset(str(dtu_root))
    assert t.n_scenes == j.n_scenes == 1
    assert t.get_scene(SCAN).n_images == j.get_scene(SCAN).n_images
    # the CLI's build_dataset returns the port's datasets
    ds = targs.build_dataset("dtu", str(dtu_root), "max")
    assert isinstance(ds, tds.DTUDataset)
    ds = targs.build_dataset("restrepo", str(mock_scene_dir.parent), "max")
    assert isinstance(ds, tds.RestrepoDataset)


def test_get_pointcloud_is_not_ported_yet(mock_scene_dir, dtu_root):  # noqa: F811
    """Ported now: the GT point clouds equal the JAX package's (the
    Restrepo mesh's vertices, the DTU scan's STL export)."""
    pairs = (
        (tsc.RestrepoScene(str(mock_scene_dir)),
         jsc.RestrepoScene(str(mock_scene_dir))),
        (tds.DTUDataset(str(dtu_root)).get_scene(SCAN),
         jds.DTUDataset(str(dtu_root)).get_scene(SCAN)),
    )
    for t, j in pairs:
        pc = t.get_pointcloud().points
        assert pc.shape[0] == 3 and pc.shape[1] > 0
        np.testing.assert_array_equal(pc, j.get_pointcloud().points)


def _same_params(a, b):
    va, vb = vars(a), vars(b)
    assert va.keys() == vb.keys()
    for k in va:
        if k == "target_distribution_factory":
            continue
        np.testing.assert_array_equal(np.asarray(va[k], dtype=object),
                                      np.asarray(vb[k], dtype=object))


@pytest.mark.parametrize("argv", [
    [],
    ["--depth_planes", "8", "--grid_shape", "12,12,12", "--padding", "5",
     "--target_distribution_factory", "gaussian", "--stddev_factor", "2",
     "--std_is_distance", "--sampling_policy", "sample_in_range",
     "--initial_gamma_prior", "0.1"],
])
def test_generation_parameters_match_jax(argv):
    _same_params(tgp.GenerationParameters(), jgp.GenerationParameters())
    parser = argparse.ArgumentParser()
    targs.add_generation_arguments(parser)
    targs.add_nn_arguments(parser)
    targs.add_mrf_related_arguments(parser)
    args = parser.parse_args(argv)
    t = tgp.GenerationParameters.from_options(args)
    j = jgp.GenerationParameters.from_options(args)
    _same_params(t, j)
    points = np.random.RandomState(1).rand(8, 4)
    target = points[3].reshape(-1, 1) + 0.01
    np.testing.assert_array_equal(t.target_distribution_factory(target, points),
                                  j.target_distribution_factory(target, points))
    for name in ("sample_in_bbox", "sample_in_range", "sample_in_disparity",
                 "sample_in_voxel_space", "other"):
        assert tgp.get_sampling_type(name) == jgp.get_sampling_type(name)


def test_numpy_helpers_match_jax(rng):
    for n_frames in (2, 5, 6, 9):
        for ref in range(n_frames):
            for n_adj in range(1, min(5, n_frames)):
                for skip in (0, 1):
                    np.testing.assert_array_equal(
                        ttu.get_adjacent_frames_idxs(ref, n_frames, n_adj,
                                                     skip),
                        jtu.get_adjacent_frames_idxs(ref, n_frames, n_adj,
                                                     skip))
    points = rng.rand(16, 4)
    target = rng.rand(4, 1)
    np.testing.assert_array_equal(ttu.dirac_distribution(target, points),
                                  jtu.dirac_distribution(target, points))
    for std_is_distance in (False, True):
        np.testing.assert_array_equal(
            ttu.gaussian_distribution(1.5, std_is_distance)(target, points),
            jtu.gaussian_distribution(1.5, std_is_distance)(target, points))
    bbox = np.array([[-1.0, -2.0, 0.0, 3.0, 2.0, 1.5]], np.float32)
    np.testing.assert_array_equal(tgu.get_voxel_grid(bbox, (4, 3, 5)),
                                  jgu.get_voxel_grid(bbox, (4, 3, 5)))
    P = rng.rand(3, 4)
    pts = rng.rand(4, 7)
    np.testing.assert_array_equal(tgeo.project(P, pts), jgeo.project(P, pts))
    np.testing.assert_array_equal(tgeo.project(P, pts[:, :1]),
                                  jgeo.project(P, pts[:, :1]))
    assert tgeo.distance(pts[:, :1], pts[:, 1:2]) == jgeo.distance(
        pts[:, :1], pts[:, 1:2])

    tris = rng.rand(60, 3, 3).astype(np.float32) * 4 - 2
    t_tree, j_tree = tot.OctTree(tris, depth=3), jot.OctTree(tris, depth=3)
    hits = 0
    for _ in range(20):
        origin = np.vstack([rng.rand(3, 1) * 4 - 2 + [[0], [0], [-10]], [1]])
        dest = np.vstack([rng.rand(3, 1) * 2 - 1, [1]])
        got = t_tree.ray_intersections(origin, dest)
        np.testing.assert_array_equal(got, j_tree.ray_intersections(origin,
                                                                    dest))
        first = ttu.get_ray_meshes_first_intersection(origin, dest, t_tree)
        ref = jtu.get_ray_meshes_first_intersection(origin, dest, j_tree)
        assert (first is None) == (ref is None)
        if first is not None:
            hits += 1
            np.testing.assert_array_equal(first, ref)
        np.testing.assert_array_equal(
            tgeo.ray_triangles_intersection_mt(
                origin[:3, 0], dest[:3, 0], tris[:, 0], tris[:, 1],
                tris[:, 2]),
            jgeo.ray_triangles_intersection_mt(
                origin[:3, 0], dest[:3, 0], tris[:, 0], tris[:, 1],
                tris[:, 2]))
    assert hits > 0

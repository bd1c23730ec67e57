"""The port's evaluation layer against the JAX package on the CPU: the PLY
reader, the ground-truth raycaster, point clouds from depth maps, the
filters and metrics, the jet colormap, and the two CLIs
(``raynet_to_pcl_torch``, ``raynet_compute_metrics_torch``) mirroring
``tests/test_cli.py``.

Tolerances: the raycaster equals the JAX package's native float32
raycaster (the same float32 operations in the same order: hit masks
identical, depths within 1e-6 relative) and agrees with a float64
Moeller-Trumbore written here wherever the float64 barycentric margins
exceed 1e-4; points, filters and metrics within 1e-5 relative of the JAX
package (the port sums some float64 products in another order); jet
equal to matplotlib's bit for bit.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from raynet_tpu import native
from raynet_tpu import metrics as jmetrics
from raynet_tpu import pointcloud as jpointcloud
from raynet_tpu.common import parse_input_data as jparse
from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.scripts import compute_metrics as jax_metrics_cli
from raynet_tpu.scripts import convert_to_pointcloud as jax_pcl_cli
from raynet_tpu_torch import metrics, pointcloud
from raynet_tpu_torch.common import parse_input_data as parse
from raynet_tpu_torch.common.scene import RestrepoScene, Scene
from raynet_tpu_torch.scripts import compute_metrics as metrics_cli
from raynet_tpu_torch.scripts import convert_to_pointcloud as pcl_cli
from raynet_tpu_torch.scripts import forward_pass as fp_cli
from raynet_tpu_torch.scripts.slicing import frame_idxs_type
from raynet_tpu_torch.utils.raycast import ray_mesh_first_hit
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = [
    "--depth_planes", "8", "--grid_shape", "12,12,12",
    "--maximum_number_of_marched_voxels", "24", "--patch_shape", "11,11,3",
]


def _rel_close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def scene_dir(mock_scene_dir, tmp_path_factory):
    """The mock scene; where the JAX package has no native raycaster (its
    per-pixel loop rejects the quad's diagonal), a copy of it with the
    port's ground-truth depth maps cached for both packages."""
    if native.is_available():
        return mock_scene_dir
    root = tmp_path_factory.mktemp("cached_gt") / "scene_1"
    shutil.copytree(mock_scene_dir, root)
    (root / "gt").mkdir()
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    for i in range(scene.n_images):
        np.save(root / "gt" / ("gt_depth_%d.npy" % (i,)),
                scene.get_depth_map(i))
    return root


@pytest.fixture(scope="module")
def predictions_dir(scene_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("predictions")
    fp_cli.main([
        str(scene_dir.parent), str(out), "--scene_idx", "0",
        "--forward_pass_factory", "multi_view_cnn",
        "--rays_batch", str(H * W), "--start_end", "0,3", "--device", "cpu",
    ] + FLAGS)
    # a NaN, which the point clouds replace by the map's minimum
    d = np.load(out / "depth_001.npy")
    d[5, 7] = np.nan
    np.save(out / "depth_001.npy", d)
    return out


def _scenes(scene_dir):
    return (RestrepoScene(str(scene_dir), device="cpu"),
            JaxRestrepoScene(str(scene_dir)))


def _depthmaps(predictions_dir, frames=(0, 1, 2)):
    return [str(predictions_dir / ("depth_%03d.npy" % i)) for i in frames]


# -- parse_input_data ------------------------------------------------------

def test_ply_round_trip(tmp_path, rng):
    pts = rng.randn(3, 50)
    path = tmp_path / "pc.ply"
    pointcloud.Pointcloud(pts).save_ply(str(path))
    got = parse.parse_stl_file_to_pointcloud(str(path))
    assert got.shape == (50, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, pts.T.astype(np.float32))
    np.testing.assert_array_equal(
        got, jparse.parse_stl_file_to_pointcloud(str(path)))
    # the JAX package's writer gives the same file
    jpath = tmp_path / "jax.ply"
    jpointcloud.Pointcloud(pts).save_ply(str(jpath))
    assert path.read_bytes() == jpath.read_bytes()

    with open(path, "rb") as f:
        header = parse.PLYHeader(f)
    assert not header.is_ascii and header.version == 1.0
    assert header.little_endian == (sys.byteorder == "little")
    assert header.comments == ["raynet_tpu pointcloud"]
    (el,) = header.elements
    assert (el.name, el.count, el.bytes) == ("vertex", 50, 12)
    assert [(p.name, p.type) for p in el.properties] == [
        ("x", "float"), ("y", "float"), ("z", "float")]


def test_ply_big_endian_extra_properties(tmp_path, rng):
    """DTU's STL exports: more properties after x, y, z, any byte order."""
    xyz = rng.randn(7, 3).astype(">f4")
    rows = np.empty(7, dtype=[("xyz", ">f4", 3), ("n", ">f4", 3),
                              ("c", "u1", 3)])
    rows["xyz"] = xyz
    rows["n"] = 1.0
    rows["c"] = 9
    path = tmp_path / "stl001_total.ply"
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_big_endian 1.0\ncomment a\ncomment b c\n"
                b"element vertex 7\nproperty float x\nproperty float y\n"
                b"property float z\nproperty float nx\nproperty float ny\n"
                b"property float nz\nproperty uchar red\nproperty uchar green\n"
                b"property uchar blue\nend_header\n")
        rows.tofile(f)
    got = parse.parse_stl_file_to_pointcloud(str(path))
    np.testing.assert_array_equal(got, xyz.astype(np.float32))
    np.testing.assert_array_equal(
        got, jparse.parse_stl_file_to_pointcloud(str(path)))
    with open(path, "rb") as f:
        header = parse.PLYHeader(f)
    assert header.comments == ["a", "b c"] and not header.little_endian
    assert header.elements[0].bytes == 27
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"obj\n")
    with pytest.raises(ValueError, match="not a PLY"):
        parse.parse_stl_file_to_pointcloud(str(bad))


# -- the raycaster ---------------------------------------------------------

def _mt_float64(origin, dirs, tris):
    """Moeller-Trumbore in float64: per pair (t, u, v, det), NaN t where
    det == 0."""
    o = origin.astype(np.float64)
    d = dirs.astype(np.float64)[:, None, :]
    p0, p1, p2 = (tris[:, k].astype(np.float64)[None] for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        tv = o[None, None] - p0
        u = (tv * pv).sum(-1) * inv
        qv = np.cross(tv, e1)
        v = (d * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
    return t, u, v, det


def _random_mesh(rng, n_rays=300, n_tris=200):
    tris = ((rng.rand(n_tris, 3, 3) - 0.5) * 6).astype(np.float32)
    tris[:, :, 2] += rng.uniform(-2, 2, (n_tris, 1)).astype(np.float32)
    d = rng.randn(n_rays, 3)
    d[:, 2] = np.abs(d[:, 2]) + 3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    origin = np.array([0.1, -0.2, -20.0], np.float32)
    return origin, d.astype(np.float32), tris


def test_ray_mesh_first_hit_matches_native_and_float64(rng):
    origin, dirs, tris = _random_mesh(rng)
    # rays through the shared vertices and edge midpoints of the triangles
    # test the open inequalities
    on_edges = np.concatenate([tris[:20, 0], (tris[:20, 0] + tris[:20, 1]) / 2])
    e = on_edges - origin
    dirs = np.concatenate([dirs, (e / np.linalg.norm(e, axis=1,
                                                     keepdims=True))
                           .astype(np.float32)])
    depth = ray_mesh_first_hit(torch.from_numpy(origin),
                               torch.from_numpy(dirs),
                               torch.from_numpy(tris)).numpy()
    assert depth.dtype == np.float32 and depth.shape == (len(dirs),)
    hits = depth > 0
    assert 0.1 < hits.mean() < 0.9
    # chunking does not change the result
    small = ray_mesh_first_hit(torch.from_numpy(origin),
                               torch.from_numpy(dirs),
                               torch.from_numpy(tris), pairs_per_chunk=97)
    np.testing.assert_array_equal(small.numpy(), depth)

    if native.is_available():
        nd, _ = native.ray_mesh_first_hit(origin, dirs, tris)
        nd = np.where(nd < 0, 0.0, nd)
        np.testing.assert_array_equal(hits, nd > 0)
        _rel_close(depth[hits], nd[hits], rtol=1e-6)

    t, u, v, det = _mt_float64(origin, dirs, tris)
    margin = np.minimum(np.minimum(u, v), 1 - u - v)
    hit64 = (det != 0) & (u > 0) & (v > 0) & (u + v < 1) & (t > 0)
    clear = np.abs(np.nan_to_num(margin)) > 1e-4
    # rays whose every pair is clear of the triangle edges agree exactly
    sure = clear.all(axis=1)
    assert sure.mean() > 0.8
    best = np.where(hit64, t, np.inf).min(axis=1)
    np.testing.assert_array_equal(hits[sure], np.isfinite(best)[sure])
    both = sure & hits
    _rel_close(depth[both], best[both], rtol=1e-5)


def test_ray_mesh_first_hit_edge_cases():
    f32 = torch.float32
    tri = torch.tensor([[[0, 0, 5], [1, 0, 5], [0, 1, 5]]], dtype=f32)
    o = torch.zeros(3, dtype=f32)
    d = torch.tensor([[0.04, 0.04, 1.0], [0.0, 0.0, 1.0], [0.5, 0.5, 1.0],
                      [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], dtype=f32)
    d = d / d.norm(dim=1, keepdim=True)
    got = ray_mesh_first_hit(o, d, tri)
    # inside; a vertex (u = v = 0) is rejected; outside; behind the
    # origin; parallel to the plane (det == 0)
    assert got[0] > 5 and (got[1:] == 0).all()
    # the nearer of two hits; none for an empty mesh
    two = torch.cat([tri, tri + torch.tensor([0, 0, -2.0])])
    assert torch.isclose(ray_mesh_first_hit(o, d[:1], two)[0],
                         got[0] * 3 / 5, rtol=1e-6)
    assert (ray_mesh_first_hit(o, d, tri[:0]) == 0).all()
    with pytest.raises(ValueError, match="float32"):
        ray_mesh_first_hit(o.double(), d, tri)


def test_scene_depth_map_is_the_raycast(scene_dir, mock_scene_dir, tmp_path):
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    jscene = JaxRestrepoScene(str(mock_scene_dir))
    dm = scene.get_depth_map(1)
    assert dm.shape == (H, W) and dm.dtype == np.float32
    assert scene.get_depth_map(1) is dm  # computed once
    assert (dm > 0).mean() > 0.9 and 19.0 < dm.max() < 21.0
    if native.is_available():
        ref = jscene.get_depth_map(1)
        np.testing.assert_array_equal(dm > 0, ref > 0)
        _rel_close(dm[dm > 0], ref[dm > 0], rtol=1e-6)
    # the scene's device is checked when the raycast first needs it
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            RestrepoScene(str(mock_scene_dir)).get_depth_map(0)


def test_scene_pointclouds(mock_scene_dir):
    scene, jscene = _scenes(mock_scene_dir)
    pc, jpc = scene.get_pointcloud(), jscene.get_pointcloud()
    assert isinstance(pc, pointcloud.Pointcloud)
    np.testing.assert_array_equal(pc.points, jpc.points)
    assert pc.points.shape == (3, 4)
    with pytest.raises(NotImplementedError):
        Scene().get_pointcloud()


# -- point clouds ----------------------------------------------------------

@pytest.mark.parametrize("consistency", [False, True])
def test_get_pointcloud_matches_jax(scene_dir, predictions_dir, consistency):
    scene, jscene = _scenes(scene_dir)
    maps = _depthmaps(predictions_dir)
    kw = dict(borders=2, consistency_threshold=0.75, n_neighbors=2)
    pc = pointcloud.get_pointcloud(scene, [0, 1, 2], maps, consistency,
                                   device="cpu", **kw)
    jpc = jpointcloud.get_pointcloud(jscene, [0, 1, 2], maps, consistency,
                                     **kw)
    assert pc.points.dtype == np.float64
    n_all = 3 * (H - 4) * (W - 4)
    if consistency:
        assert 0 < pc.points.shape[1] < n_all
    else:
        # the quad fills every view but for rays on its diagonal, which
        # the strict inequalities reject
        assert n_all - 10 < pc.points.shape[1] <= n_all
    _rel_close(pc.points, jpc.points)
    assert np.isfinite(pc.points).all()


def test_pointcloud_index_filter_and_neighbours(rng):
    X = rng.randn(3, 200)
    Q = rng.randn(3, 30)
    pc, jpc = pointcloud.Pointcloud(X), jpointcloud.Pointcloud(X)
    pc.index(), jpc.index()
    d, i = pc.nearest_neighbors(Q)
    jd, ji = jpc.nearest_neighbors(Q)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(pc.nearest_neighbors(Q, k=3,
                                                       return_distances=False),
                                  jpc.nearest_neighbors(Q, k=3,
                                                        return_distances=False))

    class Half:
        def filter(self, P):
            return P[:, ::2]

    pc.filter(Half())
    assert pc.points.shape == (3, 100) and pc._index is None


# -- filters and metrics ---------------------------------------------------

def test_filters_match_jax(rng, tmp_path):
    X = rng.uniform(-1.2, 1.2, (3, 400))
    bbox = np.array([[-1, -1, -1, 1, 1, 1]], dtype=np.float32)
    mask = (rng.rand(4, 5, 6) > 0.4).astype(np.uint8)
    vm = metrics.VoxelMask(bbox, mask, str(tmp_path))
    jvm = jmetrics.VoxelMask(bbox, mask)
    kept = vm.filter(X)
    assert 0 < kept.shape[1] < 400
    np.testing.assert_array_equal(kept, jvm.filter(X))
    assert (tmp_path / "pc_inside_voxel_mask.ply").exists()

    for min_dist in (0.05, 0.3):
        np.random.seed(3)
        thin = metrics.ReduceDensity(min_dist, str(tmp_path)).filter(X)
        np.random.seed(3)
        np.testing.assert_array_equal(
            thin, jmetrics.ReduceDensity(min_dist).filter(X))
        assert thin.shape[1] < 400
    assert (tmp_path / "pc_after_density_reduction.ply").exists()

    ff = metrics.FiltersFactory([metrics.VoxelMask(bbox, mask),
                                 metrics.ReduceDensity(0.2)])
    jff = jmetrics.FiltersFactory([jmetrics.VoxelMask(bbox, mask),
                                   jmetrics.ReduceDensity(0.2)])
    assert ff.has_filters and not metrics.FiltersFactory([]).has_filters
    np.random.seed(4)
    out = ff.filter(X)
    np.random.seed(4)
    np.testing.assert_array_equal(out, jff.filter(X))
    with pytest.raises(ValueError):
        metrics.VoxelMask(bbox[:, ::-1], mask)
    with pytest.raises(ValueError):
        vm.filter(X.T)


@pytest.mark.parametrize("name", ["ppmde", "accuracy", "completeness"])
@pytest.mark.parametrize("variant", ["plain", "filtered"])
def test_metrics_match_jax(scene_dir, predictions_dir, name, variant):
    scene, jscene = _scenes(scene_dir)
    maps = _depthmaps(predictions_dir)
    frames = [0, 1, 2]
    filtered = variant == "filtered"
    if name == "ppmde":
        m = metrics.PerPixelMeanDepthError(2 if filtered else 5)
        jm = jmetrics.PerPixelMeanDepthError(2 if filtered else 5)
    else:
        bbox = np.array([[-6, -6, -6, 6, 6, 6]], dtype=np.float32)
        mask = np.ones((4, 4, 4), np.uint8)
        mask[0] = 0

        def ff(module):
            return module.FiltersFactory([module.VoxelMask(bbox, mask)])

        cls = {"accuracy": "Accuracy", "completeness": "Completeness"}[name]
        kw = dict(truncate=0.05 if filtered else float("inf"), borders=2,
                  use_pc_from_depthmap=False)
        m = getattr(metrics, cls)(ff(metrics) if filtered else None,
                                  device="cpu", **kw)
        jm = getattr(jmetrics, cls)(ff(jmetrics) if filtered else None, **kw)

    def pc(module, s, **kw):
        return module.get_pointcloud(s, frames, maps, False, borders=2, **kw)

    values, points = m.compute(scene, frames, maps,
                               pc(pointcloud, scene, device="cpu"))
    jvalues, jpoints = jm.compute(jscene, frames, maps, pc(jpointcloud,
                                                           jscene))
    _rel_close(values, jvalues)
    assert len(values) > 0
    if name == "ppmde":  # the NaN of map 1 reaches its mean, as in JAX
        assert np.isfinite(values[[0, 2]]).all() and np.isnan(values[1])
    else:
        assert np.isfinite(values).all()
    if points is None:
        assert jpoints is None and values.shape == (3,)
    else:
        _rel_close(points, jpoints)


def test_accuracy_from_gt_depthmaps(scene_dir, predictions_dir, tmp_path):
    """``use_pc_from_depthmap``: the GT cloud backprojected from cached GT
    depth maps."""
    root = tmp_path / "scene_1"
    shutil.copytree(scene_dir, root, dirs_exist_ok=True)
    os.makedirs(root / "gt", exist_ok=True)
    t_scene = RestrepoScene(str(scene_dir), device="cpu")
    for i in range(3):
        np.save(root / "gt" / ("gt_depth_%d.npy" % i),
                t_scene.get_depth_map(i))
    scene, jscene = _scenes(root)
    maps = _depthmaps(predictions_dir)
    m = metrics.Accuracy(None, 1.0, 2, True, device="cpu")
    jm = jmetrics.Accuracy(None, 1.0, 2, True)
    values, _ = m.compute(scene, [0, 1, 2], maps, pointcloud.get_pointcloud(
        scene, [0, 1, 2], maps, False, device="cpu", borders=2))
    jvalues, _ = jm.compute(jscene, [0, 1, 2], maps,
                            jpointcloud.get_pointcloud(jscene, [0, 1, 2],
                                                       maps, False,
                                                       borders=2))
    _rel_close(values, jvalues)


# -- jet -------------------------------------------------------------------

def test_jet_matches_matplotlib(rng):
    from matplotlib import colormaps

    cmap = colormaps["jet"]
    x = np.concatenate([
        rng.rand(2000), np.linspace(0, 1, 1025), np.arange(257) / 256,
        [0.0, 1.0, 1 - 1e-12, -0.1, -1e-300, 1.5, np.inf, -np.inf, np.nan],
    ])
    np.testing.assert_array_equal(pointcloud.jet(x), cmap(x)[:, :3])
    np.testing.assert_array_equal(pointcloud.JET_LUT, cmap(np.arange(256))
                                  [:, :3])
    x32 = x.astype(np.float32)
    np.testing.assert_array_equal(pointcloud.jet(x32), cmap(x32)[:, :3])


def test_save_colored_ply_matches_jax(tmp_path, rng):
    pts = rng.randn(3, 40)
    vals = np.concatenate([rng.rand(37) * 3, [np.nan, np.inf, 0.0]])
    pointcloud.Pointcloud(pts).save_colored_ply(str(tmp_path / "a.ply"), vals)
    jpointcloud.Pointcloud(pts).save_colored_ply(str(tmp_path / "b.ply"),
                                                 vals)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    with pytest.raises(ValueError, match="jet"):
        pointcloud.Pointcloud(pts).save_colored_ply(str(tmp_path / "c.ply"),
                                                    vals, colormap="viridis")


def test_colored_ply_without_matplotlib(tmp_path):
    """The card's machine has no matplotlib: the port's colored PLY needs
    none (a subprocess with matplotlib blocked)."""
    code = r"""
import sys
sys.modules["matplotlib"] = None
import numpy as np
from raynet_tpu_torch.pointcloud import Pointcloud
Pointcloud(np.zeros((3, 4))).save_colored_ply(sys.argv[1], np.arange(4.0))
"""
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "c.ply")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert parse.parse_stl_file_to_pointcloud(str(tmp_path / "c.ply")).shape \
        == (4, 3)


# -- the CLIs --------------------------------------------------------------

def _means(out):
    return {line.split(":")[0]: float(line.split("mean=")[1].split()[0])
            for line in out.splitlines() if "mean=" in line}


def test_to_pcl_cli_matches_jax(scene_dir, predictions_dir, tmp_path):
    common = [str(scene_dir.parent), str(predictions_dir)]
    flags = ["--scene_idx", "0", "--frame_idxs", "0:3", "--borders", "2"]
    pcl_cli.main(common + [str(tmp_path / "port")] + flags
                 + ["--device", "cpu"])
    jax_pcl_cli.main(common + [str(tmp_path / "jax")] + flags)
    out = tmp_path / "port" / "pointcloud_s_0.ply"
    assert out.exists()
    pts = parse.parse_stl_file_to_pointcloud(str(out))
    assert pts.shape[1] == 3 and len(pts) > 0
    _rel_close(pts, parse.parse_stl_file_to_pointcloud(
        str(tmp_path / "jax" / "pointcloud_s_0.ply")))

    # with the consistency check and the density filter (seeded alike)
    flags += ["--with_consistency_check", "--n_neighbors", "2",
              "--min_distance", "0.05"]
    np.random.seed(0)
    pcl_cli.main(common + [str(tmp_path / "port2")] + flags
                 + ["--device", "cpu"])
    np.random.seed(0)
    jax_pcl_cli.main(common + [str(tmp_path / "jax2")] + flags)
    a = parse.parse_stl_file_to_pointcloud(
        str(tmp_path / "port2" / "pointcloud_s_0.ply"))
    assert 0 < len(a) < len(pts)
    _rel_close(a, parse.parse_stl_file_to_pointcloud(
        str(tmp_path / "jax2" / "pointcloud_s_0.ply")))


@pytest.mark.parametrize("metric_args", [
    ["ppmde"],
    ["accuracy", "completeness", "--truncate", "5"],
])
def test_compute_metrics_cli_matches_jax(scene_dir, predictions_dir,
                                         tmp_path, capsys, metric_args):
    common = [str(scene_dir.parent), str(predictions_dir)] + metric_args[:2]
    flags = metric_args[2:] + ["--scene_idx", "0", "--frame_idxs", "0:3",
                               "--borders", "2"]
    metrics_cli.main(common[:2] + [a for a in metric_args
                                   if not a.startswith("-")
                                   and a != "5"] + flags
                     + ["--output_directory", str(tmp_path / "port"),
                        "--device", "cpu"])
    port = _means(capsys.readouterr().out)
    jax_metrics_cli.main(common[:2] + [a for a in metric_args
                                       if not a.startswith("-")
                                       and a != "5"] + flags
                         + ["--output_directory", str(tmp_path / "jax")])
    ref = _means(capsys.readouterr().out)
    names = [a for a in metric_args if not a.startswith("-") and a != "5"]
    assert sorted(port) == sorted(ref) == sorted(names)
    for k in names:
        _rel_close(port[k], ref[k])
    assert (tmp_path / "port" / "predicted_pc_s_0.ply").exists()
    for k in names:
        colored = tmp_path / "port" / ("%s_colored_pc_s_0.ply" % k)
        assert colored.exists() == (k != "ppmde")
        if colored.exists():
            assert colored.read_bytes() == (
                tmp_path / "jax" / colored.name).read_bytes()


def test_frame_idxs_type():
    assert frame_idxs_type(":") == slice(None, None)
    assert frame_idxs_type("2:5") == slice(2, 5)
    assert frame_idxs_type("1,4,6") == [1, 4, 6]
    assert frame_idxs_type("3") == [3]

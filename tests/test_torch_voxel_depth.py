"""K3's voxel-depth mode on the CPU (``voxel_argmax_depth``, whose plain
version ``voxel_argmax_depth_reference`` runs here) and the mvcnn passes'
per-image depths (``mvcnn_image_depth``, ``mvcnn_voxel_image_depth``)
against the JAX package's ``mvcnn_depth_step`` and
``mvcnn_voxel_depth_step``.

Inputs: seeded numpy softmax scores on the geometries of
``test_torch_traversal.py`` (rays that miss the grid, negative directions
with exact diagonals, the mock scene) and on zero-length segments, some of
which march two or more cells; and the mock scene's view set with seeded
random features. Tolerances: counts exact; depths >= 0.999 of the rays
within 1e-3 relative, where a ray also agrees when its depth is that of a
visited voxel the JAX package scores as tied with the ray's maximum (within
rtol 1e-5, atol 1e-6: the port's hat mapping interpolates between the two
bracketing planes, the JAX package sums the hats, and a plateau of equal
plane scores makes voxels tie in exact arithmetic); a zero-length ray's
mapped scores are 0/0 = NaN, and its depth is then its first voxel's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.ops import fused as jfused
from raynet_tpu.ops import planes_voxels as jpv
from raynet_tpu.ops import ray_marching as jrm
from raynet_tpu_torch.ops import fused as tfused
from raynet_tpu_torch.ops import voxel_depth as vd
from raynet_tpu_torch.ops.sampling import segments_in_bbox
from conftest import MOCK_H as H, MOCK_W as W
from test_torch_traversal import GEOMETRIES

torch.set_num_threads(2)

PAD, D, GRID, M = 11, 8, (12, 12, 12), 24


def _zero_length(rng):
    """Zero-length segments: on a cell boundary in x (the march's nudged
    ends fall in different cells, so it marches up z: 0/0 hat scores over
    two or more cells), inside one cell (one cell), and outside the grid;
    then ordinary segments across the grid."""
    bbox = np.array([0, 0, 0, 4, 4, 4], dtype=np.float32)
    on_edge = np.array([[2.0, 1.5, 0.5], [1.0, 0.5, 2.5], [3.0, 3.5, 0.25],
                        [0.0, 2.5, 1.5]], np.float32)
    inside = np.array([[1.5, 1.5, 1.5], [0.25, 3.75, 2.5]], np.float32)
    outside = np.array([[-5.0, -5.0, -5.0]], np.float32)
    n = 40
    rs = np.concatenate([on_edge, inside, outside,
                         rng.uniform(0, 4, (n, 3)).astype(np.float32)])
    re = np.concatenate([on_edge, inside, outside,
                         rng.uniform(0, 4, (n, 3)).astype(np.float32)])
    return bbox, rs, re, (4, 4, 4), 8


def _geometry(name, rng, scene_dir):
    if name == "zero_length":
        return _zero_length(rng)
    if name == "mock_scene":
        return GEOMETRIES[name](rng, scene_dir)
    return GEOMETRIES[name](rng)


def _scores(rng, n, depth_planes=D):
    """Seeded softmax scores, with a plateau of two equal adjacent planes
    on every third ray."""
    S = rng.randn(n, depth_planes).astype(np.float32)
    S[::3, 3] = S[::3, 2]
    S = np.exp(S - S.max(axis=1, keepdims=True))
    return (S / S.sum(axis=1, keepdims=True)).astype(np.float32)


def _jax_tail(bbox, rs, re, S, center, grid, M_):
    """The JAX step's tail after the plane sweep
    (``raynet_tpu/ops/fused.py:190-205``), on given segments and scores:
    (S_vox, voxel indices, counts, depth)."""
    bbox, rs, re, S, center = (jnp.asarray(a) for a in (bbox, rs, re, S,
                                                        center))
    flat, counts = jrm.voxel_traversal_flat(bbox, rs, re, grid, M_)
    vox = jrm.unflatten_voxel_indices(flat, grid)
    S_vox = jpv.planes_to_voxels_mapping(S, vox, counts, rs, re, bbox, grid,
                                         S.shape[1])
    centers = jrm.voxel_centers(vox, bbox, grid)
    best = jnp.argmax(S_vox, axis=-1)
    best_centers = jnp.take_along_axis(centers, best[:, None, None],
                                       axis=1)[:, 0]
    depth = jnp.linalg.norm(best_centers - center[None], axis=-1)
    depth = jnp.where(counts > 0, depth, 0.0)
    return tuple(np.asarray(a) for a in (S_vox, vox, counts, depth))


def _voxel_agree(depth, jS, jvox, jcounts, jdepth, center, bbox, grid):
    """Share of rays whose ``depth`` is within 1e-3 relative of the JAX
    depth or of the depth of a visited voxel whose JAX score is within rtol
    1e-5, atol 1e-6 of the ray's maximum. The zero masks must match."""
    depth, jdepth = np.asarray(depth), np.asarray(jdepth)
    assert np.array_equal(depth > 0, jdepth > 0)
    jS = np.asarray(jS, np.float64)
    valid = np.arange(jS.shape[1])[None, :] < np.asarray(jcounts)[:, None]
    best = np.where(valid, jS, -np.inf).max(axis=1, keepdims=True)
    with np.errstate(invalid="ignore"):  # rays with NaN scores tie nowhere
        tied = valid & (jS >= best - (1e-5 * best + 1e-6))
    bbox = np.asarray(bbox, np.float64).reshape(6)
    bin_ = (bbox[3:] - bbox[:3]) / np.asarray(grid)
    dists = np.linalg.norm(bbox[:3] + (np.asarray(jvox) + 0.5) * bin_
                           - np.asarray(center, np.float64)[None, None],
                           axis=-1)
    same = np.abs(depth - jdepth) <= 1e-3 * np.abs(jdepth)
    at_tie = (tied & (np.abs(dists - depth[:, None]) <= 1e-3 * dists)).any(1)
    return float(np.mean(same | at_tie))


@pytest.mark.parametrize("name", sorted(GEOMETRIES) + ["zero_length"])
def test_voxel_argmax_depth_matches_jax(name, rng, mock_scene_dir):
    bbox, rs, re, grid, M_ = _geometry(name, rng, mock_scene_dir)
    S = _scores(rng, len(rs))
    center = np.asarray(bbox[:3] - 5.0, np.float32)
    jS, jvox, jc, jd = _jax_tail(bbox, rs, re, S, center, grid, M_)
    args = [torch.as_tensor(a) for a in (bbox, rs, re, S, center)]
    vd.voxel_argmax_depth.launches = 0
    depth, counts = vd.voxel_argmax_depth(*args, grid, M_)
    assert vd.voxel_argmax_depth.launches == 0
    ref_depth, ref_counts = vd.voxel_argmax_depth_reference(*args, grid, M_)
    assert torch.equal(depth, ref_depth) and torch.equal(counts, ref_counts)
    assert depth.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert _voxel_agree(depth.numpy(), jS, jvox, jc, jd, center, bbox,
                        grid) >= 0.999
    # zero-length segments that visit cells: NaN scores, the first cell
    ray = re - rs
    nan_rays = ((ray * ray).sum(1) == 0) & (jc > 0)
    first = np.linalg.norm(
        bbox[:3] + (jvox[:, 0] + 0.5) * (bbox[3:] - bbox[:3]) / grid
        - center, axis=-1)
    np.testing.assert_allclose(depth.numpy()[nan_rays], first[nan_rays],
                               rtol=1e-6)
    np.testing.assert_allclose(jd[nan_rays], first[nan_rays], rtol=1e-6)
    if name == "zero_length":
        assert np.isnan(jS[nan_rays & (jc > 1)]).any()
        assert int((nan_rays & (jc > 1)).sum()) == 4
    if name == "misses":
        assert not counts.any() and not depth.any()
    else:
        assert int(counts.max()) > 1


def test_voxel_argmax_depth_takes_the_first_of_tied_voxels():
    """Equal plane scores map every visited voxel to the same score: the
    depth is that of the ray's first voxel."""
    bbox = torch.tensor([0, 0, 0, 4, 4, 4], dtype=torch.float32)
    rs = torch.tensor([[0.1, 0.2, 0.3], [3.9, 3.7, 3.8]])
    re = torch.tensor([[3.8, 3.9, 3.7], [0.3, 0.1, 0.2]])
    center = torch.tensor([-2.0, -3.0, -4.0])
    S = torch.full((2, D), 1.0 / D)
    depth, counts = vd.voxel_argmax_depth(bbox, rs, re, S, center, (4, 4, 4),
                                          16)
    assert int(counts.min()) > 3
    first = torch.tensor([[0.5, 0.5, 0.5], [3.5, 3.5, 3.5]])
    torch.testing.assert_close(depth, vd.distance_to(first, center))


def test_voxel_argmax_depth_wrapper_guards():
    bbox = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32)
    rs = torch.zeros((4, 3))
    S = torch.full((4, D), 1.0 / D)
    c = torch.zeros(3)
    with pytest.raises(ValueError, match="2\\*\\*31 - 1"):
        vd.voxel_argmax_depth(bbox, rs, rs + 1, S, c, (2048, 1024, 1024), 8)
    with pytest.raises(ValueError, match="positive"):
        vd.voxel_argmax_depth(bbox, rs, rs + 1, S, c, (4, 4, 4), 0)


@pytest.fixture(scope="module")
def view_set(mock_scene_dir):
    """One view set of the mock scene with seeded random features."""
    scene = JaxRestrepoScene(str(mock_scene_dir))
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(2, 4)]
    rng = np.random.RandomState(6)
    return dict(
        idxs=np.arange(H * W, dtype=np.int32),
        feats=rng.randn(5, H + PAD + 1, W + PAD + 1, 32).astype(np.float32),
        P=np.stack([c.P for c in cams]).astype(np.float32),
        P_pinv=np.asarray(cams[0].P_pinv, np.float32),
        center=np.asarray(cams[0].center[:3, 0], np.float32),
        bbox=scene.bbox.reshape(-1).astype(np.float32),
    )


def _port_view(v):
    t = {k: torch.as_tensor(a) for k, a in v.items()}
    rs, re = segments_in_bbox(t["idxs"], t["P_pinv"], t["center"], t["bbox"],
                              H)
    return t, rs, re


def _jax_args(v):
    return [jnp.asarray(v[k]) for k in ("idxs", "feats", "P", "P_pinv",
                                        "center", "bbox")]


@pytest.mark.parametrize("rays_batch", [H * W, 700])
def test_mvcnn_image_depth_matches_jax(view_set, rays_batch):
    _, jd = jfused.mvcnn_depth_step(*_jax_args(view_set), H, W, PAD, D)
    t, rs, re = _port_view(view_set)
    depth = tfused.mvcnn_image_depth(
        rs, re, t["feats"], t["P"], t["center"], height=H, width=W,
        padding=PAD, depth_planes=D, rays_batch=rays_batch)
    assert depth.shape == (H * W,) and depth.dtype == torch.float32
    jd = np.asarray(jd)
    assert np.array_equal(depth.numpy() > 0, jd > 0)
    assert np.mean(np.abs(depth.numpy() - jd) <= 1e-3 * np.abs(jd)) >= 0.999
    # the chosen plane's point only, with the formula of the batch step
    _, step_depth = tfused.mvcnn_depth_step(
        t["idxs"], t["feats"], t["P"], t["P_pinv"], t["center"], t["bbox"],
        H, W, PAD, D)
    assert torch.equal(depth, step_depth)


@pytest.mark.parametrize("rays_batch", [H * W, 700])
def test_mvcnn_voxel_image_depth_matches_jax(view_set, rays_batch):
    jS, jvox, jc, jd = (np.asarray(a) for a in jfused.mvcnn_voxel_depth_step(
        *_jax_args(view_set), H, W, PAD, D, GRID, M))
    t, rs, re = _port_view(view_set)
    vd.voxel_argmax_depth.launches = 0
    depth = tfused.mvcnn_voxel_image_depth(
        rs, re, t["feats"], t["P"], t["center"], t["bbox"], height=H,
        width=W, padding=PAD, depth_planes=D, grid_shape=GRID, max_voxels=M,
        rays_batch=rays_batch)
    assert vd.voxel_argmax_depth.launches == 0
    assert depth.shape == (H * W,) and depth.dtype == torch.float32
    assert _voxel_agree(depth.numpy(), jS, jvox, jc, jd, view_set["center"],
                        view_set["bbox"], GRID) >= 0.999
    nz = depth[depth > 0]
    assert 10.0 <= float(nz.min()) and float(nz.max()) <= 30.0
    # the plain version on the port's scores: the JAX counts, and the
    # batch step's depth exactly
    S_vox, vox, counts, step_depth = tfused.mvcnn_voxel_depth_step(
        t["idxs"], t["feats"], t["P"], t["P_pinv"], t["center"], t["bbox"],
        H, W, PAD, D, GRID, M)
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert torch.equal(depth, step_depth)

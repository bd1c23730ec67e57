"""Parity of the port's geometry, sampling and voxel traversal with the JAX
package: the same seeded inputs go through both.

Tolerances: segments and sample points rtol=atol=1e-6 (both sides are the
same f32 multiply-add chains; XLA may fuse them differently); traversal
indices and counts EXACT, also against the numpy oracle.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.common.scene import RestrepoScene
from raynet_tpu.ops import geometry as jgeo
from raynet_tpu.ops import ray_marching as jrm
from raynet_tpu.ops import sampling as jsamp
from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.ops import geometry as tgeo
from raynet_tpu_torch.ops import ray_marching as trm
from raynet_tpu_torch.ops import sampling as tsamp
from conftest import MOCK_H as H, MOCK_W as W
from oracles import voxel_traversal_oracle

torch.set_num_threads(2)

BBOX = np.array([-3, -3, -3, 3, 3, 3], np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cams(scene, ref):
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(ref, 4)]
    P = np.stack([c.P for c in cams]).astype(np.float32)
    return (P, np.asarray(cams[0].P_pinv, np.float32),
            np.asarray(cams[0].center[:3, 0], np.float32))


@pytest.fixture(scope="module")
def scene(mock_scene_dir):
    return RestrepoScene(str(mock_scene_dir))


def _segments_both(P_pinv, center, idxs, height):
    js, je = jsamp.segments_in_bbox(
        jnp.asarray(idxs), jnp.asarray(P_pinv), jnp.asarray(center),
        jnp.asarray(BBOX), height,
    )
    ts, te = tsamp.segments_in_bbox(
        _t(idxs), _t(P_pinv), _t(center), _t(BBOX), height
    )
    return (np.asarray(js), np.asarray(je)), (ts, te)


@pytest.mark.parametrize("ref", [0, 2, 5])
def test_segments_match_jax(scene, ref):
    _, P_pinv, center = _cams(scene, ref)
    idxs = np.arange(H * W, dtype=np.int32)
    (js, je), (ts, te) = _segments_both(P_pinv, center, idxs, H)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-6, atol=1e-6)


def test_segments_match_jax_paper_rig():
    """The chip run's rig scaled down: about half the rays miss the bbox
    and collapse to zero-length segments on both sides."""
    ring = RingScene(6, 90, 120, 2750.0 / 1600 * 120, angle_origin=1)
    _, P_pinv, center = _cams(ring, 1)
    idxs = np.arange(90 * 120, dtype=np.int32)
    (js, je), (ts, te) = _segments_both(P_pinv, center, idxs, 90)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-6, atol=1e-6)
    miss_t = (te - ts).abs().sum(-1).numpy() == 0
    assert np.array_equal(miss_t, np.abs(je - js).sum(-1) == 0)
    assert 0.2 * len(idxs) < miss_t.sum() < 0.8 * len(idxs)


def test_sample_points_match_jax(scene):
    _, P_pinv, center = _cams(scene, 1)
    idxs = np.arange(H * W, dtype=np.int32)
    (js, je), (ts, te) = _segments_both(P_pinv, center, idxs, H)
    jp = jsamp.sample_points_along_segments(jnp.asarray(js), jnp.asarray(je), 8)
    tp = tsamp.sample_points_along_segments(ts, te, 8)
    assert tp.shape == (H * W, 8, 3) and tp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


def test_project_points_match_jax(scene):
    P, _, _ = _cams(scene, 3)
    rng = np.random.RandomState(1)
    pts = rng.uniform(-3, 3, size=(5, 200, 3)).astype(np.float32)
    jp = jgeo.project_points(jnp.asarray(P), jnp.asarray(pts))
    tp = tgeo.project_points(_t(P), _t(pts))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-4)


def _random_segments(rng, n):
    """Segments with endpoints inside and around the bbox, including
    axis-aligned and zero-length ones."""
    a = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    b = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    b[:8, 1:] = a[:8, 1:]  # axis-aligned along x
    b[8:12] = a[8:12]  # zero length
    return a, b


@pytest.mark.parametrize(
    "grid, M", [((12, 12, 12), 24), ((16, 16, 16), 32), ((12, 16, 8), 40)]
)
def test_traversal_matches_jax_exactly(scene, grid, M):
    rng = np.random.RandomState(2)
    a, b = _random_segments(rng, 500)
    _, P_pinv, center = _cams(scene, 0)
    (js, je), _ = _segments_both(
        P_pinv, center, np.arange(H * W, dtype=np.int32), H
    )
    starts = np.concatenate([a, js]).astype(np.float32)
    ends = np.concatenate([b, je]).astype(np.float32)
    jf, jc = jrm.voxel_traversal_flat(
        jnp.asarray(BBOX), jnp.asarray(starts), jnp.asarray(ends), grid, M
    )
    tf, tc = trm.voxel_traversal_flat(_t(BBOX), _t(starts), _t(ends), grid, M)
    assert tf.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tc.max().item() > 1


def test_traversal_matches_oracle():
    rng = np.random.RandomState(3)
    a, b = _random_segments(rng, 60)
    grid, M = (12, 12, 12), 24
    vox, counts = trm.voxel_traversal(_t(BBOX), _t(a), _t(b), grid, M)
    for i in range(len(a)):
        ov, oc = voxel_traversal_oracle(BBOX, grid, a[i], b[i], M)
        assert counts[i].item() == oc
        np.testing.assert_array_equal(vox[i].numpy(), ov)


def test_flat_indices_and_centers_match_jax():
    rng = np.random.RandomState(4)
    grid = (12, 16, 8)
    vox = rng.randint(0, 8, size=(30, 5, 3)).astype(np.int32)
    flat_t = trm.flatten_voxel_indices(_t(vox), grid)
    flat_j = jrm.flatten_voxel_indices(jnp.asarray(vox), grid)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(
        trm.unflatten_voxel_indices(flat_t, grid).numpy(), vox
    )
    np.testing.assert_allclose(
        trm.voxel_centers(_t(vox), _t(BBOX), grid).numpy(),
        np.asarray(jrm.voxel_centers(jnp.asarray(vox), jnp.asarray(BBOX), grid)),
        rtol=0, atol=0,
    )


def test_ring_scene_matches_restrepo_cameras(scene):
    """The in-memory ring rig reproduces the mock scene's cameras and view
    sets (the mock scene stores them as text with 9 digits)."""
    ring = RingScene(6, H, W, 400.0, angle_step=0.05)
    assert ring.image_shape == scene.image_shape
    np.testing.assert_allclose(ring.bbox, scene.bbox)
    for i in range(6):
        assert ring.get_view_idxs(i, 4) == scene.get_view_idxs(i, 4)
        np.testing.assert_allclose(
            ring.get_image(i).camera.P, scene.get_image(i).camera.P,
            rtol=1e-6, atol=1e-4,
        )
        np.testing.assert_allclose(
            ring.get_image(i).camera.center, scene.get_image(i).camera.center,
            rtol=1e-6, atol=1e-5,
        )

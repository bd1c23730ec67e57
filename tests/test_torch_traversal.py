"""The port's voxel traversal (``voxel_traversal_flat``, the plain version of
K3 on the CPU) against the JAX package's Pallas traversal kernel in
interpret mode and its lax.scan op, exactly: flat indices and counts.

Geometries: those of ``tests/test_pallas_traversal.py`` (N not a multiple
of the kernel's block, rays that miss the grid, negative directions with
exact diagonals) and the mock scene's own bbox segments.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.common.scene import RestrepoScene
from raynet_tpu.ops import ray_marching as jrm
from raynet_tpu.ops import sampling as jsamp
from raynet_tpu.ops.pallas.traversal import voxel_traversal_flat_pallas
from raynet_tpu_torch.ops import ray_marching as trm
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)


def _random_faces(rng):
    bbox = np.array([-1.0, -2.0, 0.0, 3.0, 2.0, 1.5], dtype=np.float32)
    n = 200  # not a multiple of the 1024-ray Pallas block or 128 threads
    starts = np.stack([rng.uniform(bbox[0], bbox[3], n),
                       rng.uniform(bbox[1], bbox[4], n),
                       np.full(n, bbox[2])], axis=1).astype(np.float32)
    ends = np.stack([rng.uniform(bbox[0], bbox[3], n),
                     rng.uniform(bbox[1], bbox[4], n),
                     np.full(n, bbox[5])], axis=1).astype(np.float32)
    return bbox, starts, ends, (13, 9, 5), 32


def _misses(rng):
    bbox = np.array([0, 0, 0, 4, 4, 4], dtype=np.float32)
    starts = np.tile(np.array([[-10.0, -10.0, -10.0]], np.float32), (8, 1))
    return bbox, starts, starts + 1.0, (4, 4, 4), 8


def _negative_and_diagonal(rng):
    bbox = np.array([-2.0, -1.0, 0.5, 2.0, 3.0, 4.5], dtype=np.float32)
    n = 160
    starts = np.stack([rng.uniform(bbox[0], bbox[3], n),
                       rng.uniform(bbox[1], bbox[4], n),
                       np.where(rng.rand(n) < 0.5, bbox[2], bbox[5])],
                      axis=1).astype(np.float32)
    ends = np.stack([rng.uniform(bbox[0], bbox[3], n),
                     rng.uniform(bbox[1], bbox[4], n),
                     bbox[2] + bbox[5] - starts[:, 2]],
                    axis=1).astype(np.float32)
    starts[:8] = [bbox[0], bbox[1], bbox[2]]
    ends[:8] = [bbox[3], bbox[4], bbox[5]]
    return bbox, starts, ends, (7, 11, 6), 40


def _mock_scene(rng, scene_dir):
    scene = RestrepoScene(str(scene_dir))
    cam = scene.get_image(1).camera
    bbox = scene.bbox.reshape(-1).astype(np.float32)
    rs, re = jsamp.segments_in_bbox(
        jnp.arange(H * W, dtype=jnp.int32),
        jnp.asarray(cam.P_pinv, jnp.float32),
        jnp.asarray(cam.center[:3, 0], jnp.float32), jnp.asarray(bbox), H,
    )
    return bbox, np.array(rs), np.array(re), (12, 12, 12), 24


GEOMETRIES = {
    "random_faces": _random_faces,
    "misses": _misses,
    "negative_and_diagonal": _negative_and_diagonal,
    "mock_scene": _mock_scene,
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_traversal_matches_pallas_and_scan(name, rng, mock_scene_dir):
    if name == "mock_scene":
        bbox, rs, re, grid, M = _mock_scene(rng, mock_scene_dir)
    else:
        bbox, rs, re, grid, M = GEOMETRIES[name](rng)
    trm.voxel_traversal_flat.launches = 0
    idx, counts = trm.voxel_traversal_flat(
        torch.as_tensor(bbox), torch.as_tensor(rs), torch.as_tensor(re),
        grid, M,
    )
    assert trm.voxel_traversal_flat.launches == 0
    assert idx.dtype == torch.int32 and counts.dtype == torch.int32
    assert idx.shape == (len(rs), M)
    jidx, jcnt = voxel_traversal_flat_pallas(
        jnp.asarray(bbox), jnp.asarray(rs), jnp.asarray(re), grid, M,
        interpret=True,
    )
    sidx, scnt = jrm.voxel_traversal_flat(
        jnp.asarray(bbox), jnp.asarray(rs), jnp.asarray(re), grid, M,
    )
    for ref_idx, ref_cnt in ((jidx, jcnt), (sidx, scnt)):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_cnt))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    # zero past each ray's count
    past = np.arange(M)[None, :] >= counts.numpy()[:, None]
    assert not idx.numpy()[past].any()
    if name == "misses":
        assert not counts.any()
    else:
        assert int(counts.max()) > 1


def test_wrapper_guards():
    bbox = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32)
    rs = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="2\\*\\*31 - 1"):
        trm.voxel_traversal_flat(bbox, rs, rs + 1, (2048, 1024, 1024), 8)
    with pytest.raises(ValueError, match="positive"):
        trm.voxel_traversal_flat(bbox, rs, rs + 1, (4, 4, 4), 0)
    # a 128x128x64 grid (the paper's) fits
    idx, counts = trm.voxel_traversal_flat(bbox, rs + 0.5, rs + 0.6,
                                           (128, 128, 64), 8)
    assert int(counts.min()) > 1 and int(idx.max()) < 128 * 128 * 64

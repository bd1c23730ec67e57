"""Depth-map export helpers for voxel-space distributions.

Copy of ``raynet_tpu/ops/mrf_utils.py`` (numpy, on the host): argmax over
the per-voxel distribution, voxel index -> world center -> distance from
camera -> (W, H).T image.
"""
import numpy as np


def export_depth_map_from_voxel_indices(
    scene, img_idx, S, ray_voxel_indices, ray_idxs, grid_shape
):
    """Depth map for image ``img_idx`` from per-ray voxel distributions.

    Arguments
    ---------
        S: (N, M) per-voxel depth distribution per ray
        ray_voxel_indices: (N, M, 3) int32 visited voxel indices
        ray_idxs: (N,) column-major ray indices of the rows of S
        grid_shape: (3,) voxels per axis
    """
    H, W = scene.image_shape
    camera_center = scene.get_image(img_idx).camera.center

    n = S.shape[0]
    idxs = ray_voxel_indices[np.arange(n), np.asarray(S).argmax(axis=-1)]

    grid = scene.voxel_grid(grid_shape)
    points = grid[:, idxs[:, 0], idxs[:, 1], idxs[:, 2]]
    dist = np.sqrt(np.sum((camera_center[:-1] - points) ** 2, axis=0))

    D = np.zeros((H * W,), dtype=np.float32)
    D[np.asarray(ray_idxs)] = dist
    return D.reshape(W, H).T

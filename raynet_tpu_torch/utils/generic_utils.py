"""Voxel-grid construction for the data layer.

Copy of ``raynet_tpu/utils/generic_utils.py::get_voxel_grid``.
"""
import numpy as np


def get_voxel_grid(bbox, grid_shape):
    """Centers of all voxels of a regular grid over the (1, 6) ``bbox``.

    Returns (3, D1, D2, D3) float32.
    """
    assert bbox.shape == (1, 6)
    xyz = [
        np.linspace(s, e, c, endpoint=False, dtype=np.float32)
        for s, e, c in zip(bbox[0, :3], bbox[0, 3:], grid_shape)
    ]
    bin_size = np.array([xi[1] - xi[0] for xi in xyz]).reshape(3, 1, 1, 1)
    return np.stack(np.meshgrid(*xyz, indexing="ij")) + bin_size / 2

"""Ray / pixel indexing, voxel-grid construction and points along rays for
the data layer, and the device check of the port's entry points.

Every function but ``resolve_device`` is a copy of
``raynet_tpu/utils/generic_utils.py``'s. The ray <-> pixel mapping is
column-major: ray r is pixel ``x = r // H`` (column), ``y = r % H`` (row),
the ``(W, H).T`` layout of the depth maps.
"""
import numpy as np
import torch


def resolve_device(device):
    """torch.device for ``device``; a CUDA device without a card raises.

    On a CUDA device the port computes in float32: cuDNN convolutions and
    cuBLAS matmuls default to TF32 on this card (a 10-bit mantissa), so it
    switches TF32 off for the process. Features feed integer feature-cell
    lookups and near-tied argmaxes, and training steps are held to the CPU's.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %s requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path" % (device,)
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def pixel_to_ray(y, x, axis_length, axis_order="columns"):
    """The ray index of pixel (y, x) (column-major by default)."""
    if axis_order == "columns":
        return x * axis_length + y
    elif axis_order == "rows":
        return y * axis_length + x
    raise ValueError("axis_order argument can be either columns or rows")


def ray_to_pixel(ray_idx, height):
    """Inverse of ``pixel_to_ray`` for column-major indexing: (x, y), x
    along the width, y along the height."""
    return ray_idx // height, ray_idx % height


def point_from_depth(camera_center, direction, depth):
    """3D point at metric ``depth`` along a (not necessarily unit) ray."""
    assert camera_center.shape == (3, 1)
    assert direction.shape == (3, 1)
    a_norm = direction / np.sqrt(np.sum(direction ** 2))
    return a_norm * depth + camera_center


def point_to_voxel(p, bbox_origin, bin_size):
    """Voxel index containing a (3, 1) point (floor semantics), int32."""
    assert p.shape == (3, 1)
    v = (p - bbox_origin) / bin_size
    return np.floor(v).astype(np.int32)


def voxel_to_world_coordinates(voxel_index, bbox, grid_shape):
    """Centre of a voxel in world coordinates; ``bbox`` is the (1, 6)
    [min, max] box."""
    assert bbox.shape == (1, 6)
    bin_size = (bbox[0, 3:] - bbox[0, :3]) / grid_shape
    t = voxel_index * bin_size
    t = t + bbox[0, :3]
    t = t + bin_size / 2
    return t


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

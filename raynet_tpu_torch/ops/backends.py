"""Backend dispatch facades with numpy APIs.

Port of ``raynet_tpu/ops/backends.py`` (the reference's
get_voxel_traversal_backend "cython"/"cuda" and
get_depth_to_voxels_backend "numpy"/"cuda"). The historical names are
aliases of the one implementation: the traversal is
``ray_marching.voxel_traversal_flat``, which runs K3's rows mode on a CUDA
device and its plain version on the CPU; the mapping is
``planes_voxels.planes_to_voxels_mapping_by_name``. Each function moves its
numpy inputs to ``device`` (default the card) and returns numpy.
"""
import numpy as np
import torch

from ..utils.generic_utils import resolve_device
from .planes_voxels import planes_to_voxels_mapping_by_name
from .ray_marching import unflatten_voxel_indices, voxel_traversal_flat


def _f32(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def get_ray_voxel_indices(bbox, grid_shape, ray_starts, ray_ends, max_voxels,
                          device="cuda"):
    """Batched voxel traversal with a numpy API.

    Returns (ray_voxel_indices (N, M, 3) int32, zero past each ray's count,
    ray_voxel_count (N,) int32).
    """
    device = resolve_device(device)
    grid_shape = tuple(int(g) for g in grid_shape)
    flat, counts = voxel_traversal_flat(
        _f32(np.asarray(bbox).reshape(-1), device),
        _f32(ray_starts, device), _f32(ray_ends, device),
        grid_shape, int(max_voxels),
    )
    vox = unflatten_voxel_indices(flat, grid_shape).to(torch.int32)
    return vox.cpu().numpy(), counts.cpu().numpy()


def perform_ray_marching(scene, grid_shape, ray_starts, ray_ends, max_voxels,
                         device=None):
    """Scene-level wrapper over :func:`get_ray_voxel_indices`, on the
    scene's device unless ``device`` is given."""
    return get_ray_voxel_indices(
        scene.bbox, grid_shape, ray_starts, ray_ends, max_voxels,
        device=scene.device if device is None else device,
    )


def get_voxel_traversal_backend(name="xla"):
    """"cython"/"cuda"/"xla"/"jax" all resolve to the one traversal."""
    if name not in ("cython", "cuda", "xla", "jax"):
        raise KeyError("unknown voxel traversal backend %r" % (name,))
    return get_ray_voxel_indices


def depth_to_voxels(
    S, ray_voxel_indices, ray_voxel_count, ray_starts, ray_ends, bbox,
    grid_shape, depth_planes, interpolation="li", gamma=10.0, device="cuda",
):
    """Numpy-API wrapper of the depth->voxel mapping.

    ``interpolation`` selects the variant ("li"/"li_2"/"quadratic"/"kde",
    the reference's factory names; another name raises KeyError);
    ``gamma`` is the kde bandwidth.
    """
    device = resolve_device(device)
    out = planes_to_voxels_mapping_by_name(
        _f32(S, device),
        torch.as_tensor(np.asarray(ray_voxel_indices), device=device),
        torch.as_tensor(np.asarray(ray_voxel_count), device=device),
        _f32(ray_starts, device), _f32(ray_ends, device),
        _f32(np.asarray(bbox).reshape(-1), device),
        tuple(int(g) for g in grid_shape), int(depth_planes),
        interpolation=interpolation, gamma=gamma,
    )
    return out.cpu().numpy()


def get_depth_to_voxels_backend(name="xla"):
    """"numpy"/"cuda"/"xla"/"jax" all resolve to the one mapping."""
    if name not in ("numpy", "cuda", "xla", "jax"):
        raise KeyError("unknown depth-to-voxels backend %r" % (name,))
    return depth_to_voxels

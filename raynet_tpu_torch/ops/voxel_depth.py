"""K3's voxel-depth mode: each ray's depth at its best-scoring voxel, and its
plain version.

``voxel_argmax_depth`` computes what the tail of the voxel-space step
(``fused.mvcnn_voxel_depth_step``; JAX ``raynet_tpu/ops/fused.py:190-205``)
computes after the plane sweep: march the ray's voxels, hat-map its D
plane scores onto each, and return the distance from the camera centre to
the centre of the first voxel of maximum score (0 for a ray that visits no
voxel), with the counts. For CUDA tensors it launches
``raynet_voxel_argmax_depth`` of ``csrc/traversal.cu``, which never forms
an (N, M) array; for CPU tensors it runs ``voxel_argmax_depth_reference``,
the step's own composition of traversal, hat mapping and argmax.
"""
import torch

from . import cuda_build
from .planes_voxels import planes_to_voxels_mapping
from .ray_marching import (
    check_grid,
    unflatten_voxel_indices,
    voxel_centers,
    voxel_traversal_flat_reference,
)

MAX_PLANES = 128


def distance_to(points, camera_center):
    """(N,) Euclidean distance of (N, 3) points from the camera centre."""
    d = points - camera_center[None]
    return torch.sqrt(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    )


def argmax_voxel_depth(S_vox, vox, counts, camera_center, bbox, grid_shape):
    """(N,) distance from the camera centre to the centre of each ray's
    first voxel of maximum ``S_vox`` (N, M), 0 where ``counts`` is 0;
    ``vox`` (N, M, 3) are the visited voxels."""
    best = torch.argmax(S_vox, dim=-1)  # first maximum
    rows = torch.arange(best.shape[0], device=best.device)
    # only the arg-max voxels' centres: the (N, M, 3) centres of the JAX
    # step hold the same values
    depth = distance_to(
        voxel_centers(vox[rows, best], bbox, grid_shape), camera_center
    )
    return torch.where(counts > 0, depth, torch.zeros_like(depth))


def plain_voxel_scores(bbox, ray_start, ray_end, S_planes, grid_shape,
                       max_voxels):
    """The plain traversal and hat mapping: (flat indices (N, M) int32,
    voxel indices (N, M, 3), counts (N,) int32, mapped scores S_vox (N, M)
    renormalised over each ray's count and zero past it)."""
    flat_idx, counts = voxel_traversal_flat_reference(
        bbox, ray_start, ray_end, grid_shape, max_voxels
    )
    vox = unflatten_voxel_indices(flat_idx, grid_shape)
    S_vox = planes_to_voxels_mapping(
        S_planes, vox, counts, ray_start, ray_end, bbox, grid_shape,
        S_planes.shape[1],
    )
    return flat_idx, vox, counts, S_vox


def voxel_argmax_depth_reference(bbox, ray_start, ray_end, S_planes,
                                 camera_center, grid_shape, max_voxels):
    """Plain version: traversal, hat mapping, argmax. Returns (depth (N,)
    float32, counts (N,) int32)."""
    _, vox, counts, S_vox = plain_voxel_scores(
        bbox, ray_start, ray_end, S_planes, grid_shape, max_voxels
    )
    return (argmax_voxel_depth(S_vox, vox, counts, camera_center, bbox,
                               grid_shape), counts)


def _voxel_argmax_depth_cuda(bbox, ray_start, ray_end, S_planes,
                             camera_center, grid_shape, max_voxels):
    n, depth_planes = ray_start.shape[0], S_planes.shape[-1]
    gx, gy, gz = (int(g) for g in grid_shape)
    f32 = torch.float32
    if not 2 <= depth_planes <= MAX_PLANES:
        raise ValueError("voxel_argmax_depth: 2 <= D <= %d, got %d"
                         % (MAX_PLANES, depth_planes))
    for name, t, shape in (("bbox", bbox, (6,)),
                           ("ray_start", ray_start, (n, 3)),
                           ("ray_end", ray_end, (n, 3)),
                           ("S_planes", S_planes, (n, depth_planes)),
                           ("camera_center", camera_center, (3,))):
        cuda_build.check_tensor("voxel_argmax_depth", name, t, f32, shape)
    if len({t.device for t in (bbox, ray_start, ray_end, S_planes,
                                camera_center)}) != 1:
        raise ValueError("voxel_argmax_depth: all tensors must be on one "
                         "device")
    device = ray_start.device
    depth = torch.empty(n, dtype=f32, device=device)
    counts = torch.empty(n, dtype=torch.int32, device=device)
    cuda_build.launch(
        "raynet_voxel_argmax_depth", ray_start,
        bbox.data_ptr(), ray_start.data_ptr(), ray_end.data_ptr(),
        S_planes.data_ptr(), camera_center.data_ptr(), depth.data_ptr(),
        counts.data_ptr(), n, int(max_voxels), depth_planes, gx, gy, gz,
    )
    voxel_argmax_depth.launches += 1
    return depth, counts


def voxel_argmax_depth(bbox, ray_start, ray_end, S_planes, camera_center,
                       grid_shape, max_voxels):
    """Depth of each ray at its best-scoring visited voxel: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    Arguments
    ---------
        bbox: (6,) float32 [min_xyz, max_xyz] of the grid
        ray_start, ray_end: (N, 3) float32 segments through the bbox
        S_planes: (N, D) float32 plane-sweep (softmax) scores, D <= 128 on
            the card
        camera_center: (3,) float32
        grid_shape: (3,) ints, the voxel count must fit the int32 flat
            index; max_voxels: M, the per-ray step budget

    Returns (depth (N,) float32, 0 where the ray visits no voxel; counts
    (N,) int32). Ties keep the first voxel along the ray; a ray with a NaN
    mapped score (a zero-length segment) takes its first voxel.
    """
    check_grid("voxel_argmax_depth", grid_shape, max_voxels)
    args = (bbox, ray_start, ray_end, S_planes, camera_center, grid_shape,
            max_voxels)
    if cuda_build.on_cuda("voxel_argmax_depth", ray_start):
        return _voxel_argmax_depth_cuda(*args)
    return voxel_argmax_depth_reference(*args)


# Kernel launches since the last reset (the plain path never counts).
voxel_argmax_depth.launches = 0

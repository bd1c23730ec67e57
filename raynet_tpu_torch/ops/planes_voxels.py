"""Depth-plane -> voxel probability mapping (the li / li_2 hat function).

Port of ``raynet_tpu/ops/planes_voxels.py:34-96`` and ``:179``. With the D
depth hypotheses uniform in the segment parameter t, the reference's top-2
inverse-distance interpolation is exactly the hat-function sum

    s_new(t) = sum_d s_d * max(0, 1 - |t - t_d| / h),   h = 1 / (D - 1).

The quadratic and kde variants are not ported yet.
"""
import torch

from .ray_marching import voxel_centers
from .sampling import true_divisor

_EPS_T = 1e-4


def project_voxels_to_rays(voxel_centers_, ray_start, ray_end, clip=True):
    """Parameter t of each voxel centre projected onto its ray segment.

    voxel_centers_: (N, M, 3); ray_start, ray_end: (N, 3). Returns (N, M)
    float32, clipped to [1e-4, 1 - 1e-4] when ``clip``. The 3-term dot
    products are written out left to right (the CUDA kernel's order).
    """
    ray = ray_end - ray_start
    vdir = voxel_centers_ - ray_start[:, None, :]
    r = ray[:, None, :]
    num = (
        vdir[..., 0] * r[..., 0] + vdir[..., 1] * r[..., 1]
        + vdir[..., 2] * r[..., 2]
    )
    den = ray[:, 0] * ray[:, 0] + ray[:, 1] * ray[:, 1] + ray[:, 2] * ray[:, 2]
    t = num / den[:, None]
    if clip:
        t = t.clamp(_EPS_T, 1 - _EPS_T)
    return t


def depth_planes_to_voxels(S_planes, t, counts, depth_planes):
    """Interpolate per-plane probabilities onto the visited voxels.

    S_planes: (N, D); t: (N, M); counts: (N,). Returns (N, M) masked to each
    ray's count and renormalised to sum 1 over the valid entries.
    """
    D = depth_planes
    m = t.shape[1]
    scale = float(D - 1)
    t_d = torch.arange(D, dtype=torch.float32, device=t.device) / true_divisor(
        D - 1, t.device
    )

    s_new = torch.zeros_like(t)
    for d in range(D):
        w = (1.0 - (t - t_d[d]).abs() * scale).clamp_min(0.0)
        s_new = s_new + S_planes[:, d][:, None] * w

    mask = torch.arange(m, device=t.device)[None, :] < counts[:, None]
    zero = torch.zeros_like(s_new)
    s_new = torch.where(mask, s_new, zero)
    total = s_new.sum(dim=1, keepdim=True)
    return torch.where(mask, s_new / total.clamp_min(1e-30), zero)


def planes_to_voxels_mapping(
    S_planes, voxel_indices, counts, ray_start, ray_end, bbox, grid_shape,
    depth_planes,
):
    """Fused: voxel centres -> segment projection -> hat interpolation."""
    centers = voxel_centers(voxel_indices, bbox, grid_shape)
    t = project_voxels_to_rays(centers, ray_start, ray_end)
    return depth_planes_to_voxels(S_planes, t, counts, depth_planes)

"""Depth-plane -> voxel probability mapping (the li / li_2 hat function).

Port of ``raynet_tpu/ops/planes_voxels.py:34-96`` and ``:179``. With the D
depth hypotheses uniform in the segment parameter t, the reference's top-2
inverse-distance interpolation is exactly the hat-function sum

    s_new(t) = sum_d s_d * max(0, 1 - |t - t_d| / h),   h = 1 / (D - 1).

The quadratic and kde variants are not ported yet.
"""
import torch

from .ray_marching import voxel_centers

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

    The hat sum is evaluated as what it equals in exact arithmetic, the
    interpolation between the two planes that bracket t: with x = t (D-1),
    lo = floor(x) and f = x - lo, s = S_lo + (S_lo+1 - S_lo) f. Where two
    adjacent planes score the same (their points project to the same
    feature cells, common at low resolution), every voxel between them
    then gets exactly that score, so the argmax takes the first of them
    whatever the rounding of the scores; the hat sum's rounding picks any
    of them. K2 (``csrc/bp_sweep.cu``) evaluates the same form.
    """
    D = depth_planes
    m = t.shape[1]
    x = t * float(D - 1)
    lo = torch.nan_to_num(x.floor(), nan=0.0).clamp(0, D - 2)
    f = x - lo
    lo = lo.to(torch.int64)
    s_lo = torch.gather(S_planes, 1, lo)
    s_hi = torch.gather(S_planes, 1, lo + 1)
    s_new = s_lo + (s_hi - s_lo) * f

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

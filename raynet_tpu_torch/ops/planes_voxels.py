"""Depth-plane -> voxel probability mapping.

Port of ``raynet_tpu/ops/planes_voxels.py``:

- ``li`` / ``li_2`` (the default): with the D depth hypotheses uniform in
  the segment parameter t, the reference's top-2 inverse-distance
  interpolation is exactly the hat-function sum
  s_new(t) = sum_d s_d * max(0, 1 - |t - t_d| / h), h = 1 / (D - 1);
- ``quadratic``: scipy ``interp1d(kind="quadratic")``, a k=2 interpolating
  B-spline whose per-interval coefficients are linear in the D samples, so
  one constant (intervals, 3, D) table per D (built with scipy) and a
  Horner step per voxel;
- ``kde``: a Gaussian kernel density over squared world-space distances
  along the ray, gamma=10.

``get_planes_voxels_mapping`` selects by the reference factory's names
("li" is the li_2 kernel there too).
"""
from functools import lru_cache, partial

import numpy as np
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
    x = t * float(D - 1)
    lo = torch.nan_to_num(x.floor(), nan=0.0).clamp(0, D - 2)
    f = x - lo
    lo = lo.to(torch.int64)
    s_lo = torch.gather(S_planes, 1, lo)
    s_hi = torch.gather(S_planes, 1, lo + 1)
    return _masked_renorm(s_lo + (s_hi - s_lo) * f, counts)


def _masked_renorm(s_new, counts):
    """Zero past each ray's count, then renormalise to sum 1."""
    mask = torch.arange(s_new.shape[1], device=s_new.device)[None, :] \
        < counts[:, None]
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


@lru_cache(maxsize=None)
def _quadratic_spline_tensor(depth_planes):
    """(breaks (K+1,), C (K, 3, D)) float32 with
    s(t) = sum_j C[k, j] . s * (t - breaks[k])^(2-j) for t in interval k:
    scipy's interpolator run on the identity basis (the JAX package's
    table, ``planes_voxels.py:100-126``)."""
    from scipy.interpolate import PPoly, make_interp_spline

    t_points = np.linspace(0.0, 1.0, depth_planes)
    cols = []
    breaks = None
    for d in range(depth_planes):
        e = np.zeros(depth_planes)
        e[d] = 1.0
        pp = PPoly.from_spline(make_interp_spline(t_points, e, k=2))
        # from_spline keeps the repeated boundary knots; drop the
        # zero-length end intervals
        keep = np.diff(pp.x) > 0
        if breaks is None:
            breaks = np.concatenate([pp.x[:-1][keep], pp.x[-1:]])
        cols.append(pp.c[:, keep])  # (3, K)
    C = np.stack(cols, axis=-1).transpose(1, 0, 2)  # (K, 3, D)
    return breaks.astype(np.float32), C.astype(np.float32)


def depth_planes_to_voxels_quadratic(S_planes, t, counts, depth_planes):
    """Quadratic-spline variant; ``t`` already clipped to [eps, 1-eps]."""
    breaks_np, C_np = _quadratic_spline_tensor(depth_planes)
    breaks = torch.as_tensor(breaks_np, device=t.device)
    C = torch.as_tensor(C_np, device=t.device)
    # per-ray polynomial tables (N, K, 3): a float32 product (TF32 is off
    # for matmul unless the caller turns it on)
    T = torch.einsum("kjd,nd->nkj", C, S_planes)
    idx = (torch.searchsorted(breaks, t.contiguous(), right=True) - 1).clamp(
        0, C.shape[0] - 1)
    dt = t - breaks[idx]
    c = torch.gather(T, 1, idx[..., None].expand(-1, -1, 3))  # (N, M, 3)
    s_new = (c[..., 0] * dt + c[..., 1]) * dt + c[..., 2]
    return _masked_renorm(s_new, counts)


def depth_planes_to_voxels_kde(S_planes, t, ray_norm_sq, counts, depth_planes,
                               gamma=10.0):
    """Gaussian-KDE variant; ``t`` is the UNclipped projection parameter and
    the distances are (t_d - t)^2 * ||ray||^2."""
    # the planes' t_d = d / (D - 1), each a float32 division (a Python
    # scalar would divide through its reciprocal)
    planes = torch.arange(depth_planes, dtype=torch.float32,
                          device=t.device) / true_divisor(depth_planes - 1,
                                                          t.device)
    g = ray_norm_sq[:, None] * gamma  # (N, 1)
    s_new = torch.zeros_like(t)
    for d in range(depth_planes):
        w = torch.exp(-((t - planes[d]) ** 2) * g)
        s_new = s_new + S_planes[:, d][:, None] * w
    return _masked_renorm(s_new, counts)


MAPPINGS = ("li", "li_2", "quadratic", "kde")


def planes_to_voxels_mapping_by_name(
    S_planes, voxel_indices, counts, ray_start, ray_end, bbox, grid_shape,
    depth_planes, interpolation="li", gamma=10.0,
):
    """Variant-selectable mapping (the reference factory's names); an
    unknown name raises KeyError."""
    if interpolation not in MAPPINGS:
        raise KeyError("unknown interpolation %r" % (interpolation,))
    centers = voxel_centers(voxel_indices, bbox, grid_shape)
    if interpolation in ("li", "li_2"):
        t = project_voxels_to_rays(centers, ray_start, ray_end)
        return depth_planes_to_voxels(S_planes, t, counts, depth_planes)
    if interpolation == "quadratic":
        t = project_voxels_to_rays(centers, ray_start, ray_end, clip=True)
        return depth_planes_to_voxels_quadratic(S_planes, t, counts,
                                                depth_planes)
    t = project_voxels_to_rays(centers, ray_start, ray_end, clip=False)
    ray = ray_end - ray_start
    ray_norm_sq = (ray * ray).sum(-1)
    return depth_planes_to_voxels_kde(S_planes, t, ray_norm_sq, counts,
                                      depth_planes, gamma)


def get_planes_voxels_mapping(name):
    """Factory with the reference's names; returns a partial of
    ``planes_to_voxels_mapping_by_name``."""
    if name not in MAPPINGS:
        raise KeyError("unknown planes->voxels mapping %r" % (name,))
    return partial(planes_to_voxels_mapping_by_name, interpolation=name)

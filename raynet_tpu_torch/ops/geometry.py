"""Projection, ray construction and the bbox slab test on torch tensors.

Port of ``raynet_tpu/ops/geometry.py`` with the same conventions:

- Ray indices are COLUMN-MAJOR over the image: ``x = r // H``, ``y = r % H``.
- Every projection is a left-to-right f32 multiply-add chain, never a
  matmul. A float32 matmul may run in TF32 on the card (10-bit mantissa),
  the same kind of operand truncation that put the TPU's bf16 matmul
  projections thousands of pixels off near the epipole. Evaluated as
  separate elementwise ops, the chain rounds identically on the CPU, in
  PyTorch's CUDA ops and in the CUDA kernels (built with ``-fmad=false``).
- Near/far of the slab test are swapped by |t| so the segment runs away
  from the camera; rays whose line misses the box collapse to a
  zero-length segment outside it.
"""
import torch


def project_points(P, points):
    """Project points with 3x4 camera matrices.

    Arguments
    ---------
        P: (..., 3, 4) projection matrix(es)
        points: (..., N, 3) 3D points (the homogeneous 1 is implicit)

    Returns
    -------
        (..., N, 2) dehomogenized pixel coordinates (x, y).
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def row(i):
        Pi = P[..., i, :]
        return (
            Pi[..., 0, None] * x + Pi[..., 1, None] * y
            + Pi[..., 2, None] * z + Pi[..., 3, None]
        )

    u, v, w = row(0), row(1), row(2)
    return torch.stack([u / w, v / w], dim=-1)


def rays_from_pixel_idxs(ray_idxs, P_pinv, camera_center, height):
    """Back-project column-major ray indices into world-space directions.

    Arguments
    ---------
        ray_idxs: (N,) integer ray indices
        P_pinv: (4, 3) pseudo-inverse projection matrix
        camera_center: (3,) camera center (world)
        height: int, image height

    Returns
    -------
        directions: (N, 3) float32, ``destination - camera_center``.
    """
    x = torch.div(ray_idxs, height, rounding_mode="floor").to(torch.float32)
    y = torch.remainder(ray_idxs, height).to(torch.float32)
    Pp = P_pinv.to(torch.float32)
    hom = [Pp[i, 0] * x + Pp[i, 1] * y + Pp[i, 2] for i in range(4)]
    dest = torch.stack(
        [hom[0] / hom[3], hom[1] / hom[3], hom[2] / hom[3]], dim=-1
    )
    return dest - camera_center[None, :]


def rays_entry_exit_bbox(directions, camera_center, bbox_min, bbox_max):
    """Slab test + |t| near/far swap; returns per-ray segment endpoints.

    Returns (ray_start, ray_end), each (N, 3) float32. A ray whose LINE
    misses the box collapses to a zero-length segment at the line's
    mid-slab point (outside the box), so traversal emits nothing for it;
    zero direction components fall back to t = 0, the camera center.
    """
    t1 = (bbox_min[None] - camera_center[None]) / directions
    t2 = (bbox_max[None] - camera_center[None]) / directions
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)

    near_mask = t_near.abs() < t_far.abs()
    t_near_actual = torch.where(near_mask, t_near, t_far)
    t_far_actual = torch.where(near_mask, t_far, t_near)
    miss = t_near > t_far
    t_mid = 0.5 * (t_near + t_far)
    t_mid = torch.where(torch.isfinite(t_mid), t_mid, torch.zeros_like(t_mid))
    t_near_actual = torch.where(miss, t_mid, t_near_actual)
    t_far_actual = torch.where(miss, t_mid, t_far_actual)

    ray_start = camera_center[None] + t_near_actual[:, None] * directions
    ray_end = camera_center[None] + t_far_actual[:, None] * directions
    return ray_start, ray_end

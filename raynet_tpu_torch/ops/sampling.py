"""Ray segments through the bbox and depth hypotheses along them.

Port of ``raynet_tpu/ops/sampling.py:16-35`` and ``:81-84``.
"""
import torch

from .geometry import rays_from_pixel_idxs, rays_entry_exit_bbox


def true_divisor(value, device):
    """``value`` as a 0-dim float32 tensor on ``device``, for use as a
    divisor. PyTorch's CUDA ops divide by a Python scalar by multiplying
    with its reciprocal, which can differ from the division by one ulp;
    a device tensor divisor gets the IEEE division that the CPU path and
    the CUDA kernels compute."""
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def sample_points_along_segments(ray_start, ray_end, depth_planes):
    """D points uniformly spaced on each [start, end] segment.

    Evaluated as ``start + (k / (D-1)) * (end - start)`` in f32, the order
    the plane-sweep kernel uses too.

    Returns (N, D, 3) float32.
    """
    k = torch.arange(depth_planes, dtype=torch.float32, device=ray_start.device)
    frac = k / true_divisor(depth_planes - 1, ray_start.device)
    delta = (ray_end - ray_start)[:, None, :]
    return ray_start[:, None, :] + frac[None, :, None] * delta


def segments_in_bbox(ray_idxs, P_pinv, camera_center, bbox, height):
    """(ray_start, ray_end) segments for each ray through the bbox."""
    directions = rays_from_pixel_idxs(ray_idxs, P_pinv, camera_center, height)
    return rays_entry_exit_bbox(directions, camera_center, bbox[:3], bbox[3:])

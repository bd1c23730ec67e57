"""Ray segments through the bbox and depth hypotheses along them.

Port of ``raynet_tpu/ops/sampling.py``: depth hypotheses between each ray's
bbox entry and exit, or at metric depths on its unit direction, for
column-major ray indices, on the device of the inputs.
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


def sample_points_in_bbox(ray_idxs, P_pinv, camera_center, bbox, height,
                          depth_planes):
    """Uniform depth hypotheses between each ray's bbox entry and exit.

    ``ray_idxs`` (N,) integer column-major ray indices; ``P_pinv`` (4, 3);
    ``camera_center`` (3,); ``bbox`` (6,) [min_xyz, max_xyz]. Returns
    (N, D, 3) float32 points.
    """
    ray_start, ray_end = segments_in_bbox(ray_idxs, P_pinv, camera_center,
                                          bbox, height)
    return sample_points_along_segments(ray_start, ray_end, depth_planes)


def sample_points_in_range(ray_idxs, P_pinv, camera_center, depth_range,
                           height, depth_planes):
    """Uniform metric-depth hypotheses on each ray's unit direction;
    ``depth_range`` (2,) is [near, far] in world units. Returns (N, D, 3)
    float32 points."""
    directions = rays_from_pixel_idxs(ray_idxs, P_pinv, camera_center, height)
    directions = directions / torch.linalg.norm(directions, dim=-1,
                                                keepdim=True)
    t = torch.linspace(float(depth_range[0]), float(depth_range[1]),
                       depth_planes, device=directions.device)
    return camera_center[None, None, :] + (
        directions[:, None, :] * t[None, :, None]
    )


SAMPLING_SCHEMES = ("sample_in_bbox", "sample_in_range")


def get_sampling_scheme_op(name):
    """The batched op of a sampling scheme name."""
    if "bbox" in name:
        return sample_points_in_bbox
    if "range" in name:
        return sample_points_in_range
    raise KeyError("unknown sampling scheme %r" % (name,))

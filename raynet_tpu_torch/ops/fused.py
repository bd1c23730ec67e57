"""The mvcnn passes' per-ray-batch steps and the raynet pass's per-image
sweeps.

Port of ``raynet_tpu/ops/fused.py``: ``mvcnn_depth_step`` (:93-138) and
``mvcnn_voxel_depth_step`` (:155-209) per batch; ``raynet_image_scores``,
``raynet_image_update`` and ``raynet_image_depth`` do over all rays of one
image what the JAX package's ``raynet_message_step`` (:228-329) and
``raynet_depth_step`` (:713-791) do per batch, and its per-image loops
(:491, :626) around them. They hand the heavy work to the kernels' wrappers
(``plane_sweep_scores``, ``voxel_traversal_flat``, ``bp_sweep``), which run
the CUDA kernels for CUDA tensors and the plain versions for CPU tensors.
The per-image sweeps take an image's segments, computed once, and launch
each kernel once per image on the card; on the CPU they run the plain
versions ``rays_batch`` rays at a time (``image_spans``). The JAX steps'
batch padding (``n_valid``), band, tile-order and ``use_pallas`` arguments
exist for Mosaic and have no counterpart: the kernels gather directly.
"""
import torch

from .bp_sweep import bp_sweep
from .planes_voxels import planes_to_voxels_mapping
from .planesweep import plane_sweep_scores
from .ray_marching import (
    unflatten_voxel_indices,
    voxel_centers,
    voxel_traversal_flat,
)
from .sampling import sample_points_along_segments, segments_in_bbox


def _grid_size(grid_shape):
    g = [int(x) for x in grid_shape]
    return g[0] * g[1] * g[2]


def _distance_to(points, camera_center):
    """(N,) Euclidean distance of (N, 3) points from the camera centre."""
    d = points - camera_center[None]
    return torch.sqrt(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    )


def mvcnn_depth_step(
    ray_idxs, features, P, P_pinv, camera_center, bbox, height, width,
    padding, depth_planes,
):
    """Plane-sweep scoring + per-ray argmax depth.

    Returns (S (N, D) softmax scores, depth (N,) = ||argmax point - C||);
    ties break to the first maximum.
    """
    ray_start, ray_end = segments_in_bbox(
        ray_idxs, P_pinv, camera_center, bbox, height
    )
    S = plane_sweep_scores(
        features, P, ray_start, ray_end, padding, height, width, depth_planes,
    )
    best = torch.argmax(S, dim=-1)  # first maximum
    points = sample_points_along_segments(ray_start, ray_end, depth_planes)
    rows = torch.arange(best.shape[0], device=best.device)
    return S, _distance_to(points[rows, best], camera_center)


def mvcnn_voxel_depth_step(
    ray_idxs, features, P, P_pinv, camera_center, bbox, height, width,
    padding, depth_planes, grid_shape, max_voxels,
):
    """Plane sweep -> voxel traversal -> depth->voxel mapping -> argmax.

    Returns (S_vox (N, M), voxel_indices (N, M, 3) int32, counts (N,) int32,
    depth (N,)): the distance from the camera centre to the centre of each
    ray's arg-max voxel (first maximum), 0 for rays that visit no voxel.
    """
    ray_start, ray_end = segments_in_bbox(
        ray_idxs, P_pinv, camera_center, bbox, height
    )
    S_planes = plane_sweep_scores(
        features, P, ray_start, ray_end, padding, height, width, depth_planes,
    )
    flat_idx, counts = voxel_traversal_flat(
        bbox, ray_start, ray_end, grid_shape, max_voxels
    )
    vox = unflatten_voxel_indices(flat_idx, grid_shape)
    S_vox = planes_to_voxels_mapping(
        S_planes, vox, counts, ray_start, ray_end, bbox, grid_shape,
        depth_planes,
    )
    best = torch.argmax(S_vox, dim=-1)  # first maximum
    rows = torch.arange(best.shape[0], device=best.device)
    # only the arg-max voxels' centres: the (N, M, 3) centres of the JAX
    # step hold the same values
    depth = _distance_to(
        voxel_centers(vox[rows, best], bbox, grid_shape), camera_center
    )
    depth = torch.where(counts > 0, depth, torch.zeros_like(depth))
    return S_vox, vox, counts, depth


def image_spans(n_rays, rays_batch, device):
    """Row ranges [lo, hi) an image's rays are swept in: all at once on a
    CUDA device (one kernel launch per image and sweep), ``rays_batch`` at
    a time on the CPU, where the plain versions hold (rows, M) and
    (rows, D, V, F) temporaries."""
    step = n_rays if device.type == "cuda" else int(rays_batch)
    return [(lo, min(lo + step, n_rays))
            for lo in range(0, max(n_rays, 1), max(step, 1))]


def _by_span(fn, n_rays, rays_batch, device):
    """``fn(lo, hi)`` over ``image_spans``, concatenated along rows."""
    parts = [fn(lo, hi) for lo, hi in image_spans(n_rays, rays_batch, device)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def raynet_image_scores(
    ray_start, ray_end, features, P, *, height, width, padding,
    depth_planes, rays_batch,
):
    """Plane-sweep scores (rows, D) of every ray of one image, from its
    (rows, 3) segments. The scores do not depend on the BP messages, so
    every sweep reuses them."""
    return _by_span(
        lambda lo, hi: plane_sweep_scores(
            features, P, ray_start[lo:hi], ray_end[lo:hi], padding, height,
            width, depth_planes,
        ),
        ray_start.shape[0], rays_batch, ray_start.device,
    )


def raynet_image_update(
    messages, scores, scatter_total, grid_acc, ray_start, ray_end,
    camera_center, bbox, *, grid_shape, max_voxels, first_iteration, prior,
    rays_batch,
):
    """One BP sweep over all rays of one image.

    Updates the image's message store ``messages`` (rows, M) in place and
    ADDS the image's messages into ``scatter_total``; ``grid_acc`` is the
    previous iteration's grid.
    """
    # the image's sum starts from zero, as the JAX package's batches do:
    # added onto the prior-filled grid directly, small messages would round
    # at the grid's magnitude
    scatter = torch.zeros(_grid_size(grid_shape), dtype=scores.dtype,
                          device=messages.device)
    for lo, hi in image_spans(messages.shape[0], rays_batch, messages.device):
        rows = messages[lo:hi]
        bp_sweep(
            ray_start[lo:hi], ray_end[lo:hi], scores[lo:hi],
            None if first_iteration else rows,
            None if first_iteration else grid_acc, scatter, camera_center,
            bbox, grid_shape, max_voxels,
            prior if first_iteration else 0.0,
            "first" if first_iteration else "message", messages_out=rows,
        )
    scatter_total += scatter
    return messages, scatter_total


def raynet_image_depth(
    messages, scores, grid_acc, ray_start, ray_end, camera_center, bbox, *,
    grid_shape, max_voxels, rays_batch,
):
    """Posterior depth of every ray of one image, (rows,) float32."""
    return _by_span(
        lambda lo, hi: bp_sweep(
            ray_start[lo:hi], ray_end[lo:hi], scores[lo:hi],
            messages[lo:hi], grid_acc, None, camera_center, bbox, grid_shape,
            max_voxels, 0.0, "depth",
        )[2],
        messages.shape[0], rays_batch, messages.device,
    )

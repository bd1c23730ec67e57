"""The forward passes' per-ray-batch steps and their per-image loops.

Port of ``raynet_tpu/ops/fused.py``: ``mvcnn_depth_step`` (:93-138),
``mvcnn_voxel_depth_step`` (:155-209), ``raynet_message_step``
(:228-329), ``raynet_depth_step`` (:713-791) and, as plain Python loops
over ray batches, ``raynet_image_update`` / ``raynet_image_depth`` (:491,
:626). The steps compute segments in torch and hand the heavy work to the
kernels' wrappers (``plane_sweep_scores``, ``voxel_traversal_flat``,
``bp_sweep``), which run the CUDA kernels for CUDA tensors and the plain
versions for CPU tensors. The JAX steps' band, tile-order and
``use_pallas`` arguments exist for Mosaic and have no counterpart: the
kernels gather directly.
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


def raynet_message_step(
    ray_idxs, features, P, P_pinv, camera_center, bbox, messages_pon,
    grid_acc_flat, n_valid, height, width, padding, depth_planes,
    grid_shape, max_voxels, first_iteration=False, S_planes=None,
    prior=None,
):
    """Plane sweep (unless ``S_planes`` is given) + one BP message update.

    Rows >= ``n_valid`` are padding: they visit no voxel and scatter
    nothing. ``first_iteration``: the grid still holds the prior
    (``prior``, default ``grid_acc_flat[0]``) and the incoming messages are
    zero.

    Returns (new_messages (N, M), scatter (G,), S_planes (N, D)); scatter
    is this batch's contribution to ADD into the next iteration's grid.
    """
    ray_start, ray_end = segments_in_bbox(
        ray_idxs, P_pinv, camera_center, bbox, height
    )
    if S_planes is None:
        S_planes = plane_sweep_scores(
            features, P, ray_start, ray_end, padding, height, width,
            depth_planes,
        )
    n = ray_idxs.shape[0]
    valid = (
        torch.arange(n, device=ray_idxs.device) < n_valid
    ).to(torch.int32)
    # the batch's sum starts from zero, as in the JAX package: added onto
    # the prior-filled grid directly, small messages would round at the
    # grid's magnitude
    scatter = torch.zeros(
        _grid_size(grid_shape), dtype=S_planes.dtype, device=ray_start.device
    )
    if first_iteration:
        if prior is None:
            prior = float(grid_acc_flat[0])
        msgs, _, _ = bp_sweep(
            ray_start, ray_end, valid, S_planes, None, None, scatter,
            camera_center, bbox, grid_shape, max_voxels, prior, "first",
        )
    else:
        msgs, _, _ = bp_sweep(
            ray_start, ray_end, valid, S_planes, messages_pon, grid_acc_flat,
            scatter, camera_center, bbox, grid_shape, max_voxels, 0.0,
            "message",
        )
    return msgs, scatter, S_planes


def raynet_depth_step(
    ray_idxs, features, P, P_pinv, camera_center, bbox, messages_pon,
    grid_acc_flat, height, width, padding, depth_planes, grid_shape,
    max_voxels, S_planes=None,
):
    """Final sweep: occlusion-aware posterior depth per ray, (N,) float32
    (0 for rays that visit no voxel)."""
    ray_start, ray_end = segments_in_bbox(
        ray_idxs, P_pinv, camera_center, bbox, height
    )
    if S_planes is None:
        S_planes = plane_sweep_scores(
            features, P, ray_start, ray_end, padding, height, width,
            depth_planes,
        )
    valid = torch.ones(
        ray_idxs.shape[0], dtype=torch.int32, device=ray_idxs.device
    )
    _, _, depth = bp_sweep(
        ray_start, ray_end, valid, S_planes, messages_pon, grid_acc_flat,
        None, camera_center, bbox, grid_shape, max_voxels, 0.0, "depth",
    )
    return depth


def _rows(store, off, n_valid, batch):
    """``store[off:off+batch]``, zero-padded past ``n_valid`` rows."""
    if n_valid == batch:
        return store[off:off + batch]
    out = torch.zeros((batch,) + tuple(store.shape[1:]), dtype=store.dtype,
                      device=store.device)
    out[:n_valid] = store[off:off + n_valid]
    return out


def raynet_image_scores(
    scores_full, batches, features, P, P_pinv, camera_center, bbox, *,
    height, width, padding, depth_planes,
):
    """Plane-sweep scores of every ray of one image into ``scores_full``
    (rows, D). ``batches``: (offset, n_valid, chunk) from the forward pass.
    The scores do not depend on the BP messages, so every sweep reuses them.
    """
    for off, n_valid, chunk in batches:
        ray_start, ray_end = segments_in_bbox(
            chunk, P_pinv, camera_center, bbox, height
        )
        S = plane_sweep_scores(
            features, P, ray_start, ray_end, padding, height, width,
            depth_planes,
        )
        scores_full[off:off + n_valid] = S[:n_valid]
    return scores_full


def raynet_image_update(
    msgs_full, scores_full, scatter_total, grid_acc, batches, P_pinv,
    camera_center, bbox, *, height, width, padding, depth_planes,
    grid_shape, max_voxels, first_iteration, prior,
):
    """One BP sweep over all ray batches of one image.

    Updates ``msgs_full`` (rows, M) in place and ADDS the image's messages
    into ``scatter_total``; ``grid_acc`` is the previous iteration's grid.
    """
    for off, n_valid, chunk in batches:
        batch = chunk.shape[0]
        msg_in = (
            None if first_iteration
            else _rows(msgs_full, off, n_valid, batch)
        )
        new_msgs, scatter, _ = raynet_message_step(
            chunk, None, None, P_pinv, camera_center, bbox, msg_in, grid_acc,
            n_valid, height, width, padding, depth_planes, grid_shape,
            max_voxels, first_iteration=first_iteration,
            S_planes=_rows(scores_full, off, n_valid, batch), prior=prior,
        )
        msgs_full[off:off + n_valid] = new_msgs[:n_valid]
        scatter_total += scatter
    return msgs_full, scatter_total


def raynet_image_depth(
    msgs_full, scores_full, grid_acc, batches, P_pinv, camera_center, bbox,
    *, height, width, padding, depth_planes, grid_shape, max_voxels,
):
    """Posterior depth of every ray of one image, (rows,) float32."""
    depth = torch.zeros(msgs_full.shape[0], dtype=torch.float32,
                        device=msgs_full.device)
    for off, n_valid, chunk in batches:
        batch = chunk.shape[0]
        d = raynet_depth_step(
            chunk, None, None, P_pinv, camera_center, bbox,
            _rows(msgs_full, off, n_valid, batch), grid_acc, height, width,
            padding, depth_planes, grid_shape, max_voxels,
            S_planes=_rows(scores_full, off, n_valid, batch),
        )
        depth[off:off + n_valid] = d[:n_valid]
    return depth

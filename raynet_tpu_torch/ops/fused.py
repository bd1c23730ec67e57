"""RayNet's per-ray-batch steps and their per-image loops.

Port of ``raynet_tpu/ops/fused.py``: ``raynet_message_step`` (:228-329),
``raynet_depth_step`` (:713-791) and, as plain Python loops over ray
batches, ``raynet_image_update`` / ``raynet_image_depth`` (:491, :626).
The steps compute segments in torch and hand the heavy work to the two
kernels' wrappers (``plane_sweep_scores``, ``bp_sweep``), which run the
CUDA kernels for CUDA tensors and the plain versions for CPU tensors.
"""
import torch

from .bp_sweep import bp_sweep
from .planesweep import plane_sweep_scores
from .sampling import segments_in_bbox


def _grid_size(grid_shape):
    g = [int(x) for x in grid_shape]
    return g[0] * g[1] * g[2]


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

"""K2: one fused BP sweep over a batch of rays, and its plain version.

``bp_sweep`` runs the CUDA kernel ``csrc/bp_sweep.cu`` for CUDA tensors and
``bp_sweep_reference`` (plain PyTorch: traversal, hat mapping and the mrf
ops) for CPU tensors. Modes:

- ``"first"``: first BP iteration; the grid is uniformly the prior and the
  incoming messages are zero, so mu is the constant sigmoid(prior);
- ``"message"``: later iterations; mu from ``grid_acc`` and the ray's own
  previous messages;
- ``"depth"``: the posterior depth of each ray; nothing is scattered.

Message modes ADD the batch's new messages into ``grid_out`` in place (the
next iteration's accumulator) and return the (N, M) messages in DDA order.
Rows with ``valid == 0`` visit no voxel: zero messages, no scatter, depth 0.
"""
import torch

from . import cuda_build
from .mrf import bp_update, bp_update_first, depth_estimate
from .planes_voxels import planes_to_voxels_mapping
from .ray_marching import (
    unflatten_voxel_indices,
    voxel_centers,
    voxel_traversal_flat,
)

MODES = {"first": 0, "message": 1, "depth": 2}


def bp_sweep_reference(
    ray_start, ray_end, valid, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
):
    """Plain PyTorch BP sweep (the XLA path of raynet_tpu/ops/fused.py).

    Returns (messages_out (N, M) or None, counts (N,) int32,
    depth (N,) or None).
    """
    if mode not in MODES:
        raise ValueError("unknown bp_sweep mode %r" % (mode,))
    grid_shape = tuple(int(g) for g in grid_shape)
    grid_size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    depth_planes = S_planes.shape[1]
    flat_idx, counts = voxel_traversal_flat(
        bbox, ray_start, ray_end, grid_shape, max_voxels
    )
    counts = torch.where(valid != 0, counts, torch.zeros_like(counts))
    vox = unflatten_voxel_indices(flat_idx, grid_shape)
    S_vox = planes_to_voxels_mapping(
        S_planes, vox, counts, ray_start, ray_end, bbox, grid_shape,
        depth_planes,
    )
    if mode == "first":
        pon = torch.tensor(prior, dtype=torch.float32, device=S_vox.device)
        msgs, scatter = bp_update_first(
            S_vox, flat_idx, counts, pon, grid_size
        )
    elif mode == "message":
        msgs, scatter = bp_update(
            S_vox, flat_idx, counts, messages_in, grid_acc, grid_size
        )
    else:
        S_new = depth_estimate(S_vox, flat_idx, counts, messages_in, grid_acc)
        centers = voxel_centers(vox, bbox, grid_shape)
        best = torch.argmax(S_new, dim=-1)  # first maximum
        rows = torch.arange(best.shape[0], device=best.device)
        d = centers[rows, best] - camera_center[None]
        depth = torch.sqrt(
            d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        )
        depth = torch.where(counts > 0, depth, torch.zeros_like(depth))
        return None, counts, depth
    grid_out.add_(scatter)
    return msgs, counts, None


def _check_cuda(name, t, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError("bp_sweep: %s must be a CUDA tensor" % name)
    if t.dtype != dtype:
        raise ValueError("bp_sweep: %s must be %s, got %s" % (name, dtype, t.dtype))
    if not t.is_contiguous():
        raise ValueError("bp_sweep: %s must be contiguous" % name)
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            "bp_sweep: %s must have shape %s, got %s"
            % (name, tuple(shape), tuple(t.shape))
        )


def _bp_sweep_cuda(
    ray_start, ray_end, valid, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
):
    n, depth_planes = S_planes.shape
    gx, gy, gz = (int(g) for g in grid_shape)
    grid_size = gx * gy * gz
    M = int(max_voxels)
    f32 = torch.float32
    _check_cuda("ray_start", ray_start, f32, (n, 3))
    _check_cuda("ray_end", ray_end, f32, (n, 3))
    _check_cuda("valid", valid, torch.int32, (n,))
    _check_cuda("S_planes", S_planes, f32)
    _check_cuda("camera_center", camera_center, f32, (3,))
    _check_cuda("bbox", bbox, f32, (6,))
    if mode != "first":
        _check_cuda("messages_in", messages_in, f32, (n, M))
        _check_cuda("grid_acc", grid_acc, f32, (grid_size,))
    if mode != "depth":
        _check_cuda("grid_out", grid_out, f32, (grid_size,))
    devices = {t.device for t in (ray_start, ray_end, valid, S_planes,
                                  camera_center, bbox)}
    if len(devices) != 1:
        raise ValueError("bp_sweep: all tensors must be on one device")
    device = ray_start.device

    counts = torch.empty(n, dtype=torch.int32, device=device)
    idx_scratch = torch.empty((M, n), dtype=torch.int32, device=device)
    s_scratch = torch.empty((M, n), dtype=f32, device=device)
    msgs = depth = None
    if mode == "depth":
        depth = torch.empty(n, dtype=f32, device=device)
    else:
        msgs = torch.empty((n, M), dtype=f32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = cuda_build.library()
    with torch.cuda.device(device):
        err = lib.raynet_bp_sweep(
            ray_start.data_ptr(), ray_end.data_ptr(), valid.data_ptr(),
            S_planes.data_ptr(),
            ptr(messages_in) if mode != "first" else None,
            ptr(grid_acc) if mode != "first" else None,
            ptr(grid_out) if mode != "depth" else None,
            camera_center.data_ptr(), bbox.data_ptr(),
            ptr(msgs), counts.data_ptr(), ptr(depth),
            idx_scratch.data_ptr(), s_scratch.data_ptr(),
            n, M, depth_planes, gx, gy, gz, float(prior), MODES[mode],
            cuda_build.stream_ptr(device),
        )
    cuda_build.check(err, "raynet_bp_sweep")
    bp_sweep.launches += 1
    return msgs, counts, depth


def bp_sweep(
    ray_start, ray_end, valid, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
):
    """One BP sweep over N rays: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    Arguments
    ---------
        ray_start, ray_end: (N, 3) float32 segments through the bbox
        valid: (N,) int32, 0 for padding rows
        S_planes: (N, D) float32 plane-sweep scores
        messages_in: (N, M) float32 previous messages (unused in "first")
        grid_acc: (G,) float32 accumulator of the previous iteration
            (unused in "first")
        grid_out: (G,) float32, the batch's messages are ADDED into it
            (message modes; unused in "depth")
        camera_center: (3,), bbox: (6,) float32
        grid_shape: (3,) ints; max_voxels: M; prior: float log(g/(1-g))
        mode: "first" | "message" | "depth"

    Returns (messages_out (N, M) or None, counts (N,) int32,
    depth (N,) or None).
    """
    if mode not in MODES:
        raise ValueError("unknown bp_sweep mode %r" % (mode,))
    args = (ray_start, ray_end, valid, S_planes, messages_in, grid_acc,
            grid_out, camera_center, bbox, grid_shape, max_voxels, prior,
            mode)
    if ray_start.device.type == "cuda":
        return _bp_sweep_cuda(*args)
    if ray_start.device.type == "cpu":
        return bp_sweep_reference(*args)
    raise ValueError("bp_sweep: unsupported device %s" % ray_start.device)


# Kernel launches since the last reset (the plain path never counts).
bp_sweep.launches = 0

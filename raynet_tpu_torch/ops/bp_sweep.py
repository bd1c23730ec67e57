"""K2: one fused BP sweep over the rays of an image, and its plain version.

``bp_sweep`` runs the CUDA kernel ``csrc/bp_sweep.cu`` for CUDA tensors and
``bp_sweep_reference`` (plain PyTorch: traversal, hat mapping and the mrf
ops) for CPU tensors. Modes:

- ``"first"``: first BP iteration; the grid is uniformly the prior and the
  incoming messages are zero, so mu is the constant sigmoid(prior);
- ``"message"``: later iterations; mu from ``grid_acc`` and the ray's own
  previous messages;
- ``"depth"``: the posterior depth of each ray; nothing is scattered.

Message modes ADD the rays' new messages into ``grid_out`` in place (the
next iteration's accumulator) and return the (N, M) messages in DDA order.
Given ``messages_out``, they write each ray's messages into its row there,
for k < count only, and leave the rest of the row as it is;
``messages_out`` may be ``messages_in`` itself (the forward pass's store,
updated in place). Without it they return a new zero-filled (N, M) tensor.
"""
import torch

from . import cuda_build
from .mrf import bp_update, bp_update_first, depth_estimate
from .planes_voxels import planes_to_voxels_mapping
from .ray_marching import (
    unflatten_voxel_indices,
    voxel_centers,
    voxel_traversal_flat_reference,
)

MODES = {"first": 0, "message": 1, "depth": 2}
MAX_PLANES = 128


def bp_sweep_reference(
    ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
    messages_out=None,
):
    """Plain PyTorch BP sweep (the XLA path of raynet_tpu/ops/fused.py).

    Returns (messages (N, M) or None, counts (N,) int32, depth (N,) or
    None); the messages are ``messages_out`` where given.
    """
    if mode not in MODES:
        raise ValueError("unknown bp_sweep mode %r" % (mode,))
    grid_shape = tuple(int(g) for g in grid_shape)
    grid_size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    depth_planes = S_planes.shape[1]
    flat_idx, counts = voxel_traversal_flat_reference(
        bbox, ray_start, ray_end, grid_shape, max_voxels
    )
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
    if messages_out is None:
        return msgs, counts, None
    visited = (torch.arange(msgs.shape[1], device=msgs.device)[None, :]
               < counts[:, None])
    messages_out.copy_(torch.where(visited, msgs, messages_out))
    return messages_out, counts, None


def _check_cuda(name, t, dtype, shape=None):
    cuda_build.check_tensor("bp_sweep", name, t, dtype, shape)


def _overlap(a, b):
    """Whether the memory of tensors ``a`` and ``b`` overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _bp_sweep_cuda(
    ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode, messages_out,
):
    n, depth_planes = S_planes.shape
    gx, gy, gz = (int(g) for g in grid_shape)
    grid_size = gx * gy * gz
    M = int(max_voxels)
    f32 = torch.float32
    if not 2 <= depth_planes <= MAX_PLANES:
        raise ValueError("bp_sweep: 2 <= D <= %d, got %d"
                         % (MAX_PLANES, depth_planes))
    _check_cuda("ray_start", ray_start, f32, (n, 3))
    _check_cuda("ray_end", ray_end, f32, (n, 3))
    _check_cuda("S_planes", S_planes, f32)
    _check_cuda("camera_center", camera_center, f32, (3,))
    _check_cuda("bbox", bbox, f32, (6,))
    if mode != "first":
        _check_cuda("messages_in", messages_in, f32, (n, M))
        _check_cuda("grid_acc", grid_acc, f32, (grid_size,))
    if mode != "depth":
        _check_cuda("grid_out", grid_out, f32, (grid_size,))
        if mode == "message" and _overlap(grid_out, grid_acc):
            raise ValueError("bp_sweep: grid_out must not overlap grid_acc")
        if messages_out is not None:
            _check_cuda("messages_out", messages_out, f32, (n, M))
            if (mode == "message"
                    and messages_out.data_ptr() != messages_in.data_ptr()
                    and _overlap(messages_out, messages_in)):
                raise ValueError("bp_sweep: messages_out must be messages_in "
                                 "itself or not overlap it")
    devices = {t.device for t in (ray_start, ray_end, S_planes,
                                  camera_center, bbox)}
    if len(devices) != 1:
        raise ValueError("bp_sweep: all tensors must be on one device")
    device = ray_start.device

    counts = torch.empty(n, dtype=torch.int32, device=device)
    msgs = depth = None
    if mode == "depth":
        depth = torch.empty(n, dtype=f32, device=device)
    elif messages_out is not None:
        msgs = messages_out
    else:
        msgs = torch.zeros((n, M), dtype=f32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = cuda_build.library()
    with torch.cuda.device(device):
        err = lib.raynet_bp_sweep(
            ray_start.data_ptr(), ray_end.data_ptr(), S_planes.data_ptr(),
            ptr(messages_in) if mode != "first" else None,
            ptr(grid_acc) if mode != "first" else None,
            ptr(grid_out) if mode != "depth" else None,
            camera_center.data_ptr(), bbox.data_ptr(),
            ptr(msgs), counts.data_ptr(), ptr(depth),
            n, M, depth_planes, gx, gy, gz, float(prior), MODES[mode],
            cuda_build.stream_ptr(device),
        )
    cuda_build.check(err, "raynet_bp_sweep")
    bp_sweep.launches += 1
    return msgs, counts, depth


def bp_sweep(
    ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
    messages_out=None,
):
    """One BP sweep over N rays: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    Arguments
    ---------
        ray_start, ray_end: (N, 3) float32 segments through the bbox
        S_planes: (N, D) float32 plane-sweep scores
        messages_in: (N, M) float32 previous messages (unused in "first")
        grid_acc: (G,) float32 accumulator of the previous iteration
            (unused in "first")
        grid_out: (G,) float32, the rays' messages are ADDED into it
            (message modes; unused in "depth")
        camera_center: (3,), bbox: (6,) float32
        grid_shape: (3,) ints; max_voxels: M; prior: float log(g/(1-g))
        mode: "first" | "message" | "depth"
        messages_out: (N, M) float32 or None (message modes): written for
            k < count, the rest of each row left as it is; may be
            ``messages_in``. None: a new zero-filled (N, M) tensor.

    Returns (messages (N, M) or None, counts (N,) int32, depth (N,) or
    None).
    """
    if mode not in MODES:
        raise ValueError("unknown bp_sweep mode %r" % (mode,))
    args = (ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
            camera_center, bbox, grid_shape, max_voxels, prior, mode,
            messages_out)
    if ray_start.device.type == "cuda":
        return _bp_sweep_cuda(*args)
    if ray_start.device.type == "cpu":
        return bp_sweep_reference(*args)
    raise ValueError("bp_sweep: unsupported device %s" % ray_start.device)


# Kernel launches since the last reset (the plain path never counts).
bp_sweep.launches = 0

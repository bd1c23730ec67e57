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

``ray_sums``, a pair (counts (N,) int32, totals (N,) float32) on the rays'
device, holds what a sweep's first pass over each ray computes and no
sweep changes: the ray's march count and the total T1 of its hat-mapped
scores (``ray_totals``). The first-iteration sweep writes them; a message
or depth sweep given them reads them instead of marching that pass again.
Without them every sweep counts.
"""
import torch

from . import cuda_build
from .mrf import bp_update, bp_update_first, depth_estimate
from .planes_voxels import hat_scores, project_voxels_to_rays
from .ray_marching import voxel_centers
from .voxel_depth import argmax_voxel_depth, plain_voxel_scores

MODES = {"first": 0, "message": 1, "depth": 2}
MAX_PLANES = 128


def ray_totals(S_planes, voxel_indices, counts, ray_start, ray_end, bbox,
               grid_shape):
    """Each ray's total T1 (N,) float32 as K2 carries it: its hat-mapped
    scores summed in float64 over its ``counts`` visited voxels, then
    rounded to float32 and floored at 1e-30 (a NaN stays NaN)."""
    t = project_voxels_to_rays(voxel_centers(voxel_indices, bbox, grid_shape),
                               ray_start, ray_end)
    s = hat_scores(S_planes, t, S_planes.shape[1]).double()
    visited = torch.arange(s.shape[1], device=s.device)[None, :] \
        < counts[:, None]
    total = torch.where(visited, s, torch.zeros_like(s)).sum(dim=1)
    return total.float().clamp_min(1e-30)


def bp_sweep_reference(
    ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
    messages_out=None, ray_sums=None,
):
    """Plain PyTorch BP sweep (the XLA path of raynet_tpu/ops/fused.py).

    Returns (messages (N, M) or None, counts (N,) int32, depth (N,) or
    None); the messages are ``messages_out`` where given, the counts
    ``ray_sums[0]`` where given. With ``ray_sums`` the first-iteration
    sweep fills them, and a message or depth sweep takes its counts from
    them (it renormalises by its own total, so it does not read T1).
    """
    if mode not in MODES:
        raise ValueError("unknown bp_sweep mode %r" % (mode,))
    grid_shape = tuple(int(g) for g in grid_shape)
    grid_size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    flat_idx, vox, counts, S_vox = plain_voxel_scores(
        bbox, ray_start, ray_end, S_planes, grid_shape, max_voxels
    )
    if ray_sums is not None:
        if mode == "first":
            ray_sums[0].copy_(counts)
            ray_sums[1].copy_(ray_totals(S_planes, vox, counts, ray_start,
                                         ray_end, bbox, grid_shape))
        counts = ray_sums[0]
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
        depth = argmax_voxel_depth(S_new, vox, counts, camera_center, bbox,
                                   grid_shape)
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


def _check_ray_sums(ray_sums, n, device):
    """Raise ValueError unless ``ray_sums`` is a pair of contiguous (n,)
    tensors on ``device``: int32 counts and float32 totals."""
    if not isinstance(ray_sums, (tuple, list)) or len(ray_sums) != 2:
        raise ValueError("bp_sweep: ray_sums must be a pair (counts, totals)")
    for name, t, dtype in (("counts", ray_sums[0], torch.int32),
                           ("totals", ray_sums[1], torch.float32)):
        if t.device != device:
            raise ValueError("bp_sweep: ray_sums %s must be on %s, got %s"
                             % (name, device, t.device))
        if t.dtype != dtype:
            raise ValueError("bp_sweep: ray_sums %s must be %s, got %s"
                             % (name, dtype, t.dtype))
        if tuple(t.shape) != (n,):
            raise ValueError("bp_sweep: ray_sums %s must have shape (%d,), "
                             "got %s" % (name, n, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("bp_sweep: ray_sums %s must be contiguous"
                             % name)


def _overlap(a, b):
    """Whether the memory of tensors ``a`` and ``b`` overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _bp_sweep_cuda(
    ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode, messages_out,
    ray_sums,
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

    if ray_sums is None:
        counts, totals = torch.empty(n, dtype=torch.int32, device=device), None
    else:
        counts, totals = ray_sums
    msgs = depth = None
    if mode == "depth":
        depth = torch.empty(n, dtype=f32, device=device)
    elif messages_out is not None:
        msgs = messages_out
    else:
        msgs = torch.zeros((n, M), dtype=f32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    cuda_build.launch(
        "raynet_bp_sweep", ray_start,
        ray_start.data_ptr(), ray_end.data_ptr(), S_planes.data_ptr(),
        ptr(messages_in) if mode != "first" else None,
        ptr(grid_acc) if mode != "first" else None,
        ptr(grid_out) if mode != "depth" else None,
        camera_center.data_ptr(), bbox.data_ptr(),
        ptr(msgs), counts.data_ptr(), ptr(totals), ptr(depth),
        n, M, depth_planes, gx, gy, gz, float(prior), MODES[mode],
    )
    bp_sweep.launches += 1
    if totals is not None and mode != "first":
        bp_sweep.sums_read += 1
    return msgs, counts, depth


def bp_sweep(
    ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
    camera_center, bbox, grid_shape, max_voxels, prior, mode,
    messages_out=None, ray_sums=None,
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
        ray_sums: (counts (N,) int32, totals (N,) float32) on the rays'
            device, or None: written in "first", read in "message" and
            "depth" (module docstring).

    Returns (messages (N, M) or None, counts (N,) int32, depth (N,) or
    None); the counts are ``ray_sums[0]`` where given.
    """
    if mode not in MODES:
        raise ValueError("unknown bp_sweep mode %r" % (mode,))
    if ray_sums is not None:
        _check_ray_sums(ray_sums, ray_start.shape[0], ray_start.device)
    args = (ray_start, ray_end, S_planes, messages_in, grid_acc, grid_out,
            camera_center, bbox, grid_shape, max_voxels, prior, mode,
            messages_out, ray_sums)
    if cuda_build.on_cuda("bp_sweep", ray_start):
        return _bp_sweep_cuda(*args)
    return bp_sweep_reference(*args)


# Kernel launches since the last reset (the plain path never counts), and
# those of them that read stored ray_sums instead of counting.
bp_sweep.launches = 0
bp_sweep.sums_read = 0

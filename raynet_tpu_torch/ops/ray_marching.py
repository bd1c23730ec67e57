"""Amanatides-Woo voxel traversal: K3 and its plain version.

Port of ``raynet_tpu/ops/ray_marching.py:29-172``. ``voxel_traversal`` is
the plain march: a loop over the static step budget M whose body is
elementwise over all N rays, with the early exit as an ``alive`` mask. The
same semantics are the ``__device__`` march of the CUDA kernels
(``csrc/march.cuh``), which K3 (``csrc/traversal.cu``: its rows mode behind
``voxel_traversal_flat``, its voxel-depth mode behind
``voxel_depth.voxel_argmax_depth``) and K2 run:

- eps = 1e-2 boundary nudging of both endpoints;
- the first voxel is emitted iff it is inside the grid;
- closed-form crossing times ``t_max + n * t_delta``;
- axis choice ``tx < ty ? (tx < tz ? X : Z) : (ty < tz ? Y : Z)``;
- leaving the grid ends the march WITHOUT emitting; reaching the last voxel
  or filling M entries ends it AFTER emitting.
"""
import torch

from . import cuda_build

_EPS = 1e-2
_FLT_MAX = 3.4028234663852886e38
_INT32_MAX = 2 ** 31 - 1


def voxel_traversal(bbox, ray_start, ray_end, grid_shape, max_voxels):
    """Traverse a regular voxel grid along N ray segments.

    Arguments
    ---------
        bbox: (6,) float32 [min_xyz, max_xyz] of the grid
        ray_start, ray_end: (N, 3) float32 segment endpoints
        grid_shape: (3,) ints, voxels per axis
        max_voxels: int M, per-ray step budget

    Returns
    -------
        voxel_indices: (N, M, 3) int32, zero past each ray's count
        counts: (N,) int32 number of visited voxels per ray
    """
    device = ray_start.device
    grid = torch.tensor([int(g) for g in grid_shape], dtype=torch.int32,
                        device=device)
    gridf = grid.to(torch.float32)
    bbox = bbox.to(device=device, dtype=torch.float32).reshape(6)

    bin_size = (bbox[3:] - bbox[:3]) / gridf
    start = ray_start - bbox[None, :3]
    end = ray_end - bbox[None, :3]
    ray = end - start
    step = torch.where(ray >= 0, 1, -1).to(torch.int32)
    stepf = step.to(torch.float32)

    start = start + stepf * bin_size[None] * _EPS
    end = end - stepf * bin_size[None] * _EPS

    cur = torch.floor(start / bin_size[None]).to(torch.int32)
    last = torch.floor(end / bin_size[None]).to(torch.int32)
    inside0 = ((cur >= 0) & (cur < grid[None])).all(dim=-1)

    cur_coord = cur.to(torch.float32) * bin_size[None]
    boundary = torch.where(
        (step < 0) & (cur_coord < start),
        cur_coord,
        cur_coord + stepf * bin_size[None],
    )
    nonzero = ray != 0
    big = torch.full_like(ray, _FLT_MAX)
    t_max = torch.where(nonzero, (boundary - start) / ray, big)
    t_delta = torch.where(nonzero, stepf * bin_size[None] / ray, big)

    n = ray_start.shape[0]
    rows = torch.arange(n, device=device)
    voxels = [cur]
    emitted = [inside0]
    ncross = torch.zeros_like(cur)
    alive = inside0
    for _ in range(max_voxels - 1):
        t_cur = t_max + ncross.to(torch.float32) * t_delta
        at_last = (cur == last).all(dim=-1)
        advance = alive & ~at_last
        tx, ty, tz = t_cur[:, 0], t_cur[:, 1], t_cur[:, 2]
        axis = torch.where(
            tx < ty,
            torch.where(tx < tz, 0, 2),
            torch.where(ty < tz, 1, 2),
        )
        onehot = torch.nn.functional.one_hot(axis, 3).to(torch.int32)
        new_cur = cur + onehot * step
        moved = new_cur[rows, axis]
        oob = (moved < 0) | (moved >= grid[axis])
        emit = advance & ~oob
        cur = torch.where(emit[:, None], new_cur, cur)
        ncross = ncross + torch.where(emit[:, None], onehot, 0)
        alive = emit
        voxels.append(cur)
        emitted.append(emit)

    voxels = torch.stack(voxels, dim=1)  # (N, M, 3)
    emitted = torch.stack(emitted, dim=1)  # (N, M)
    voxels = torch.where(emitted[..., None], voxels, 0)
    counts = emitted.sum(dim=1).to(torch.int32)
    return voxels, counts


def flatten_voxel_indices(voxel_indices, grid_shape):
    """(N, M, 3) voxel indices -> (N, M) flat row-major grid offsets."""
    _, d2, d3 = (int(g) for g in grid_shape)
    return (
        voxel_indices[..., 0] * (d2 * d3)
        + voxel_indices[..., 1] * d3
        + voxel_indices[..., 2]
    )


def unflatten_voxel_indices(flat_idx, grid_shape):
    """(...,) flat row-major offsets -> (..., 3) voxel indices."""
    _, d2, d3 = (int(g) for g in grid_shape)
    return torch.stack(
        [
            torch.div(flat_idx, d2 * d3, rounding_mode="floor"),
            torch.remainder(torch.div(flat_idx, d3, rounding_mode="floor"), d2),
            torch.remainder(flat_idx, d3),
        ],
        dim=-1,
    )


def voxel_traversal_flat_reference(bbox, ray_start, ray_end, grid_shape,
                                   max_voxels):
    """Plain traversal returning (N, M) FLAT indices + counts."""
    vox, counts = voxel_traversal(
        bbox, ray_start, ray_end, grid_shape, max_voxels
    )
    return flatten_voxel_indices(vox, grid_shape), counts


def _voxel_traversal_cuda(bbox, ray_start, ray_end, grid_shape, max_voxels):
    n = ray_start.shape[0]
    gx, gy, gz = (int(g) for g in grid_shape)
    M = int(max_voxels)
    for name, t, shape in (("bbox", bbox, (6,)),
                           ("ray_start", ray_start, (n, 3)),
                           ("ray_end", ray_end, (n, 3))):
        cuda_build.check_tensor("voxel_traversal_flat", name, t,
                                torch.float32, shape)
    if len({bbox.device, ray_start.device, ray_end.device}) != 1:
        raise ValueError("voxel_traversal_flat: all tensors must be on one "
                         "device")
    device = ray_start.device
    idx = torch.empty((n, M), dtype=torch.int32, device=device)
    counts = torch.empty(n, dtype=torch.int32, device=device)
    cuda_build.launch(
        "raynet_voxel_traversal", ray_start,
        bbox.data_ptr(), ray_start.data_ptr(), ray_end.data_ptr(),
        idx.data_ptr(), counts.data_ptr(), n, M, gx, gy, gz,
    )
    voxel_traversal_flat.launches += 1
    return idx, counts


def check_grid(op, grid_shape, max_voxels):
    """Raise ValueError unless the grid and M are positive and the grid's
    voxel count fits the kernels' int32 flat index."""
    gx, gy, gz = (int(g) for g in grid_shape)
    if min(gx, gy, gz) < 1 or int(max_voxels) < 1:
        raise ValueError("%s: grid %s and max_voxels %d must be positive"
                         % (op, (gx, gy, gz), max_voxels))
    if gx * gy * gz > _INT32_MAX:
        raise ValueError(
            "%s: grid %s has %d voxels; the flat int32 index takes at most "
            "2**31 - 1" % (op, (gx, gy, gz), gx * gy * gz)
        )


def voxel_traversal_flat(bbox, ray_start, ray_end, grid_shape, max_voxels):
    """Traversal returning (N, M) FLAT int32 indices (zero past each ray's
    count) + (N,) int32 counts: K3's rows mode for CUDA tensors, the plain
    version for CPU tensors.

    bbox: (6,) float32; ray_start, ray_end: (N, 3) float32, on the card all
    three contiguous. The grid's voxel count must fit the int32 flat index.
    """
    check_grid("voxel_traversal_flat", grid_shape, max_voxels)
    args = (bbox, ray_start, ray_end, grid_shape, max_voxels)
    if cuda_build.on_cuda("voxel_traversal_flat", ray_start):
        return _voxel_traversal_cuda(*args)
    return voxel_traversal_flat_reference(*args)


# Kernel launches since the last reset (the plain path never counts).
voxel_traversal_flat.launches = 0


def voxel_centers(voxel_indices, bbox, grid_shape):
    """World-space centers of (..., 3) voxel indices."""
    bbox = bbox.to(torch.float32).reshape(6)
    grid = torch.tensor([float(g) for g in grid_shape], dtype=torch.float32,
                        device=bbox.device)
    bin_size = (bbox[3:] - bbox[:3]) / grid
    return (
        bbox[:3] + voxel_indices.to(torch.float32) * bin_size + bin_size / 2
    )

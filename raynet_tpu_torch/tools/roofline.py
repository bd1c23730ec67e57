"""Bytes, operations and bounds of the port's kernels on an NVIDIA H100.

Counterpart of ``tools/roofline.py``, whose peaks are the TPU's. A kernel's
bound is the least time the card could take for its work: the larger of
the bytes it must move (each input read once, each output written once)
over the memory rate, and its operations over the peak rate of their type.
Where the work depends on the data (rays that leave the grid early, the
feature rows a batch touches), the counts are those of the batch at hand:
``feature_rows`` and ``march_counts`` measure them.

    bound(plane_sweep_cost(n_rays, V, D, F, 2, n_rows))  # (ms, "operations")
"""
import collections

import torch

# NVIDIA H100 SXM data sheet at a 700 W power limit: HBM3 bytes/s, dense
# float32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on them
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# bytes read and written, operations, and the peak rate of their type
Cost = collections.namedtuple("Cost", "nbytes ops peak_ops")


def bound(cost):
    """(bound_ms, bound_by) of ``cost``: "bytes" or "operations"."""
    t_bytes = cost.nbytes / PEAK_BYTES_S * 1e3
    t_ops = cost.ops / cost.peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def feature_rows(cells, feature_shape):
    """Distinct (view, feature cell) rows that (N, D, V, 2) int (x, y)
    feature cells touch in features of shape (V, Hf, Wf, F)."""
    V, Hf, Wf, _ = feature_shape
    rows = cells[..., 1].long() * Wf + cells[..., 0].long()
    rows = rows + torch.arange(V, device=cells.device)[None, None, :] * (Hf * Wf)
    return int(torch.unique(rows).numel())


def march_counts(flat_idx, counts):
    """(visits, distinct cells) of a batch's march: (N, M) flat voxel
    indices and (N,) counts, as K3 returns them."""
    M = flat_idx.shape[1]
    visited = torch.arange(M, device=flat_idx.device)[None, :] < counts[:, None]
    return int(counts.sum()), int(torch.unique(flat_idx[visited]).numel())


def _endpoint_bytes(n_rays):
    return 2 * n_rays * 3 * 4


def plane_sweep_cost(n_rays, V, D, F, elem_size, n_rows):
    """K1: each touched feature row read once, the endpoints and P read,
    the (N, D) scores written; 3 F + 20 float32 operations per (ray,
    plane, view)."""
    nbytes = (n_rows * F * elem_size + _endpoint_bytes(n_rays) + V * 12 * 4
              + n_rays * D * 4)
    return Cost(nbytes, n_rays * D * V * (3 * F + 20), PEAK_F32_FLOPS)


def voxel_traversal_cost(n_rays, M, visits):
    """K3: the endpoints and bbox read, (N, M) indices and (N,) counts
    written; ~25 operations per visited cell."""
    nbytes = n_rays * M * 4 + n_rays * 4 + _endpoint_bytes(n_rays) + 24
    return Cost(nbytes, visits * 25, PEAK_F32_FLOPS)


def voxel_depth_cost(n_rays, D, visits):
    """K3's voxel-depth mode: the endpoints, the (N, D) scores, the bbox
    and the camera centre read, the (N,) depths and counts written; ~40
    float32 operations per visited cell (march and hat mapping, one
    march)."""
    nbytes = _endpoint_bytes(n_rays) + n_rays * D * 4 + 24 + 12 + n_rays * 8
    return Cost(nbytes, visits * 40, PEAK_F32_FLOPS)


BP_MODES = ("first", "message", "depth")


def bp_sweep_cost(mode, n_rays, D, visits, cells):
    """K2 in ``mode``, updating the message store in place: the endpoints
    and the (N, D) scores read, the (N,) counts written; the visited
    messages read (message, depth) and written (first, message) once, with
    no zero tail past each ray's count; the visited grid cells read
    (message, depth) and written once (first, message: atomics); the (N,)
    depths written (depth); ~60 float32 operations per visited cell."""
    common = _endpoint_bytes(n_rays) + n_rays * D * 4 + n_rays * 4
    nbytes = {
        "first": common + visits * 4 + cells * 4,
        "message": common + 2 * visits * 4 + 2 * cells * 4,
        "depth": common + visits * 4 + cells * 4 + n_rays * 4,
    }[mode]
    return Cost(nbytes, visits * 60, PEAK_F32_FLOPS)


def tma_box_cost():
    """P1: the 4 x-groups of the (12, 16, 128) bf16 box that the output
    holds read once (16,384 B; the kernel copies the whole 49,152-byte box,
    but the function needs only these), the (64, 128) float32 rows written
    (32,768 B); one conversion per output element."""
    out_elems = 4 * 16 * 128
    return Cost(out_elems * 2 + out_elems * 4, out_elems, PEAK_F32_FLOPS)


def tensor_core_dot_cost(n=128):
    """P2: two (n, n) float32 operands read, the (n, n) product written;
    2 n^3 TF32 operations."""
    return Cost(3 * n * n * 4, 2 * n ** 3, PEAK_TF32_FLOPS)

"""K1: plane-sweep scores from ray segments, and its plain version.

``plane_sweep_scores`` runs the CUDA kernel ``csrc/planesweep.cu`` for CUDA
tensors and ``plane_sweep_scores_reference`` (plain PyTorch:
``ops/similarities.compute_similarities`` on the sampled points) for CPU
tensors. Both return the (N, D) softmax over D of the mean pair dot product
of the views' features where each depth hypothesis projects.
"""
import torch

from . import cuda_build
from .sampling import sample_points_along_segments
from .similarities import compute_similarities, project_to_feature_idx


def plane_sweep_scores_reference(
    features, P, ray_start, ray_end, padding, height, width, depth_planes,
):
    """Plain PyTorch plane sweep: (N, D) float32 scores."""
    points = sample_points_along_segments(ray_start, ray_end, depth_planes)
    return compute_similarities(features, P, points, padding, height, width)


def plane_sweep_cells_reference(
    P, ray_start, ray_end, padding, height, width, depth_planes,
):
    """(N, D, V, 2) int32 feature cells the plain version gathers."""
    points = sample_points_along_segments(ray_start, ray_end, depth_planes)
    return project_to_feature_idx(P, points, padding, height, width)


def _plane_sweep_cuda(features, P, ray_start, ray_end, padding, height,
                      width, depth_planes, return_cells):
    V, Hf, Wf, F = features.shape
    n = ray_start.shape[0]
    D = int(depth_planes)
    if features.dtype == torch.bfloat16:
        is_bf16 = 1
    elif features.dtype == torch.float32:
        is_bf16 = 0
    else:
        raise ValueError(
            "plane_sweep_scores: features must be float32 or bfloat16, "
            "got %s" % features.dtype
        )
    if F % 8 != 0 or F > 64:
        raise ValueError(
            "plane_sweep_scores: the kernel takes F a multiple of 8 up to "
            "64, got F=%d" % F
        )
    if not 2 <= V <= 32:
        raise ValueError("plane_sweep_scores: 2 <= V <= 32, got %d" % V)
    if D < 2:
        raise ValueError("plane_sweep_scores: depth_planes must be >= 2")
    if Hf < height + 1 or Wf < width + 1:
        raise ValueError(
            "plane_sweep_scores: features (%d, %d) do not cover cells up to "
            "(H, W) = (%d, %d)" % (Hf, Wf, height, width)
        )
    for name, t, shape in (
        ("features", features, None),
        ("P", P, (V, 3, 4)),
        ("ray_start", ray_start, (n, 3)),
        ("ray_end", ray_end, (n, 3)),
    ):
        if t.device != features.device:
            raise ValueError("plane_sweep_scores: %s is on %s, features on %s"
                             % (name, t.device, features.device))
        if not t.is_contiguous():
            raise ValueError("plane_sweep_scores: %s must be contiguous" % name)
        if shape is not None and (tuple(t.shape) != shape
                                  or t.dtype != torch.float32):
            raise ValueError("plane_sweep_scores: %s must be float32 %s"
                             % (name, shape))
    if features.data_ptr() % 16:
        raise ValueError("plane_sweep_scores: features must be 16-byte aligned")

    device = features.device
    scores = torch.empty((n, D), dtype=torch.float32, device=device)
    cells = None
    if return_cells:
        cells = torch.empty((n, D, V, 2), dtype=torch.int32, device=device)
    cuda_build.launch(
        "raynet_plane_sweep_scores", features,
        features.data_ptr(), is_bf16, P.data_ptr(),
        ray_start.data_ptr(), ray_end.data_ptr(), scores.data_ptr(),
        None if cells is None else cells.data_ptr(),
        V, Hf, Wf, F, n, D, int(padding), int(height), int(width),
    )
    plane_sweep_scores.launches += 1
    return (scores, cells) if return_cells else scores


def plane_sweep_scores(
    features, P, ray_start, ray_end, padding, height, width, depth_planes,
    return_cells=False,
):
    """Plane-sweep scores of N ray segments.

    Arguments
    ---------
        features: (V, Hf, Wf, F) float32 or bfloat16 feature maps, view 0
            the reference view, (Hf, Wf) = (H + padding + 1, W + padding + 1)
        P: (V, 3, 4) float32 projection matrices
        ray_start, ray_end: (N, 3) float32 segment endpoints
        padding, height, width, depth_planes: ints

    Returns (N, D) float32 scores; with ``return_cells`` also the
    (N, D, V, 2) int32 feature cells that were read.
    """
    args = (features, P, ray_start, ray_end, padding, height, width,
            depth_planes)
    if cuda_build.on_cuda("plane_sweep_scores", features):
        return _plane_sweep_cuda(*args, return_cells)
    S = plane_sweep_scores_reference(*args)
    if return_cells:
        return S, plane_sweep_cells_reference(*args[1:])
    return S


# Kernel launches since the last reset (the plain path never counts).
plane_sweep_scores.launches = 0

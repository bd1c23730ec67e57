"""Multi-view plane-sweep scores: the plain PyTorch version of K1.

Port of ``raynet_tpu/ops/similarities.py:31-108``. The accumulated
similarity over all view pairs uses the closed form

    S_d = sum_{i<j} f_i . f_j  =  0.5 * ( || sum_i f_i ||^2 - sum_i ||f_i||^2 )

Feature-map indexing (feature_similarities.cu:42-61 of the original):
    f_x = round(px) + padding - (padding - 1) // 2, clamped to [0, W]
    f_y = round(py) + padding - (padding - 1) // 2, clamped to [0, H]
    if either clamps to 0, BOTH are set to 0 (zero-padding sentinel),
where round is half-to-even and the feature maps have shape
(H + padding + 1, W + padding + 1).
"""
import torch

from .geometry import project_points
from .sampling import true_divisor


def pixel_to_feature_idx(pixels, padding, height, width):
    """(..., 2) float (x, y) pixels -> (..., 2) int32 (fx, fy) cells."""
    offset = padding - (padding - 1) // 2
    f = torch.round(pixels).to(torch.int32) + offset  # half to even
    fx = f[..., 0].clamp(0, width)
    fy = f[..., 1].clamp(0, height)
    either_zero = (fx == 0) | (fy == 0)
    zero = torch.zeros_like(fx)
    fx = torch.where(either_zero, zero, fx)
    fy = torch.where(either_zero, zero, fy)
    return torch.stack([fx, fy], dim=-1)


def project_to_feature_idx(P, points, padding, height, width):
    """(N, D, V, 2) int32 feature cells of every point in every view.

    P: (V, 3, 4); points: (N, D, 3).
    """
    n_views = P.shape[0]
    flat_pts = points.reshape(-1, 3)
    pixels = project_points(P, flat_pts[None].expand(n_views, -1, -1))
    pixels = pixels.reshape(n_views, *points.shape[:2], 2)  # (V, N, D, 2)
    pixels = pixels.permute(1, 2, 0, 3)  # (N, D, V, 2)
    return pixel_to_feature_idx(pixels, padding, height, width)


def gather_view_features(features, feature_idx):
    """features (V, Hf, Wf, F), cells (N, D, V, 2) -> (N, D, V, F)."""
    fx = feature_idx[..., 0].long()
    fy = feature_idx[..., 1].long()
    v = torch.arange(features.shape[0], device=features.device)[None, None, :]
    return features[v, fy, fx]


def compute_similarities(features, P, points, padding, height, width):
    """Per-ray softmax depth distribution from multi-view feature agreement.

    Arguments
    ---------
        features: (V, Hf, Wf, F) feature maps (view 0 = reference view),
            f32 or bf16; all arithmetic after the gather is f32
        P: (V, 3, 4) projection matrices
        points: (N, D, 3) depth-hypothesis points

    Returns
    -------
        S: (N, D) float32 softmax over D of the mean pair dot product.
    """
    n_views = features.shape[0]
    fidx = project_to_feature_idx(P, points, padding, height, width)
    f = gather_view_features(features, fidx).to(torch.float32)  # (N,D,V,F)

    sum_f = f.sum(dim=2)
    sum_sq = (f * f).sum(dim=(2, 3))
    pair_sum = 0.5 * ((sum_f * sum_f).sum(dim=-1) - sum_sq)

    n_pairs = (n_views * (n_views - 1)) // 2
    return torch.softmax(
        pair_sum / true_divisor(n_pairs, pair_sum.device), dim=-1
    )

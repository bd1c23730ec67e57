"""Loss functions over per-ray depth distributions, and the pretraining
metrics.

Port of ``raynet_tpu/models/losses.py``. The losses take (y_true, y_pred)
tensors of shape (B, D) and return per-sample losses (B,); callers take the
mean.
"""
import torch


def emd(y_true, y_pred):
    """Earth mover's distance: mean |cumsum(y_true - y_pred)| over D."""
    return torch.cumsum(y_true - y_pred, dim=-1).abs().mean(dim=-1)


def squared_emd(y_true, y_pred):
    """Squared EMD: sum of squared prefix sums."""
    return (torch.cumsum(y_true - y_pred, dim=-1) ** 2).sum(dim=-1)


def expected_squared_error(y_true, y_pred, voxel_center_dists):
    """|E_true[depth] - E_pred[depth]| with depths taken as the camera-centre
    distances ``voxel_center_dists`` (B, M) of the per-ray voxel centres;
    ``y_true``, ``y_pred``: (B, M) distributions over the visited voxels."""
    d_true = (y_true * voxel_center_dists).sum(dim=-1)
    d_pred = (y_pred * voxel_center_dists).sum(dim=-1)
    return (d_true - d_pred).abs()


def mse(y_true, y_pred):
    return ((y_true - y_pred) ** 2).mean(dim=-1)


def categorical_crossentropy(y_true, y_pred, eps=1e-7):
    return -(y_true * torch.log(torch.clamp(y_pred, eps, 1.0))).sum(dim=-1)


def mae(y_true, y_pred):
    """Mean absolute error metric."""
    return (y_true - y_pred).abs().mean()


def mde(y_true, y_pred):
    """Mean depth-plane error: the mean |argmax distance|."""
    return (torch.argmax(y_true, dim=-1) - torch.argmax(y_pred, dim=-1)
            ).abs().to(torch.float32).mean()


def loss_factory(loss):
    """The loss of ``loss``; an unknown name gives ``emd``, as in the JAX
    package."""
    return {
        "emd": emd,
        "squared_emd": squared_emd,
        "mse": mse,
        "categorical_crossentropy": categorical_crossentropy,
    }.get(loss, emd)

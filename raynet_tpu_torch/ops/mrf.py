"""Sum-product BP with ray potentials: the plain per-sweep operations.

Port of ``raynet_tpu/ops/mrf.py:28-179``. Messages are "pon" log-quotients
log(mu+ / mu-). The per-ray linear-time recurrences (eq. 13/14 of Ulusoy
3DV'15) are masked exclusive cumprod / cumsum over the voxel budget M; the
cross-ray reduction into the occupancy grid is ``index_add_``.
``belief_propagation`` (:183) runs every sweep over one batch of rays.
"""
import torch

_CLIP_S = 1e-5
_CLIP_MU = 1e-4


def log_prior(gamma):
    """log(gamma / (1 - gamma)) in float32: the grid's per-voxel init."""
    if isinstance(gamma, torch.Tensor):
        return torch.log(gamma) - torch.log(1.0 - gamma)
    return (
        torch.log(torch.tensor(gamma, dtype=torch.float32))
        - torch.log(torch.tensor(1.0 - gamma, dtype=torch.float32))
    )


def clip_and_renorm(S, mask):
    """Clip to [1e-5, 1-1e-5] on valid entries and renormalise to sum 1."""
    S = S.clamp(_CLIP_S, 1.0 - _CLIP_S)
    S = torch.where(mask, S, torch.zeros_like(S))
    return S / S.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _sigmoid_clipped(pon):
    mx = pon.clamp_min(0.0)
    t1 = torch.exp(0.0 - mx)
    t2 = torch.exp(pon - mx)
    return (t2 / (t1 + t2)).clamp(_CLIP_MU, 1.0 - _CLIP_MU)


def occupancy_to_ray(grid_acc_flat, flat_idx, messages_pon, mask):
    """Positive occupancy-to-ray message mu in (0, 1), 0 where masked."""
    mu = _sigmoid_clipped(grid_acc_flat[flat_idx.long()] - messages_pon)
    return torch.where(mask, mu, torch.zeros_like(mu))


def _exclusive_cumprod(one_minus):
    return torch.cat(
        [torch.ones_like(one_minus[..., :1]),
         torch.cumprod(one_minus, dim=-1)[..., :-1]],
        dim=-1,
    )


def _ray_messages_from_mu(mu, S, mask):
    """New pon messages from mu and the renormalised scores S."""
    one = torch.ones_like(mu)
    one_minus = torch.where(mask, 1.0 - mu, one)
    exclprod = _exclusive_cumprod(one_minus)
    contrib = mu * exclprod * S
    cumsum_incl = torch.cumsum(contrib, dim=-1)
    cumsum_excl = cumsum_incl - contrib
    total = cumsum_incl[..., -1:]

    pos = cumsum_excl + exclprod * S
    neg = cumsum_excl + (total - cumsum_incl) / one_minus
    p = pos / (pos + neg).clamp_min(1e-37)
    p = p.clamp(1e-37, 1.0 - 1e-7)
    new_pon = torch.log(p) - torch.log1p(-p)
    return torch.where(mask, new_pon, torch.zeros_like(new_pon))


def _bp_mask(counts, m):
    ar = torch.arange(m, device=counts.device)[None, :]
    return (ar < counts[:, None]) & (counts[:, None] > 1)


def _scatter(new_pon, flat_idx, mask, grid_size):
    safe_idx = torch.where(mask, flat_idx, torch.zeros_like(flat_idx))
    scatter = torch.zeros(grid_size, dtype=new_pon.dtype,
                          device=new_pon.device)
    return scatter.index_add_(
        0, safe_idx.reshape(-1).long(),
        torch.where(mask, new_pon, torch.zeros_like(new_pon)).reshape(-1),
    )


def bp_update_first(S, flat_idx, counts, pon_const, grid_size):
    """First BP sweep: the grid still holds the prior and the messages are
    zero, so mu is the constant sigmoid(prior) and nothing is gathered.

    Returns (new_messages (N, M), scatter (G,)).
    """
    mask = _bp_mask(counts, S.shape[-1])
    Sr = clip_and_renorm(S, mask)
    mu_const = _sigmoid_clipped(
        torch.as_tensor(pon_const, dtype=torch.float32, device=S.device)
    )
    mu = torch.where(mask, mu_const, torch.zeros_like(Sr))
    new_pon = _ray_messages_from_mu(mu, Sr, mask)
    return new_pon, _scatter(new_pon, flat_idx, mask, grid_size)


def bp_update(S, flat_idx, counts, messages_pon, grid_acc_flat, grid_size):
    """One BP sweep over a batch of rays.

    S: (N, M) per-voxel depth probabilities (before clip/renorm);
    flat_idx: (N, M) flat grid indices; counts: (N,); messages_pon: (N, M)
    previous messages; grid_acc_flat: (G,) accumulated messages of the
    previous iteration. Returns (new_messages (N, M), scatter (G,)), the
    scatter being this batch's contribution to ADD into the next grid.
    Rays with counts <= 1 are skipped: messages 0, no contribution.
    """
    mask = _bp_mask(counts, S.shape[-1])
    Sr = clip_and_renorm(S, mask)
    mu = occupancy_to_ray(grid_acc_flat, flat_idx, messages_pon, mask)
    new_pon = _ray_messages_from_mu(mu, Sr, mask)
    return new_pon, _scatter(new_pon, flat_idx, mask, grid_size)


def depth_estimate(S, flat_idx, counts, messages_pon, grid_acc_flat):
    """Posterior depth distribution after BP, normalised per ray:
    S_new_i = mu_i * prod_{j<i}(1 - mu_j) * s_i."""
    mask = _bp_mask(counts, S.shape[-1])
    Sr = clip_and_renorm(S, mask)
    mu = occupancy_to_ray(grid_acc_flat, flat_idx, messages_pon, mask)
    one_minus = torch.where(mask, 1.0 - mu, torch.ones_like(mu))
    s_new = mu * _exclusive_cumprod(one_minus) * Sr
    total = s_new.sum(dim=-1, keepdim=True)
    return torch.where(
        mask, s_new / total.clamp_min(1e-30), torch.zeros_like(s_new)
    )


def belief_propagation(S, voxel_indices, counts, grid_shape, gamma=0.05,
                       bp_iterations=3):
    """Full multi-iteration BP over one batch of rays.

    S: (N, M) per-voxel depth probabilities; voxel_indices: (N, M, 3)
    visited voxel indices; counts: (N,); grid_shape: (D1, D2, D3); gamma:
    occupancy prior. Every ray is visited once per sweep before the
    accumulator swap. Returns (grid_acc (D1, D2, D3) accumulated pon
    messages after the final sweep, messages_pon (N, M)).
    """
    from .ray_marching import flatten_voxel_indices

    grid_shape = tuple(int(g) for g in grid_shape)
    grid_size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    flat_idx = flatten_voxel_indices(voxel_indices, grid_shape)
    prior = log_prior(torch.as_tensor(gamma, dtype=S.dtype, device=S.device))
    # the first sweep: uniform prior and zero messages, nothing gathered
    msgs, scatter = bp_update_first(S, flat_idx, counts, prior, grid_size)
    grid_acc = scatter + prior
    for _ in range(bp_iterations - 1):
        msgs, scatter = bp_update(S, flat_idx, counts, msgs, grid_acc,
                                  grid_size)
        grid_acc = scatter + prior
    return grid_acc.reshape(grid_shape), msgs

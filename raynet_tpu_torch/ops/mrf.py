"""Sum-product BP with ray potentials: the plain per-sweep operations.

Port of ``raynet_tpu/ops/mrf.py:28-179``. Messages are "pon" log-quotients
log(mu+ / mu-). The per-ray linear-time recurrences (eq. 13/14 of Ulusoy
3DV'15) are masked exclusive cumprod / cumsum over the voxel budget M; the
cross-ray reduction into the occupancy grid is ``index_add``.
``belief_propagation`` (:183) runs every sweep over one batch of rays; it
is differentiable in the scores and in gamma (end-to-end training unrolls
it under autograd, as the JAX package does under ``jax.value_and_grad``),
and no op writes in place into a tensor that autograd saves.
"""
import torch
from torch.utils.checkpoint import checkpoint

_CLIP_S = 1e-5
_CLIP_MU = 1e-4


def _max(x, lo):
    return torch.maximum(x, x.new_full((), lo))


def _clip(x, lo, hi):
    """``x`` clipped to [lo, hi] as ``jnp.clip`` is: as min(max(x, lo), hi),
    whose gradient at a bound is one half (``Tensor.clamp`` passes all of
    it), so that gradients equal the JAX package's where a value sits on a
    bound (float32 values near 1 lie a few ulps apart)."""
    return torch.minimum(_max(x, lo), x.new_full((), hi))


def log_prior(gamma):
    """log(gamma / (1 - gamma)) in float32: the grid's per-voxel init. A
    tensor ``gamma`` keeps its autograd graph."""
    if isinstance(gamma, torch.Tensor):
        return torch.log(gamma) - torch.log(1.0 - gamma)
    return (
        torch.log(torch.tensor(gamma, dtype=torch.float32))
        - torch.log(torch.tensor(1.0 - gamma, dtype=torch.float32))
    )


def clip_and_renorm(S, mask):
    """Clip to [1e-5, 1-1e-5] on valid entries and renormalise to sum 1."""
    S = _clip(S, _CLIP_S, 1.0 - _CLIP_S)
    S = torch.where(mask, S, torch.zeros_like(S))
    return S / _max(S.sum(dim=-1, keepdim=True), 1e-30)


def _sigmoid_clipped(pon):
    mx = _max(pon, 0.0)
    t1 = torch.exp(0.0 - mx)
    t2 = torch.exp(pon - mx)
    return _clip(t2 / (t1 + t2), _CLIP_MU, 1.0 - _CLIP_MU)


def occupancy_to_ray(grid_acc_flat, flat_idx, messages_pon, mask):
    """Positive occupancy-to-ray message mu in (0, 1), 0 where masked.

    The gather is ``index_select``, whose gradient is an ``index_add``:
    the gradient of advanced indexing sorts the indices and sums each
    index's entries in one thread, and every masked entry (most of a
    ray's M) reads index 0, so on the card that one thread summed 0.5 M
    entries a sweep (143 ms of a 0.34 s training step on an H100)."""
    acc = grid_acc_flat.index_select(0, flat_idx.reshape(-1).long())
    mu = _sigmoid_clipped(acc.reshape(flat_idx.shape) - messages_pon)
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
    p = pos / _max(pos + neg, 1e-37)
    p = _clip(p, 1e-37, 1.0 - 1e-7)
    new_pon = torch.log(p) - torch.log1p(-p)
    return torch.where(mask, new_pon, torch.zeros_like(new_pon))


def _bp_mask(counts, m):
    ar = torch.arange(m, device=counts.device)[None, :]
    return (ar < counts[:, None]) & (counts[:, None] > 1)


def _scatter(new_pon, flat_idx, mask, grid_size):
    safe_idx = torch.where(mask, flat_idx, torch.zeros_like(flat_idx))
    scatter = torch.zeros(grid_size, dtype=new_pon.dtype,
                          device=new_pon.device)
    return scatter.index_add(
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
        torch.as_tensor(pon_const, dtype=S.dtype, device=S.device)
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
        mask, s_new / _max(total, 1e-30), torch.zeros_like(s_new)
    )


def belief_propagation(S, voxel_indices, counts, grid_shape, gamma=0.05,
                       bp_iterations=3, remat=True, sum_over_ranks=None):
    """Full multi-iteration BP over one batch of rays.

    S: (N, M) per-voxel depth probabilities; voxel_indices: (N, M, 3)
    visited voxel indices; counts: (N,); grid_shape: (D1, D2, D3); gamma:
    occupancy prior, a float or a 0-dim tensor (which may require grad).
    Every ray is visited once per sweep before the accumulator swap.
    Returns (grid_acc (D1, D2, D3) accumulated pon messages after the final
    sweep, messages_pon (N, M)).

    ``remat``: when autograd records, each sweep after the first runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass
    instead of keeping its (N, M) cumprod / cumsum chain (the JAX package's
    ``jax.checkpoint``, ``raynet_tpu/ops/mrf.py:230-231``); the numbers are
    the same either way.

    ``sum_over_ranks``: where the batch's rays are split over the ranks of
    a ray group, a callable that sums a tensor over the ranks with its
    gradient (``parallel.sharding.all_reduce_sum``); each sweep's scatter
    goes through it before the prior is added, once.
    """
    from .ray_marching import flatten_voxel_indices

    grid_shape = tuple(int(g) for g in grid_shape)
    grid_size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    flat_idx = flatten_voxel_indices(voxel_indices, grid_shape)
    prior = log_prior(torch.as_tensor(gamma, dtype=S.dtype, device=S.device))
    # the first sweep: uniform prior and zero messages, nothing gathered
    reduce = sum_over_ranks or (lambda t: t)
    msgs, scatter = bp_update_first(S, flat_idx, counts, prior, grid_size)
    grid_acc = reduce(scatter) + prior

    def sweep(msgs, grid_acc):
        msgs, scatter = bp_update(S, flat_idx, counts, msgs, grid_acc,
                                  grid_size)
        return msgs, reduce(scatter) + prior

    remat = remat and torch.is_grad_enabled()
    for _ in range(bp_iterations - 1):
        if remat:
            msgs, grid_acc = checkpoint(sweep, msgs, grid_acc,
                                        use_reentrant=False)
        else:
            msgs, grid_acc = sweep(msgs, grid_acc)
    return grid_acc.reshape(grid_shape), msgs

"""End-to-end RayNet training: CNN -> pairwise similarities -> depth->voxel
mapping -> unrolled BP -> posterior depth -> loss, with an optionally
trainable occupancy prior gamma.

Port of ``raynet_tpu/train/train_e2e.py``. The view-pair sums are the
closed form on the CNN's 1x1 patch features, the li_2 mapping, BP and the
posterior are torch ops (``ops/planes_voxels.py``, ``ops/mrf.py``) under
``torch.autograd``, as the JAX package differentiates its XLA code with
``jax.value_and_grad``; no kernel of the port runs in a step. BatchNorm
trains over all V * B * D patches with flax's semantics
(``models.cnn.BatchNorm2d``), and the optimizer chain is the JAX package's
optax chain (``models.optimizers.OptaxChain``) over the CNN's parameters
and gamma. Batches are the JAX layout: numpy arrays (or tensors), X
channels last, (V, B, D, ph, pw, C).

With a ray group (``parallel.sharding``), each rank steps on its part of
the batch (``sharding.shard_e2e_batch``) and the step is the whole batch's,
as the JAX step under GSPMD is: every BP sweep's grid scatter and every
BatchNorm's sums are summed over the ranks (with their gradients), each
rank's loss is its rays' sum over the global batch size, and the
gradients are summed over the ranks before the update, which every rank
then makes alike.
"""
import functools

import numpy as np
import torch

from ..models.cnn import BatchNorm2d, HartmannCNN, cnn_factory
from ..models.convert import read_cnn_weights
from ..models.losses import expected_squared_error, loss_factory
from ..models.optimizers import optimizer_factory
from ..ops import mrf
from ..ops.planes_voxels import depth_planes_to_voxels, project_voxels_to_rays
from ..ops.ray_marching import flatten_voxel_indices, voxel_centers
from ..ops.sampling import true_divisor
from ..parallel import sharding
from ..utils.generic_utils import resolve_device

_GAMMA_CLIP = (1e-5, 1.0 - 1e-5)


class E2EState:
    """The CNN module (its parameters and BatchNorm running statistics),
    gamma (a float32 ``torch.nn.Parameter`` when it is trained, else None)
    and the optimizer chain over both; ``step`` counts the updates."""

    def __init__(self, model, gamma, tx):
        self.model = model
        self.gamma = gamma
        self.tx = tx

    @property
    def step(self):
        return self.tx.count

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "gamma": None if self.gamma is None
                else self.gamma.detach().clone(),
                "tx": self.tx.state_dict()}

    def load_state_dict(self, sd):
        self.model.load_state_dict(sd["model"])
        if self.gamma is not None:
            with torch.no_grad():
                self.gamma.copy_(sd["gamma"])
        self.tx.load_state_dict(sd["tx"])


def feature_size(model, h, w):
    """Spatial size of the CNN's features of an (h, w) patch, 0 along an
    axis where the patch is smaller than the receptive field (where flax's
    VALID convolutions return an empty map and torch's raise)."""
    pool = isinstance(model, HartmannCNN)
    for conv in model.convs:
        k = conv.dilation[0] * (conv.kernel_size[0] - 1)
        h, w = max(h - k, 0), max(w - k, 0)
        if pool:
            h, w = h // 2, w // 2
    return h, w


def patch_features(model, X, train=True):
    """The CNN's features of (V, B, D, ph, pw, C) patch stacks, (V, B, D, F)
    channels last, as the JAX package flattens its (1x1) feature maps.
    ``train``: BatchNorm normalises with the batch's statistics and updates
    its running ones (else it uses them)."""
    v, b, d = X.shape[:3]
    if 0 in feature_size(model, X.shape[3], X.shape[4]):
        raise ValueError(
            "patch %r is smaller than the CNN receptive field"
            % (tuple(X.shape[3:5]),)
        )
    model.train(train)
    flat = X.reshape((v * b * d,) + tuple(X.shape[3:])).permute(0, 3, 1, 2)
    return model(flat).permute(0, 2, 3, 1).reshape(v, b, d, -1)


def raynet_head(f, gamma, points, ray_voxel_indices, ray_voxel_count, bbox,
                grid_shape, bp_iterations=3, sum_over_ranks=None):
    """From (V, B, D, F) features to the posterior: the view-pair sums, the
    softmax over planes, the li_2 mapping onto the visited voxels, BP and
    the depth estimate. Returns (S_post (B, M), aux dict with S_planes,
    S_vox and centers). ``sum_over_ranks``: see
    ``mrf.belief_propagation``."""
    v, _, d = f.shape[:3]
    # sum over view pairs i<j via the closed-form identity
    sum_f = f.sum(dim=0)
    sum_sq = (f * f).sum(dim=(0, 3))
    pair_sum = 0.5 * ((sum_f * sum_f).sum(dim=-1) - sum_sq)
    n_pairs = true_divisor((v * (v - 1)) // 2, f.device)
    S_planes = torch.softmax(pair_sum / n_pairs, dim=-1)  # (B, D)

    # depth -> voxel mapping (li_2 top-2 interpolation)
    centers = voxel_centers(ray_voxel_indices, bbox, grid_shape)
    t = project_voxels_to_rays(centers, points[:, 0, :3], points[:, -1, :3])
    S_vox = depth_planes_to_voxels(S_planes, t, ray_voxel_count, d)

    gamma = gamma.clamp(*_GAMMA_CLIP)
    grid_acc, msgs = mrf.belief_propagation(
        S_vox, ray_voxel_indices, ray_voxel_count, grid_shape, gamma=gamma,
        bp_iterations=bp_iterations, sum_over_ranks=sum_over_ranks,
    )
    flat_idx = flatten_voxel_indices(ray_voxel_indices, grid_shape)
    S_post = mrf.depth_estimate(S_vox, flat_idx, ray_voxel_count, msgs,
                                grid_acc.reshape(-1))
    return S_post, {"S_planes": S_planes, "S_vox": S_vox, "centers": centers}


def raynet_forward(
    model,
    gamma,
    X,
    points,
    ray_voxel_indices,
    ray_voxel_count,
    bbox,
    grid_shape,
    bp_iterations=3,
    train=True,
    sum_over_ranks=None,
):
    """Differentiable RayNet forward on a batch of rays from one scene:
    ``raynet_head`` of ``patch_features``.

    X: (V, B, D, ph, pw, C) per-view patch stacks; points: (B, D, 4)
    sampled points (homogeneous); ray_voxel_indices: (B, M, 3);
    ray_voxel_count: (B,); bbox: (6,); grid_shape: (D1, D2, D3); gamma: a
    0-dim float32 tensor, clipped to [1e-5, 1 - 1e-5] here. ``train``: see
    ``patch_features``. BP recomputes each sweep after the first in the
    backward pass (``mrf.belief_propagation``'s ``remat``).

    Returns (S_post (B, M), aux dict with S_planes, S_vox and centers).
    """
    return raynet_head(
        patch_features(model, X, train), gamma, points, ray_voxel_indices,
        ray_voxel_count, bbox, grid_shape, bp_iterations=bp_iterations,
        sum_over_ranks=sum_over_ranks)


def batch_to_device(batch, device):
    """A batch of the RayNet providers' layout as tensors on ``device``
    (``scene_idx`` dropped)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device)
            for k, v in batch.items() if k != "scene_idx"}


def build_end_to_end_training(
    seed,
    generation_params,
    grid_shape,
    cnn_name="simple_cnn",
    loss="emd",
    optimizer="Adam",
    lr=1e-4,
    momentum=None,
    clipnorm=0.0,
    gamma=0.031,
    train_with_gamma=True,
    bp_iterations=3,
    weight_file=None,
    return_grads=False,
    device="cuda",
    ray_group=None,
):
    """Returns (state, train_fn, eval_fn), the JAX package's functional
    pair as steps over an ``E2EState``.

    The CNN's weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` (flax's initialisers), or read from ``weight_file`` (a flax
    msgpack of the CNN, or of a similarity net). ``train_fn(state, batch)``
    -> (state, {"loss", "gamma"}), gamma being the value the step used;
    with ``return_grads`` also "grads": {"cnn": {parameter name: gradient},
    "gamma": gradient or None}. The parameters' ``.grad`` hold the same.
    ``eval_fn(state, batch)`` -> {"loss", "gamma"} with the BatchNorm
    running statistics. Compare gradients, not updated parameters, with
    another implementation: a conv bias feeding a BatchNorm has zero
    gradient in exact arithmetic, and Adam turns its rounding noise into
    +-lr.

    ``ray_group``: step on each rank's part of the batch (see the module's
    docstring) on the group's device; the state is broadcast from rank 0,
    and the metrics and gradients are the whole batch's on every rank."""
    gp = generation_params
    device = resolve_device(device if ray_group is None
                            else ray_group.device)
    model = cnn_factory(cnn_name)(gp.patch_shape[2])
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if weight_file:
        model.load_state_dict(read_cnn_weights(weight_file))
    model.to(device)
    grid_shape = tuple(int(g) for g in grid_shape)
    loss_fn = loss_factory(loss)

    params = list(model.parameters())
    g_param = None
    if train_with_gamma:
        g_param = torch.nn.Parameter(
            torch.tensor(gamma, dtype=torch.float32, device=device))
        params.append(g_param)
    state = E2EState(model, g_param, optimizer_factory(
        optimizer, lr, momentum, clipnorm)(params))
    fixed_gamma = torch.tensor(gamma, dtype=torch.float32, device=device)
    grid_sum = None
    if ray_group is not None:
        def grid_sum(t):
            return sharding.all_reduce_sum(t, ray_group, grid=True)

        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.sum_over_ranks = functools.partial(
                    sharding.all_reduce_sum, ray_group=ray_group)
        sharding.replicate_state(ray_group, state)

    def _forward(state, batch, train):
        g = state.gamma if state.gamma is not None else fixed_gamma
        S_post, aux = raynet_forward(
            state.model, g, batch["X"], batch["points"],
            batch["ray_voxel_indices"], batch["ray_voxel_count"],
            batch["bbox"], grid_shape, bp_iterations=bp_iterations,
            train=train, sum_over_ranks=grid_sum,
        )
        return S_post, aux, g

    def _loss(y, S_post, aux, batch):
        if loss == "expected_squared_error":
            dists = torch.linalg.norm(
                aux["centers"] - batch["camera_centers"][:, None, :3], dim=-1
            )
            per_ray = expected_squared_error(y, S_post, dists)
        else:
            per_ray = loss_fn(y, S_post)
        if ray_group is None:
            return per_ray.mean()
        # this rank's share of the whole batch's mean
        n = sharding.global_count(ray_group, per_ray.shape[0])
        return per_ray.sum() / true_divisor(n, device)

    def train_fn(state, batch):
        batch = batch_to_device(batch, device)
        state.tx.zero_grad()
        S_post, aux, g = _forward(state, batch, train=True)
        loss_val = _loss(batch["y"], S_post, aux, batch)
        loss_val.backward()
        if ray_group is not None:
            sharding.all_reduce_grads(ray_group, state.tx.params)
            loss_val = ray_group.all_reduce(loss_val.detach().clone())
        metrics = {"loss": loss_val.detach(), "gamma": g.detach().clone()}
        if return_grads:
            metrics["grads"] = {
                "cnn": {n: p.grad.detach().clone()
                        for n, p in state.model.named_parameters()},
                "gamma": None if state.gamma is None
                else state.gamma.grad.detach().clone(),
            }
        state.tx.step()
        if state.gamma is not None:
            # the clip constraint (forward_backward_pass.py:346-353)
            with torch.no_grad():
                state.gamma.clamp_(*_GAMMA_CLIP)
        return state, metrics

    @torch.no_grad()
    def eval_fn(state, batch):
        batch = batch_to_device(batch, device)
        S_post, aux, g = _forward(state, batch, train=False)
        loss_val = _loss(batch["y"], S_post, aux, batch)
        if ray_group is not None:
            ray_group.all_reduce(loss_val)
        return {"loss": loss_val, "gamma": g.detach().clone()}

    return state, train_fn, eval_fn

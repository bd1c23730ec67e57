"""MVCNN and Hartmann pretraining: the training and evaluation steps.

Port of ``raynet_tpu/train/pretrain.py``. A ``PretrainState`` holds the
module (with its BatchNorm running statistics, updated in training mode
with flax's semantics, ``models.cnn.BatchNorm2d``) and the optax-equivalent
optimizer chain (``models.optimizers``). The steps take the JAX package's
channels-last numpy batches, move them to the module's device, and return
the state and a dict of 0-dim tensor metrics. Gradients stay in each
parameter's ``.grad`` after a step.
"""
import numpy as np
import torch

from ..models.cnn import HartmannSimilarityNet, MultiViewSimilarityNet
from ..models.losses import categorical_crossentropy, loss_factory
from ..models.optimizers import l2_loss, optimizer_factory
from ..utils.generic_utils import resolve_device


class PretrainState:
    """A module and its optimizer chain; ``step`` counts the updates."""

    def __init__(self, model, tx):
        self.model = model
        self.tx = tx

    @property
    def step(self):
        return self.tx.count

    def state_dict(self):
        return {"model": self.model.state_dict(), "tx": self.tx.state_dict()}

    def load_state_dict(self, sd):
        self.model.load_state_dict(sd["model"])
        self.tx.load_state_dict(sd["tx"])


def _device_of(module):
    return next(module.parameters()).device


def _f32(x, device):
    """An array or a tensor (on any device) as a float32 tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _patches(x, device):
    """Channels-last patches (..., h, w, C) -> a (..., C, h, w) float32
    tensor on ``device``."""
    return _f32(x, device).movedim(-1, -3)


def _init(model, seed, device):
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def create_pretrain_state(
    seed,
    input_shape,
    cnn_name="simple_cnn",
    optimizer="Adam",
    lr=1e-3,
    momentum=None,
    clipnorm=0.0,
    loss="emd",
    reducer="average",
    merge_layer="dot-product",
    weight_decay=0.0,
    device="cuda",
):
    """A MultiViewSimilarityNet seeded with ``seed``, its chain, loss and
    weight decay; ``input_shape`` = (D, N, H, W, C) without the batch dim.
    Returns (model, state, loss_fn, weight_decay)."""
    model = _init(MultiViewSimilarityNet(cnn_name, reducer, merge_layer,
                                         in_channels=input_shape[-1]),
                  seed, device)
    tx = optimizer_factory(optimizer, lr, momentum, clipnorm)(
        model.parameters())
    return model, PretrainState(model, tx), loss_factory(loss), weight_decay


def _accuracy(y, out):
    return (torch.argmax(y, dim=-1) == torch.argmax(out, dim=-1)).to(
        torch.float32).mean()


def create_hartmann_pretrain_state(
    seed,
    patch_shape,
    n_views=5,
    optimizer="SGD",
    lr=1e-3,
    momentum=0.9,
    clipnorm=0.0,
    device="cuda",
):
    """Hartmann et al. baseline pretraining: patch quintuples -> 2-way
    match softmax under categorical crossentropy. Returns (model, state,
    train_step); ``train_step(state, patches (B, V, ph, pw, C), y (B, 1, 1,
    2))`` -> (state, {"loss", "acc"})."""
    del n_views  # the net takes any number of views
    model = _init(HartmannSimilarityNet(patch_shape[2]), seed, device)
    tx = optimizer_factory(optimizer, lr, momentum, clipnorm)(
        model.parameters())

    def train_step(state, patches, y):
        dev = _device_of(state.model)
        state.model.train()
        y = _f32(y, dev).reshape(len(y), -1)
        state.tx.zero_grad()
        out = state.model(_patches(patches, dev)).permute(0, 2, 3, 1)
        out = out.reshape(len(out), -1)
        loss = categorical_crossentropy(y, out).mean()
        loss.backward()
        state.tx.step()
        return state, {"loss": loss.detach(), "acc": _accuracy(y, out)}

    return model, PretrainState(model, tx), train_step


def _metrics(y, out, loss):
    return {
        "loss": loss,
        "acc": _accuracy(y, out),
        "mae": (y - out).abs().mean(),
        "mde": (torch.argmax(y, -1) - torch.argmax(out, -1)).abs().to(
            torch.float32).mean(),
    }


def make_pretrain_step(model, loss_fn, weight_decay=0.0):
    """(train_step, eval_step) of a MultiViewSimilarityNet: each takes
    (state, x1, x2, y) with x (B, D, N, H, W, C) and y (B, D) numpy arrays
    or tensors;
    train_step returns (state, metrics), eval_step metrics. The loss gets
    ``weight_decay`` times the sum of squares of every parameter with more
    than one dimension."""
    del model  # the state carries it

    def train_step(state, x1, x2, y):
        m = state.model
        dev = _device_of(m)
        m.train()
        y = _f32(y, dev)
        state.tx.zero_grad()
        out = m(_patches(x1, dev), _patches(x2, dev))
        loss = loss_fn(y, out).mean()
        if weight_decay:
            loss = loss + l2_loss(m.parameters(), weight_decay)
        loss.backward()
        state.tx.step()
        with torch.no_grad():
            return state, _metrics(y, out, loss.detach())

    @torch.no_grad()
    def eval_step(state, x1, x2, y):
        m = state.model
        dev = _device_of(m)
        m.eval()
        y = _f32(y, dev)
        out = m(_patches(x1, dev), _patches(x2, dev))
        return _metrics(y, out, loss_fn(y, out).mean())

    return train_step, eval_step

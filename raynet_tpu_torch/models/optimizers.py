"""Optimizer and regularizer factories: the JAX package's optax chain on
torch parameters.

Port of ``raynet_tpu/models/optimizers.py``. ``optimizer_factory`` builds
the same chain, applied in the same order and float32 arithmetic:

1. an element-wise clip of every gradient to [-clipvalue, clipvalue] (on by
   default, ``optax.clip``);
2. when ``clipnorm`` is nonzero, a rescale of all gradients by
   ``clipnorm / norm`` where their global norm reaches ``clipnorm``
   (``optax.clip_by_global_norm``; not ``clip_grad_norm_``, which divides
   by ``norm + 1e-6`` always);
3. Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments) or SGD with
   optional momentum (``optax.adam`` / ``optax.sgd``),

then ``p += -lr * update``. ``lr`` may be a callable of the step, which is
evaluated at the count of updates made before this one, as optax does.
"""
import numpy as np
import torch


class OptaxChain:
    """The chain above over ``params``; ``step()`` reads each ``p.grad``."""

    def __init__(self, params, optimizer, lr, momentum=None, clipnorm=0.0,
                 clipvalue=1.0):
        if optimizer not in ("Adam", "SGD"):
            raise ValueError("unknown optimizer %r" % (optimizer,))
        self.params = [p for p in params]
        self.optimizer = optimizer
        self.lr = lr
        self.momentum = momentum
        self.clipnorm = clipnorm
        self.clipvalue = clipvalue
        self.count = 0
        if optimizer == "Adam":
            self.state = {
                "mu": [torch.zeros_like(p) for p in self.params],
                "nu": [torch.zeros_like(p) for p in self.params],
            }
        elif momentum:
            self.state = {"trace": [torch.zeros_like(p) for p in self.params]}
        else:
            self.state = {}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def learning_rate(self, count):
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.clipvalue:
            grads = [g.clamp(-self.clipvalue, self.clipvalue) for g in grads]
        if self.clipnorm:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [torch.where(norm < self.clipnorm, g,
                                 (g / norm) * self.clipnorm) for g in grads]
        if self.optimizer == "Adam":
            updates = self._adam(grads)
        elif self.momentum:
            for t, g in zip(self.state["trace"], grads):
                t.copy_(g + self.momentum * t)
            updates = self.state["trace"]
        else:
            updates = grads
        step_size = -self.learning_rate(self.count)
        for p, u in zip(self.params, updates):
            p.add_(step_size * u)
        self.count += 1

    def _adam(self, grads, b1=0.9, b2=0.999, eps=1e-8):
        # optax's bias corrections are float32: 1 - 0.999f ** count
        count = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        out = []
        for mu, nu, g in zip(self.state["mu"], self.state["nu"], grads):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            out.append(mu_hat / (torch.sqrt(nu_hat) + eps))
        return out

    def state_dict(self):
        return {"count": self.count,
                "state": {k: [t.clone() for t in v]
                          for k, v in self.state.items()}}

    def load_state_dict(self, sd):
        self.count = int(sd["count"])
        for k, v in sd["state"].items():
            for t, src in zip(self.state[k], v):
                t.copy_(src)


def optimizer_factory(optimizer, lr, momentum=None, clipnorm=0.0,
                      clipvalue=1.0):
    """A constructor ``params -> OptaxChain`` (optax builds its chain before
    it sees parameters; so does this)."""

    def make(params):
        return OptaxChain(params, optimizer, lr, momentum, clipnorm,
                          clipvalue)

    return make


def kernel_regularizer_factory(regularizer_factor):
    """The l2 factor (weight-decay loss term coefficient), or None."""
    if regularizer_factor == 0.0:
        return None
    return regularizer_factor


def l2_loss(params, factor):
    """``factor`` times the sum of squares of every parameter with more than
    one dimension (the kernels)."""
    return factor * sum((p ** 2).sum() for p in params if p.ndim > 1)

"""The port's pretraining layer against the JAX package's, on the CPU:
masked softmax, losses, the optax-equivalent optimizer chain and its
learning-rate schedule, the MVCNN and Hartmann training steps from the same
converted state on the same batches, the sample generators and the batch
provider.

Tolerances: losses and softmax rtol 1e-5 / atol 1e-6 (float32 sums over
a few entries, in another order); the optimizer chain on fixed gradients
rtol 1e-6 / atol 1e-7 (the same float32 operations in the same order);
training steps rtol 1e-4 / atol 1e-6 on losses, metrics and BatchNorm
statistics, rtol 1e-4 / atol 1e-4 of the model's largest gradient entry on
gradients, and on updated parameters 1e-4 of the tensor's largest
magnitude plus lr times twice the gradient tolerance (XLA's and PyTorch's
convolutions and reductions sum in different orders: against a float64
evaluation, the JAX package's first-layer kernel gradient is off by up to
2e-5 of its largest entry, the port's by 5e-6, and gradients that are zero
in exact arithmetic, such as those of the conv biases under a BatchNorm,
are that noise); sample generators bit for bit.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raynet_tpu.common.dataset import RestrepoDataset as JaxRestrepoDataset
from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
    get_target_distribution_factory as jax_tdf,
)
from raynet_tpu.common.sampling_schemes import (
    get_sampling_scheme as jax_scheme,
)
from raynet_tpu.models import layers as jlayers
from raynet_tpu.models import losses as jlosses
from raynet_tpu.models.optimizers import (
    l2_loss as jax_l2_loss,
    optimizer_factory as jax_optimizer_factory,
)
from raynet_tpu.scripts.pretrain_network import lr_schedule as jax_lr_schedule
from raynet_tpu.train import sample as jsample
from raynet_tpu.train.pretrain import (
    create_hartmann_pretrain_state as jax_hartmann_state,
    create_pretrain_state as jax_pretrain_state,
    make_pretrain_step as jax_make_step,
)
from raynet_tpu_torch.common.dataset import RestrepoDataset
from raynet_tpu_torch.common.generation_parameters import (
    GenerationParameters,
    get_target_distribution_factory,
)
from raynet_tpu_torch.common.sampling_schemes import get_sampling_scheme
from raynet_tpu_torch.models import layers, losses
from raynet_tpu_torch.models.convert import (
    hartmann_state_dict_from_flax,
    similarity_state_dict_from_flax,
)
from raynet_tpu_torch.models.optimizers import (
    kernel_regularizer_factory,
    l2_loss,
    optimizer_factory,
)
from raynet_tpu_torch.scripts.pretrain_network import lr_schedule
from raynet_tpu_torch.train import sample
from raynet_tpu_torch.train.batch_provider import BatchProvider
from raynet_tpu_torch.train.pretrain import (
    create_hartmann_pretrain_state,
    create_pretrain_state,
    make_pretrain_step,
)

torch.set_num_threads(2)
ELEM = dict(rtol=1e-5, atol=1e-6)
CHAIN = dict(rtol=1e-6, atol=1e-7)
STEP = dict(rtol=1e-4, atol=1e-6)


def assert_close_to_scale(got, want, err_msg, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=err_msg)


def assert_grads_close(model, want):
    """Each parameter's ``.grad`` against ``want[name]``, to the scale of
    the model's largest gradient entry."""
    scale = max(float(v.abs().max()) for k, v in want.items()
                if k in dict(model.named_parameters()))
    for name, p in model.named_parameters():
        assert_close_to_scale(p.grad.numpy(), want[name].numpy(),
                              "grad " + name, scale)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_masked_softmax_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 9) * 3).astype(np.float32)
    counts = np.array([0, 1, 3, 9, 5, 2], np.int32)
    got = layers.masked_softmax(_t(x), _t(counts)).numpy()
    want = np.asarray(jlayers.masked_softmax(jnp.asarray(x),
                                             jnp.asarray(counts)))
    np.testing.assert_allclose(got[1:], want[1:], **ELEM)
    # a row with no valid entry is 0/0 in both packages
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    assert (got[2, 3:] == 0).all()


@pytest.mark.parametrize("name", ["emd", "squared_emd", "mse",
                                  "categorical_crossentropy", "mae", "mde"])
def test_losses_match_jax(name):
    rng = np.random.RandomState(1)
    y = np.eye(7, dtype=np.float32)[rng.randint(0, 7, 5)]
    p = rng.rand(5, 7).astype(np.float32)
    p[0, 2] = 0.0  # crossentropy's clip at 1e-7
    p /= p.sum(-1, keepdims=True)
    got = getattr(losses, name)(_t(y), _t(p)).numpy()
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(y), jnp.asarray(p)))
    np.testing.assert_allclose(got, want, **ELEM)
    if name in ("emd", "squared_emd", "mse", "categorical_crossentropy"):
        assert losses.loss_factory(name) is getattr(losses, name)


def test_expected_squared_error_and_loss_fallback():
    rng = np.random.RandomState(2)
    y, p, d = (rng.rand(4, 6).astype(np.float32) for _ in range(3))
    got = losses.expected_squared_error(_t(y), _t(p), _t(d)).numpy()
    want = np.asarray(jlosses.expected_squared_error(y, p, d))
    np.testing.assert_allclose(got, want, **ELEM)
    # an unknown name falls back to emd, as in the JAX package
    assert losses.loss_factory("nope") is losses.emd
    assert jlosses.loss_factory("nope") is jlosses.emd


def test_l2_loss_and_regularizer():
    rng = np.random.RandomState(3)
    params = {"k": rng.randn(2, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    got = float(l2_loss([_t(v) for v in params.values()], 0.1))
    np.testing.assert_allclose(got, float(jax_l2_loss(params, 0.1)), **ELEM)
    assert kernel_regularizer_factory(0.0) is None
    assert kernel_regularizer_factory(0.5) == 0.5


OPTIMIZERS = [
    ("Adam", dict(clipnorm=0.0)),
    ("Adam", dict(clipnorm=1.5)),
    ("Adam", dict(clipnorm=0.0, schedule=True)),
    ("SGD", dict(momentum=0.9)),
    ("SGD", dict(momentum=0.9, clipnorm=2.0)),
    ("SGD", dict(momentum=None)),
]


@pytest.mark.parametrize("optimizer,kw", OPTIMIZERS)
def test_optimizer_chain_matches_optax(optimizer, kw):
    kw = dict(kw)
    lr = 1e-2
    if kw.pop("schedule", False):
        # two steps an epoch, /10 after epoch 1 and again after epoch 2
        lr_t, lr_j = (f(lr, 10.0, [1, 2], 2)
                      for f in (lr_schedule, jax_lr_schedule))
    else:
        lr_t = lr_j = lr
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    tx = jax_optimizer_factory(optimizer, lr_j, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = [torch.tensor(params[k]) for k in sorted(params)]
    chain = optimizer_factory(optimizer, lr_t, **kw)(tparams)
    for step in range(6):
        # gradients above and below the element clip and the norm clip
        grads = {k: (rng.randn(*v.shape) * (0.2 + step)).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(tparams, sorted(params)):
            p.grad = torch.tensor(grads[k])
        chain.step()
        for p, k in zip(tparams, sorted(params)):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       err_msg="step %d %s" % (step, k),
                                       **CHAIN)
    assert chain.count == 6


def test_lr_schedule_matches_jax():
    assert lr_schedule(0.1, None, [1], 5) == 0.1
    f, g = lr_schedule(1e-3, 3.0, [1, 3], 4), jax_lr_schedule(1e-3, 3.0,
                                                              [1, 3], 4)
    for step in range(20):
        np.testing.assert_allclose(f(step), float(g(step)), rtol=1e-7)


def _jax_grads(model, loss_fn, wd, state, x1, x2, y):
    def compute(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": state.batch_stats}, x1, x2,
            train=True, mutable=["batch_stats"])
        loss = loss_fn(y, out).mean()
        if wd:
            loss = loss + wd * sum(jnp.sum(p ** 2) for p in
                                   jax.tree_util.tree_leaves(params)
                                   if p.ndim > 1)
        return loss

    return jax.grad(compute)(state.params)


# A relu whose input lies within float32 noise of 0 takes the other branch
# in one package, which moves a whole channel's gradient (a BatchNorm
# couples its positions): the Adam case runs the tanh stack, smooth
# everywhere, and the relu stacks take SGD.
STEPS = [
    ("dilated_cnn_receptive_field_25_with_tanh", "Adam", "emd", 1e-3, 25),
    ("simple_cnn_ln", "SGD", "squared_emd", 0.0, 11),
    ("simple_cnn", "SGD", "emd", 1e-3, 11),
]


def _sync(jstate, model, state, optimizer):
    """Load the JAX state (parameters, BatchNorm statistics, optimizer
    moments and count) into the port's model and chain."""
    def port(tree):
        return similarity_state_dict_from_flax(
            {"params": tree, "batch_stats": jstate.batch_stats})

    model.load_state_dict(port(jstate.params))
    names = [n for n, _ in model.named_parameters()]
    inner = jstate.opt_state[1][0]
    moments = ("mu", "nu") if optimizer == "Adam" else ("trace",)
    state.tx.load_state_dict({
        "count": int(jstate.step),
        "state": {k: [port(getattr(inner, k))[n] for n in names]
                  for k in moments},
    })


@pytest.mark.parametrize("cnn_name,optimizer,loss,wd,patch", STEPS)
def test_pretrain_steps_match_jax(cnn_name, optimizer, loss, wd, patch):
    """Three training steps and an evaluation, each from the same state
    (the JAX state loaded into the port first) on the same batch.
    Compared: losses, metrics, gradients, BatchNorm running statistics and
    the updated parameters. Under Adam, an entry whose gradient sits near
    the float32 noise floor (under 1e-3 of the model's largest gradient
    entry, ten times the gradient tolerance) gets an update of noise,
    +-lr whatever its size: those entries are left out of the parameter
    comparison. They are every conv bias under a BatchNorm (zero gradient in
    exact arithmetic; ``raynet_tpu/train/train_e2e.py:124-128``) and a few
    kernel entries. Across steps Adam's noise updates would compound, which
    is why each step starts from the JAX state."""
    shape = (4, 2, patch, patch, 3)
    jmodel, jstate, jloss, jwd = jax_pretrain_state(
        jax.random.PRNGKey(0), shape, cnn_name=cnn_name, optimizer=optimizer,
        lr=1e-3, momentum=0.9, loss=loss, weight_decay=wd)
    jtrain, jeval = jax_make_step(jmodel, jloss, jwd)
    model, state, loss_fn, twd = create_pretrain_state(
        1, shape, cnn_name=cnn_name, optimizer=optimizer, lr=1e-3,
        momentum=0.9, loss=loss, weight_decay=wd, device="cpu")
    train, evaluate = make_pretrain_step(model, loss_fn, twd)
    rng = np.random.RandomState(5)

    def batch():
        x1, x2 = (rng.rand(2, *shape).astype(np.float32) for _ in range(2))
        y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 2)]
        return x1, x2, y

    kept = total = 0
    for _ in range(3):
        _sync(jstate, model, state, optimizer)
        x1, x2, y = batch()
        jgrads = _jax_grads(jmodel, jloss, jwd, jstate, x1, x2, y)
        jstate, jm = jtrain(jstate, x1, x2, y)
        state, m = train(state, x1, x2, y)
        for k in ("loss", "acc", "mae", "mde"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=k, **STEP)
        params = dict(model.named_parameters())
        grads = {k: v for k, v in similarity_state_dict_from_flax(
            {"params": jgrads, "batch_stats": jstate.batch_stats}).items()
            if k in params}
        assert_grads_close(model, grads)
        scale = max(float(v.abs().max()) for v in grads.values())
        got = model.state_dict()
        for k, v in similarity_state_dict_from_flax(
                {"params": jstate.params,
                 "batch_stats": jstate.batch_stats}).items():
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                           err_msg=k, **STEP)
            elif k in params:
                mask = np.ones(v.shape, bool)
                if optimizer == "Adam":
                    mask = grads[k].abs().numpy() > 1e-3 * scale
                kept, total = kept + mask.sum(), total + mask.size
                # an update is lr times (the gradient and the momentum
                # trace), each within the gradient tolerance
                np.testing.assert_allclose(
                    got[k].numpy()[mask], v.numpy()[mask], rtol=1e-4,
                    atol=1e-4 * (float(np.abs(v.numpy()).max())
                                 + 2 * 1e-3 * scale), err_msg=k)
    assert kept > 0.9 * total
    _sync(jstate, model, state, optimizer)
    x1, x2, y = batch()
    jm, m = jeval(jstate, x1, x2, y), evaluate(state, x1, x2, y)
    for k in ("loss", "acc", "mae", "mde"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **STEP)
    assert state.step == 3


def test_hartmann_pretrain_step_matches_jax():
    """One SGD step of the Hartmann net: loss, accuracy, gradients and every
    updated parameter (SGD's update is -lr * g, no amplification)."""
    jmodel, jstate, jtrain = jax_hartmann_state(
        jax.random.PRNGKey(0), (32, 32, 3), optimizer="SGD", lr=1e-2,
        momentum=0.9)
    model, state, train = create_hartmann_pretrain_state(
        3, (32, 32, 3), optimizer="SGD", lr=1e-2, momentum=0.9,
        device="cpu")
    model.load_state_dict(hartmann_state_dict_from_flax(
        {"params": jstate.params}))
    rng = np.random.RandomState(6)
    patches = rng.rand(4, 5, 32, 32, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 4)].reshape(4, 1, 1, 2)

    def compute(params):
        out = jmodel.apply({"params": params}, patches, train=True)
        return jlosses.categorical_crossentropy(
            y.reshape(4, -1), out.reshape(4, -1)).mean()

    jgrads = jax.grad(compute)(jstate.params)
    jstate, jm = jtrain(jstate, patches, y)
    state, m = train(state, patches, y)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **STEP)
    assert_grads_close(model, hartmann_state_dict_from_flax(
        {"params": jgrads}))
    want = hartmann_state_dict_from_flax({"params": jstate.params})
    for name, v in model.state_dict().items():
        assert_close_to_scale(v.numpy(), want[name].numpy(), name)


def _gps(patch, expand, step_depth=None):
    out = []
    for cls, tdf in ((GenerationParameters, get_target_distribution_factory),
                     (JaxGenerationParameters, jax_tdf)):
        out.append(cls(depth_planes=4, neighbors=2, patch_shape=patch,
                       padding=patch[0], expand_patch=expand,
                       step_depth=step_depth,
                       sampling_type="sample_points_in_bbox",
                       target_distribution_factory=tdf("dirac")))
    return out


GENERATORS = [
    ("DefaultSampleGenerator", (11, 11, 3), True, None),
    ("CompareWithReferenceSampleGenerator", (11, 11, 3), True, None),
    # 32x32 patches leave the 48x36 mock images, so they are zero-filled
    ("HartmannSampleGenerator", (32, 32, 3), True, 1),
]


@pytest.mark.parametrize("name,patch,expand,step_depth", GENERATORS)
def test_sample_generators_equal_jax(mock_scene_dir, name, patch, expand,
                                     step_depth):
    gp, jgp = _gps(patch, expand, step_depth)
    root = str(mock_scene_dir.parent)
    n_pairs = {"DefaultSampleGenerator": 3}.get(name, 2)
    if name == "HartmannSampleGenerator":
        shapes = [patch] * 3, [(1, 1, 2)]
    else:
        shapes = [(4, n_pairs) + patch] * 2, [(4,)]
    sg = getattr(sample, name)(
        get_sampling_scheme("sample_in_bbox")(gp), gp, [0], *shapes,
        rng=np.random.RandomState(11))
    jsg = getattr(jsample, name)(
        jax_scheme("sample_in_bbox")(jgp), jgp, [0], *shapes,
        rng=np.random.RandomState(11))
    ds, jds = RestrepoDataset(root, device="cpu"), JaxRestrepoDataset(root)
    valid = 0
    for _ in range(12):
        s, j = sg.get_sample(ds), jsg.get_sample(jds)
        assert (s.scene_idx, s.img_idx, s.patch_x, s.patch_y) == (
            j.scene_idx, j.img_idx, j.patch_x, j.patch_y)
        for a, b in ((s.points, j.points), (s.X, j.X), (s.y, j.y)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        valid += s.X is not None
    assert valid > 0


def test_sample_helpers_and_rng_required():
    pairs = sample.create_combinations_of_patches([1, 2, 3])
    assert pairs == jsample.create_combinations_of_patches([1, 2, 3])
    assert sample.is_empty(-np.ones((2, 2))) and not sample.is_empty(
        np.zeros((2, 2)))
    gp, _ = _gps((11, 11, 3), True)
    with pytest.raises(TypeError):
        sample.DefaultSampleGenerator(None, gp, [0], [], [])


class _Counter:
    """A sample generator that numbers its samples (every third rejected)."""

    input_shapes = [(2,)]
    output_shapes = [(1,)]

    def __init__(self):
        self.n = 0

    def get_sample(self, dataset):
        self.n += 1
        x = None if self.n % 3 == 0 else [np.full(2, self.n, np.float32)]
        return sample.Sample(0, 0, 0, 0, None, x, [np.ones(1, np.float32)])


def test_batch_provider_is_a_function_of_its_seeds():
    """The same generator and batch rng give the same batches, whatever the
    producer process's timing; rejected samples never reach the cache."""
    def batches():
        bp = BatchProvider(None, _Counter(), cache_size=5, batch_size=4,
                           rng=np.random.RandomState(0))
        try:
            return [bp.get_batch()[0][0] for _ in range(6)]
        finally:
            bp.stop()
            assert not bp._producer.is_alive()

    # a shortened switch interval interleaves the consumer's threads finely
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a, b = batches(), batches()
    finally:
        sys.setswitchinterval(interval)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    values = np.concatenate(a)[:, 0]
    assert (values % 3 != 0).all()
    # after the first fill, each batch brings batch_size new samples: the
    # sixth batch draws from the samples numbered up to 5 + 5 * 4 = 25,
    # kept ones numbered 1, 2, 4, 5, ... (every third is rejected)
    assert values.max() > 7 and values.max() <= 38


def test_batch_provider_raises_the_producers_error():
    class Broken(_Counter):
        def get_sample(self, dataset):
            raise ValueError("no scene")

    bp = BatchProvider(None, Broken(), cache_size=2, batch_size=1,
                       rng=np.random.RandomState(0))
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            bp.get_batch()
    finally:
        bp.stop()

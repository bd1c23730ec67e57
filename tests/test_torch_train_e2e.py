"""The port's end-to-end RayNet training against the JAX package's, on the
CPU: ``raynet_forward``, one ``train_fn`` step with ``return_grads`` (loss,
every gradient leaf, gamma after the update, BatchNorm statistics) over
the losses, a trainable or fixed gamma and both optimizers, ``eval_fn``,
remat, and learning on a fixed batch of the mock scene.

The same numpy batches (built as ``__graft_entry__.py`` builds its sharded
check's) go through both packages, the JAX CNN's initial variables
converted into the port's module. Tolerances: the forward's S_post,
S_planes and S_vox rtol 1e-5 / atol 1e-6; a step's loss rtol 1e-5,
updated gamma rtol 1e-5 / atol 1e-7, every gradient leaf rtol 1e-4 / atol
1e-5 of the largest gradient entry (the bars of the JAX package's own
sharded check, ``__graft_entry__.py:159-172``), BatchNorm statistics rtol
1e-5 / atol 1e-7. Gradients are compared, not updated parameters: a conv
bias feeding a BatchNorm has zero gradient in exact arithmetic, and Adam
turns its rounding noise into +-lr.

Where BatchNorm trains, the patches are centred (uniform in [-0.5,
0.5)). On uncentred patches (uniform in [0, 1), as the images give them)
the float32 gradients of the first two layers of both packages lie up to
1e-4 (the port) and 6e-4 (the JAX package) of the largest entry away from
the float64 gradient, and their S_planes up to 2e-5 relative from each
other: cancellation at the first BatchNorms' inputs, as in pretraining.
There ``test_step_on_uncentred_patches`` holds the port to be no farther
from float64 than the JAX package (or within the bar), leaf by leaf.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
)
from raynet_tpu.models.cnn import cnn_factory as jax_cnn_factory
from raynet_tpu.train.train_e2e import (
    build_end_to_end_training as jax_build,
    raynet_forward as jax_raynet_forward,
)
from raynet_tpu_torch.common.dataset import RestrepoDataset
from raynet_tpu_torch.common.generation_parameters import (
    GenerationParameters,
    get_target_distribution_factory,
)
from raynet_tpu_torch.common.sampling_schemes import get_sampling_scheme
from raynet_tpu_torch.models.convert import state_dict_from_flax
from raynet_tpu_torch.models.losses import emd
from raynet_tpu_torch.ops import mrf
from raynet_tpu_torch.ops.ray_marching import flatten_voxel_indices
from raynet_tpu_torch.train.batch_provider import RayNetBatchProvider
from raynet_tpu_torch.train.sample import RayNetRandomSampleGenerator
from raynet_tpu_torch.train.train_e2e import (
    batch_to_device,
    build_end_to_end_training,
    raynet_forward,
)

torch.set_num_threads(2)
FWD = dict(rtol=1e-5, atol=1e-6)


def _gps(v, d, m, patch=11):
    kw = dict(depth_planes=d, neighbors=v - 1, patch_shape=(patch, patch, 3),
              grid_shape=np.array([6, 6, 6], dtype=np.int32),
              max_number_of_marched_voxels=m)
    return GenerationParameters(**kw), JaxGenerationParameters(**kw)


def make_batch(seed, v, b, d, m, shift=0.0, patch=11):
    """A random batch of the RayNet layout (``__graft_entry__.py:121-140``):
    patches uniform in [-shift, 1 - shift)."""
    rng = np.random.RandomState(seed)
    return {
        "X": (rng.rand(v, b, d, patch, patch, 3) - shift).astype(np.float32),
        "points": np.concatenate(
            [np.cumsum(rng.rand(b, d, 3).astype(np.float32), axis=1),
             np.ones((b, d, 1), np.float32)], axis=-1),
        "ray_voxel_indices": rng.randint(0, 6, (b, m, 3)).astype(np.int32),
        "ray_voxel_count": rng.randint(2, m + 1, (b,)).astype(np.int32),
        "y": np.eye(m, dtype=np.float32)[rng.randint(0, m, b)],
        "camera_centers": rng.rand(b, 4).astype(np.float32),
        "bbox": np.array([0, 0, 0, 6, 6, 6], dtype=np.float32),
    }


def _port(jstate, variables=None):
    """The JAX state's CNN variables as the port's state_dict."""
    return state_dict_from_flax(variables or {
        "params": jstate.params["cnn"], "batch_stats": jstate.batch_stats})


def _pair(v, d, m, **kw):
    """The JAX package's and the port's (state, train_fn, eval_fn), the
    port's CNN set to the JAX one's initial variables."""
    gp, jgp = _gps(v, d, m)
    jax_side = jax_build(jax.random.PRNGKey(0), jgp, jgp.grid_shape,
                         return_grads=True, **kw)
    port = build_end_to_end_training(1, gp, gp.grid_shape, return_grads=True,
                                     device="cpu", **kw)
    port[0].model.load_state_dict(_port(jax_side[0]))
    return jax_side, port


@pytest.mark.parametrize("v,d,m,train", [(3, 4, 8, True), (5, 8, 16, True),
                                         (4, 6, 12, False)])
def test_raynet_forward_matches_jax(v, d, m, train):
    """S_post, S_planes and S_vox, BatchNorm in training (batch statistics,
    centred patches) or evaluation mode (running statistics after a JAX
    step, patches in [0, 1))."""
    (jstate, jtrain, _), (state, _, _) = _pair(v, d, m, lr=1e-3)
    batch = make_batch(1, v, 12, d, m, shift=0.5 if train else 0.0)
    if not train:
        jstate, _ = jtrain(jstate, make_batch(2, v, 12, d, m))
        state.model.load_state_dict(_port(jstate))
    variables = {"params": jstate.params["cnn"],
                 "batch_stats": jstate.batch_stats}
    gamma = np.float32(0.031)
    want, waux, _ = jax_raynet_forward(
        jax_cnn_factory("simple_cnn")(), variables, gamma, batch["X"],
        batch["points"], batch["ray_voxel_indices"],
        batch["ray_voxel_count"], batch["bbox"], (6, 6, 6), train=train)
    t = batch_to_device(batch, "cpu")
    with torch.no_grad():
        got, aux = raynet_forward(
            state.model, torch.tensor(gamma), t["X"], t["points"],
            t["ray_voxel_indices"], t["ray_voxel_count"], t["bbox"],
            (6, 6, 6), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    for k in ("S_planes", "S_vox", "centers"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   err_msg=k, **FWD)
    assert got.shape == (12, m)


def assert_grads_match(port_grads, jgrads, jstate):
    """Every gradient leaf within rtol 1e-4 / atol 1e-5 of the largest."""
    want = _port(None, {"params": jgrads["cnn"],
                        "batch_stats": jstate.batch_stats})
    leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    scale = max(float(np.abs(g).max()) for g in leaves)
    for name, g in port_grads["cnn"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    if "gamma" in jgrads:
        np.testing.assert_allclose(float(port_grads["gamma"]),
                                   float(jgrads["gamma"]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg="gamma")
    else:
        assert port_grads["gamma"] is None


LOSSES = ["emd", "squared_emd", "mse", "categorical_crossentropy",
          "expected_squared_error"]
OPTIMIZERS = [dict(optimizer="Adam"),
              dict(optimizer="SGD", momentum=0.9, clipnorm=1e-3)]


@pytest.mark.parametrize("opt", OPTIMIZERS, ids=["Adam", "SGD-clipnorm"])
@pytest.mark.parametrize("train_with_gamma", [True, False],
                         ids=["gamma", "fixed"])
@pytest.mark.parametrize("loss", LOSSES)
def test_train_step_matches_jax(loss, train_with_gamma, opt):
    """One step from the same state on the same batch: loss, every
    gradient leaf (gamma's included), gamma after the update and its clip,
    the BatchNorm running statistics, the metrics' gamma, the step count."""
    (jstate, jtrain, _), (state, train, _) = _pair(
        4, 6, 12, lr=1e-3, loss=loss, gamma=0.031,
        train_with_gamma=train_with_gamma, bp_iterations=3, **opt)
    batch = make_batch(3, 4, 16, 6, 12, shift=0.5)
    jstate2, jm = jtrain(jstate, batch)
    state, m = train(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["gamma"]), float(jm["gamma"]),
                               rtol=1e-7)
    assert_grads_match(m["grads"], jm["grads"], jstate)
    if train_with_gamma:
        np.testing.assert_allclose(state.gamma.item(),
                                   float(jstate2.params["gamma"]),
                                   rtol=1e-5, atol=1e-7)
        assert 1e-5 <= state.gamma.item() <= 1 - 1e-5
        assert state.gamma.item() != 0.031
    else:
        assert state.gamma is None
    got = state.model.state_dict()
    for k, w in _port(jstate2).items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert state.step == 1


def test_eval_fn_matches_jax():
    """``eval_fn`` with the running statistics of a JAX step."""
    (jstate, jtrain, jeval), (state, _, evaluate) = _pair(
        3, 4, 8, lr=1e-3, gamma=0.031)
    jstate, _ = jtrain(jstate, make_batch(4, 3, 10, 4, 8, shift=0.5))
    state.model.load_state_dict(_port(jstate))
    with torch.no_grad():
        state.gamma.copy_(torch.tensor(float(jstate.params["gamma"])))
    batch = make_batch(5, 3, 10, 4, 8, shift=0.5)
    got, want = evaluate(state, batch), jeval(jstate, batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["gamma"]), float(want["gamma"]),
                               rtol=1e-7)


def _float64_grads(state, batch):
    """The port's gradients of the EMD step with the CNN, the patches and
    gamma in float64 (a copy of the state's module), and its S_post."""
    model = copy.deepcopy(state.model).double()
    gamma = torch.tensor(0.031, dtype=torch.float64, requires_grad=True)
    t = batch_to_device(batch, "cpu")
    S, _ = raynet_forward(model, gamma, t["X"].double(), t["points"],
                          t["ray_voxel_indices"], t["ray_voxel_count"],
                          t["bbox"], (6, 6, 6))
    emd(t["y"].double(), S).mean().backward()
    return ({n: p.grad for n, p in model.named_parameters()}, gamma.grad,
            S.detach())


def test_step_on_uncentred_patches():
    """Patches in [0, 1): each gradient leaf of the port is no farther from
    the float64 gradient than the JAX package's, or within the gradient
    bar of it; gamma's gradient within the bar of the JAX package's."""
    (jstate, jtrain, _), (state, train, _) = _pair(3, 4, 8, lr=1e-3,
                                                  gamma=0.031)
    batch = make_batch(0, 3, 16, 4, 8)
    g64, gamma64, S64 = _float64_grads(state, batch)
    t = batch_to_device(batch, "cpu")
    with torch.no_grad():
        S, _ = raynet_forward(copy.deepcopy(state.model), torch.tensor(0.031),
                              t["X"], t["points"], t["ray_voxel_indices"],
                              t["ray_voxel_count"], t["bbox"], (6, 6, 6))
    jS, _, _ = jax_raynet_forward(
        jax_cnn_factory("simple_cnn")(), {"params": jstate.params["cnn"],
                                          "batch_stats": jstate.batch_stats},
        np.float32(0.031), batch["X"], batch["points"],
        batch["ray_voxel_indices"], batch["ray_voxel_count"], batch["bbox"],
        (6, 6, 6))
    port_err = float((S.double() - S64).abs().max())
    jax_err = float((torch.as_tensor(np.array(jS)).double() - S64).abs().max())
    assert port_err <= max(jax_err, 1e-6), (port_err, jax_err)
    _, jm = jtrain(jstate, batch)
    state, m = train(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = _port(None, {"params": jm["grads"]["cnn"],
                        "batch_stats": jstate.batch_stats})
    scale = float(max(g.abs().max() for g in g64.values()))
    worse = []
    for name, g in m["grads"]["cnn"].items():
        port_err = float((g.double() - g64[name]).abs().max())
        jax_err = float((want[name].double() - g64[name]).abs().max())
        if port_err > max(jax_err, 1e-5 * scale):
            worse.append((name, port_err / scale, jax_err / scale))
    assert not worse, worse
    np.testing.assert_allclose(float(m["grads"]["gamma"]),
                               float(jm["grads"]["gamma"]), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(m["grads"]["gamma"]), float(gamma64),
                               rtol=1e-4)


@pytest.mark.parametrize("bp_iterations", [1, 3])
def test_remat_gives_equal_gradients(bp_iterations):
    """BP's gradients in S and gamma are the same with each sweep after the
    first recomputed in the backward pass (``remat``) and without."""
    batch = batch_to_device(make_batch(6, 3, 10, 4, 8), "cpu")
    S0 = torch.softmax(torch.as_tensor(np.random.RandomState(7).randn(
        10, 8).astype(np.float32)), dim=-1)
    grads = []
    for remat in (True, False):
        S = S0.clone().requires_grad_()
        gamma = torch.tensor(0.031, requires_grad=True)
        grid, msgs = mrf.belief_propagation(
            S, batch["ray_voxel_indices"], batch["ray_voxel_count"],
            (6, 6, 6), gamma=gamma, bp_iterations=bp_iterations,
            remat=remat)
        S_post = mrf.depth_estimate(
            S, flatten_voxel_indices(batch["ray_voxel_indices"], (6, 6, 6)),
            batch["ray_voxel_count"], msgs, grid.reshape(-1))
        emd(batch["y"], S_post).mean().backward()
        grads.append((S.grad, gamma.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert float(grads[0][1].abs()) > 0


@pytest.mark.parametrize("x", [0.0, 1e-5, 0.5, 1 - 1e-5, 1.0])
def test_bp_clip_gradient_is_jnp_clip(x):
    """The gradient of BP's clip is jnp.clip's, one half at a bound (where
    float32 values near 1 land, a few ulps apart), which Tensor.clamp
    would pass whole."""
    lo, hi = np.float32(1e-5), np.float32(1 - 1e-5)
    x = float(np.float32(x))
    t = torch.tensor(x, requires_grad=True)
    mrf._clip(t, float(lo), float(hi)).backward()
    want = jax.grad(lambda v: jax.numpy.clip(v, lo, hi))(np.float32(x))
    assert float(t.grad) == float(want)


def test_five_steps_lower_the_loss(mock_scene_dir):
    """It learns on a fixed batch of the mock scene, gamma moves inside its
    clip (as ``tests/test_training.py`` checks the JAX package)."""
    gp = GenerationParameters(
        depth_planes=4, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array([8, 8, 8], dtype=np.int32),
        max_number_of_marched_voxels=16, padding=11,
        sampling_type="sample_points_in_bbox",
        target_distribution_factory=get_target_distribution_factory("dirac"))
    sg = RayNetRandomSampleGenerator(
        get_sampling_scheme("sample_in_bbox")(gp), gp, [0], [], [],
        window=2, rng=np.random.RandomState(5), device="cpu")
    batch = RayNetBatchProvider(
        RestrepoDataset(str(mock_scene_dir.parent), device="cpu"),
        sg).get_batch_of_rays(3)
    state, train, evaluate = build_end_to_end_training(
        0, gp, gp.grid_shape, lr=1e-3, gamma=0.031, train_with_gamma=True,
        bp_iterations=2, device="cpu")
    losses = []
    for _ in range(5):
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert state.gamma.item() != 0.031
    assert 1e-5 <= state.gamma.item() <= 1 - 1e-5
    assert np.isfinite(float(evaluate(state, batch)["loss"]))


def test_patch_smaller_than_the_receptive_field_raises():
    gp, _ = _gps(3, 4, 8, patch=9)
    state, train, _ = build_end_to_end_training(0, gp, gp.grid_shape,
                                                device="cpu")
    with pytest.raises(ValueError, match="receptive field"):
        train(state, make_batch(0, 3, 4, 4, 8, patch=9))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gp, _ = _gps(3, 4, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        build_end_to_end_training(0, gp, gp.grid_shape, device="cuda")

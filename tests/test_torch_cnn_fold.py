"""``FeatureExtractor.predict`` with eval-mode BatchNorm folded into the
convolutions (``cnn.fold_batch_norm``): the features of the unfolded
stack, a cache that follows every change of the weights, and the model's
own parameters left unfolded.

BatchNorm statistics are drawn as the benchmark draws them
(``bench_torch.scene.cnn_weights``: scales 0.8-1.2, shifts and means
+-0.1, variances 0.8-1.2). Tolerance: rtol = atol = 1e-5 against the
unfolded float32 forward, and no farther from a float64 unfolded forward
than the float32 unfolded one plus 1e-6 (the fold only rounds its weights
once more).
"""
import copy

import numpy as np
import pytest
import torch

from bench_torch.scene import cnn_weights
from raynet_tpu_torch.models.cnn import cnn_factory, folds
from raynet_tpu_torch.models.convert import read_cnn_weights
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor

torch.set_num_threads(2)

FOLDED = [
    "simple_cnn",
    "dilated_cnn_receptive_field_25",
    "dilated_cnn_receptive_field_25_with_tanh",
]
IMAGES = 2


def _layers(name):
    """(filters, kernel, dilation) of each conv of factory ``name``."""
    return [(c.out_channels, c.kernel_size[0], c.dilation[0])
            for c in cnn_factory(name)(3).convs]


def _weights(name, seed):
    return cnn_weights(_layers(name), 3, seed, torch.device("cpu"))


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(IMAGES, 40, 52, 3) * 255).astype(np.uint8)


def _unfolded(model, images, dtype=torch.float32):
    """The stack's own eval-mode forward, channels last, in ``dtype``."""
    x = torch.as_tensor(images).to(dtype) / 255.0
    model = copy.deepcopy(model).eval().to(dtype)
    with torch.no_grad():
        return model(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", FOLDED)
def test_folded_predict_equals_the_unfolded_stack(name):
    fe = FeatureExtractor(name, state_dict=_weights(name, 7), device="cpu")
    images = _images()
    got = fe.predict(images)
    want = _unfolded(fe.model, images)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    exact = _unfolded(fe.model, images, torch.float64)
    fold_err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    assert fold_err <= plain_err + 1e-6
    assert fe.fold_builds == 1
    assert fe.folded_layers == len(fe.model.convs) * IMAGES


@pytest.mark.parametrize("name", ["simple_cnn_ln", "hartmann_cnn"])
def test_a_stack_that_cannot_fold_keeps_its_own_forward(name):
    fe = FeatureExtractor(name, seed=3, device="cpu")
    with torch.no_grad():  # LayerNorm's gamma and shifts off their defaults
        for p in fe.model.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator().manual_seed(1)))
    images = _images(1)
    assert not folds(fe.model)
    assert torch.equal(fe.predict(images), _unfolded(fe.model, images))
    assert fe.folded_layers == fe.fold_builds == 0


def test_no_fold_in_training_mode():
    """A stack in training mode runs its own forward (batch statistics);
    ``ConvBNStack.forward`` is what the training steps call."""
    fe = FeatureExtractor("simple_cnn", state_dict=_weights("simple_cnn", 2),
                          device="cpu")
    fe.model.train()
    assert not folds(fe.model)
    fe.predict(_images())
    assert fe.folded_layers == 0
    assert fe.fold_builds == 1


def test_repeated_calls_build_the_fold_once():
    fe = FeatureExtractor("simple_cnn", state_dict=_weights("simple_cnn", 4),
                          device="cpu")
    images = _images()
    first = fe.predict(images)
    assert torch.equal(fe.predict(images), first)
    assert fe.fold_builds == 1
    assert fe.folded_layers == 2 * 5 * IMAGES


@pytest.mark.parametrize("route", ["load_state_dict", "load_weights",
                                   "tensor_replaced"])
def test_the_fold_follows_new_weights(route, tmp_path):
    """New weights, loaded after a first call, give their own unfolded
    features and one more build; ``tensor_replaced`` swaps a parameter's
    tensor as ``model.to(device)`` does."""
    fe = FeatureExtractor("simple_cnn", state_dict=_weights("simple_cnn", 5),
                          device="cpu")
    images = _images()
    before = fe.predict(images)
    other = _weights("simple_cnn", 6)
    if route == "load_state_dict":
        fe.model.load_state_dict(other)
    elif route == "load_weights":
        FeatureExtractor("simple_cnn", state_dict=other,
                         device="cpu").save_weights(tmp_path / "w.msgpack")
        fe.load_weights(tmp_path / "w.msgpack")
    else:
        for key, t in fe.model.state_dict(keep_vars=True).items():
            t.data = other[key].clone()
    builds = fe.fold_builds
    got = fe.predict(images)
    assert fe.fold_builds == builds + 1
    ref = cnn_factory("simple_cnn")(3)
    ref.load_state_dict(other)
    want = _unfolded(ref, images)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, before, rtol=1e-3, atol=1e-3)


def test_the_model_keeps_the_unfolded_weights(tmp_path):
    """After a call, ``state_dict`` and ``save_weights`` give the weights
    that were loaded, bit for bit."""
    weights = _weights("simple_cnn", 9)
    fe = FeatureExtractor("simple_cnn", state_dict=weights, device="cpu")
    fe.predict(_images())
    sd = fe.model.state_dict()
    assert sd.keys() == weights.keys()
    for key, value in weights.items():
        assert torch.equal(sd[key], value), key
    fe.save_weights(tmp_path / "w.msgpack")
    saved = read_cnn_weights(tmp_path / "w.msgpack")
    for key, value in weights.items():
        if key.endswith("num_batches_tracked"):
            continue
        assert torch.equal(torch.as_tensor(np.asarray(saved[key])), value), key


@pytest.mark.parametrize("factory", ["raynet", "multi_view_cnn_voxel_space"])
def test_passes_sharing_an_extractor_build_the_fold_once(factory):
    """As the benchmark runs them: passes back to back, each through a
    new pass object over one extractor; 5 folded layers an image
    featurised (one "Features computation" phase an image)."""
    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.inference.forward_pass import (
        get_forward_pass_factory,
    )

    scene = RingScene(4, 24, 32, 55.0, angle_step=0.3, seed=1)
    gp = GenerationParameters(
        depth_planes=4, neighbors=2, patch_shape=(11, 11, 3),
        grid_shape=np.array([8, 8, 4], dtype=np.int32),
        max_number_of_marched_voxels=24, padding=11, gamma_mrf=0.05)
    fe = FeatureExtractor("simple_cnn", state_dict=_weights("simple_cnn", 1),
                          device="cpu")
    images = 0
    for _ in range(3):
        fp = get_forward_pass_factory(factory)(fe, gp, None,
                                               scene.image_shape, 200,
                                               device="cpu")
        for _ in fp.forward_pass(scene, (0, 3, 1)):
            pass
        images += fp.timer.counts["Features computation"]
    assert images == 3 * 4
    assert fe.fold_builds == 1
    assert fe.folded_layers == 5 * images

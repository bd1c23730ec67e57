"""Parity of the port's CNN feature extractors with the JAX package's:
the JAX FeatureExtractor's flax variables are converted with
``state_dict_from_flax`` and both run the same seeded images.

Tolerance: rtol=atol=1e-5 on the float32 features (XLA's and PyTorch's CPU
convolutions sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
    zeropad_images as jax_zeropad_images,
)
from raynet_tpu_torch.models.convert import (
    read_flax_msgpack,
    state_dict_from_flax,
)
from raynet_tpu_torch.models.feature_extractor import (
    FeatureExtractor,
    zeropad_images,
)

torch.set_num_threads(2)

FACTORIES = [
    "simple_cnn",
    "simple_cnn_ln",
    "dilated_cnn_receptive_field_25",
    "dilated_cnn_receptive_field_25_with_tanh",
]


def _images(dtype, seed=0):
    rng = np.random.RandomState(seed)
    u8 = (rng.rand(2, 37, 45, 3) * 255).astype(np.uint8)
    if dtype == "u8":
        return u8
    return u8.astype(np.float32) / np.float32(255.0)


def _perturbed_variables(jfe, seed):
    """The JAX extractor's variables with every leaf that starts at an
    identity default (BatchNorm stats and scales, LayerNorm gamma, biases)
    moved off it, so a mis-mapped parameter cannot hide; the conv kernels
    are already random."""
    import jax

    rng = np.random.RandomState(seed)

    def perturb(path, x):
        x = np.asarray(x)
        name = str(path[-1])
        if "kernel" in name:
            return x
        if "var" in name:
            return (0.5 + rng.rand(*x.shape)).astype(x.dtype)
        return (x + 0.1 * rng.randn(*x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(perturb, jfe.variables)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("name", FACTORIES)
def test_features_match_jax(name, dtype):
    jfe = JaxFeatureExtractor(name, seed=0)
    jfe = JaxFeatureExtractor(name, variables=_perturbed_variables(jfe, 1))
    tfe = FeatureExtractor(
        name, state_dict=state_dict_from_flax(jfe.variables), device="cpu"
    )
    images = _images(dtype)
    jout = np.asarray(jfe.predict(images))
    tout = tfe.predict(images)
    assert tout.shape == jout.shape and tout.dtype == torch.float32
    assert tfe.feature_dim == jout.shape[-1] == 32
    np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-5, atol=1e-5)


def test_bf16_output_matches_jax():
    jfe = JaxFeatureExtractor("simple_cnn", seed=3, output_dtype=jnp.bfloat16)
    tfe = FeatureExtractor(
        "simple_cnn", state_dict=state_dict_from_flax(jfe.variables),
        output_dtype=torch.bfloat16, device="cpu",
    )
    images = _images("u8", seed=2)
    jout = np.asarray(jfe.predict(images).astype(jnp.float32))
    tout = tfe.predict(images)
    assert tout.dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) where the f32 values round differently
    np.testing.assert_allclose(
        tout.to(torch.float32).numpy(), jout, rtol=2 ** -7, atol=1e-5
    )


def test_load_weights_reads_flax_msgpack(tmp_path):
    jfe = JaxFeatureExtractor("simple_cnn_ln", seed=5)
    jfe = JaxFeatureExtractor(
        "simple_cnn_ln", variables=_perturbed_variables(jfe, 2)
    )
    path = tmp_path / "weights.msgpack"
    jfe.save_weights(str(path))
    tree = read_flax_msgpack(str(path))
    assert set(tree) == {"params"}
    tfe = FeatureExtractor.from_weights("simple_cnn_ln", str(path),
                                        device="cpu")
    images = _images("f32", seed=4)
    np.testing.assert_allclose(
        tfe.predict(images).numpy(), np.asarray(jfe.predict(images)),
        rtol=1e-5, atol=1e-5,
    )


def test_seeded_weights_are_reproducible():
    a = FeatureExtractor("simple_cnn", seed=7, device="cpu")
    b = FeatureExtractor("simple_cnn", seed=7, device="cpu")
    c = FeatureExtractor("simple_cnn", seed=8, device="cpu")
    images = _images("u8")
    assert torch.equal(a.predict(images), b.predict(images))
    assert not torch.equal(a.predict(images), c.predict(images))


def test_zeropad_images_matches_jax():
    class Im:
        def __init__(self, u8):
            self.image_u8 = u8
            self.image = u8.astype(np.float32) / np.float32(255.0)

    ims = [Im(x) for x in _images("u8")]
    for pad in (0, 11):
        out = zeropad_images(ims, pad)
        ref = jax_zeropad_images(ims, pad)
        assert out.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        FeatureExtractor("simple_cnn", device="cuda")

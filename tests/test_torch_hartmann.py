"""The port's Hartmann half against the JAX package's, on the CPU: the
Hartmann and multi-view similarity nets with converted flax weights, the
feature extractor and match model at their boundaries, the patch gathers
and the ``hartmann_fp`` pass on the mock scene through both of its routes.

Tolerances: rtol = atol = 1e-5 on float32 network outputs (XLA's and
PyTorch's CPU convolutions sum in different orders); patch gathers and the
stub route's depth maps exactly; the CNN route's depth maps >= 0.999 of the
pixels within 1e-3 relative (the ROADMAP's depth bar), masks identical.
"""
import jax
import numpy as np
import pytest
import torch

from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
)
from raynet_tpu.common.sampling_schemes import (
    get_sampling_scheme as jax_scheme,
)
from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.inference import get_forward_pass_factory as jax_factory
from raynet_tpu.models import cnn as jcnn
from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
    HartmannModel as JaxHartmannModel,
    upsample_features as jax_upsample,
)
from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.image import gather_patches, padded_images
from raynet_tpu_torch.common.sampling_schemes import get_sampling_scheme
from raynet_tpu_torch.common.scene import RestrepoScene
from raynet_tpu_torch.inference import (
    HartmannForwardPass,
    get_forward_pass_factory,
)
from raynet_tpu_torch.models import cnn
from raynet_tpu_torch.models.convert import (
    flax_from_similarity_state_dict,
    hartmann_state_dict_from_flax,
    read_flax_msgpack,
    similarity_state_dict_from_flax,
    state_dict_from_flax,
    write_flax_msgpack,
)
from raynet_tpu_torch.models.feature_extractor import (
    FeatureExtractor,
    HartmannModel,
    upsample_features,
)
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed(variables, seed):
    """Every non-kernel leaf moved off its initial value (zero biases,
    unit BatchNorm stats), so a mis-mapped parameter cannot hide."""
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        x = np.asarray(x)
        name = str(path[-1])
        if "kernel" in name:
            return x
        if "var" in name:
            return (0.5 + rng.rand(*x.shape)).astype(x.dtype)
        return (x + 0.1 * rng.randn(*x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _nchw(x):
    """channels-last patches (..., h, w, C) -> (..., C, h, w) tensor."""
    x = torch.as_tensor(np.asarray(x))
    return x.movedim(-1, -3).contiguous()


def test_hartmann_cnn_feature_extractor_matches_jax():
    jfe = JaxFeatureExtractor("hartmann_cnn", seed=0)
    variables = _perturbed(jfe.variables, 1)
    jfe = JaxFeatureExtractor("hartmann_cnn", variables=variables)
    tfe = FeatureExtractor("hartmann_cnn", device="cpu",
                           state_dict=state_dict_from_flax(variables))
    # any leading dims, as flax takes them: quintuples of patches
    x = np.random.RandomState(2).rand(2, 5, 32, 32, 3).astype(np.float32)
    jout, tout = np.asarray(jfe.predict(x)), tfe.predict(x)
    assert tout.shape == jout.shape == (2, 5, 5, 5, 64)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)
    assert tfe.feature_dim == 64 and tfe.first_conv_channels == 32
    assert cnn.cnn_output_padding("hartmann_cnn") is None
    assert cnn.cnn_output_padding("simple_cnn") == 10


def test_hartmann_model_matches_jax():
    jm = JaxHartmannModel(seed=0)
    variables = _perturbed(jm.variables, 3)
    jm = JaxHartmannModel(variables=variables)
    tm = HartmannModel(state_dict=hartmann_state_dict_from_flax(variables),
                       device="cpu")
    # 36x36 patches leave a 2x2 head map, so the layout is tested too
    for shape in ((3, 5, 32, 32, 3), (2, 5, 36, 36, 3)):
        x = np.random.RandomState(4).rand(*shape).astype(np.float32)
        jout, tout = np.asarray(jm.predict(x)), tm.predict(x)
        assert tout.shape == jout.shape  # channels last: (B, h', w', 2)
        np.testing.assert_allclose(tout.numpy(), jout, **TOL)
        np.testing.assert_allclose(tout.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_hartmann_similarity_net_rejects_small_patches():
    net = cnn.HartmannSimilarityNet()
    with pytest.raises(ValueError, match="at least 32x32"):
        net(torch.zeros(1, 5, 3, 31, 31))
    with pytest.raises(ValueError):
        jcnn.HartmannSimilarityNet().init(
            jax.random.PRNGKey(0), np.zeros((1, 5, 31, 31, 3), np.float32))


@pytest.mark.parametrize("reducer", ["average", "max", "topK"])
@pytest.mark.parametrize("merge", ["dot-product", "cosine-similarity"])
@pytest.mark.parametrize("cnn_name", ["simple_cnn", "simple_cnn_ln"])
def test_multi_view_similarity_net_matches_jax(cnn_name, merge, reducer):
    jnet = jcnn.MultiViewSimilarityNet(cnn_name=cnn_name, reducer=reducer,
                                       merge_layer=merge)
    rng = np.random.RandomState(5)
    x1, x2 = (rng.rand(2, 4, 6, 11, 11, 3).astype(np.float32)
              for _ in range(2))
    variables = _perturbed(jnet.init(jax.random.PRNGKey(0), x1, x2), 6)
    jout = np.asarray(jnet.apply(variables, x1, x2, train=False))
    tnet = cnn.MultiViewSimilarityNet(cnn_name, reducer, merge)
    tnet.load_state_dict(similarity_state_dict_from_flax(variables))
    with torch.no_grad():
        tout = tnet.eval()(_nchw(x1), _nchw(x2))
    assert tout.shape == jout.shape == (2, 4)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


def test_get_nn_and_factories():
    assert cnn.get_nn("hartmann") is cnn.HartmannSimilarityNet
    assert cnn.get_nn("simple_nn_for_training") is cnn.MultiViewSimilarityNet
    assert isinstance(cnn.get_nn("simple_cnn")(cnn_name="hartmann_cnn"),
                      cnn.HartmannCNN)
    with pytest.raises(ValueError):
        cnn.Reducer("median")


def test_weight_files_round_trip_with_flax(tmp_path):
    """Weight files the port writes are the JAX package's layout, read back
    by flax, and the JAX package's files load into the port's nets."""
    import flax

    jm = JaxHartmannModel(seed=1)
    tm = HartmannModel(
        state_dict=hartmann_state_dict_from_flax(jm.variables), device="cpu")
    path = str(tmp_path / "hartmann.msgpack")
    tm.save_weights(path)
    with open(path, "rb") as f:
        back = flax.serialization.msgpack_restore(f.read())
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(jm.variables["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    tm2 = HartmannModel(seed=5, device="cpu")
    tm2.load_weights(path)
    for k, v in tm.model.state_dict().items():
        assert torch.equal(v, tm2.model.state_dict()[k]), k

    jnet = jcnn.MultiViewSimilarityNet(cnn_name="simple_cnn")
    x = np.zeros((1, 2, 3, 11, 11, 3), np.float32)
    variables = _perturbed(jnet.init(jax.random.PRNGKey(0), x, x), 2)
    sd = similarity_state_dict_from_flax(variables)
    path = str(tmp_path / "mvcnn.msgpack")
    write_flax_msgpack(path, flax_from_similarity_state_dict(sd, "simple_cnn"))
    with open(path, "rb") as f:
        back = flax.serialization.from_bytes(variables, f.read())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a FeatureExtractor takes the similarity net's CNN out of the file
    fe = FeatureExtractor("simple_cnn", device="cpu")
    fe.load_weights(path)
    want = state_dict_from_flax(read_flax_msgpack(path))
    for k, v in fe.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(v, want[k]), k
            assert torch.equal(v, sd["cnn." + k]), k


def test_upsample_features_matches_jax():
    f = np.random.RandomState(0).rand(2, 3, 4, 5).astype(np.float32)
    up = upsample_features(torch.as_tensor(f), "hartmann_cnn")
    assert up.shape == (2, 12, 16, 5)
    np.testing.assert_array_equal(up.numpy(), jax_upsample(f, "hartmann_cnn"))
    same = torch.as_tensor(f)
    assert upsample_features(same, "simple_cnn") is same


@pytest.mark.parametrize("patch", [(5, 5), (4, 7), (32, 32)])
def test_gather_patches_equals_image_patch(mock_scene_dir, patch):
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    images = [scene.get_image(i) for i in range(3)]
    rng = np.random.RandomState(1)
    # centres inside, on the border and far outside the 48x36 images
    centers = np.stack([np.stack([rng.randint(-50, 100, 64),
                                  rng.randint(-50, 90, 64)], -1)
                        for _ in images]).astype(np.int32)
    padded = padded_images(
        torch.as_tensor(np.stack([im.image for im in images])), patch)
    got = gather_patches(padded, torch.as_tensor(centers), patch)
    assert got.shape == (64, 3) + patch + (3,)
    for k in range(64):
        for v, im in enumerate(images):
            ref = im.patch(np.array([[centers[v, k, 0]], [centers[v, k, 1]],
                                     [1]]), patch, expand_patch=True)
            np.testing.assert_array_equal(got[k, v].numpy(), ref)


class TinyQuintupleScorer:
    """The JAX package's test stub (``tests/test_hartmann_fp.py``):
    (B, V, ph, pw, C) -> (B, 1, 1, 2), the mean absolute deviation across
    views (lower = more consistent). It sums in float64 and rounds to
    float32: numpy's float32 sum order depends on the chunk's shape, and
    the two passes cut their chunks differently."""

    cnn_name = "tiny"

    def predict(self, patches):
        p = np.asarray(patches, dtype=np.float64)
        dev = np.abs(p - p.mean(axis=1, keepdims=True)).mean(axis=(1, 2, 3, 4))
        dev = dev.astype(np.float32)
        return np.stack([-dev, dev], axis=-1).reshape(-1, 1, 1, 2)


def _params(module, d, patch):
    return module(depth_planes=d, neighbors=4, patch_shape=patch,
                  padding=patch[0], sampling_type="sample_points_in_bbox")


def test_hartmann_pass_stub_equals_jax(mock_scene_dir):
    gp, jgp = (_params(m, 4, (11, 11, 3))
               for m in (GenerationParameters, JaxGenerationParameters))
    jscene = JaxRestrepoScene(str(mock_scene_dir))
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    jfp = jax_factory("hartmann_fp")(
        TinyQuintupleScorer(), jgp, jax_scheme("sample_in_bbox")(jgp),
        jscene.image_shape, rays_batch=4096)
    fp = get_forward_pass_factory("hartmann_fp")(
        TinyQuintupleScorer(), gp, get_sampling_scheme("sample_in_bbox")(gp),
        scene.image_shape, rays_batch=1000, device="cpu")
    assert isinstance(fp, HartmannForwardPass)
    jmaps = list(jfp.forward_pass(jscene, (0, 2, 1)))
    maps = list(fp.forward_pass(scene, (0, 2, 1)))
    for a, b in zip(maps, jmaps):
        assert a.shape == (H, W) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert a.max() <= 800
    assert set(fp.timer.totals) >= {"Sampling", "Projection", "Patch gather",
                                    "Patch net", "Per-pixel depth estimation"}


def test_hartmann_pass_cnn_route_matches_jax(mock_scene_dir):
    """The JAX CLI's route: a FeatureExtractor('hartmann_cnn') as the model,
    a quintuple scored by channel 0 of its features."""
    gp, jgp = (_params(m, 2, (32, 32, 3))
               for m in (GenerationParameters, JaxGenerationParameters))
    jfe = JaxFeatureExtractor("hartmann_cnn", seed=0)
    tfe = FeatureExtractor("hartmann_cnn", device="cpu",
                           state_dict=state_dict_from_flax(jfe.variables))
    jscene = JaxRestrepoScene(str(mock_scene_dir))
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    jfp = jax_factory("hartmann_fp")(
        jfe, jgp, jax_scheme("sample_in_bbox")(jgp), jscene.image_shape,
        rays_batch=1728)
    fp = HartmannForwardPass(
        tfe, gp, get_sampling_scheme("sample_in_bbox")(gp), scene.image_shape,
        rays_batch=1728, device="cpu")
    a = next(iter(fp.forward_pass(scene, (0, 1, 1))))
    b = next(iter(jfp.forward_pass(jscene, (0, 1, 1))))
    assert a.shape == b.shape == (H, W)
    assert np.array_equal(a > 0, b > 0)
    assert np.mean(np.abs(a - b) <= 1e-3 * np.abs(b)) >= 0.999


def test_hartmann_cuda_request_without_card_raises(mock_scene_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    gp = _params(GenerationParameters, 2, (32, 32, 3))
    with pytest.raises(RuntimeError, match="is_available"):
        HartmannModel()
    with pytest.raises(RuntimeError, match="is_available"):
        HartmannForwardPass(TinyQuintupleScorer(), gp, None, (H, W))
    with pytest.raises(RuntimeError, match="is_available"):
        get_sampling_scheme("tf_sample_in_bbox")(gp)

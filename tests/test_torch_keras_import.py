"""The port's Keras .hdf5 import (``raynet_tpu_torch.models.keras_import``)
against the JAX package's (``raynet_tpu.models.keras_import``).

The tests write Keras-layout files themselves: the five factories from
the JAX model's own variable tree (every identity default moved off it),
and ``simple_cnn`` also with the random Keras weights of
``tests/test_keras_import.py``. Each file is read by both packages. Bars:
the port's state_dict ``torch.equal`` to ``convert.state_dict_from_flax``
of the JAX conversion; its CPU features within rtol 5e-3 / atol 1e-3 of a
float64 numpy evaluation of the Keras arithmetic
(``tests/test_keras_import.py``'s bar) and, from the variable trees (O(1)
features), within rtol = atol = 1e-5 of the JAX FeatureExtractor's
(``tests/test_torch_cnn.py``'s bar). The random Keras weights grow the
features to ~150, where the two packages' float32 sums differ by up to
3e-4, so those are held to JAX by the equal state_dicts and the oracle.
Errors: the same type and message.
"""
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

import jax  # noqa: E402

from raynet_tpu.models import keras_import as jax_keras  # noqa: E402
from raynet_tpu.models.feature_extractor import (  # noqa: E402
    FeatureExtractor as JaxFeatureExtractor,
)
from raynet_tpu.scripts import forward_pass as jax_cli  # noqa: E402
from raynet_tpu_torch.models.cnn import cnn_factory  # noqa: E402
from raynet_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from raynet_tpu_torch.models.feature_extractor import (  # noqa: E402
    FeatureExtractor,
)
from raynet_tpu_torch.models.keras_import import (  # noqa: E402
    keras_state_dict_for_cnn,
    read_keras_tree,
)
from raynet_tpu_torch.scripts import forward_pass as port_cli  # noqa: E402
from test_keras_import import (  # noqa: E402
    _numpy_simple_cnn,
    _write_keras_simple_cnn,
)

torch.set_num_threads(2)

FACTORIES = [
    "simple_cnn",
    "simple_cnn_ln",
    "dilated_cnn_receptive_field_25",
    "dilated_cnn_receptive_field_25_with_tanh",
    "hartmann_cnn",
]
LAYOUTS = ["flat", "model", "submodel"]
KERAS_KIND = {"Conv": "conv2d", "BatchNorm": "batch_normalization",
              "LayerNormalization": "layer_normalization"}


def _perturbed_variables(name, seed=1):
    """The JAX extractor's variables with every leaf that starts at an
    identity default moved off it (conv kernels are random already)."""
    jfe = JaxFeatureExtractor(name, seed=0)
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        x = np.asarray(x)
        leaf = str(path[-1])
        if "kernel" in leaf:
            return x
        if "var" in leaf:
            return (0.5 + rng.rand(*x.shape)).astype(x.dtype)
        return (x + 0.1 * rng.randn(*x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(perturb, jfe.variables)


def _layers(variables):
    """The (kind, index, params, stats) of a flax CNN tree, in model order:
    conv i, then norm i."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    if "_ConvBNStack_0" in params:
        params = params["_ConvBNStack_0"]
        stats = stats.get("_ConvBNStack_0", {})
    out = []
    for i in range(sum(k.startswith("Conv_") for k in params)):
        out.append(("Conv", i, params["Conv_%d" % i], None))
        for kind in ("BatchNorm", "LayerNormalization"):
            key = "%s_%d" % (kind, i)
            if key in params:
                out.append((kind, i, params[key], stats.get(key)))
    return out


def _write_from_flax(path, variables, layout, first=8):
    """A Keras 2 file of a flax CNN tree, layers numbered from ``first``
    (from 8, h5py's alphabetical order is not the model's:
    conv2d_10 < conv2d_8); LayerNormalization's gamma stored as (1,)."""
    with h5py.File(path, "w") as f:
        if layout == "flat":
            root = f
        elif layout == "model":
            root = f.create_group("model_weights")
        else:
            root = f.create_group("model_weights").create_group("model_1")
        names = []
        for kind, i, p, st in _layers(variables):
            name = "%s_%d" % (KERAS_KIND[kind], first + i)
            g = root.create_group(name)
            names.append(name)
            if kind == "Conv":
                g.create_dataset("kernel:0", data=np.asarray(p["kernel"]))
                g.create_dataset("bias:0", data=np.asarray(p["bias"]))
            elif kind == "BatchNorm":
                g.create_dataset("gamma:0", data=np.asarray(p["scale"]))
                g.create_dataset("beta:0", data=np.asarray(p["bias"]))
                g.create_dataset("moving_mean:0", data=np.asarray(st["mean"]))
                g.create_dataset("moving_variance:0",
                                 data=np.asarray(st["var"]))
            else:
                g.create_dataset("gamma:0",
                                 data=np.asarray(p["gamma"]).reshape(1))
                g.create_dataset("bias:0", data=np.asarray(p["bias"]))
        if layout == "flat":
            f.attrs["layer_names"] = np.array([n.encode() for n in names])


def _jax_state_dict(path, name):
    jfe = JaxFeatureExtractor(name, seed=0)
    return state_dict_from_flax(
        jax_keras.keras_variables_for_cnn(path, jfe.variables))


def _assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# the dilation of each conv of the four conv stacks
_DILATIONS = {
    "simple_cnn": [1] * 5,
    "simple_cnn_ln": [1] * 5,
    "dilated_cnn_receptive_field_25": [1, 1, 2, 1, 1, 1, 1],
    "dilated_cnn_receptive_field_25_with_tanh": [1, 1, 2, 1, 1, 1, 1],
}


def _conv_valid(x, k, b, dilation=1):
    kh, kw = k.shape[:2]
    n, h, w, _ = x.shape
    out = np.zeros((n, h - dilation * (kh - 1), w - dilation * (kw - 1),
                    k.shape[3]))
    for dy in range(kh):
        for dx in range(kw):
            patch = x[:, dy * dilation: dy * dilation + out.shape[1],
                      dx * dilation: dx * dilation + out.shape[2]]
            out += np.einsum("nhwc,cf->nhwf", patch, k[dy, dx])
    return out + b


def _numpy_cnn(x, name, variables, eps=1e-3):
    """Keras inference arithmetic in float64 from a flax CNN tree: VALID
    convs, BatchNorm with the moving statistics or the reference's layer
    norm (std + eps), the activation between layers and none after the
    last; hartmann_cnn: conv5-tanh-maxpool2 twice."""
    x = x.astype(np.float64)
    layers = _layers(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), variables))
    if name == "hartmann_cnn":
        for _, _, p, _ in layers:
            x = np.tanh(_conv_valid(x, p["kernel"], p["bias"]))
            n, h, w, c = x.shape
            x = x[:, : h // 2 * 2, : w // 2 * 2].reshape(
                n, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))
        return x
    dilations = _DILATIONS[name]
    for i, dilation in enumerate(dilations):
        conv = layers[2 * i][2]
        kind, _, p, st = layers[2 * i + 1]
        x = _conv_valid(x, conv["kernel"], conv["bias"], dilation)
        if kind == "BatchNorm":
            x = p["scale"] * (x - st["mean"]) / np.sqrt(st["var"] + eps) \
                + p["bias"]
        else:
            axes = (1, 2, 3)
            std = x.std(axis=axes, keepdims=True) + eps
            x = p["gamma"] * (x - x.mean(axis=axes, keepdims=True)) / std \
                + p["bias"]
        if i < len(dilations) - 1:
            x = np.tanh(x) if name.endswith("tanh") else np.maximum(x, 0.0)
    return x


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", FACTORIES)
def test_keras_file_maps_like_jax(tmp_path, name, layout):
    path = str(tmp_path / "weights.hdf5")
    _write_from_flax(path, _perturbed_variables(name), layout)
    want = _jax_state_dict(path, name)
    got = keras_state_dict_for_cnn(path, cnn_factory(name)())
    _assert_state_dicts_equal(got, want)

    # the user surface: load_weights of an .hdf5 file, then predict
    fe = FeatureExtractor(name, device="cpu")
    fe.load_weights(path)
    _assert_state_dicts_equal(fe.model.state_dict(), want)
    jfe = JaxFeatureExtractor(name, seed=0)
    jfe.load_weights(path)
    x = np.random.RandomState(2).rand(2, 29, 31, 3).astype(np.float32)
    tout = fe.predict(x).numpy()
    jout = np.asarray(jfe.predict(x))
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout, _numpy_cnn(x, name, jfe.variables),
                               rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_keras_test_weights_map_like_jax(tmp_path, layout):
    path = str(tmp_path / "weights.hdf5")
    layers = _write_keras_simple_cnn(path, np.random.RandomState(0),
                                     layout=layout)
    fe = FeatureExtractor("simple_cnn", device="cpu")
    fe.load_weights(path)
    _assert_state_dicts_equal(fe.model.state_dict(),
                              _jax_state_dict(path, "simple_cnn"))
    x = np.random.RandomState(2).rand(2, 21, 23, 3).astype(np.float32)
    np.testing.assert_allclose(fe.predict(x).numpy(),
                               _numpy_simple_cnn(x, layers),
                               rtol=5e-3, atol=1e-3)


def test_theano_ordered_kernels_are_taken_as_oihw(tmp_path):
    hwio, oihw = str(tmp_path / "tf.hdf5"), str(tmp_path / "th.hdf5")
    for path in (hwio, oihw):
        _write_keras_simple_cnn(path, np.random.RandomState(0), layout="flat")
    with h5py.File(oihw, "r+") as f:
        for i in range(5):
            g = f["conv2d_%d" % (i + 1,)]
            k = np.asarray(g["kernel:0"])
            del g["kernel:0"]
            g.create_dataset("kernel:0", data=k.transpose(3, 2, 0, 1))
    got = keras_state_dict_for_cnn(oihw, cnn_factory("simple_cnn")())
    _assert_state_dicts_equal(got, _jax_state_dict(oihw, "simple_cnn"))
    _assert_state_dicts_equal(
        got, keras_state_dict_for_cnn(hwio, cnn_factory("simple_cnn")()))


def _wrong_cin(path):
    _write_keras_simple_cnn(path, np.random.RandomState(0), layout="flat",
                            cin=1)


def _partial(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("conv2d_1")
        g.create_dataset("kernel:0", data=np.random.RandomState(0).randn(
            3, 3, 3, 32).astype(np.float32))
        g.create_dataset("bias:0", data=np.zeros(32, np.float32))


def _extra_layer(path):
    _write_keras_simple_cnn(path, np.random.RandomState(0), layout="model")
    with h5py.File(path, "r+") as f:
        g = f["model_weights"].create_group("conv2d_6")
        g.create_dataset("kernel:0", data=np.zeros((3, 3, 32, 32), np.float32))


def _batchnorm_without_gamma(path):
    _write_keras_simple_cnn(path, np.random.RandomState(0), layout="submodel")
    with h5py.File(path, "r+") as f:
        del f["model_weights/sequential_1/batch_normalization_3/gamma:0"]


@pytest.mark.parametrize("write, name, error, match", [
    (_wrong_cin, "simple_cnn", ValueError, "shape"),
    (_partial, "simple_cnn", ValueError, "missing"),
    (_partial, "hartmann_cnn", ValueError, "shape"),
    (_extra_layer, "simple_cnn", ValueError, "no such parameter"),
    (_batchnorm_without_gamma, "simple_cnn", KeyError, "gamma"),
])
def test_errors_raised_where_jax_raises(tmp_path, write, name, error, match):
    path = str(tmp_path / "bad.hdf5")
    write(path)
    jfe = JaxFeatureExtractor(name, seed=0)
    with pytest.raises(error, match=match) as want:
        jax_keras.keras_variables_for_cnn(path, jfe.variables)
    with pytest.raises(error, match=match) as got:
        keras_state_dict_for_cnn(path, cnn_factory(name)())
    assert str(got.value) == str(want.value)
    with pytest.raises(error, match=match):
        FeatureExtractor(name, device="cpu").load_weights(path)


@pytest.mark.parametrize("name", FACTORIES)
def test_save_weights_is_read_by_the_jax_package(tmp_path, name):
    fe = FeatureExtractor(name, seed=4, device="cpu")
    path = str(tmp_path / "cnn.msgpack")
    fe.save_weights(path)
    jfe = JaxFeatureExtractor(name, seed=0)
    jfe.load_weights(path)
    _assert_state_dicts_equal(state_dict_from_flax(jfe.variables),
                              fe.model.state_dict())
    x = np.random.RandomState(5).rand(1, 29, 31, 3).astype(np.float32)
    np.testing.assert_allclose(fe.predict(x).numpy(),
                               np.asarray(jfe.predict(x)),
                               rtol=1e-5, atol=1e-5)
    back = FeatureExtractor(name, seed=9, device="cpu")
    back.load_weights(path)
    _assert_state_dicts_equal(back.model.state_dict(), fe.model.state_dict())


def test_in_memory_tree_needs_no_h5py(tmp_path, monkeypatch):
    path = str(tmp_path / "weights.hdf5")
    _write_from_flax(path, _perturbed_variables("simple_cnn_ln"), "submodel")
    tree = read_keras_tree(path)
    assert set(tree["layer_names"]) == {"", "model_weights"}
    assert all(isinstance(v, np.ndarray) for v in tree["datasets"].values())
    want = keras_state_dict_for_cnn(path, cnn_factory("simple_cnn_ln")())
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        read_keras_tree(path)
    got = keras_state_dict_for_cnn(tree, cnn_factory("simple_cnn_ln")())
    _assert_state_dicts_equal(got, want)


def test_forward_cli_hdf5_equals_the_msgpack_route(tmp_path, mock_scene_dir):
    """raynet_forward_torch --weight_file x.hdf5 gives the depth maps of the
    same CLI with the msgpack file the JAX package's FeatureExtractor
    writes from that .hdf5."""
    hdf5 = str(tmp_path / "published.hdf5")
    _write_keras_simple_cnn(hdf5, np.random.RandomState(3), layout="submodel")
    msgpack = str(tmp_path / "cnn.msgpack")
    jfe = JaxFeatureExtractor("simple_cnn", seed=0)
    jfe.load_weights(hdf5)
    jfe.save_weights(msgpack)
    common = [
        str(mock_scene_dir.parent), "--scene_idx", "0",
        "--forward_pass_factory", "raynet", "--rays_batch", "700",
        "--start_end", "0,2", "--depth_planes", "8",
        "--grid_shape", "12,12,12", "--maximum_number_of_marched_voxels",
        "24", "--patch_shape", "11,11,3", "--device", "cpu",
    ]
    maps = {}
    for label, weights in (("hdf5", hdf5), ("msgpack", msgpack)):
        out = tmp_path / label
        port_cli.main([common[0], str(out)] + common[1:]
                      + ["--weight_file", weights])
        maps[label] = np.stack([np.load(out / ("depth_%03d.npy" % i))
                                for i in range(2)])
    assert maps["hdf5"].shape == (2, 36, 48)
    assert np.isfinite(maps["hdf5"]).all() and (maps["hdf5"] > 0).any()
    assert np.array_equal(maps["hdf5"], maps["msgpack"])
    # and the JAX CLI reads the same .hdf5
    jax_out = tmp_path / "jax"
    jax_cli.main([common[0], str(jax_out)] + common[1:-2]
                 + ["--weight_file", hdf5])
    jmap = np.load(jax_out / "depth_000.npy")
    assert np.array_equal(jmap > 0, maps["hdf5"][0] > 0)
    close = np.abs(jmap - maps["hdf5"][0]) <= 1e-3 * np.abs(jmap)
    assert close.mean() >= 0.999

"""Keras .hdf5 checkpoints -> the state_dict of a ``cnn_factory`` module.

Port of ``raynet_tpu/models/keras_import.py``. The reference trains with
Keras 2 and publishes its weights as .hdf5 files; this module reads them
into the port's CNNs, in two parts:

- ``read_keras_tree(path)`` reads the file with h5py (imported when it is
  called) into plain numpy and Python objects;
- ``keras_state_dict_for_cnn(tree_or_path, module)`` maps such a tree, in
  numpy and torch alone, onto a ``ConvBNStack`` or ``HartmannCNN``: the
  i-th Keras Conv2D / BatchNormalization / LayerNormalization onto the
  module's i-th conv / norm.

The mapping takes the JAX function's decisions in its order, on the flax
shapes that function sees (conv kernels HWIO), so that one file gives the
same tensors or the same error in both packages:

  layouts   plain ``save_weights`` (layer groups at the root, ordered by
            the root's ``layer_names``), ``model.save`` (the same under
            ``model_weights``) and the CNN as a sub-model of the siamese
            net (``model_weights/<submodel>/<layer>/<weight>:0``);
  order     ``layer_names`` when present, else the layers' numeric name
            suffixes, then their order of appearance;
  shapes    a Keras HWIO kernel becomes OIHW; a Theano-ordered OIHW kernel
            is taken as it is; a weight of the same size and another shape
            is reshaped (LayerNormalization's gamma); any other shape
            raises ``ValueError`` ("shape");
  coverage  every parameter and BatchNorm statistic must be filled, else
            ``ValueError`` ("missing").

Dataset names per layer type (Keras 2):
  Conv2D               kernel:0 (kh, kw, cin, cout)  bias:0 (cout,)
  BatchNormalization   gamma:0  beta:0  moving_mean:0  moving_variance:0
  LayerNormalization   gamma:0 ([1]*ndims)           bias:0 (cout,)
"""
import re

import numpy as np
import torch

from .cnn import ConvBNStack, HartmannCNN

__all__ = ["read_keras_tree", "keras_state_dict_for_cnn"]


def _walk_datasets(group, prefix=""):
    """Yield (path, np.ndarray) for every dataset under ``group``."""
    import h5py

    for name, item in group.items():
        path = prefix + "/" + name if prefix else name
        if isinstance(item, h5py.Dataset):
            yield path, np.asarray(item)
        else:
            yield from _walk_datasets(item, path)


def _decode(names):
    return [n.decode() if isinstance(n, bytes) else str(n) for n in names]


def _layer_names(group):
    if "layer_names" not in group.attrs:
        return None
    return _decode(group.attrs["layer_names"])


def read_keras_tree(path):
    """The datasets and ``layer_names`` attributes of a Keras .hdf5 file.

    Returns ``{"datasets": {path: ndarray}, "layer_names": {group: names}}``:
    every dataset by its path in the file, in h5py's order, and the
    ``layer_names`` attribute (a list of str, or None where it is absent)
    of the file's root ``""`` and, when the file has one, of its
    ``"model_weights"`` group.
    """
    import h5py

    with h5py.File(path, "r") as f:
        names = {"": _layer_names(f)}
        if "model_weights" in f:
            names["model_weights"] = _layer_names(f["model_weights"])
        return {"datasets": dict(_walk_datasets(f)), "layer_names": names}


def _layer_index(name):
    """Trailing Keras auto-numbering (conv2d_3 -> 3; conv2d -> 0)."""
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else 0


def _collect_layers(tree):
    """Group the tree's datasets by owning layer, in model order: an
    ordered list of (layer_name, {weight_basename: array})."""
    groups = tree["layer_names"]
    root = "model_weights" if "model_weights" in groups else ""
    prefix = root + "/" if root else ""

    by_layer = {}
    order = {}
    for path, arr in tree["datasets"].items():
        if not path.startswith(prefix):
            continue
        parts = path[len(prefix):].split("/")
        base = parts[-1].split(":")[0]
        # the owning layer is the dataset's parent group
        layer = parts[-2] if len(parts) >= 2 else parts[0]
        by_layer.setdefault(layer, {})[base] = arr
        order.setdefault(layer, len(order))

    names = groups.get(root)
    if names is not None:
        names = [n for n in _decode(names) if n in by_layer]
    if not names:
        names = sorted(by_layer, key=lambda n: (_layer_index(n), order[n]))
    return [(n, by_layer[n]) for n in names]


def _classify(weights):
    """'conv' / 'bn' / 'ln' / None from a layer's weight basenames."""
    keys = set(weights)
    if "moving_mean" in keys or "moving_variance" in keys:
        return "bn"
    if "kernel" in keys:
        return "conv"
    if "gamma" in keys and "bias" in keys:
        return "ln"
    return None


def _hwio(weight):
    """An OIHW torch kernel's shape as flax's HWIO."""
    o, i, h, w = weight.shape
    return (h, w, i, o)


def _targets(module):
    """The flax leaves of ``module`` -> (state_dict key, flax shape, whether
    it is a conv kernel), keyed by the flax path the JAX package's
    FeatureExtractor gives them (errors name those paths)."""
    if isinstance(module, ConvBNStack):
        scope = ("_ConvBNStack_0",)
    elif isinstance(module, HartmannCNN):
        scope = ()
    else:
        raise TypeError("keras import: %s is not a cnn_factory module"
                        % type(module).__name__)
    sd = module.state_dict()
    out = {}
    for i, conv in enumerate(module.convs):
        mod = ("params",) + scope + ("Conv_%d" % i,)
        out[mod + ("kernel",)] = ("convs.%d.weight" % i, _hwio(conv.weight),
                                  True)
        out[mod + ("bias",)] = ("convs.%d.bias" % i, tuple(conv.bias.shape),
                                False)
    for i in range(len(getattr(module, "norms", ()))):
        p = "norms.%d." % i
        if p + "running_mean" in sd:
            fields = (("params", "scale", "weight"), ("params", "bias", "bias"),
                      ("batch_stats", "mean", "running_mean"),
                      ("batch_stats", "var", "running_var"))
            mod = "BatchNorm_%d" % i
        else:
            fields = (("params", "gamma", "gamma"), ("params", "bias", "bias"))
            mod = "LayerNormalization_%d" % i
        for coll, name, key in fields:
            out[(coll,) + scope + (mod, name)] = (
                p + key, tuple(sd[p + key].shape), False)
    return out


def keras_state_dict_for_cnn(tree_or_path, module):
    """The state_dict of ``module`` (a ``ConvBNStack`` or ``HartmannCNN`` of
    ``cnn_factory``) filled from a Keras checkpoint: a path to an .hdf5
    file, or a tree as ``read_keras_tree`` returns it. Float32 tensors on
    the CPU; BatchNorm's ``num_batches_tracked`` 0. Raises ``ValueError``
    where the JAX package's ``keras_variables_for_cnn`` raises, with its
    message."""
    targets = _targets(module)
    tree = (tree_or_path if isinstance(tree_or_path, dict)
            else read_keras_tree(tree_or_path))
    new = {}

    def put(key, arr):
        ref = targets.get(key)
        if ref is None:
            raise ValueError(
                "hdf5 import: file provides %r but the target model has no "
                "such parameter" % ("/".join(key),)
            )
        _, shape, _ = ref
        arr = np.asarray(arr)
        if arr.shape != shape:
            if arr.ndim == 4 and arr.transpose(2, 3, 1, 0).shape == shape:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW (Theano) -> HWIO
            elif arr.size == int(np.prod(shape)):
                arr = arr.reshape(shape)
            else:
                raise ValueError(
                    "hdf5 import: %s shape %s does not match target %s"
                    % ("/".join(key), arr.shape, shape)
                )
        new[key] = arr.astype(np.float32)

    scope = next(iter(targets))[1:-2]
    counts = {"conv": 0, "bn": 0, "ln": 0}
    for _, weights in _collect_layers(tree):
        kind = _classify(weights)
        if kind is None:
            continue  # activations / reshapes carry no weights
        i = counts[kind]
        counts[kind] += 1
        if kind == "conv":
            mod = ("params",) + scope + ("Conv_%d" % i,)
            put(mod + ("kernel",), weights["kernel"])
            if "bias" in weights:
                put(mod + ("bias",), weights["bias"])
        elif kind == "bn":
            mod = scope + ("BatchNorm_%d" % i,)
            put(("params",) + mod + ("scale",), weights["gamma"])
            put(("params",) + mod + ("bias",), weights["beta"])
            put(("batch_stats",) + mod + ("mean",), weights["moving_mean"])
            put(("batch_stats",) + mod + ("var",), weights["moving_variance"])
        else:
            mod = ("params",) + scope + ("LayerNormalization_%d" % i,)
            put(mod + ("gamma",), weights["gamma"])
            put(mod + ("bias",), weights["bias"])

    missing = sorted(set(targets) - set(new))
    if missing:
        raise ValueError(
            "hdf5 import: checkpoint fills %d/%d parameters; missing: %s"
            % (len(new), len(targets),
               ", ".join("/".join(k) for k in missing[:8]))
        )
    sd = {}
    for key, arr in new.items():
        name, _, is_kernel = targets[key]
        if is_kernel:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    # what flax does not hold: BatchNorm's num_batches_tracked
    return {k: sd[k] if k in sd else torch.tensor(0)
            for k in module.state_dict()}

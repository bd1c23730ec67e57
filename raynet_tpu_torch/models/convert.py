"""Carry flax variables across to the port's modules, and back.

``state_dict_from_flax(variables)`` maps the nested dict of numpy arrays
(``{"params": ..., "batch_stats": ...}``) of a CNN onto its module's
``state_dict``: conv kernels HWIO -> OIHW, BatchNorm ``scale``/``bias``/
``mean``/``var`` into BatchNorm2d's weight, bias and running buffers,
LayerNormalization ``gamma``/``bias`` as they are. The CNN's subtree is
found wherever the JAX package puts it: at the top (``FeatureExtractor``),
or under the flax class of a similarity net (``SimpleCNN_0``,
``HartmannCNN_0``, ...), so the weight files of the JAX package's
``raynet_pretrain`` load into a FeatureExtractor too.
``similarity_state_dict_from_flax`` and ``hartmann_state_dict_from_flax``
map whole similarity nets; ``flax_from_*`` go the other way. For a CNN
alone, ``state_dict_from_flax`` / ``flax_from_cnn_state_dict`` map
``{"params", "batch_stats"}`` (the JAX package's ``FeatureExtractor`` and
``raynet_train`` weight files) both ways, and ``read_cnn_weights`` /
``write_cnn_weights`` read and write such a file.
``read_flax_msgpack`` / ``write_flax_msgpack`` read and write the files of
``flax.serialization.to_bytes`` without flax.
"""
import msgpack
import numpy as np
import torch

from .cnn import FLAX_CLASS


def _indexed(layer_tree, prefix):
    keys = [k for k in layer_tree if k.startswith(prefix + "_")]
    return [layer_tree[k]
            for k in sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))]


def _cnn_tree(tree):
    """The subtree of one CNN's layers (``Conv_i``, ``BatchNorm_i``, ...)
    inside ``tree``, descending through the flax module wrappers."""
    while True:
        stacks = [k for k in tree if k.startswith("_ConvBNStack")]
        if stacks:
            return tree[stacks[0]]
        wrappers = [k for k in tree
                    if k.rsplit("_", 1)[0] in FLAX_CLASS.values()]
        if not wrappers:
            return tree
        tree = tree[wrappers[0]]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(sd, prefix, conv):
    sd[prefix + ".weight"] = _t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
    sd[prefix + ".bias"] = _t(conv["bias"])


def state_dict_from_flax(variables, prefix=""):
    """flax variables of a CNN -> the state_dict of ``cnn_factory``'s module
    (ConvBNStack or HartmannCNN), keys prefixed with ``prefix``."""
    params = _cnn_tree(variables["params"])
    stats = _cnn_tree(variables.get("batch_stats") or {})
    sd = {}
    for i, conv in enumerate(_indexed(params, "Conv")):
        _conv(sd, prefix + "convs.%d" % i, conv)
    bns = _indexed(params, "BatchNorm")
    for i, (bn, st) in enumerate(zip(bns, _indexed(stats, "BatchNorm"))):
        p = prefix + "norms.%d." % i
        sd[p + "weight"] = _t(bn["scale"])
        sd[p + "bias"] = _t(bn["bias"])
        sd[p + "running_mean"] = _t(st["mean"])
        sd[p + "running_var"] = _t(st["var"])
        sd[p + "num_batches_tracked"] = torch.tensor(0)
    for i, ln in enumerate(_indexed(params, "LayerNormalization")):
        sd[prefix + "norms.%d.gamma" % i] = _t(ln["gamma"]).reshape(1, 1, 1, 1)
        sd[prefix + "norms.%d.bias" % i] = _t(ln["bias"])
    return sd


def similarity_state_dict_from_flax(variables):
    """flax variables of a MultiViewSimilarityNet -> its port's state_dict."""
    return state_dict_from_flax(variables, prefix="cnn.")


def hartmann_state_dict_from_flax(variables):
    """flax variables of a HartmannSimilarityNet -> its port's state_dict."""
    params = variables["params"]
    sd = state_dict_from_flax({"params": params["HartmannCNN_0"]},
                              prefix="cnn.")
    for i, conv in enumerate(_indexed(params, "Conv")):
        _conv(sd, "head.%d" % i, conv)
    return sd


def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


def _flax_cnn(sd, prefix):
    """(params, batch_stats) flax subtrees of a CNN's state_dict entries."""
    params, stats = {}, {}
    i = 0
    while prefix + "convs.%d.weight" % i in sd:
        params["Conv_%d" % i] = {
            "kernel": np.transpose(_np(sd[prefix + "convs.%d.weight" % i]),
                                   (2, 3, 1, 0)),
            "bias": _np(sd[prefix + "convs.%d.bias" % i]),
        }
        p = prefix + "norms.%d." % i
        if p + "running_mean" in sd:
            params["BatchNorm_%d" % i] = {"scale": _np(sd[p + "weight"]),
                                          "bias": _np(sd[p + "bias"])}
            stats["BatchNorm_%d" % i] = {"mean": _np(sd[p + "running_mean"]),
                                         "var": _np(sd[p + "running_var"])}
        elif p + "gamma" in sd:
            params["LayerNormalization_%d" % i] = {
                "gamma": _np(sd[p + "gamma"]), "bias": _np(sd[p + "bias"])}
        i += 1
    if params.keys() - {"Conv_0", "Conv_1"}:  # a ConvBNStack
        params = {"_ConvBNStack_0": params}
        stats = {"_ConvBNStack_0": stats} if stats else {}
    return params, stats


def flax_from_cnn_state_dict(sd):
    """A CNN module's state_dict -> the flax ``{"params", "batch_stats"}``
    of the JAX package's module of the same factory."""
    params, stats = _flax_cnn(sd, "")
    return {"params": params, "batch_stats": stats}


def read_cnn_weights(path):
    """The state_dict of a CNN from a flax msgpack file (a CNN's, or a
    similarity net's, whose CNN is taken)."""
    return state_dict_from_flax(read_flax_msgpack(path))


def write_cnn_weights(path, sd):
    """Write a CNN's state_dict as the JAX package's weight file of that
    CNN (``flax.serialization.to_bytes({"params", "batch_stats"})``)."""
    write_flax_msgpack(path, flax_from_cnn_state_dict(sd))


def flax_from_similarity_state_dict(sd, cnn_name):
    """A MultiViewSimilarityNet's state_dict -> the flax variables the JAX
    package's ``raynet_pretrain`` saves for it."""
    params, stats = _flax_cnn(sd, "cnn.")
    name = FLAX_CLASS[cnn_name] + "_0"
    out = {"params": {name: params}, "batch_stats": {}}
    if stats:
        out["batch_stats"] = {name: stats}
    return out


def flax_from_hartmann_state_dict(sd):
    """A HartmannSimilarityNet's state_dict -> the flax variables the JAX
    package's ``raynet_pretrain`` saves for it."""
    params, _ = _flax_cnn(sd, "cnn.")
    out = {"HartmannCNN_0": params}
    i = 0
    while "head.%d.weight" % i in sd:
        out["Conv_%d" % i] = {
            "kernel": np.transpose(_np(sd["head.%d.weight" % i]), (2, 3, 1, 0)),
            "bias": _np(sd["head.%d.bias" % i]),
        }
        i += 1
    return {"params": out, "batch_stats": {}}


def read_flax_msgpack(path):
    """Nested dict of numpy arrays from a flax msgpack checkpoint."""

    def ext_hook(code, data):
        # 1: ndarray, 3: numpy scalar; both (shape, dtype name, C bytes)
        if code in (1, 3):
            shape, dtype, buf = msgpack.unpackb(data, raw=False)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == 1 else arr[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(
            f.read(), ext_hook=ext_hook, raw=False, strict_map_key=False
        )


def write_flax_msgpack(path, tree):
    """Write a nested dict of numpy arrays as ``flax.serialization.to_bytes``
    does (arrays as msgpack extension 1: shape, dtype name, C bytes)."""

    def default(x):
        if isinstance(x, np.ndarray):
            data = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                                 use_bin_type=True)
            return msgpack.ExtType(1, data)
        raise TypeError("cannot serialise %r" % (type(x),))

    with open(path, "wb") as f:
        f.write(msgpack.packb(tree, default=default, strict_types=True))

"""Carry the JAX FeatureExtractor's flax variables into the port.

``state_dict_from_flax(variables)`` maps the nested dict of numpy arrays
(``{"params": ..., "batch_stats": ...}``) onto a ConvBNStack ``state_dict``:
conv kernels HWIO -> OIHW, BatchNorm ``scale``/``bias``/``mean``/``var`` into
BatchNorm2d's weight, bias and eval buffers, LayerNormalization
``gamma``/``bias`` as they are. ``read_flax_msgpack`` decodes a file written
by ``flax.serialization.to_bytes`` without flax.
"""
import numpy as np
import torch


def _stack(tree):
    (name,) = [k for k in tree if k.startswith("_ConvBNStack")]
    return tree[name]


def _indexed(layer_tree, prefix):
    keys = [k for k in layer_tree if k.startswith(prefix + "_")]
    return [layer_tree[k] for k in sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))]


def state_dict_from_flax(variables):
    """flax variables of a ``_ConvBNStack`` CNN -> ConvBNStack state_dict."""
    params = _stack(variables["params"])
    stats = _stack(variables["batch_stats"]) if "batch_stats" in variables else {}
    sd = {}

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    for i, conv in enumerate(_indexed(params, "Conv")):
        sd["convs.%d.weight" % i] = t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
        sd["convs.%d.bias" % i] = t(conv["bias"])
    bns = _indexed(params, "BatchNorm")
    for i, (bn, st) in enumerate(zip(bns, _indexed(stats, "BatchNorm"))):
        sd["norms.%d.weight" % i] = t(bn["scale"])
        sd["norms.%d.bias" % i] = t(bn["bias"])
        sd["norms.%d.running_mean" % i] = t(st["mean"])
        sd["norms.%d.running_var" % i] = t(st["var"])
        sd["norms.%d.num_batches_tracked" % i] = torch.tensor(0)
    for i, ln in enumerate(_indexed(params, "LayerNormalization")):
        sd["norms.%d.gamma" % i] = t(ln["gamma"]).reshape(1, 1, 1, 1)
        sd["norms.%d.bias" % i] = t(ln["bias"])
    return sd


def read_flax_msgpack(path):
    """Nested dict of numpy arrays from a flax msgpack checkpoint."""
    import msgpack

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

"""Feature extraction and the Hartmann match scorer: modules bound to
parameters with a predict() API.

Port of ``raynet_tpu/models/feature_extractor.py``. The public layout is
JAX's, channels last: images (..., H, W, C) in and features (..., Hf, Wf, F)
out, patch quintuples (B, V, ph, pw, C) in and match scores (B, h', w', 2)
out; the modules run NCHW in between.
"""
import numpy as np
import torch

from ..utils.generic_utils import resolve_device
from .cnn import (
    HartmannSimilarityNet,
    cnn_factory,
    fold_batch_norm,
    fold_inputs,
    folds,
)
from .convert import (
    flax_from_hartmann_state_dict,
    hartmann_state_dict_from_flax,
    read_cnn_weights,
    read_flax_msgpack,
    write_cnn_weights,
    write_flax_msgpack,
)
from .keras_import import keras_state_dict_for_cnn


def _as_float_tensor(x, device):
    """An array or tensor on ``device`` as float32; uint8 is divided by 255
    in float32 there."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.to(device)
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


class FeatureExtractor:
    """A CNN bound to parameters, callable on image stacks.

    ``state_dict``: the CNN's parameters (e.g. from
    ``convert.state_dict_from_flax``); without it the weights are drawn
    from a ``torch.Generator`` seeded with ``seed`` (on the CPU, so a seed
    gives the same weights on every device). ``output_dtype``: the feature
    maps' dtype (bfloat16 on the main path); the CNN computes in float32.

    ``predict`` runs a stack whose eval-mode BatchNorm folds into its convs
    (``cnn.folds``) from the folded weights (``cnn.fold_batch_norm``),
    which it keeps as a cache and builds again whenever a tensor the fold
    reads (``cnn.fold_inputs``) is another tensor or was written in place:
    its storage or its ``_version`` moved (``load_weights``,
    ``model.load_state_dict``, ``model.to``). A write through ``.data``
    bypasses the version and is not seen. The model's own parameters stay
    the unfolded ones. Counters, over the object's calls:
    ``folded_layers``, conv layers run with a folded norm (per image: 5
    for ``simple_cnn``, 0 for ``simple_cnn_ln``); ``fold_builds``, builds
    of the cache (the first in the constructor; none for a stack that does
    not fold).
    """

    def __init__(self, cnn_name="simple_cnn", state_dict=None, seed=0,
                 channels=3, output_dtype=None, device="cuda"):
        self.cnn_name = cnn_name
        self.channels = channels
        self.output_dtype = output_dtype
        self.device = resolve_device(device)
        self.model = cnn_factory(cnn_name)(channels)
        if state_dict is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.eval().to(self.device)
        self.folded_layers = 0
        self.fold_builds = 0
        self._fold_key = self._fold_tensors = self._fold = None
        self._folded()

    def _folded(self):
        """The (weight, bias) pairs of the model's folded layers, built
        again if a tensor they come from changed; None where the model does
        not fold."""
        if not folds(self.model):
            return None
        tensors = fold_inputs(self.model)
        key = [(t.data_ptr(), t._version) for t in tensors]
        if key != self._fold_key:
            self._fold = fold_batch_norm(self.model)
            self._fold_key = key
            # held so that no new tensor takes a freed one's address
            self._fold_tensors = [t.detach() for t in tensors]
            self.fold_builds += 1
        return self._fold

    @property
    def feature_dim(self):
        return self.model.convs[-1].out_channels

    @property
    def first_conv_channels(self):
        return self.model.convs[0].out_channels

    @torch.no_grad()
    def predict(self, images):
        """images: (..., H, W, C) float array or tensor in [0, 1], or uint8,
        which is moved as is and divided by 255 in float32 on the device ->
        (..., Hf, Wf, F) features on this extractor's device. Any leading
        dims, as flax's modules take them."""
        x = _as_float_tensor(images, self.device)
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).contiguous()
        folded = self._folded()
        if folded is None:
            out = self.model(x)
        else:
            out = self.model.forward_folded(x, folded)
            self.folded_layers += len(folded) * x.shape[0]
        out = out.permute(0, 2, 3, 1)
        out = out.reshape(lead + out.shape[1:]).contiguous()
        if self.output_dtype is not None:
            out = out.to(self.output_dtype)
        return out

    def save_weights(self, path):
        """Write the CNN as a flax msgpack file, the one the JAX package's
        ``FeatureExtractor.save_weights`` writes and its ``load_weights``
        reads."""
        write_cnn_weights(path, self.model.state_dict())

    def load_weights(self, path):
        """Load a flax msgpack file (the JAX package's
        ``FeatureExtractor.save_weights``, or a weight file of either
        package's pretraining: the similarity net's CNN is taken), or a
        Keras .hdf5 / .h5 checkpoint (``keras_import``)."""
        if str(path).endswith((".hdf5", ".h5")):
            sd = keras_state_dict_for_cnn(path, self.model)
        else:
            sd = read_cnn_weights(path)
        self.model.load_state_dict(sd)
        self.model.to(self.device)

    @classmethod
    def from_weights(cls, cnn_name, path, channels=3, **kwargs):
        fe = cls(cnn_name, channels=channels, **kwargs)
        fe.load_weights(path)
        return fe


class HartmannModel:
    """HartmannSimilarityNet bound to parameters, with a predict() API:
    patch quintuples -> 2-way match softmax maps.

    ``state_dict``: the net's parameters (e.g. from
    ``convert.hartmann_state_dict_from_flax``); without it they are drawn
    from a ``torch.Generator`` seeded with ``seed``, on the CPU.
    """

    cnn_name = "hartmann_cnn"

    def __init__(self, state_dict=None, seed=0, patch_shape=(32, 32, 3),
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = HartmannSimilarityNet(patch_shape[2])
        if state_dict is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.eval().to(self.device)

    @property
    def first_conv_channels(self):
        return self.model.cnn.convs[0].out_channels

    @torch.no_grad()
    def predict(self, patches):
        """patches: (B, V, ph, pw, C) array or tensor -> (B, h', w', 2)
        match scores on this model's device, channels last."""
        x = _as_float_tensor(patches, self.device).permute(0, 1, 4, 2, 3)
        return self.model(x.contiguous()).permute(0, 2, 3, 1).contiguous()

    def save_weights(self, path):
        write_flax_msgpack(
            path, flax_from_hartmann_state_dict(self.model.state_dict()))

    def load_weights(self, path):
        self.model.load_state_dict(
            hartmann_state_dict_from_flax(read_flax_msgpack(path)))
        self.model.to(self.device)


def upsample_features(features, cnn_name):
    """Repeat the cells of a strided CNN's (V, Hf, Wf, F) feature maps back
    to pixel stride (``hartmann_cnn``: two 2x2 max-pools, 4x), on their
    device; pure conv stacks return them unchanged."""
    total_stride = {"hartmann_cnn": 4}.get(cnn_name, 1)
    if total_stride <= 1:
        return features
    return features.repeat_interleave(total_stride, dim=1).repeat_interleave(
        total_stride, dim=2)


def zeropad_images(images, padding):
    """Stack Image objects into one zero-padded (V, H+2p, W+2p, C) array.

    When every view's source was 8-bit the stack stays uint8, and predict()
    normalises it on the device. Copy of the JAX package's numpy helper.
    """
    h, w, c = images[0].image.shape
    p = padding
    u8s = [getattr(im, "image_u8", None) for im in images]
    if all(u is not None for u in u8s):
        out = np.zeros(
            (len(images), h + 2 * p, w + 2 * p, c), dtype=np.uint8
        )
        for i, u in enumerate(u8s):
            out[i, p : p + h, p : p + w, :] = u
        return out
    out = np.zeros((len(images), h + 2 * p, w + 2 * p, c), dtype=np.float32)
    for i, im in enumerate(images):
        out[i, p : p + h, p : p + w, :] = im.image
    return out

"""Feature extraction: a CNN bound to parameters with a predict() API.

Port of ``raynet_tpu/models/feature_extractor.py:16-69`` and ``:147-170``.
The public layout is JAX's, (V, H, W, C) in and (V, Hf, Wf, F) out; the
module runs NCHW in between.
"""
import numpy as np
import torch

from .cnn import cnn_factory
from .convert import read_flax_msgpack, state_dict_from_flax


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %s requested but torch.cuda.is_available() is False"
            % (device,)
        )
    return device


class FeatureExtractor:
    """A CNN bound to parameters, callable on image stacks.

    ``state_dict``: the CNN's parameters (e.g. from
    ``convert.state_dict_from_flax``); without it the weights are drawn
    from a ``torch.Generator`` seeded with ``seed`` (on the CPU, so a seed
    gives the same weights on every device). ``output_dtype``: the feature
    maps' dtype (bfloat16 on the main path); the CNN computes in float32.
    """

    def __init__(self, cnn_name="simple_cnn", state_dict=None, seed=0,
                 channels=3, output_dtype=None, device="cuda"):
        self.cnn_name = cnn_name
        self.channels = channels
        self.output_dtype = output_dtype
        self.device = _device(device)
        if self.device.type == "cuda":
            # cuDNN convolutions and cuBLAS matmuls default to TF32 on this
            # card (10-bit mantissa). The features feed integer feature-cell
            # lookups and near-tied argmaxes downstream; keep them float32
            # so they agree with the CPU path and the JAX reference.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = cnn_factory(cnn_name)(channels)
        if state_dict is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.eval().to(self.device)

    @property
    def feature_dim(self):
        return self.model.convs[-1].out_channels

    @torch.no_grad()
    def predict(self, images):
        """images: (V, H, W, C) float array in [0, 1], or uint8, which is
        moved as is and divided by 255 in float32 on the device ->
        (V, Hf, Wf, F) features on this extractor's device."""
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        else:
            x = x.to(torch.float32)
        out = self.model(x.permute(0, 3, 1, 2).contiguous())
        out = out.permute(0, 2, 3, 1).contiguous()
        if self.output_dtype is not None:
            out = out.to(self.output_dtype)
        return out

    def load_weights(self, path):
        """Load a flax msgpack checkpoint written by the JAX package's
        ``FeatureExtractor.save_weights``."""
        sd = state_dict_from_flax(read_flax_msgpack(path))
        self.model.load_state_dict(sd)
        self.model.to(self.device)

    @classmethod
    def from_weights(cls, cnn_name, path, channels=3, **kwargs):
        fe = cls(cnn_name, channels=channels, **kwargs)
        fe.load_weights(path)
        return fe


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

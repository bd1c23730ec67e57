"""The traffic generator: a scene and a CNN's weights from a traffic file
and ``--seed``.

A traffic file of kind "ring" describes calibrated pinhole cameras on a
ring of ``radius`` around the origin in the xz plane, looking at it,
``angle_step`` radians apart, with a bbox of +-``bbox_half`` and seeded
random uint8 images of ``height`` x ``width``: the rig of the port's
``common/ring_scene.RingScene``, copied here so that the benchmark owns
it. The geometry is fixed by the file, so every seed asks for the same
work; the seed draws the pixels (one call on the device) and the weights.

The scene offers the part of the scene interface the forward passes read:
``n_images``, ``bbox``, ``image_shape``, ``get_image(i)`` (``camera.P``,
``camera.P_pinv``, ``camera.center``, ``image_u8``, ``image``) and
``get_view_idxs(i, neighbors)``.
"""
import math

import numpy as np
import torch


class Camera:
    """P = K [R | t], its pseudo-inverse and its centre, as the port's data
    layer computes them."""

    def __init__(self, K, R, t):
        self.P = K.dot(np.hstack([R, t]))
        self.P_pinv = np.linalg.pinv(self.P)
        self.center = np.vstack([(-np.linalg.inv(R)).dot(t), [1]]).astype(
            np.float32)


def ring_camera(angle, height, width, focal, radius):
    """(K, R, t) float32 of a ring camera at ``angle`` looking at the
    origin."""
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                 dtype=np.float32)
    c = np.array([radius * np.sin(angle), 0.0, -radius * np.cos(angle)])
    z = -c / np.linalg.norm(c)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z]).astype(np.float32)
    t = (-R @ c.reshape(3, 1)).astype(np.float32)
    return K, R, t


class Image:
    """The uint8 pixels and, as the port's data layer holds them beside
    those, the pixels divided by 255 in float32."""

    def __init__(self, camera, image_u8):
        self.camera = camera
        self.image_u8 = image_u8
        self.image = image_u8.astype(np.float32) / np.float32(255.0)


class RingScene:
    """Ring cameras with the given uint8 images (n, H, W, 3); camera i at
    angle ``(i - n / 2) * angle_step``. The neighbours of image i are the
    ``neighbors`` nearest indices (the lower first on a tie)."""

    def __init__(self, images_u8, focal, radius, angle_step, bbox_half):
        n, height, width, _ = images_u8.shape
        self._images = []
        for i in range(n):
            K, R, t = ring_camera((i - n / 2) * angle_step, height, width,
                                  focal, radius)
            self._images.append(Image(Camera(K, R, t), images_u8[i]))
        h = float(bbox_half)
        self._bbox = np.array([[-h, -h, -h, h, h, h]], dtype=np.float32)

    @property
    def n_images(self):
        return len(self._images)

    @property
    def bbox(self):
        return self._bbox

    @property
    def image_shape(self):
        return self._images[0].image_u8.shape[:2]

    def get_image(self, i):
        return self._images[i]

    def get_view_idxs(self, i, neighbors=4):
        others = sorted((j for j in range(self.n_images) if j != i),
                        key=lambda j: (abs(j - i), j))
        return [i] + sorted(others[:neighbors])


def generator(seed, device, stream):
    """A ``torch.Generator`` on ``device`` for one use (``stream``) of
    ``seed``: the images and the weights draw from different streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream) % (1 << 63))
    return g


def make_scene(traffic, seed, device):
    """The scene of a traffic file (a dict) for ``seed``; its pixels are
    drawn in one call on ``device`` and kept on the host as the passes
    take them."""
    if traffic["kind"] != "ring":
        raise ValueError("unknown traffic kind %r" % (traffic["kind"],))
    shape = (traffic["n_images"], traffic["height"], traffic["width"], 3)
    images = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                           generator=generator(seed, device, 0))
    return RingScene(images.cpu().numpy(), traffic["focal"],
                     traffic["radius"], traffic["angle_step"],
                     traffic["bbox_half"])


def cnn_weights(layers, channels, seed, device):
    """A conv stack's state dict (the port's ``ConvBNStack`` keys) drawn
    from ``seed`` on ``device`` in one call: He-uniform kernels (variance
    2 / fan_in, so activations keep their scale through the ReLUs),
    biases in +-0.05, BatchNorm scales in [0.8, 1.2], shifts in +-0.1,
    running means in +-0.1 and variances in [0.8, 1.2]."""
    shapes, c = [], channels
    for filters, kernel, _ in layers:
        shapes.append((filters, c, kernel, kernel))
        c = filters
    total = sum(math.prod(s) + 5 * s[0] for s in shapes)
    u = torch.rand(total, dtype=torch.float32, device=device,
                   generator=generator(seed, device, 1))
    sd, off = {}, 0

    def take(shape, lo, hi):
        nonlocal off
        n = math.prod(shape)
        out = u[off:off + n].reshape(shape) * (hi - lo) + lo
        off += n
        return out

    for i, shape in enumerate(shapes):
        bound = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
        sd["convs.%d.weight" % i] = take(shape, -bound, bound)
        f = shape[0]
        sd["convs.%d.bias" % i] = take((f,), -0.05, 0.05)
        sd["norms.%d.weight" % i] = take((f,), 0.8, 1.2)
        sd["norms.%d.bias" % i] = take((f,), -0.1, 0.1)
        sd["norms.%d.running_mean" % i] = take((f,), -0.1, 0.1)
        sd["norms.%d.running_var" % i] = take((f,), 0.8, 1.2)
        sd["norms.%d.num_batches_tracked" % i] = torch.zeros(
            (), dtype=torch.int64, device=device)
    return sd

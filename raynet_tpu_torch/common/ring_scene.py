"""A synthetic scene built in memory: ring cameras around the origin.

The rig of the JAX package's ``bench_scene.py`` (and of the test fixture
``tests/conftest.py::mock_scene_dir``): pinhole cameras on a ring of radius
20 in the xz plane, looking at the origin, ``angle_step`` radians apart,
with a bbox of +-3 and seeded random uint8 images. It needs no files and no
image codec, so it can drive the forward pass where only numpy and torch
are installed, and imports nothing of the JAX package. It offers the part
of the Scene interface that ``RayNetForwardPass`` reads.
"""
import numpy as np


class RingCamera:
    """Pinhole camera: P = K [R | t], its pseudo-inverse and its centre,
    computed as ``raynet_tpu.common.camera.Camera`` computes them."""

    def __init__(self, K, R, t):
        self.K, self.R, self.t = K, R, t
        self.P = K.dot(np.hstack([R, t]))
        self.P_pinv = np.linalg.pinv(self.P)
        self.center = np.vstack([(-np.linalg.inv(R)).dot(t), [1]]).astype(
            np.float32
        )


def ring_camera(angle, height, width, focal, radius=20.0):
    """(K, R, t) float32 of a camera on the ring looking at the origin."""
    K = np.array(
        [[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
        dtype=np.float32,
    )
    c = np.array([radius * np.sin(angle), 0.0, -radius * np.cos(angle)])
    z = -c / np.linalg.norm(c)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z]).astype(np.float32)
    t = (-R @ c.reshape(3, 1)).astype(np.float32)
    return K, R, t


class RingImage:
    """uint8 pixels and their camera (the Image attributes the pass reads)."""

    def __init__(self, camera, image_u8):
        self.camera = camera
        self.image_u8 = image_u8
        self.image = image_u8.astype(np.float32) / np.float32(255.0)

    @property
    def height(self):
        return self.image_u8.shape[0]

    @property
    def width(self):
        return self.image_u8.shape[1]


class RingScene:
    """``n_images`` ring cameras with seeded random images.

    Camera i sits at angle ``(i - angle_origin) * angle_step`` on the ring;
    the neighbours of image i are the ``neighbors`` indices nearest to i
    (the lower one first on a tie), which is what a Restrepo scene's
    "filesystem" policy picks on such a ring.
    """

    def __init__(self, n_images, height, width, focal, angle_step=0.04,
                 angle_origin=None, bbox_half=3.0, seed=0):
        rng = np.random.RandomState(seed)
        origin = n_images / 2 if angle_origin is None else angle_origin
        self._images = []
        for i in range(n_images):
            img = (rng.rand(height, width, 3) * 255).astype(np.uint8)
            K, R, t = ring_camera((i - origin) * angle_step, height, width,
                                  focal)
            self._images.append(RingImage(RingCamera(K, R, t), img))
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
        return self._images[0].height, self._images[0].width

    def get_image(self, i):
        return self._images[i]

    def get_view_idxs(self, i, neighbors=4):
        others = sorted(
            (j for j in range(self.n_images) if j != i),
            key=lambda j: (abs(j - i), j),
        )
        return [i] + sorted(others[:neighbors])

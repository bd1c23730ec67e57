"""Image = pixel buffer (normalized to [0, 1]) + the camera that produced it.

Port of ``raynet_tpu/common/image.py`` without the patch gathers (they serve
the Hartmann pass and training, not ported yet). Files are decoded with
Pillow. Axis conventions: the x-axis runs along image COLUMNS (width), the
y-axis along ROWS (height); pixels are homogeneous (3, 1) column vectors
[x, y, 1]^T. ``rays()`` enumerates pixels COLUMN-MAJOR (u outer, v inner) to
match the ray indexing of the forward pass.
"""
import numpy as np
from PIL import Image as PILImage

from .camera import Camera
from ..utils.geometry import project


def read_image(image_file):
    """Pixels of an image file as a numpy array ((H, W) or (H, W, C))."""
    with PILImage.open(image_file) as im:
        return np.asarray(im)


class Image:
    def __init__(self, camera, image_data, normalize=True):
        self._camera = camera
        self._image = image_data
        if self._image.ndim == 2:
            self._image = self._image[:, :, np.newaxis]
        # the raw uint8 is kept beside the normalized float view: the
        # feature extractor moves u8 to the device and divides there
        self._image_u8 = None
        if normalize:
            if self._image.dtype == np.uint8:
                self._image_u8 = self._image
            self._image = self._image.astype(np.float32) / np.float32(255.0)

    @property
    def image_u8(self):
        """Raw uint8 pixels when the source was 8-bit (else None)."""
        return self._image_u8

    @classmethod
    def from_file(cls, image_file, camera_poses):
        camera = Camera(
            K=camera_poses["K"], R=camera_poses["R"], t=camera_poses["t"]
        )
        return cls(camera, read_image(image_file))

    @property
    def image(self):
        return self._image

    @property
    def camera(self):
        return self._camera

    @property
    def width(self):
        return self._image.shape[1]

    @property
    def height(self):
        return self._image.shape[0]

    @property
    def channels(self):
        return self._image.shape[2]

    def project(self, point):
        """Project 3D homogeneous point(s) to rounded integer pixels."""
        return np.round(project(self._camera.P, point)).astype(int)

    def ray(self, pixel):
        """The (camera_center, back-projected point) pair of a pixel.

        Both returned as homogeneous (4, 1) columns; the back-projection is
        ``pinv(P) @ pixel`` dehomogenized.
        """
        if len(pixel) == 2:
            pixel = np.vstack((pixel, [1]))
        ray = project(self._camera.P_pinv, pixel.astype(np.float32))
        assert ray.shape == (4, 1)
        return self._camera.center, ray

    def rays(self):
        """Back-projections of ALL pixels, column-major (u outer, v inner).

        Returns (camera_center (4,1), rays (N, 4)) with N = W*H.
        """
        u = np.repeat(np.arange(self.width), self.height)
        v = np.tile(np.arange(self.height), self.width)
        pixels = np.stack([u, v, np.ones_like(u)]).astype(np.float64)
        rays = project(self._camera.P_pinv, pixels)
        return self._camera.center, rays

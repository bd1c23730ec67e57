"""Image = pixel buffer (normalized to [0, 1]) + the camera that produced it.

Port of ``raynet_tpu/common/image.py``, with its host patch gathers, and
``gather_patches``, the batched gather of the Hartmann pass on the device.
Files are decoded with Pillow. Axis conventions: the x-axis runs along
image COLUMNS (width), the y-axis along ROWS (height); pixels are
homogeneous (3, 1) column vectors [x, y, 1]^T. ``rays()`` enumerates pixels
COLUMN-MAJOR (u outer, v inner) to match the ray indexing of the forward
pass; ``camera_rays`` computes them from a camera alone.
"""
import numpy as np
import torch
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

    def random_pixel(self, rng):
        """A uniformly drawn (3, 1) pixel [x, y, 1]^T; ``rng`` is a
        ``np.random.RandomState``."""
        return np.array(
            [[rng.randint(0, self.width), rng.randint(0, self.height), 1]]
        ).T

    def rgb2gray(self):
        return Image(
            self._camera,
            np.dot(self._image[..., :3], [0.299, 0.587, 0.114]),
            normalize=False,
        )

    def project(self, point):
        """Project 3D homogeneous point(s) to rounded integer pixels."""
        return np.round(project(self._camera.P, point)).astype(int)

    def patch_from_3d(self, point, patch_size, expand_patch=True):
        return self.patch(self.project(point), patch_size, expand_patch)

    def patch(self, patch_center, patch_size, expand_patch=True):
        """Image content around ``patch_center`` ((C+1, 1) pixel column).

        Out-of-bounds regions are zero-filled when ``expand_patch``;
        otherwise the whole patch is -1.
        """
        pad_x = patch_size[1] // 2
        pad_y = patch_size[0] // 2
        min_x = int(patch_center[0, 0]) - pad_x
        max_x = int(patch_center[0, 0]) + pad_x + patch_size[1] % 2
        min_y = int(patch_center[1, 0]) - pad_y
        max_y = int(patch_center[1, 0]) + pad_y + patch_size[0] % 2

        patch = np.zeros(
            tuple(patch_size) + self._image.shape[2:], dtype=np.float32
        )
        h, w = self.height, self.width
        if min_x >= 0 and min_y >= 0 and max_x <= w and max_y <= h:
            patch[:, :] = self._image[min_y:max_y, min_x:max_x]
        elif expand_patch:
            p_min_x = min(w, max(0, min_x))
            p_max_x = max(0, min(w, max_x))
            p_min_y = min(h, max(0, min_y))
            p_max_y = max(0, min(h, max_y))
            s_min_x = min(patch_size[1], max(0, -min_x))
            s_max_x = max(0, min(patch_size[1], patch_size[1] + w - max_x))
            s_min_y = min(patch_size[0], max(0, -min_y))
            s_max_y = max(0, min(patch_size[0], patch_size[0] + h - max_y))
            patch[s_min_y:s_max_y, s_min_x:s_max_x] = self._image[
                p_min_y:p_max_y, p_min_x:p_max_x
            ]
        else:
            patch.fill(-1.0)
        return patch

    def patches_from_3d_points(self, points, patch_size):
        """Patches around the projections of (N, 4) homogeneous points, or
        None if ANY projected patch falls outside the image."""
        patch_centers = np.round(project(self._camera.P, points.T)).astype(int)
        return self.patches(patch_centers, patch_size)

    def patches(self, patch_centers, patch_size):
        """(N, ph, pw, C) patches around (N, 2+) integer centres, or None if
        any of them leaves the image."""
        if patch_centers.shape[0] <= patch_centers.shape[1]:
            raise ValueError("patch_centers must be (N, 2+) with N > 2+, got "
                             "%r" % (patch_centers.shape,))
        pad_x = patch_size[1] // 2
        pad_y = patch_size[0] // 2
        min_x = patch_centers[:, 0] - pad_x
        max_x = patch_centers[:, 0] + pad_x + patch_size[1] % 2
        min_y = patch_centers[:, 1] - pad_y
        max_y = patch_centers[:, 1] + pad_y + patch_size[0] % 2

        h, w = self.height, self.width
        inside = (min_x >= 0) & (min_y >= 0) & (max_x <= w) & (max_y <= h)
        if not np.all(inside):
            return None
        n = patch_centers.shape[0]
        ph, pw = patch_size[0], patch_size[1]
        ys = min_y[:, None, None] + np.arange(ph)[None, :, None]
        xs = min_x[:, None, None] + np.arange(pw)[None, None, :]
        return self._image[ys, xs].astype(np.float32).reshape(
            (n, ph, pw) + self._image.shape[2:]
        )

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
        return camera_rays(self._camera, self.height, self.width)


def camera_rays(camera, height, width):
    """Back-projections of every pixel of a ``height`` x ``width`` image
    through ``camera`` (its ``P_pinv`` and ``center``), column-major (u
    outer, v inner), in float64: (camera_center (4, 1), rays (N, 4)),
    N = W*H. Any scene's cameras have these attributes, so the sampling
    schemes take their rays from here."""
    u = np.repeat(np.arange(width), height)
    v = np.tile(np.arange(height), width)
    pixels = np.stack([u, v, np.ones_like(u)]).astype(np.float64)
    return camera.center, project(camera.P_pinv, pixels)


def padded_images(images, patch_size):
    """(V, H, W, C) float32 image tensor -> (V, H + 2 ph, W + 2 pw, C), zero
    bordered for ``gather_patches``."""
    ph, pw = patch_size
    return torch.nn.functional.pad(images, (0, 0, pw, pw, ph, ph))


def gather_patches(padded, centers, patch_size):
    """Patches of every view around integer pixel centres, on the device.

    ``padded``: (V, H + 2 ph, W + 2 pw, C) from ``padded_images``;
    ``centers``: (V, K, 2) integer (x, y) centres, one row of K per view.
    Returns (K, V, ph, pw, C), channels last as ``predict`` takes them,
    made by one indexing op: bit for bit ``Image.patch(center, patch_size,
    expand_patch=True)``, zero where a patch leaves its image.
    A centre whose patch lies wholly outside the image is first clamped to
    the nearest such centre inside the zero border.
    """
    v, hp, wp, c = padded.shape
    ph, pw = patch_size
    h, w = hp - 2 * ph, wp - 2 * pw
    centers = centers.to(torch.int64)
    # a patch's first column at centre x is x - pw // 2; it lies wholly
    # outside the image for x < pw // 2 - pw + 1 and x >= w + pw // 2
    x = centers[..., 0].clamp(pw // 2 - pw, w + pw // 2) - pw // 2 + pw
    y = centers[..., 1].clamp(ph // 2 - ph, h + ph // 2) - ph // 2 + ph
    dev = padded.device
    base = (torch.arange(v, device=dev)[:, None] * hp + y) * wp + x
    offs = (torch.arange(ph, device=dev)[:, None] * wp
            + torch.arange(pw, device=dev)[None, :])
    idx = base.T[:, :, None, None] + offs  # (K, V, ph, pw)
    return padded.reshape(-1, c)[idx]

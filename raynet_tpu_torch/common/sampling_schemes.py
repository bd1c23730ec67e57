"""Sampling-scheme objects with the reference's factory API.

Port of ``raynet_tpu/common/sampling_schemes.py``: the same scheme names and
the same three entry points (per ray / all rays / a batch of rays). The
scalar paths, which the sample generators call while they build training
data, and the all-rays paths of the host schemes stay float64 numpy; the
``Device*`` schemes evaluate the batched ops of ``ops.sampling`` on their
``device`` (default ``cuda``) and return numpy, as the JAX package's do.

Shapes are the reference's: ``sample_points_across_ray`` returns (D, 4)
homogeneous points, ``sample_points_across_rays[_batched]`` (4, N, D) (the
device schemes (3, N, D)).
"""
import numpy as np
import torch

from ..ops import sampling as ops_sampling
from ..ops.ray_marching import voxel_traversal
from ..utils.generic_utils import resolve_device
from ..utils.geometry import (
    project,
    ray_aabbox_intersection,
    ray_ray_intersection,
)
from .image import camera_rays


def _homogeneous(points_xyz):
    return np.hstack(
        [points_xyz, np.ones((points_xyz.shape[0], 1), dtype=points_xyz.dtype)]
    )


class SamplingScheme:
    def __init__(self, generation_params):
        self.sampling_type = generation_params.sampling_type
        self.n_points = generation_params.depth_planes
        self._gp = generation_params

    def _get_ray_from_pixel(self, scene, i, y, x):
        pixel = np.array([[x, y, 1]]).T
        origin, destination = scene.get_image(i).ray(pixel)
        return origin, destination

    def _points_in_line(self, start, end, t):
        points = (start + t * (end - start)).T
        return points.astype(np.float32)

    def sample_points_across_ray(self, scene, i, y, x):
        raise NotImplementedError()

    def sample_points_across_rays(self, scene, i):
        raise NotImplementedError()

    def sample_points_across_rays_batched(self, scene, i, batch):
        raise NotImplementedError()


class SamplingInBboxScheme(SamplingScheme):
    """Uniform samples between the ray's bbox entry and exit."""

    def sample_points_across_ray(self, scene, i, y, x):
        origin, destination = self._get_ray_from_pixel(scene, i, y, x)
        bbox = scene.bbox
        t_near, t_far = ray_aabbox_intersection(
            origin[:3], destination[:3], bbox[0, :3], bbox[0, 3:]
        )
        if t_near is None or t_far is None:
            return None
        t = np.linspace(t_near, t_far, self.n_points, dtype=np.float32)
        return self._points_in_line(origin, destination, t)

    def _rays_to_points(self, camera_center, directions, bbox):
        """(4, N, D) points for explicit origin/directions (float64)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (bbox[:3].reshape(3, 1) - camera_center[:3]) / directions[:3]
            t2 = (bbox[3:].reshape(3, 1) - camera_center[:3]) / directions[:3]
        t_near = np.minimum(t1, t2).max(axis=0)
        t_far = np.maximum(t1, t2).min(axis=0)
        t = np.linspace(t_near, t_far, self.n_points, axis=-1)  # (N, D)
        pts = camera_center[:, :, None] + directions[:, :, None] * t[None]
        return pts.astype(np.float32)  # (4, N, D); homogeneous row stays 1

    def sample_points_across_rays(self, scene, i):
        camera_center, rays = camera_rays(scene.get_image(i).camera,
                                          *scene.image_shape)
        directions = rays.T - camera_center
        return self._rays_to_points(
            camera_center, directions, scene.bbox.reshape(-1)
        )

    def sample_points_across_rays_batched(self, scene, i, batch):
        camera_center, rays = camera_rays(scene.get_image(i).camera,
                                          *scene.image_shape)
        directions = (rays.T - camera_center)[:, batch]
        return self._rays_to_points(
            camera_center, directions, scene.bbox.reshape(-1)
        )


class SamplingInRangeScheme(SamplingScheme):
    """Uniform metric depths on the normalized direction."""

    def __init__(self, generation_params):
        super().__init__(generation_params)
        self._range = generation_params.depth_range

    def sample_points_across_ray(self, scene, i, y, x):
        origin, destination = self._get_ray_from_pixel(scene, i, y, x)
        t = np.linspace(
            self._range[0], self._range[1], self.n_points, dtype=np.float32
        )
        d = destination - origin
        d = d / np.sqrt(np.sum(d ** 2))
        return (origin + t * d).T

    def _rays_to_points(self, camera_center, directions):
        t = np.linspace(self._range[0], self._range[1], self.n_points)
        pts = camera_center[:, :, None] + directions[:, :, None] * t[
            None, None, :
        ]
        return pts.astype(np.float32)

    def _unit_directions(self, scene, i):
        camera_center, rays = camera_rays(scene.get_image(i).camera,
                                          *scene.image_shape)
        directions = rays.T - camera_center
        return camera_center, directions / np.sqrt(
            (directions ** 2).sum(axis=0))

    def sample_points_across_rays(self, scene, i):
        return self._rays_to_points(*self._unit_directions(scene, i))

    def sample_points_across_rays_batched(self, scene, i, batch):
        camera_center, directions = self._unit_directions(scene, i)
        return self._rays_to_points(camera_center, directions[:, batch])


class SamplingInDisparityScheme(SamplingScheme):
    """Uniform in the farthest neighbor's image plane, back-triangulated."""

    def sample_points_across_ray(self, scene, i, y, x):
        bbox = scene.bbox
        origin, destination = self._get_ray_from_pixel(scene, i, y, x)
        t_near, t_far = ray_aabbox_intersection(
            origin[:3], destination[:3], bbox[0, :3], bbox[0, 3:]
        )
        if t_near is None or t_far is None:
            return None

        direction = destination - origin
        p_near = (origin + t_near * direction).T
        p_far = (origin + t_far * direction).T

        images = scene.get_image_with_neighbors(i)
        far_view = images[-1]
        pixel_near = project(far_view.camera.P, p_near.T)[:-1]
        pixel_far = project(far_view.camera.P, p_far.T)[:-1]

        t = np.linspace(0, 1, self.n_points, dtype=np.float32)
        pixels = (pixel_near + t * (pixel_far - pixel_near)).T
        pixels = np.hstack((pixels, np.ones((self.n_points, 1))))

        points = []
        for p in pixels:
            n_origin, n_destination = far_view.ray(p.reshape(-1, 1))
            n_direction = n_destination - n_origin
            point = ray_ray_intersection(
                origin[:-1], direction[:-1], n_origin[:-1], n_direction[:-1]
            )
            points.append(np.hstack((point[0], [1.0])))
        return np.array(points, dtype=np.float32)


class SamplingInVoxelSpaceScheme(SamplingScheme):
    """Points = centers of the voxels the ray marches through (the march
    runs on the CPU, as a scalar path)."""

    def __init__(self, generation_params):
        super().__init__(generation_params)
        self._grid_shape = generation_params.grid_shape
        self.n_points = generation_params.max_number_of_marched_voxels

    def sample_points_across_ray(self, scene, i, y, x):
        bbox = scene.bbox
        origin, destination = self._get_ray_from_pixel(scene, i, y, x)
        t_near, t_far = ray_aabbox_intersection(
            origin[:3], destination[:3], bbox[0, :3], bbox[0, 3:]
        )
        if t_near is None or t_far is None:
            return None

        direction = destination - origin
        p_near = (origin + t_near * direction)[:3].reshape(1, 3)
        p_far = (origin + t_far * direction)[:3].reshape(1, 3)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32))

        vox, cnt = voxel_traversal(
            f32(bbox.reshape(-1)), f32(p_near), f32(p_far),
            tuple(int(g) for g in self._grid_shape), self.n_points,
        )
        idxs = vox[0][: int(cnt[0])].numpy()
        grid = scene.voxel_grid(self._grid_shape)
        points = grid[:, idxs[:, 0], idxs[:, 1], idxs[:, 2]].T
        return _homogeneous(points.astype(np.float32))


class _DeviceScheme:
    """All-rays sampling evaluated by an ``ops.sampling`` op on
    ``device``."""

    def __init__(self, generation_params, device="cuda"):
        super().__init__(generation_params)
        self.device = resolve_device(device)

    def _extra(self, scene):
        raise NotImplementedError()

    def sample_points_across_rays(self, scene, i):
        H, W = scene.image_shape
        image = scene.get_image(i)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        pts = self._op(
            torch.arange(H * W, dtype=torch.int32, device=self.device),
            f32(image.camera.P_pinv), f32(image.camera.center[:3, 0]),
            f32(self._extra(scene)), H, self.n_points,
        )
        return np.moveaxis(pts.cpu().numpy(), -1, 0)  # (3, N, D)


class DeviceSamplingInBboxScheme(_DeviceScheme, SamplingInBboxScheme):
    """All-rays bbox sampling on the device."""

    _op = staticmethod(ops_sampling.sample_points_in_bbox)

    def _extra(self, scene):
        return scene.bbox.reshape(-1)


class DeviceSamplingInRangeScheme(_DeviceScheme, SamplingInRangeScheme):
    """All-rays range sampling on the device."""

    _op = staticmethod(ops_sampling.sample_points_in_range)

    def _extra(self, scene):
        return self._range


class DummySamplingScheme:
    def __init__(self, generation_params):
        self.sampling_type = generation_params.sampling_type


def get_sampling_scheme(name):
    """The scheme class of ``name`` (the reference factory's names; the
    tf_* aliases map onto the device schemes)."""
    return {
        "sample_in_bbox": SamplingInBboxScheme,
        "sample_in_disparity": SamplingInDisparityScheme,
        "sample_in_range": SamplingInRangeScheme,
        "sample_in_voxel_space": SamplingInVoxelSpaceScheme,
        "tf_sample_in_bbox": DeviceSamplingInBboxScheme,
        "tf_sample_in_range": DeviceSamplingInRangeScheme,
        "device_sample_in_bbox": DeviceSamplingInBboxScheme,
        "device_sample_in_range": DeviceSamplingInRangeScheme,
        "full_tf_sample_in_bbox": DummySamplingScheme,
        "full_tf_sample_in_range": DummySamplingScheme,
    }[name]


def make_sampling_scheme(name, generation_params, device="cuda"):
    """An instance of ``name``'s scheme; ``device`` reaches the device
    schemes only."""
    cls = get_sampling_scheme(name)
    if issubclass(cls, _DeviceScheme):
        return cls(generation_params, device=device)
    return cls(generation_params)

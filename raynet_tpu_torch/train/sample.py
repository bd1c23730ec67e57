"""Training-sample generation: rays with GT depth targets and multi-view
patch stacks, drawn on the host in numpy; RayNet samples add each ray's
voxel traversal and a one-hot target over the visited voxels.

Port of ``raynet_tpu/train/sample.py``: the same namedtuple sample records,
rejection rules (no GT depth / target outside the bbox / any patch outside
any view / ray missing the voxel grid), scene stickiness and (scene, image
window) schedules. Every draw comes from the generator's ``rng`` (a
``np.random.RandomState``), so two generators seeded alike, in either
package, give the same samples.

A RayNet sample is made in two steps: ``draw`` (host: the schedule, the
pixel, the target, the points and the patches) and ``finish`` (the voxel
traversal of many drawn rays in one ``voxel_traversal_flat`` call on the
generator's device: K3's rows mode on a card, its plain version on the
CPU). The JAX package traverses each ray alone on the host.
"""
import sys
from collections import namedtuple
from itertools import combinations

import numpy as np
import torch

from ..ops.ray_marching import unflatten_voxel_indices, voxel_traversal_flat
from ..utils.generic_utils import (
    point_from_depth,
    point_to_voxel,
    resolve_device,
)
from ..utils.geometry import point_in_aabbox


SampleFromImage = namedtuple(
    "SampleFromImage", ["img_idx", "patch_x", "patch_y", "points", "target"]
)
Sample = namedtuple(
    "Sample", ["scene_idx", "img_idx", "patch_x", "patch_y", "points", "X", "y"]
)
RayNetSample = namedtuple(
    "RayNetSample",
    [
        "scene_idx",
        "img_idx",
        "patch_x",
        "patch_y",
        "points",
        "X",
        "y",
        "Nr",
        "ray_voxel_indices",
        "camera_center",
    ],
)
# A drawn RayNet sample before its traversal: X is None when the host
# rejected it; ``snapshot`` is the generator's state before the draw was
# counted as accepted (``RayNetSampleGenerator.restore``).
RayNetDraw = namedtuple(
    "RayNetDraw",
    ["scene_idx", "img_idx", "patch_x", "patch_y", "points", "X", "target",
     "camera_center", "bbox", "snapshot"],
)


def create_combinations_of_patches(patches, n_pairs=2):
    return [list(p) for p in combinations(patches, n_pairs)]


def is_empty(x):
    return x.sum() == -np.prod(x.shape)


class SampleGenerator:
    """Draws (ray, target-distribution, patch-stack) samples from a dataset."""

    def __init__(
        self,
        sampling_scheme,
        generation_params,
        scenes_range,
        input_shapes,
        output_shapes,
        repeat_from_same_scene=1000,
        *,
        rng,
    ):
        self._sampling_scheme = sampling_scheme
        self._generation_params = generation_params
        self._scenes_range = scenes_range
        self.input_shapes = input_shapes
        self.output_shapes = output_shapes
        self._repeat_from_same_scene = repeat_from_same_scene
        self._cnt_same_scenes = sys.maxsize
        self._scene_idx = 0
        self._rng = rng

    def set_sampling_scheme(self, sampling_scheme):
        self._sampling_scheme = sampling_scheme

    @property
    def generation_params(self):
        return self._generation_params

    def compute_X(self, images, points, y, target):
        raise NotImplementedError()

    def compute_y(self, points, target):
        return self._generation_params.target_distribution_factory(
            np.vstack([target, [1]]), points
        )

    def _compute_patches_from_point(self, images, point):
        expand = self._generation_params.expand_patch
        patches = [
            im.patch_from_3d(
                point.reshape(-1, 1),
                self._generation_params.patch_shape[:2],
                expand,
            )
            for im in images
        ]
        if not expand and any(map(is_empty, patches)):
            return None
        return patches

    def _compute_patches_from_points(self, images, points):
        """(views, D) patch stack, or None if any projection leaves any
        image."""
        gp = self._generation_params
        views = gp.neighbors + 1
        shape = (views, gp.depth_planes) + tuple(gp.patch_shape)
        X = np.empty(shape, dtype=np.float32)
        for i, im in enumerate(images):
            patches = im.patches_from_3d_points(points, gp.patch_shape[:2])
            if patches is None:
                return None
            X[i] = patches.reshape((gp.depth_planes,) + tuple(gp.patch_shape))
        return X

    def _get_sample_from_image_idx(self, scene, img_idx):
        images = scene.get_image_with_neighbors(
            img_idx, self._generation_params.neighbors
        )
        px, py, _ = images[0].random_pixel(self._rng)[:, 0]
        bs = self._get_sample_from_patch_idx(
            scene, images[0], img_idx, px, py
        )
        return bs, images

    def _get_sample_from_patch_idx(self, scene, ref_img, img_idx, px, py):
        reject = SampleFromImage(
            img_idx=img_idx, patch_x=px, patch_y=py, points=None, target=None
        )
        depth = scene.get_depth_for_pixel(img_idx, py, px)
        if depth is None or depth == 0:
            return reject

        origin, direction = ref_img.ray(np.vstack([px, py, [1]]))
        target = point_from_depth(
            origin[:-1], direction[:-1] - origin[:-1], depth
        )
        bbox = scene.bbox
        if not point_in_aabbox(
            target, bbox[0, :3].reshape(-1, 1), bbox[0, 3:].reshape(-1, 1)
        ):
            return reject

        points = self._sampling_scheme.sample_points_across_ray(
            scene, img_idx, py, px
        )
        return SampleFromImage(
            img_idx=img_idx,
            patch_x=px,
            patch_y=py,
            points=points,
            target=target,
        )

    def get_sample(self, dataset):
        if self._cnt_same_scenes > self._repeat_from_same_scene:
            self._scene_idx = self._rng.choice(self._scenes_range)
            self._cnt_same_scenes = 0

        scene = dataset.get_scene(self._scene_idx)
        self._cnt_same_scenes += 1
        img_idx = self._rng.choice(np.arange(2, scene.n_images))

        bs, images = self._get_sample_from_image_idx(scene, img_idx)
        if bs.target is None or bs.points is None:
            return Sample(
                scene_idx=self._scene_idx,
                img_idx=img_idx,
                patch_x=bs.patch_x,
                patch_y=bs.patch_y,
                points=bs.points,
                X=None,
                y=None,
            )

        y = self.compute_y(bs.points, bs.target)
        X = self.compute_X(images, bs.points, y, bs.target)
        return Sample(
            scene_idx=self._scene_idx,
            img_idx=img_idx,
            patch_x=bs.patch_x,
            patch_y=bs.patch_y,
            points=bs.points,
            X=X,
            y=[y],
        )


class DefaultSampleGenerator(SampleGenerator):
    """X = patch stacks for all C(views, 2) view pairs: two inputs of shape
    (D, n_pairs) + patch_shape."""

    def compute_X(self, images, points, y, target):
        patches = self._compute_patches_from_points(images, points)
        if patches is None:
            return None
        X = np.array(
            create_combinations_of_patches(
                list(patches), len(self.input_shapes)
            )
        ).transpose([1, 2, 0, 3, 4, 5])
        return list(X)


class CompareWithReferenceSampleGenerator(SampleGenerator):
    """X = (reference, other) pairs only."""

    def compute_X(self, images, points, y, target):
        patches = self._compute_patches_from_points(images, points)
        if patches is None:
            return None
        X = np.array([[patches[0], p] for p in patches[1:]]).transpose(
            [1, 2, 0, 3, 4, 5]
        )
        return list(X)


class HartmannSampleGenerator(SampleGenerator):
    """Positive/negative patch quintuples (Hartmann et al. 2017)."""

    def _get_positive_index(self, target_distribution):
        return int(np.argmax(target_distribution))

    def _get_negative_index(self, target_distribution):
        pos_idx = self._get_positive_index(target_distribution)
        gp = self._generation_params
        new_depths = np.delete(
            np.arange(gp.depth_planes),
            range(
                max(0, pos_idx - gp.step_depth),
                min(pos_idx + gp.step_depth, gp.depth_planes),
            ),
        )
        return self._rng.choice(new_depths)

    def compute_y(self, points, target):
        if self._rng.random() > 0.5:
            return np.array([1.0, 0.0], dtype=np.float32).reshape(1, 1, 2)
        return np.array([0.0, 1.0], dtype=np.float32).reshape(1, 1, 2)

    def compute_X(self, images, points, y, target):
        td = self._generation_params.target_distribution_factory(
            np.vstack([target, [1]]), points
        )
        idx = (
            self._get_positive_index(td)
            if y[0, 0, 0] == 1
            else self._get_negative_index(td)
        )
        X = self._compute_patches_from_point(images, points[idx])
        return None if X is None else np.array(X)


class RayNetSampleGenerator(SampleGenerator):
    """Adds per-ray voxel traversal and a one-hot voxel-space target.

    ``draw(dataset)`` takes the schedule's next reference image and draws a
    ray on the host. A draw the host keeps is counted as accepted at once,
    and its ``snapshot`` holds the generator's state from before that
    count. ``finish(draws)`` traverses the kept draws and turns them into
    ``RayNetSample``s; one whose ray visits no voxel (``Nr == 0``) is a
    rejection, and ``restore(draw.snapshot)`` then puts the generator where
    the JAX generator would be after rejecting it: every later draw must be
    dropped and drawn again. ``get_sample`` is both steps for one sample.
    """

    def __init__(
        self,
        sampling_scheme,
        generation_params,
        scenes_range,
        input_shapes,
        output_shapes,
        n_rays=10000,
        window=4,
        *,
        rng,
        device="cuda",
    ):
        super().__init__(
            sampling_scheme,
            generation_params,
            scenes_range,
            input_shapes,
            output_shapes,
            rng=rng,
        )
        self.device = resolve_device(device)
        self._window = window
        self._n_rays = n_rays
        self._rays_cnt = 0
        self._scene_idx = 0
        self._img_idx = 2

    def compute_X(self, images, points, y, target):
        return self._compute_patches_from_points(images, points)

    def _draw(self, scene, scene_idx, img_idx):
        """The host's part of a sample from reference image ``img_idx``."""
        bs, images = self._get_sample_from_image_idx(scene, img_idx)
        X = None
        if bs.target is not None and bs.points is not None:
            X = self.compute_X(images, bs.points, None, None)
        return RayNetDraw(
            scene_idx=scene_idx, img_idx=img_idx, patch_x=bs.patch_x,
            patch_y=bs.patch_y, points=bs.points, X=X, target=bs.target,
            camera_center=images[0].camera.center, bbox=scene.bbox,
            snapshot=None,
        )

    def _snapshot(self):
        return (self._rng.get_state(), self._rays_cnt, self._scene_idx,
                self._img_idx)

    def restore(self, snapshot):
        """Return to the state of ``snapshot`` (a draw's)."""
        state, self._rays_cnt, self._scene_idx, self._img_idx = snapshot
        self._rng.set_state(state)

    def draw(self, dataset):
        """Draw the next sample on the host (a ``RayNetDraw``)."""
        scene_idx = self._scenes_range[self._scene_idx]
        scene = dataset.get_scene(scene_idx)
        d = self._draw(scene, scene_idx, self._draw_img_idx(scene, self._rng))
        if d.X is not None:
            d = d._replace(snapshot=self._snapshot())
            self._rays_cnt += 1
        self._advance(scene)
        return d

    @staticmethod
    def _reject(d):
        return RayNetSample(
            scene_idx=d.scene_idx, img_idx=d.img_idx, patch_x=d.patch_x,
            patch_y=d.patch_y, points=d.points, X=None, y=None, Nr=None,
            ray_voxel_indices=None, camera_center=d.camera_center,
        )

    def finish(self, draws):
        """``RayNetSample``s of kept draws: their rays traversed in one
        ``voxel_traversal_flat`` call per scene on this generator's device,
        the target's voxel found among each ray's M rows (the zero tail
        included, as in the JAX package), a one-hot ``y``. A ray that
        visits no voxel gives a rejected sample (X None)."""
        gp = self._generation_params
        grid_shape = tuple(int(g) for g in gp.grid_shape)
        M = gp.max_number_of_marched_voxels
        out = [None] * len(draws)
        by_scene = {}
        for i, d in enumerate(draws):
            by_scene.setdefault(d.scene_idx, []).append(i)
        for idxs in by_scene.values():
            bbox = draws[idxs[0]].bbox

            def rows(k):
                return torch.as_tensor(
                    np.stack([draws[i].points[k, :-1] for i in idxs]).astype(
                        np.float32), device=self.device)

            flat, counts = voxel_traversal_flat(
                torch.as_tensor(bbox.ravel().astype(np.float32),
                                device=self.device),
                rows(0), rows(-1), grid_shape, M)
            vox = unflatten_voxel_indices(flat, grid_shape).to(
                torch.int32).cpu().numpy()
            counts = counts.cpu().numpy()
            bin_size = (bbox[0, 3:].T - bbox[0, :3].T) / np.asarray(grid_shape)
            for j, i in enumerate(idxs):
                d = draws[i]
                Nr = int(counts[j])
                if Nr == 0:
                    out[i] = self._reject(d)
                    continue
                v = point_to_voxel(d.target, bbox[:, :3].T,
                                   bin_size.reshape(-1, 1))
                y = np.zeros((M,), dtype=np.float32)
                y[np.abs(vox[j] - v.T).sum(axis=-1).argmin()] = 1.0
                out[i] = RayNetSample(
                    scene_idx=d.scene_idx, img_idx=d.img_idx,
                    patch_x=d.patch_x, patch_y=d.patch_y, points=d.points,
                    X=d.X, y=y, Nr=Nr, ray_voxel_indices=vox[j],
                    camera_center=d.camera_center,
                )
        return out

    def _draw_img_idx(self, scene, rng):
        """Next reference-image index (separable so that parallel providers
        can draw with per-worker RNGs)."""
        return self._img_idx + int(rng.rand() * self._window)

    def _advance(self, scene):
        """Move the (scene, image-window) schedule forward once enough rays
        were accepted from the current position."""
        if self._rays_cnt >= self._n_rays:
            self._rays_cnt = 0
            self._img_idx += 2
            if self._img_idx >= scene.n_images - self._window:
                self._img_idx = 2
                self._scene_idx += 1
            if self._scene_idx >= len(self._scenes_range):
                self._scene_idx = 0

    def get_sample(self, dataset):
        d = self.draw(dataset)
        if d.X is None:
            return self._reject(d)
        (s,) = self.finish([d])
        if s.X is None:
            self.restore(d.snapshot)
        return s


class RayNetRandomSampleGenerator(RayNetSampleGenerator):
    """RayNet samples with random image/scene advancement."""

    def _draw_img_idx(self, scene, rng):
        return rng.choice(np.arange(2, scene.n_images - self._window))

    def _advance(self, scene):
        if self._rays_cnt >= self._n_rays:
            self._rays_cnt = 0
            self._scene_idx = self._rng.choice(
                np.arange(len(self._scenes_range))
            )

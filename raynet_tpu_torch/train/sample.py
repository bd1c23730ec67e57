"""Training-sample generation for pretraining: rays with GT depth targets
and multi-view patch stacks, on the host in numpy.

Port of ``raynet_tpu/train/sample.py:1-255``: the same namedtuple sample
records, rejection rules (no GT depth / target outside the bbox / any patch
outside any view) and scene stickiness. Every draw comes from the
generator's ``rng`` (a ``np.random.RandomState``), so two generators seeded
alike, in either package, give the same samples.
"""
import sys
from collections import namedtuple
from itertools import combinations

import numpy as np

from ..utils.generic_utils import point_from_depth
from ..utils.geometry import point_in_aabbox


SampleFromImage = namedtuple(
    "SampleFromImage", ["img_idx", "patch_x", "patch_y", "points", "target"]
)
Sample = namedtuple(
    "Sample", ["scene_idx", "img_idx", "patch_x", "patch_y", "points", "X", "y"]
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

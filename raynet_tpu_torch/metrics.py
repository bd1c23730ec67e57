"""Reconstruction metrics and point-cloud filters.

Port of ``raynet_tpu/metrics.py``: PerPixelMeanDepthError (nonzero-GT
pixels inside borders), Accuracy (predicted->GT NN distances, truncated),
Completeness (GT->predicted), VoxelMask (DTU ObsMask grid filter),
ReduceDensity (KDTree radius thinning), FiltersFactory. They work on the
host, on (3, N) numpy point clouds, with scipy's ``cKDTree`` as in the JAX
package; the GT point cloud backprojected from depth maps
(``use_pc_from_depthmap``) is computed on ``device``.
"""
import os

import numpy as np
from scipy.spatial import cKDTree

from .pointcloud import Pointcloud, PointcloudFromDepthMaps
from .utils.geometry import keep_points_in_aabbox


def _check_points(X):
    if X.shape[0] != 3:
        raise ValueError("expected a (3, N) point cloud, got %s" % (X.shape,))


class FiltersFactory:
    def __init__(self, filters):
        self.filters = filters

    @property
    def has_filters(self):
        return len(self.filters) > 0

    def filter(self, X):
        for f in self.filters:
            X = f.filter(X)
        return X


class VoxelMask:
    """Keep points falling into mask==1 cells of a voxel grid over bbox."""

    def __init__(self, bbox, mask, output_directory=None):
        if bbox.shape != (1, 6) or not np.all(bbox[0, :3] < bbox[0, 3:]):
            raise ValueError("VoxelMask: bbox must be (1, 6) with min < max, "
                             "got %s" % (bbox,))
        self._bbox_min = bbox[0, :3, np.newaxis]
        self._bbox_max = bbox[0, 3:, np.newaxis]
        self._grid_shape = np.array(mask.shape).reshape(3, 1)
        self._mask = mask
        self._steps = (self._bbox_max - self._bbox_min) / self._grid_shape
        self.output_directory = output_directory

    def filter(self, X):
        _check_points(X)
        points = keep_points_in_aabbox(X, self._bbox_min, self._bbox_max)
        idxs = np.round(
            (points - self._bbox_min - self._steps / 2) / self._steps
        ).astype(int)
        idxs = np.clip(idxs, 0, self._grid_shape - 1)
        points = points[:, self._mask[idxs[0], idxs[1], idxs[2]] == 1]

        if self.output_directory is not None:
            Pointcloud(points).save_ply(
                os.path.join(self.output_directory, "pc_inside_voxel_mask.ply")
            )
        return points


class ReduceDensity:
    """Greedy radius-based thinning in random visit order (numpy's global
    generator, as in the JAX package)."""

    def __init__(self, min_dist, output_directory=None):
        self._min_dist = min_dist
        self.output_directory = output_directory

    def filter(self, X):
        _check_points(X)
        keep = np.ones(X.shape[1], dtype=bool)
        order = np.arange(X.shape[1])
        np.random.shuffle(order)

        tree = cKDTree(X.T)
        neighbor_lists = tree.query_ball_point(X[:, order].T, self._min_dist)
        for ids, i in zip(neighbor_lists, order):
            if keep[i]:
                keep[ids] = False
                keep[i] = True

        if self.output_directory is not None:
            Pointcloud(X[:, keep]).save_ply(
                os.path.join(
                    self.output_directory, "pc_after_density_reduction.ply"
                )
            )
        return X[:, keep]


class Metric:
    def compute(self, scene, frame_idxs, depthmaps, predicted_pointcloud):
        raise NotImplementedError()


class PerPixelMeanDepthError(Metric):
    def __init__(self, borders=40):
        self.borders = borders

    def compute(self, scene, frame_idxs, depthmaps, predicted_pointcloud):
        metric = np.zeros((len(frame_idxs),))
        H, W = scene.image_shape
        bh = slice(self.borders, H - self.borders)
        bw = slice(self.borders, W - self.borders)
        for i, (fi, d) in enumerate(zip(frame_idxs, depthmaps)):
            G = scene.get_depth_map(fi)[bh, bw]
            D = np.load(d)[bh, bw]
            pixels = G != 0
            metric[i] = np.abs(G[pixels] - D[pixels]).mean()
        return metric, None


class _CloudToCloud(Metric):
    def __init__(
        self,
        filter_factory=None,
        truncate=float("inf"),
        borders=40,
        use_pc_from_depthmap=False,
        device="cuda",
    ):
        self.filter_factory = filter_factory
        self.truncate = truncate
        self.borders = borders
        self.use_pc_from_depthmap = use_pc_from_depthmap
        self.device = device

    def _ground_truth_pc(self, scene, frame_idxs):
        if self.use_pc_from_depthmap:
            gt_depthmaps = [scene.get_depthmap_file(i) for i in frame_idxs]
            return PointcloudFromDepthMaps(
                scene, frame_idxs, gt_depthmaps, self.borders,
                device=self.device,
            )
        return scene.get_pointcloud()


class Accuracy(_CloudToCloud):
    """Distances predicted -> ground truth (how accurate the prediction is)."""

    def compute(self, scene, frame_idxs, depthmaps, predicted_pointcloud):
        gt_pc = self._ground_truth_pc(scene, frame_idxs)
        if self.filter_factory is not None and self.filter_factory.has_filters:
            gt_pc.filter(self.filter_factory)
            predicted_pointcloud.filter(self.filter_factory)
        gt_pc.index()
        distances, _ = gt_pc.nearest_neighbors(predicted_pointcloud.points)
        return np.minimum(distances, self.truncate), predicted_pointcloud.points


class Completeness(_CloudToCloud):
    """Distances ground truth -> predicted (how complete the prediction is)."""

    def compute(self, scene, frame_idxs, depthmaps, predicted_pointcloud):
        gt_pc = self._ground_truth_pc(scene, frame_idxs)
        if self.filter_factory is not None and self.filter_factory.has_filters:
            gt_pc.filter(self.filter_factory)
            predicted_pointcloud.filter(self.filter_factory)
        predicted_pointcloud.index()
        distances, _ = predicted_pointcloud.nearest_neighbors(gt_pc.points)
        return np.minimum(distances, self.truncate), gt_pc.points

"""Scene = images + cameras + bbox + ground truth, per dataset flavor.

Port of ``raynet_tpu/common/scene.py``: RestrepoScene (aerial: imgs/ +
cams_krt/ + scene_info.xml, GT depth from cached gt/gt_depth_%d.npy or a
batched first-hit raycast of the GT mesh, ``utils.raycast``, on the scene's
``device``; the GT point cloud is the mesh's vertices) and DTUScene
(Rectified/ images filtered by illumination, Calibration/cal18 P matrices
decomposed via K^-1 P, ObsMask .mat bbox, npy GT depth maps re-expressed as
camera-center ray distances, the STL point export as GT point cloud). The
per-pixel OctTree raycast (``get_depth_for_pixel``) stays for single
pixels.
"""
import os
from functools import lru_cache

import numpy as np
import torch

from .image import Image
from .parse_input_data import (
    parse_gt_data,
    parse_gt_mesh,
    parse_scene_info,
    parse_scene_info_dtu_dataset,
    parse_stl_file_to_pointcloud,
)
from ..utils.generic_utils import get_voxel_grid, resolve_device
from ..utils.geometry import distance, project
from ..utils.oct_tree import OctTree
from ..utils.raycast import ray_mesh_first_hit
from ..utils.training_utils import (
    get_adjacent_frames_idxs,
    get_ray_meshes_first_intersection,
)


def mesh_depth_map(camera, height, width, triangles, device):
    """(height, width) float32 distances from the camera centre to the
    first triangle each pixel's ray hits, 0 where it hits none: the rays of
    ``Image.rays`` (column-major), normalised in float64 and cast to
    float32 as the JAX package's ``RestrepoScene.get_depth_map`` does, then
    ``ray_mesh_first_hit`` on ``device``. ``camera`` needs ``P_pinv`` and
    ``center``; ``triangles`` is (T, 3, 3)."""
    device = resolve_device(device)
    u = np.repeat(np.arange(width), height)
    v = np.tile(np.arange(height), width)
    pixels = np.stack([u, v, np.ones_like(u)]).astype(np.float64)
    rays = project(camera.P_pinv, pixels)
    center = camera.center
    directions = rays[:, :3] - center[:3, 0][None]
    directions = directions / np.linalg.norm(directions, axis=1,
                                             keepdims=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    depths = ray_mesh_first_hit(
        f32(center[:3, 0]), f32(directions), f32(triangles)
    ).cpu().numpy()
    return depths.reshape(width, height).T


class Scene:
    """``device``: where the scene's own tensor work runs (the GT
    raycast); checked when it is first used."""

    def __init__(self, select_neighbors_based_on="filesystem",
                 device="cuda"):
        self._voxel_grid = None
        self._camera_neighbors = None
        self._select_neighbors_based_on = select_neighbors_based_on
        self.device = device

    @staticmethod
    def _load_sorted_files(basepath, subdir, condition=None):
        path = os.path.join(basepath, subdir)
        return [
            os.path.join(path, f)
            for f in sorted(filter(condition, os.listdir(path)))
        ]

    def _get_neighbor_idxs(self, i, neighbors):
        if self._select_neighbors_based_on == "distance":
            return self._get_adjacent_camera_centers(neighbors)[i]
        elif self._select_neighbors_based_on == "filesystem":
            return get_adjacent_frames_idxs(i, self.n_images, neighbors, 0)
        raise NotImplementedError(
            "unknown neighbor policy %r" % (self._select_neighbors_based_on,)
        )

    def _get_adjacent_camera_centers(self, neighbors, skip=0):
        if self._camera_neighbors is None:
            centers = np.hstack(
                [self.get_image(i).camera.center for i in range(self.n_images)]
            )
            d = ((centers.T[:, :, None] - centers[None]) ** 2).sum(axis=1)
            self._camera_neighbors = d.argsort()[:, 1 : neighbors + 1 : skip + 1]
        return self._camera_neighbors

    @property
    def bbox(self):
        raise NotImplementedError()

    @property
    def n_images(self):
        raise NotImplementedError()

    @property
    def image_shape(self):
        im = self.get_image(0)
        return im.height, im.width

    @property
    def observation_mask(self):
        return None

    @property
    def gt_depth_range(self):
        D = self.get_depth_map(0)
        return np.min(D[D != 0]), np.max(D)

    def get_image(self, i):
        raise NotImplementedError()

    def get_images(self):
        return [self.get_image(i) for i in range(self.n_images)]

    def get_view_idxs(self, i, neighbors=4):
        """Reference view index followed by its neighbor indices, in the
        order ``get_image_with_neighbors`` loads them."""
        return [i] + [
            int(n) for n in self._get_neighbor_idxs(i, neighbors)
        ]

    def get_random_image(self, rng=np.random):
        return self.get_image(rng.choice(np.arange(0, self.n_images)))

    def get_image_with_neighbors(self, i, neighbors=4):
        return [self.get_image(j) for j in self.get_view_idxs(i, neighbors)]

    def get_depth_for_pixel(self, i, y, x):
        raise NotImplementedError()

    def get_depth_map(self, i):
        h, w = self.image_shape
        dm = np.zeros((h, w), dtype=np.float32)
        for x in range(w):
            for y in range(h):
                d = self.get_depth_for_pixel(i, y, x)
                dm[y, x] = 0.0 if d is None else d
        return dm

    def get_depth_maps(self):
        return [self.get_depth_map(i) for i in range(self.n_images)]

    def get_depthmap_file(self, i):
        return None

    def get_pointcloud(self):
        """The ground-truth point cloud (a ``pointcloud.Pointcloud``)."""
        raise NotImplementedError()

    def voxel_grid(self, grid_shape):
        if self._voxel_grid is None:
            if self.bbox is None:
                raise ValueError("bbox needs to be different than None")
            self._voxel_grid = get_voxel_grid(self.bbox, grid_shape)
        return self._voxel_grid.astype(np.float32)


class RestrepoScene(Scene):
    """Aerial (Restrepo) scene directory."""

    def __init__(self, basepath, select_neighbors_based_on="filesystem",
                 device="cuda"):
        super().__init__(select_neighbors_based_on, device)
        self._basepath = basepath
        self._image_paths = self._load_sorted_files(basepath, "imgs")
        self._cam_paths = self._load_sorted_files(basepath, "cams_krt")
        self._bbox_path = os.path.join(basepath, "scene_info.xml")
        self._bbox = None
        self._oct_tree = None
        self._triangles = None
        self._cache = [None] * len(self._image_paths)
        self._cache_depth_maps = [None] * len(self._image_paths)

    @property
    def n_images(self):
        return len(self._image_paths)

    @property
    def bbox(self):
        if self._bbox is None:
            self._bbox = parse_scene_info(self._bbox_path)
        return self._bbox

    def get_image(self, i):
        if self._cache[i] is None:
            self._cache[i] = Image.from_file(
                self._image_paths[i], self._read_camera_poses(i)
            )
        return self._cache[i]

    def _has_gt_depth(self, i):
        gt_file = os.path.join(self._basepath, "gt", "gt_depth_%d.npy" % (i,))
        return os.path.isfile(gt_file)

    def get_depth_for_pixel(self, i, y, x):
        im = self.get_image(i)
        origin, destination = im.ray(
            np.array([[x, y, 1.0]], dtype=np.float64).T
        )
        target_point = get_ray_meshes_first_intersection(
            origin, destination, self._get_oct_tree()
        )
        if target_point is None:
            return None
        return distance(target_point[:-1], im.camera.center[:-1])

    def get_depth_map(self, i):
        """Full GT depth map: the cached gt/gt_depth_%d.npy when present,
        else the first hits of every pixel's ray on the GT mesh
        (``ray_mesh_first_hit`` on the scene's device; 0 where a ray hits
        nothing), computed once per image."""
        f = self.get_depthmap_file(i)
        if f is not None:
            return np.load(f)
        if self._cache_depth_maps[i] is None:
            self._cache_depth_maps[i] = self._raycast_depth_map(i)
        return self._cache_depth_maps[i]

    def _raycast_depth_map(self, i):
        if self._triangles is None:
            self._triangles = parse_gt_mesh(self._basepath)
        h, w = self.image_shape
        return mesh_depth_map(self.get_image(i).camera, h, w,
                              self._triangles, self.device)

    def get_depthmap_file(self, i):
        if not self._has_gt_depth(i):
            return None
        return os.path.join(self._basepath, "gt", "gt_depth_%d.npy" % (i,))

    def _read_camera_poses(self, i):
        """cams_krt text layout: K (3 rows), R (3 rows), t (1 row)."""
        with open(self._cam_paths[i]) as f:
            rows = [
                x.strip().split(" ") for x in f.readlines() if x != "\n"
            ]
        return {
            "K": np.array(rows[0:3]).astype(np.float32),
            "R": np.array(rows[3:-1]).astype(np.float32),
            "t": np.array(rows[-1]).astype(np.float32).reshape(-1, 1),
        }

    def _get_oct_tree(self):
        if self._oct_tree is None:
            self._oct_tree = OctTree(parse_gt_mesh(self._basepath))
        return self._oct_tree

    def get_pointcloud(self):
        """The GT mesh's vertices."""
        from ..pointcloud import Pointcloud

        points, _, _ = parse_gt_data(self._basepath)
        return Pointcloud(points.T)


class DTUScene(Scene):
    """DTU MVS scan."""

    def __init__(
        self,
        basepath,
        scene_idx,
        illumination="max",
        select_neighbors_based_on="filesystem",
        device="cuda",
    ):
        super().__init__(select_neighbors_based_on, device)
        self._basepath = basepath

        image_paths = self._load_sorted_files(
            basepath,
            os.path.join("Rectified", "scan%03d" % (scene_idx,)),
            lambda i: illumination in i,
        )
        # GT depth maps exist only for the first 49 frames
        self._image_paths = [
            ip
            for ip in image_paths
            if int(os.path.basename(ip).split(".")[0].split("_")[1]) <= 49
        ]
        self._cam_paths = self._load_sorted_files(
            basepath,
            "SampleSet/MVS_Data/Calibration/cal18",
            lambda i: "pos" in i,
        )
        self._cam_intrinsic_path = os.path.join(
            basepath, "SampleSet/MVS_Data/Calibration/cal18/intrinsic.txt"
        )
        self._bbox_path = os.path.join(
            basepath,
            "SampleSet/MVS_Data/ObsMask",
            "ObsMask%d_10.mat" % (scene_idx,),
        )
        self._depth_map_paths = self._load_sorted_files(
            basepath,
            os.path.join("Depth", "scan%03d" % (scene_idx,)),
            lambda i: i.endswith("npy"),
        )
        self._gt_stl_path = os.path.join(
            basepath, "Points/stl/stl%03d_total.ply" % (scene_idx,)
        )

        self._bbox = None
        self._cache = [None] * len(self._image_paths)
        self._cache_depth_maps = [None] * len(self._image_paths)

    @property
    def n_images(self):
        return len(self._image_paths)

    @property
    def bbox(self):
        if self._bbox is None:
            self._bbox = parse_scene_info_dtu_dataset(self._bbox_path)
        return self._bbox

    @property
    def observation_mask(self):
        from scipy.io import loadmat

        return loadmat(self._bbox_path)["ObsMask"]

    def get_image(self, i):
        if self._cache[i] is None:
            self._cache[i] = Image.from_file(
                self._image_paths[i], self._read_camera_poses(i)
            )
        return self._cache[i]

    def _read_camera_poses(self, i):
        """Shared intrinsics + per-view P decomposed as [R|t] = K^-1 P."""
        with open(self._cam_intrinsic_path) as f:
            rows = [x.strip().split(" ") for x in f.readlines()]
        K = np.array(rows[0:3]).astype(np.float32)

        with open(self._cam_paths[i]) as f:
            rows = [x.strip().split(" ") for x in f.readlines()]
        P = np.array(rows[0:4])[:3].astype(np.float32)

        Rt = np.linalg.inv(K).dot(P)
        return {"K": K, "R": Rt[:, :3], "t": Rt[:, -1].reshape(-1, 1)}

    @lru_cache(maxsize=8)
    def get_gt_depth_map(self, i):
        return np.load(self._depth_map_paths[i])

    def get_depth_map(self, i):
        """GT z-depth map re-expressed as ray distances from the camera."""
        if self._cache_depth_maps[i] is None:
            image = self.get_image(i)
            gt = self.get_gt_depth_map(i)
            H, W = gt.shape

            u = np.repeat(np.arange(W), H)
            v = np.tile(np.arange(H), W)
            pixels = np.stack([u, v, np.ones_like(u)]).astype(np.float64)
            p_cc = np.linalg.inv(image.camera.K) @ pixels
            p_cc = p_cc * gt.T.reshape(1, -1)
            p_cc = np.vstack([p_cc, np.ones(p_cc.shape[1])])

            T = np.vstack(
                [
                    np.hstack([image.camera.R, image.camera.t]),
                    np.array([0.0, 0.0, 0.0, 1.0]),
                ]
            )
            target = project(np.linalg.inv(T), p_cc)
            D = np.sqrt(
                ((target - image.camera.center.T) ** 2).sum(axis=-1)
            )
            D = D.reshape(W, H).T * (gt != 0)
            self._cache_depth_maps[i] = D.astype(np.float32)
        return self._cache_depth_maps[i]

    def get_depth_for_pixel(self, i, y, x):
        gt = self.get_gt_depth_map(i)
        depth_value = gt[y, x]
        if depth_value == 0:
            return None
        im = self.get_image(i)
        p_cc = np.linalg.inv(im.camera.K) @ np.array(
            [[x, y, 1]], dtype=np.float64
        ).T
        p_cc = np.vstack((p_cc * depth_value, [[1.0]]))
        T = np.vstack(
            [
                np.hstack([im.camera.R, im.camera.t]),
                np.array([0.0, 0.0, 0.0, 1.0]),
            ]
        )
        target_point = project(np.linalg.inv(T), p_cc)
        return distance(target_point[:-1], im.camera.center[:-1])

    def get_pointcloud(self):
        """The scan's STL point export."""
        from ..pointcloud import Pointcloud

        return Pointcloud(parse_stl_file_to_pointcloud(self._gt_stl_path).T)

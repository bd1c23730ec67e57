"""Point clouds from depth maps: backprojection, consistency filtering,
PLY export, kNN indexing.

Port of ``raynet_tpu/pointcloud.py``. Points are (3, N) float64 numpy
arrays, as there. The backprojection of the depth maps and the consistency
check's reprojection into the neighbouring views run as float64 tensors on
the chosen device; which pixels and which views take part is decided on
the host, as the JAX package decides it. The kNN index is scipy's
``cKDTree`` on the host, as in the JAX package, so neighbours, distances
and their ties are the same.

``save_colored_ply`` colours with the port's own ``jet`` (matplotlib's
segment table and lookup, without matplotlib).
"""
import sys

import numpy as np
import torch
from scipy.spatial import cKDTree

from .utils.generic_utils import resolve_device

# matplotlib's _jet_data: (x, y0, y1) segments per channel
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
     (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)
JET_N = 256


def _lookup_table(segments, n):
    """The n-entry table ``LinearSegmentedColormap`` samples from one
    channel's segments."""
    data = np.array(segments, dtype=float)
    x = data[:, 0] * (n - 1)
    y0, y1 = data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_lookup_table(s, JET_N) for s in _JET_SEGMENTS], axis=1)


def jet(values):
    """(N, 3) RGB floats of matplotlib's "jet" at float ``values`` in
    [0, 1], indexed as matplotlib indexes its table: ``int(x * 256)``, 1.0
    and above at the last entry, below 0 at the first, NaN black."""
    xa = np.array(values, copy=True)
    if xa.dtype.kind != "f":
        xa = xa.astype(float)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    under, over, bad = xa < 0, xa >= JET_N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = JET_N - 1
    idx[bad] = 0
    rgb = JET_LUT[idx]
    rgb[bad] = 0.0
    return rgb


class Pointcloud:
    """A (D, N) collection of points, searchable and exportable."""

    def __init__(self, points):
        self._points = points
        self._index = None

    @property
    def points(self):
        return self._points

    def save_ply(self, file):
        n = self.points.shape[1]
        header = (
            "ply\nformat binary_%s_endian 1.0\ncomment raynet_tpu"
            " pointcloud\nelement vertex %d\nproperty float x\n"
            "property float y\nproperty float z\nend_header\n"
        ) % (sys.byteorder, n)
        with open(file, "wb") as f:
            f.write(header.encode("ascii"))
            self.points.T.astype(np.float32).tofile(f)

    def save_colored_ply(self, file, intensities, colormap="jet"):
        if colormap != "jet":
            raise ValueError("save_colored_ply: only the jet colormap, got %r"
                             % (colormap,))
        colors = jet(np.asarray(intensities).ravel() / 2)
        colors = (colors * 255).astype(np.uint8)

        n = self.points.shape[1]
        header = (
            "ply\nformat binary_%s_endian 1.0\ncomment raynet_tpu"
            " pointcloud\nelement vertex %d\nproperty float x\n"
            "property float y\nproperty float z\nproperty uchar red\n"
            "property uchar green\nproperty uchar blue\nend_header\n"
        ) % (sys.byteorder, n)
        # interleave xyz (12 B) + rgb (3 B) per vertex
        rows = np.empty(n, dtype=[("xyz", np.float32, 3),
                                  ("rgb", np.uint8, 3)])
        rows["xyz"] = self.points.T
        rows["rgb"] = colors
        with open(file, "wb") as f:
            f.write(header.encode("ascii"))
            rows.tofile(f)

    def save(self, file):
        np.save(file, self.points)

    def filter(self, mask):
        self._points = mask.filter(self.points)
        self._index = None

    def index(self, leaf_size=40):
        if self._index is None:
            self._index = cKDTree(self.points.T, leafsize=leaf_size)

    def nearest_neighbors(self, X, k=1, return_distances=True):
        dists, idxs = self._index.query(X.T, k=k)
        if return_distances:
            return dists.reshape(-1, 1), idxs.reshape(-1, 1)
        return idxs.reshape(-1, 1)


def _project(P, points):
    """(rows of P, N) dehomogenised ``P @ points``, as float64 tensors,
    with each product summed in index order."""
    out = sum(P[:, k, None] * points[k] for k in range(P.shape[1]))
    return out / out[-1:]


class PointcloudFromDepthMaps(Pointcloud):
    """Backproject per-view depth maps along normalized rays.

    Pixels near the image borders (default 40 px) and pixels with zero
    ground-truth depth are dropped (parity: pointcloud.py:76-159).
    """

    def __init__(self, scene, frame_idxs, depthmaps, borders=40,
                 device="cuda"):
        super().__init__(None)
        self._scene = scene
        self._frame_idxs = frame_idxs
        self._depthmaps = depthmaps
        self._borders = borders
        self._device = resolve_device(device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self._device)

    def _kept_pixels(self, G):
        """Column-major indices of the pixels inside the borders whose
        ground truth is nonzero."""
        h, w = G.shape
        idxs = np.arange(h * w).reshape(w, h).T
        bh = slice(self._borders, h - self._borders)
        bw = slice(self._borders, w - self._borders)
        return idxs[bh, bw][G[bh, bw] != 0].ravel()

    def _generate_points_per_image(self, frame, predicted_depth_file):
        """(4, n) homogeneous float64 points on the device."""
        image = self._scene.get_image(frame)
        depth = np.load(predicted_depth_file)
        if np.isnan(depth).any():
            depth[np.isnan(depth)] = depth[~np.isnan(depth)].min()

        keep = self._kept_pixels(self._scene.get_depth_map(frame))
        h = depth.shape[0]
        d = self._tensor(depth.T.reshape(-1)[keep])
        pixels = self._tensor(np.stack([keep // h, keep % h,
                                        np.ones_like(keep)]))
        rays = _project(self._tensor(image.camera.P_pinv), pixels)
        center = self._tensor(image.camera.center)
        directions = rays - center
        norms = torch.sqrt((directions ** 2).sum(dim=0, keepdim=True))
        return center + d * directions / norms

    @property
    def points(self):
        if self._points is None:
            pts = torch.cat(
                [
                    self._generate_points_per_image(i, d)
                    for i, d in zip(self._frame_idxs, self._depthmaps)
                ],
                dim=1,
            )
            self._points = pts[:-1, :].cpu().numpy()
        return self._points


class PointcloudFromDepthMapsWithConsistency(PointcloudFromDepthMaps):
    """Keep only points whose reprojection into the n nearest views agrees
    with those views' predicted depths within a threshold.
    """

    def __init__(
        self,
        scene,
        frame_idxs,
        depthmaps,
        borders=40,
        consistency_threshold=0.75,
        n_neighbors=5,
        device="cuda",
    ):
        super().__init__(scene, frame_idxs, depthmaps, borders, device)
        self._consistency_threshold = consistency_threshold
        self._n_neighbors = n_neighbors
        self._camera_neighbors = None
        self._frame_idxs_map = {f: i for i, f in enumerate(frame_idxs)}

    def _neighbor_frames(self, frame):
        if self._camera_neighbors is None:
            a = np.hstack(
                [
                    self._scene.get_image(i).camera.center
                    for i in self._frame_idxs
                ]
            )
            d = 2 * (a * a).sum(axis=0) - 2 * a.T.dot(a)
            self._camera_neighbors = d.argsort()[:, 1 : self._n_neighbors + 1]
        return [
            (self._frame_idxs[i], self._depthmaps[i])
            for i in self._camera_neighbors[self._frame_idxs_map[frame]]
        ]

    def _generate_points_per_image(self, frame, predicted_depth_file):
        pts = super()._generate_points_per_image(frame, predicted_depth_file)

        tau = None
        for i, d in self._neighbor_frames(frame):
            image = self._scene.get_image(i)
            pixels = _project(self._tensor(image.camera.P), pts)
            x = torch.round(pixels[0]).to(torch.int32)
            y = torch.round(pixels[1]).to(torch.int32)
            valid = (
                (0 <= x) & (x < image.width) & (0 <= y) & (y < image.height)
            )
            x = torch.where(valid, x, 0).long()
            y = torch.where(valid, y, 0).long()
            predicted = self._tensor(np.load(d))[y, x]
            center = self._tensor(image.camera.center)
            depths = torch.sqrt(((pts - center) ** 2).sum(dim=0))

            dev = (predicted - depths).abs()
            tau = dev if tau is None else torch.maximum(dev, tau)
            tau = torch.where(valid, tau, float("inf"))

        return pts[:, tau < self._consistency_threshold]


def get_pointcloud(scene, frame_idxs, depthmaps, with_consistency,
                   device="cuda", **kwargs):
    if with_consistency:
        return PointcloudFromDepthMapsWithConsistency(
            scene,
            frame_idxs,
            depthmaps,
            kwargs["borders"],
            kwargs["consistency_threshold"],
            kwargs["n_neighbors"],
            device=device,
        )
    return PointcloudFromDepthMaps(
        scene, frame_idxs, depthmaps, kwargs["borders"], device=device
    )

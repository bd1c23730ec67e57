"""Numpy geometry of the data layer: projection, distance, ray/triangle
intersection.

Copy of the functions of ``raynet_tpu/utils/geometry.py`` that the port's
scenes, images, GT-mesh index and metrics call. Points are homogeneous column
vectors unless stated otherwise. The tensor geometry of the forward pass is
``raynet_tpu_torch/ops/geometry.py``.
"""
import numpy as np


def project(P, points):
    """Affine transform of homogeneous coordinates.

    Arguments
    ---------
        P: (D1, D2) projection matrix
        points: (D2, N) stacked homogeneous column vectors

    Returns
    -------
        (N, D1) dehomogenized projected points; a single point is returned as
        a (D1, 1) column vector.
    """
    points_hat = np.dot(P, points).T
    points_hat = points_hat / points_hat[:, -1:]
    if len(points_hat) == 1:
        points_hat = points_hat.T
    return points_hat


def ray_triangles_intersection_mt(origin, destination, p0, p1, p2):
    """Vectorized Moeller-Trumbore ray/triangles intersection.

    Arguments
    ---------
        origin, destination: (3,) ray endpoints (world coordinates)
        p0, p1, p2: (T, 3) triangle vertices

    Returns
    -------
        (K, 3) array of intersection points (possibly empty); the
        barycentric test is open (u > 0, v > 0, u + v < 1).
    """
    origin = np.asarray(origin, dtype=np.float64).reshape(-1)
    destination = np.asarray(destination, dtype=np.float64).reshape(-1)
    ray = destination - origin
    ray = ray / np.sqrt((ray ** 2).sum())

    e1 = p1 - p0
    e2 = p2 - p0
    pvec = np.cross(ray[None, :], e2)
    with np.errstate(divide="ignore", invalid="ignore"):
        det = (e1 * pvec).sum(axis=1)
        inv_det = 1.0 / det
        tvec = origin[None, :] - p0
        u = (tvec * pvec).sum(axis=1) * inv_det
        qvec = np.cross(tvec, e1)
        v = (ray[None, :] * qvec).sum(axis=1) * inv_det

        idxs = np.logical_and.reduce([u > 0, v > 0, u + v < 1])
        if not np.any(idxs):
            return np.zeros((0, 3))
        t = (e2[idxs] * qvec[idxs]).sum(axis=1) * inv_det[idxs]
    return origin[None, :] + t[:, None] * ray[None, :]


def distance(p1, p2):
    """Euclidean distance between two column vectors."""
    return np.sqrt(np.sum((np.asarray(p1) - np.asarray(p2)) ** 2))


def keep_points_in_aabbox(points, bbox_min, bbox_max):
    """Filter a (3, N) point cloud to the points inside the box."""
    if points.shape[0] != 3:
        raise ValueError("keep_points_in_aabbox: points must be (3, N), got %s"
                         % (points.shape,))
    bbox_min = np.asarray(bbox_min).reshape(3, 1)
    bbox_max = np.asarray(bbox_max).reshape(3, 1)
    mask = np.all((points >= bbox_min) & (points <= bbox_max), axis=0)
    return points[:, mask]

"""Numpy geometry of the data layer: projection, distance, ray/triangle
intersection.

Copy of the functions of ``raynet_tpu/utils/geometry.py``: those the
port's scenes, images, GT-mesh index, metrics, sampling schemes and sample
generators call, and its public helpers ``rays_aabbox_intersection``,
``rays_entry_exit`` and ``is_collinear``. Points are homogeneous column
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


def ray_aabbox_intersection(origin, destination, bbox_min, bbox_max):
    """Scalar slab test of a ray against an axis-aligned box.

    The ray is parameterized as ``origin + t * (destination - origin)``.
    Returns ``(t_near, t_far)`` or ``(None, None)`` when the box is missed or
    lies entirely behind the ray.
    """
    origin = np.asarray(origin, dtype=np.float64).reshape(-1)
    destination = np.asarray(destination, dtype=np.float64).reshape(-1)
    direction = destination - origin
    bbox_min = np.asarray(bbox_min, dtype=np.float64).reshape(-1)
    bbox_max = np.asarray(bbox_max, dtype=np.float64).reshape(-1)

    t_near, t_far = float("-inf"), float("inf")
    for i in range(3):
        if direction[i] == 0:
            if origin[i] < bbox_min[i] or origin[i] > bbox_max[i]:
                return None, None
        else:
            t1 = (bbox_min[i] - origin[i]) / direction[i]
            t2 = (bbox_max[i] - origin[i]) / direction[i]
            if t1 > t2:
                t1, t2 = t2, t1
            t_near = max(t1, t_near)
            t_far = min(t2, t_far)
            if t_near > t_far or t_far < 0:
                return None, None
    return t_near, t_far


def rays_aabbox_intersection(origins, directions, bbox_min, bbox_max):
    """Vectorized slab test of N rays ``origins + t * directions``
    ((N, 3) each) against the box [bbox_min, bbox_max] ((3,) each).

    Returns (t_near, t_far), (N,) float64; a ray misses the box iff
    ``t_near > t_far``. No |t| swap here; see ``rays_entry_exit``.
    """
    origins = np.asarray(origins, dtype=np.float64)
    directions = np.asarray(directions, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (bbox_min[None] - origins) / directions
        t2 = (bbox_max[None] - origins) / directions
    t_near = np.minimum(t1, t2).max(axis=1)
    t_far = np.maximum(t1, t2).min(axis=1)
    return t_near, t_far


def rays_entry_exit(origins, directions, bbox_min, bbox_max):
    """Entry and exit points ((N, 3) float64 each) of N rays through a box,
    as the reference's sampling kernel takes them: after the slab test,
    near and far swap where ``|t_near| >= |t_far|``, so that a segment
    always runs from the camera outwards."""
    t_near, t_far = rays_aabbox_intersection(
        origins, directions, bbox_min, bbox_max
    )
    near_mask = np.abs(t_near) < np.abs(t_far)
    t_near_actual = np.where(near_mask, t_near, t_far)
    t_far_actual = np.where(near_mask, t_far, t_near)
    ray_start = origins + t_near_actual[:, None] * directions
    ray_end = origins + t_far_actual[:, None] * directions
    return ray_start, ray_end


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


def is_collinear(p1, p2, p3, atol=2e-5):
    """Whether the column vectors p1, p2, p3 lie on one line: their float32
    cross product within ``atol`` of 0."""
    v0 = (p2 - p1).astype(np.float32)
    v1 = (p1 - p3).astype(np.float32)
    return np.allclose(np.cross(v0, v1, axis=0), 0.0, atol=atol)


def point_in_aabbox(point, bbox_min, bbox_max):
    return bool(np.all(point >= bbox_min) and np.all(point <= bbox_max))


def ray_ray_intersection(p1, a1, p2, a2):
    """Least-squares closest point of two rays ``p + a t``.

    Arguments are (3, 1) column vectors (non-homogeneous). Returns the point
    on the first ray closest to the second, as a (1, 3) row vector.
    """
    a1_pow2 = np.dot(a1.T, a1)
    a2_pow2 = np.dot(a2.T, a2)
    a1a2 = np.dot(a1.T, a2)
    divisor = a1_pow2 * a2_pow2 - a1a2.T * a1a2

    a1p1 = np.dot(a1.T, p1)
    a1p2 = np.dot(a1.T, p2)
    a2p1 = np.dot(a2.T, p1)
    a2p2 = np.dot(a2.T, p2)

    t1 = -a2_pow2 * (a1p1 - a1p2) + a1a2 * (a2p1 - a2p2)
    t1 = t1 / divisor
    return (p1 + a1 * t1).T


def keep_points_in_aabbox(points, bbox_min, bbox_max):
    """Filter a (3, N) point cloud to the points inside the box."""
    if points.shape[0] != 3:
        raise ValueError("keep_points_in_aabbox: points must be (3, N), got %s"
                         % (points.shape,))
    bbox_min = np.asarray(bbox_min).reshape(3, 1)
    bbox_max = np.asarray(bbox_max).reshape(3, 1)
    mask = np.all((points >= bbox_min) & (points <= bbox_max), axis=0)
    return points[:, mask]

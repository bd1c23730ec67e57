"""Neighbour-frame selection, target depth distributions and the GT-mesh
first hit, for the data layer.

Copy of the functions of ``raynet_tpu/utils/training_utils.py`` that the
port's scenes and generation parameters call, and of its ``get_triangles``.
"""
import numpy as np

from .geometry import distance


def get_adjacent_frames_idxs(ref_idx, n_frames, n_adjacent, skip):
    """Indices of the ``n_adjacent`` frames around ``ref_idx``, assuming
    consecutive frames are spatial neighbours, with the reference's border
    handling."""
    if ref_idx > n_frames:
        raise ValueError("Ref index needs to be smaller than n_frames")
    step = skip + 1
    median = np.floor(n_adjacent / 2.0)
    if n_adjacent % 2 == 0:
        min_idx = max(0, ref_idx - median * step)
    else:
        min_idx = max(0, ref_idx - median * step - 1)
    max_idx = min(n_frames, ref_idx + median * step + 1)

    idxs = np.append(
        np.arange(min_idx, ref_idx, step=step, dtype=np.uint32),
        np.arange(ref_idx + 1, max_idx, step=step, dtype=np.uint32),
    )

    if len(idxs) != n_adjacent:
        if ref_idx == 0:
            idxs = np.arange(step, (n_adjacent + 1) * step, step=step)
        elif ref_idx == n_frames - 1:
            idxs = np.arange(ref_idx - n_adjacent * step, ref_idx, step=step)
        elif len(idxs) and max(idxs) == n_frames - 1:
            while len(idxs) < n_adjacent:
                idxs = np.insert(idxs, 0, min(idxs) - step)
        elif len(idxs) and min(idxs) == 0:
            while len(idxs) < n_adjacent:
                idxs = np.append(idxs, max(idxs) + step)
    return idxs


def dirac_distribution(target, points):
    """One-hot on the sampled point closest to the target (4, 1) point."""
    D = np.zeros(len(points), dtype=np.float32)
    dists = ((target[:-1].T - points[:, :-1]) ** 2).sum(axis=1)
    D[dists.argmin()] = 1.0
    return D


def get_std(stddev_factor, points, std_is_distance):
    p_near = points[0, :-1].reshape(-1, 1)
    p_far = points[-1, :-1].reshape(-1, 1)
    if std_is_distance:
        std = stddev_factor * distance(p_near, p_far) / len(points)
    else:
        std = stddev_factor * ((p_near - p_far) ** 2).sum() / len(points)
    return std


def gaussian_distribution(stddev_factor, std_is_distance):
    """Factory returning a gaussian target-distribution function."""

    def inner(target, points):
        std = get_std(stddev_factor, points, std_is_distance)
        dists = ((target[:-1].T - points[:, :-1]) ** 2).sum(axis=-1)
        D = np.exp(-dists / (2 * std ** 2))
        s = D.sum()
        if s == 0:
            # degenerate: a dirac on the closest point
            return dirac_distribution(target, points)
        return D / s

    return inner


def get_triangles(points, faces):
    """(T, 3, 3) triangle array from vertices and face index rows."""
    return np.asarray(points)[np.asarray(faces)]


def get_ray_meshes_first_intersection(origin, destination, meshes):
    """Closest ray/mesh intersection point (homogeneous (4, 1)), or None.

    ``meshes`` is any object with ``ray_intersections(origin, destination)``
    (normally an OctTree).
    """
    intersections = meshes.ray_intersections(origin, destination)
    if len(intersections) == 0:
        return None
    dists = ((intersections - origin[:3].T) ** 2).sum(axis=1)
    target_point = intersections[dists.argmin()].reshape(-1, 1)
    return np.vstack((target_point, [1]))

"""Spatial index over ground-truth mesh triangles for ray->mesh queries.

Copy of ``raynet_tpu/utils/oct_tree.py``: triangles are bucketed into a
regular grid of axis-aligned cells; a ray query gathers the candidate
triangles of the cells its segment touches and runs one batched
Moeller-Trumbore over them.
"""
import numpy as np

from .geometry import ray_triangles_intersection_mt


class OctTree:
    """Regular-grid triangle index with the reference OctTree's query API."""

    def __init__(self, triangles, depth=5):
        """triangles: (T, 3, 3) float (triangle, vertex, xyz) — or the
        flattened (T, 9) layout."""
        triangles = np.asarray(triangles, dtype=np.float32)
        if triangles.ndim == 2:
            triangles = triangles.reshape(-1, 3, 3)
        self.triangles = triangles
        self._p0 = triangles[:, 0]
        self._p1 = triangles[:, 1]
        self._p2 = triangles[:, 2]

        self.bbox_min = triangles.reshape(-1, 3).min(axis=0)
        self.bbox_max = triangles.reshape(-1, 3).max(axis=0)
        span = np.maximum(self.bbox_max - self.bbox_min, 1e-6)

        # per-axis resolution: degenerate axes (planar meshes) use one cell
        base_res = 2 ** depth
        self._res = np.where(
            span > 1e-5 * span.max(), base_res, 1
        ).astype(np.int64)
        self._bin = span / self._res

        tri_min = triangles.min(axis=1)
        tri_max = triangles.max(axis=1)
        lo = np.clip(
            np.floor((tri_min - self.bbox_min) / self._bin).astype(np.int64),
            0,
            self._res - 1,
        )
        hi = np.clip(
            np.floor((tri_max - self.bbox_min) / self._bin).astype(np.int64),
            0,
            self._res - 1,
        )
        lo = np.broadcast_to(lo, tri_min.shape)
        hi = np.broadcast_to(hi, tri_max.shape)

        # bucket triangle ids by the cells their AABBs overlap
        cells = {}
        for t in range(len(triangles)):
            for cx in range(lo[t, 0], hi[t, 0] + 1):
                for cy in range(lo[t, 1], hi[t, 1] + 1):
                    for cz in range(lo[t, 2], hi[t, 2] + 1):
                        cells.setdefault((cx, cy, cz), []).append(t)
        self._cells = {k: np.array(v, dtype=np.int64) for k, v in cells.items()}

    def _candidate_triangles(self, origin, destination):
        """Triangle ids in the grid cells along the ray segment (3D DDA)."""
        o = np.asarray(origin, dtype=np.float64).reshape(-1)[:3]
        d = np.asarray(destination, dtype=np.float64).reshape(-1)[:3] - o

        # clip the ray to the index bbox
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (self.bbox_min - o) / d
            t2 = (self.bbox_max - o) / d
        t1 = np.where(np.isfinite(t1), t1, -np.inf)
        t2 = np.where(np.isfinite(t2), t2, np.inf)
        t_near = max(np.minimum(t1, t2).max(), 0.0)
        t_far = np.maximum(t1, t2).min()
        if t_near > t_far:
            return np.zeros(0, dtype=np.int64)

        # march cells from entry to exit, visiting the entry cell first
        ids = []
        seen = set()
        eps = 1e-9
        t = t_near
        max_steps = int(8 * self._res.max())
        for _ in range(max_steps):
            p = np.clip(
                o + t * d,
                self.bbox_min,
                self.bbox_max - 0.5 * self._bin,
            )
            cell = np.clip(
                np.floor((p - self.bbox_min) / self._bin).astype(np.int64),
                0,
                self._res - 1,
            )
            key = (int(cell[0]), int(cell[1]), int(cell[2]))
            if key not in seen:
                seen.add(key)
                tri = self._cells.get(key)
                if tri is not None:
                    ids.append(tri)
            # advance to the next cell boundary
            nxt = self.bbox_min + (cell + (d > 0)) * self._bin
            with np.errstate(divide="ignore", invalid="ignore"):
                t_cands = (nxt - o) / d
            t_cands = np.where(d != 0, t_cands, np.inf)
            t_step = t_cands.min()
            if not np.isfinite(t_step) or t_step <= t or t_step > t_far:
                break
            t = t_step + eps

        if not ids:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(ids))

    def ray_intersections(self, origin, destination):
        """All intersection points of the ray with indexed triangles.

        origin/destination: homogeneous (4, 1) columns.
        Returns (K, 3) intersection points, possibly empty.
        """
        cand = self._candidate_triangles(origin, destination)
        if len(cand) == 0:
            return np.zeros((0, 3))
        return ray_triangles_intersection_mt(
            np.asarray(origin, dtype=np.float64).reshape(-1)[:3],
            np.asarray(destination, dtype=np.float64).reshape(-1)[:3],
            self._p0[cand],
            self._p1[cand],
            self._p2[cand],
        )

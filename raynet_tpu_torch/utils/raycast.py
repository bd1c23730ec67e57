"""First hits of rays on a triangle mesh: the ground-truth depth raycaster.

Port of ``raynet_tpu/native/raynet_host.cpp:106-136`` (the JAX package's
``native.ray_mesh_first_hit``): a brute-force Moeller-Trumbore test of every
ray against every triangle in float32, keeping each ray's nearest hit. It
is host C++ there, not a TPU kernel; here it is torch ops on whichever
device the tensors are on, over chunks of rays x triangles with a running
minimum.

Every operation is one float32 operation in the C++ order (the library is
built with ``-ffp-contract=off``, and an eager torch op rounds once), with
its inequalities: a triangle with ``det == 0`` is skipped, ``u <= 0``,
``v <= 0`` and ``u + v >= 1`` reject (written so, not as ``u > 0``: a NaN
must pass them as it passes the C++ tests), and a hit needs
``0 < t < FLT_MAX`` and less than the best so far.
"""
import numpy as np
import torch

_FLT_MAX = float(np.finfo(np.float32).max)
# ray x triangle pairs per chunk: each of the ~10 float32 temporaries of a
# chunk takes 4 bytes a pair
PAIRS_PER_CHUNK = {"cuda": 1 << 26, "cpu": 1 << 22}


def _cross(a, b):
    """a x b of (..., 3) float32 vectors, one rounding per operation."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot(a, b):
    """a . b of (..., 3) vectors, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_mesh_first_hit(origin, dirs, triangles, pairs_per_chunk=None):
    """Distance from ``origin`` to the first triangle each ray hits.

    Arguments
    ---------
        origin: (3,) float32 tensor, the rays' common origin
        dirs: (N, 3) float32 unit directions, on the same device
        triangles: (T, 3, 3) float32 vertices (p0, p1, p2), same device
        pairs_per_chunk: rays x triangles per step (default by device)

    Returns (N,) float32 depths, 0 where a ray hits nothing.
    """
    f32 = torch.float32
    for name, t in (("origin", origin), ("dirs", dirs),
                    ("triangles", triangles)):
        if t.dtype != f32:
            raise ValueError("ray_mesh_first_hit: %s must be float32, got %s"
                             % (name, t.dtype))
    if len({origin.device, dirs.device, triangles.device}) != 1:
        raise ValueError("ray_mesh_first_hit: all tensors on one device")
    n, t = dirs.shape[0], triangles.shape[0]
    device = dirs.device
    best = torch.full((n,), _FLT_MAX, dtype=f32, device=device)
    if n == 0 or t == 0:
        return torch.zeros(n, dtype=f32, device=device)
    p0 = triangles[:, 0]
    e1 = triangles[:, 1] - p0
    e2 = triangles[:, 2] - p0
    tv = origin.reshape(1, 3) - p0
    # the ray-independent terms, per triangle
    qv = _cross(tv, e1)
    e2_qv = _dot(e2, qv)
    pairs = pairs_per_chunk or PAIRS_PER_CHUNK.get(device.type, 1 << 22)
    tris = max(1, min(t, pairs // 1024))
    rays = max(1, pairs // tris)
    for r0 in range(0, n, rays):
        d = dirs[r0:r0 + rays, None, :]
        for t0 in range(0, t, tris):
            sl = slice(t0, t0 + tris)
            pv = _cross(d, e2[None, sl])
            det = _dot(e1[None, sl], pv)
            inv = 1.0 / det
            u = _dot(tv[None, sl], pv) * inv
            v = _dot(d, qv[None, sl]) * inv
            tt = e2_qv[None, sl] * inv
            hit = ((det != 0) & ~(u <= 0) & ~(v <= 0) & ~(u + v >= 1)
                   & (tt > 0) & (tt < _FLT_MAX))
            near = torch.where(hit, tt, _FLT_MAX).amin(dim=1)
            best[r0:r0 + rays] = torch.minimum(best[r0:r0 + rays], near)
    return torch.where(best < _FLT_MAX, best, 0.0)

"""K4: MVSNet's variance cost volume, and its plain version.

``cost_volume`` runs the CUDA kernel ``csrc/cost_volume.cu`` for CUDA
tensors and ``cost_volume_reference`` (plain PyTorch, a hypothesis chunk
at a time) for CPU tensors. For every reference feature pixel (u, v) and
depth hypothesis z_d, each source view's feature map is sampled
bilinearly where the homography of depth z_d takes the pixel (taps outside
the map read 0, as ``grid_sample`` with zero padding and
``align_corners=True``), and the volume holds, per channel, the variance
over the V views (MVSNet, ECCV 2018, eq. 2, as MVSNet_pytorch computes
it):

    C(c, d, v, u) = (sum_i f_i(c)^2) / V - ((sum_i f_i(c)) / V)^2,

the reference view entering unwarped. The hypotheses are planes, z_d =
``depths[d]`` for every pixel (MVSNet; CasMVSNet's first stage), or, given
a ``centre`` map, per pixel, z_d(v, u) = ``centre[v, u] + depths[d]``
(CasMVSNet's later stages, Gu et al., CVPR 2020, each pixel's hypotheses
around the previous stage's depth). Both take a source pixel as (z A[:, 0])
u + (z (A[:, 1] v + A[:, 2]) + b), so a centre of 0 gives the planes'
volume bit for bit. Both versions take the same steps in the same order
(the kernel is built without multiply-add contraction), so they round
alike. The warp (the homographies, the projection, its
division and the bilinear weights) is float64: at 400-pixel maps a
float32 coordinate is off by ~1e-5 pixel, which white-noise features
turn into ~2e-5 of the variance (see ``csrc/cost_volume.cu``).

The host helpers give the geometry: ``crop_window`` (MVSNet's centre crop
to multiples of 32), ``feature_cameras`` (the projections at a feature
map's resolution, a quarter of the image's for MVSNet, scaled so that the
third row gives camera z), ``depth_range`` and ``plane_depths``
(fronto-parallel planes in the reference camera's z over the bbox) and
``homographies``.
"""
import numpy as np
import torch

from . import cuda_build

# MVSNet's feature maps' stride in the image
STRIDE = 4
# the image's crop: height and width down to multiples of this (the U-Net
# halves the quarter-resolution maps three times)
CROP_MULTIPLE = 32
# (plane, pixel) pairs the plain version computes at a time
PLAIN_BLOCK = 1 << 20


def crop_window(height, width, multiple=CROP_MULTIPLE):
    """(top, left, height, width) of the centre crop of an image to the
    largest multiples of ``multiple``: DTU's 1600 x 1200 -> 1600 x 1184,
    8 rows off the top and the bottom."""
    h, w = height - height % multiple, width - width % multiple
    if h == 0 or w == 0:
        raise ValueError("an image of %d x %d holds no %d x %d crop"
                         % (width, height, multiple, multiple))
    return (height - h) // 2, (width - w) // 2, h, w


def feature_cameras(Ps, top, left, stride=STRIDE):
    """(V, 3, 4) float64 projections into feature-map pixels of cameras
    ``Ps`` (V, 3, 4) of the uncropped image: the crop's offset taken off,
    the intrinsics divided by the feature map's ``stride`` (as MVSNet and
    CasMVSNet scale them), and each matrix divided by the norm of its
    third row's first three entries, so that the third homogeneous
    coordinate of a projected point is its depth along the camera's
    axis."""
    shift = np.array([[1.0, 0, -left], [0, 1.0, -top], [0, 0, 1.0]])
    scale = np.diag([1.0 / stride, 1.0 / stride, 1.0])
    out = scale @ shift @ np.asarray(Ps, np.float64)
    return out / np.linalg.norm(out[:, 2, :3], axis=-1)[:, None, None]


def depth_range(P_ref, bbox):
    """(nearest, farthest) float64 z in the reference camera of the bbox's
    8 corners (``P_ref`` from ``feature_cameras``)."""
    box = np.asarray(bbox, np.float64).reshape(2, 3)
    corners = np.array([[box[i, 0], box[j, 1], box[k, 2], 1.0]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    z = corners @ P_ref[2]
    if z.min() <= 0:
        raise ValueError("the bbox reaches behind the reference camera")
    return z.min(), z.max()


def plane_depths(P_ref, bbox, planes):
    """(D,) float64 depths of ``planes`` fronto-parallel planes, uniform in
    the reference camera's z from the nearest to the farthest of the bbox's
    8 corners (``depth_range``)."""
    lo, hi = depth_range(P_ref, bbox)
    step = (hi - lo) / (planes - 1)
    return lo + step * np.arange(planes)


def homographies(P):
    """(V - 1, 12) float64 plane homographies from the reference view
    ``P[0]`` to each source view ``P[1:]`` (``feature_cameras``): A (3 x 3,
    row-major) and b (3,), so that a reference pixel (u, v) at depth z
    lands on z A (u, v, 1) + b in the source's homogeneous pixels."""
    inv = np.linalg.inv(P[0, :, :3])
    out = []
    for p in P[1:]:
        A = p[:, :3] @ inv
        out.append(np.concatenate([A.ravel(), p[:, 3] - A @ P[0, :, 3]]))
    return np.stack(out)


def _divisor(value, device):
    # an IEEE division by a device scalar, not a product by its reciprocal
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def _bilinear(feats, x, y):
    """(..., C) bilinear samples of ``feats`` (H, W, C) at the float64
    (x, y), pixel centres at the integers; a tap outside the map reads 0.
    The weights in float64, cast to the features' dtype once, and the sum
    in ``grid_sample``'s order (north-west, north-east, south-west,
    south-east)."""
    H, W, _ = feats.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    taps = ((x0, y0, (x1 - x) * (y1 - y)), (x1, y0, (x - x0) * (y1 - y)),
            (x0, y1, (x1 - x) * (y - y0)), (x1, y1, (x - x0) * (y - y0)))
    out = torch.zeros(x.shape + feats.shape[-1:], dtype=feats.dtype,
                      device=feats.device)
    for tx, ty, w in taps:
        inside = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
        ix = torch.where(inside, tx, 0).to(torch.int64)
        iy = torch.where(inside, ty, 0).to(torch.int64)
        tap = feats[iy, ix] * w.to(feats.dtype)[..., None]
        out = out + torch.where(inside[..., None], tap, 0)
    return out


def cost_volume_reference(features, homs, depths, centre=None):
    """Plain PyTorch K4: (1, C, D, H, W) float32, ``PLAIN_BLOCK``
    (hypothesis, pixel) pairs at a time."""
    V, H, W, C = features.shape
    D = depths.shape[0]
    dev = features.device
    out = torch.empty((1, C, D, H, W), dtype=torch.float32, device=dev)
    uu = torch.arange(W, dtype=torch.float64, device=dev)
    vv = torch.arange(H, dtype=torch.float64, device=dev)[:, None]
    n = _divisor(V, dev)
    ref = features[0]
    step = max(1, PLAIN_BLOCK // (H * W))
    for d0 in range(0, D, step):
        z = depths[d0:d0 + step, None, None]
        if centre is not None:
            z = centre.to(torch.float64) + z
        s = ref.expand((z.shape[0],) + ref.shape)
        q = ref * ref
        for k in range(V - 1):
            A, b = homs[k, :9].reshape(3, 3), homs[k, 9:]
            # in float64: with planes per (plane, row) once, then per pixel
            p = [(z * A[i, 0]) * uu + (z * (A[i, 1] * vv + A[i, 2]) + b[i])
                 for i in range(3)]
            val = _bilinear(features[k + 1], p[0] / p[2], p[1] / p[2])
            s = s + val
            q = q + val * val
        m = s / n
        out[0, :, d0:d0 + z.shape[0]] = (q / n - m * m).permute(3, 0, 1, 2)
    return out


def _cost_volume_cuda(features, homs, depths, centre):
    V, H, W, C = features.shape
    D = depths.shape[0]
    if C % 4 != 0 or C > 64:
        raise ValueError("cost_volume: the kernel takes C a multiple of 4 "
                         "up to 64, got C=%d" % C)
    if not 2 <= V <= 17:
        raise ValueError("cost_volume: 2 <= V <= 17, got %d" % V)
    op = "cost_volume"
    cuda_build.check_tensor(op, "features", features, torch.float32)
    cuda_build.check_tensor(op, "homographies", homs, torch.float64,
                            (V - 1, 12))
    cuda_build.check_tensor(op, "depths", depths, torch.float64, (D,))
    operands = [("homographies", homs), ("depths", depths)]
    if centre is not None:
        cuda_build.check_tensor(op, "centre", centre, torch.float32, (H, W))
        operands.append(("centre", centre))
    for name, t in operands:
        if t.device != features.device:
            raise ValueError("cost_volume: %s is on %s, features on %s"
                             % (name, t.device, features.device))
    if features.data_ptr() % 16:
        raise ValueError("cost_volume: features must be 16-byte aligned")
    if C * D * H * W >= 1 << 31 or V * H * W * C >= 1 << 31:
        raise ValueError("cost_volume: the volume must hold fewer than "
                         "2**31 values")
    out = torch.empty((1, C, D, H, W), dtype=torch.float32,
                      device=features.device)
    cuda_build.launch("raynet_cost_volume", features, features.data_ptr(),
                      homs.data_ptr(), depths.data_ptr(),
                      None if centre is None else centre.data_ptr(),
                      out.data_ptr(), V, H, W, C, D)
    cost_volume.launches += 1
    cost_volume.per_pixel_launches += centre is not None
    return out


def cost_volume(features, homs, depths, centre=None):
    """MVSNet's variance cost volume.

    Arguments
    ---------
        features: (V, H, W, C) float32 feature maps, channels last, view 0
            the reference view
        homs: (V - 1, 12) float64 ``homographies`` of the source views
        depths: (D,) float64 plane depths, or with ``centre`` each
            hypothesis's offset from the pixel's centre depth
        centre: None (planes), or (H, W) float32 centre depths of the
            reference pixels (per-pixel hypotheses)

    Returns the (1, C, D, H, W) float32 volume.
    """
    if cuda_build.on_cuda("cost_volume", features):
        return _cost_volume_cuda(features, homs, depths, centre)
    if centre is None:
        return cost_volume_reference(features, homs, depths)
    return cost_volume_reference(features, homs, depths, centre)


# Kernel launches since the last reset, and those of them in the per-pixel
# mode (the plain path never counts).
cost_volume.launches = 0
cost_volume.per_pixel_launches = 0

"""The plain PyTorch reference of the RayNet passes, for the benchmark's
check of ``correct``.

It follows the published description (RayNet, Paschalidou et al., CVPR
2018; ray potentials and their messages after Ulusoy et al., 3DV 2015) as
the port's plain versions spell it out, in float32 elementwise PyTorch
operations (BP's per-ray sums and products in float64, see
``bp_messages``) with no kernel, cache or batching of the program: the CNN
(VALID convolutions, BatchNorm with running statistics, ReLU after all but
the last), each pixel's ray segment through the bbox, the plane sweep
(the mean of the pair dot products of the views' features at each depth
hypothesis, softmax over the planes), the Amanatides-Woo march of the
voxel grid, the hat mapping of plane scores onto the visited voxels, and
sum-product BP with ray potentials. The pair dot products are summed pair
by pair, as the paper defines them; the program uses a closed form.

It imports nothing of the program and takes nothing the program made: the
benchmark gives it the scene and the weights it drew from the seed. It
works in blocks of rays so that it fits on the card once the program's
state is freed.
"""
import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-2
_FLT_MAX = 3.4028234663852886e38
_CLIP_S = 1e-5
_CLIP_MU = 1e-4


def f32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def cnn_features(image_u8, weights, layers, padding, bn_eps):
    """(Hf, Wf, F) float32 features of one (H, W, C) uint8 image on the
    device, zero-padded by ``padding`` and divided by 255."""
    x = image_u8.permute(2, 0, 1)[None].to(torch.float32) / 255.0
    x = F.pad(x, (padding, padding, padding, padding))
    for i, (_, _, dilation) in enumerate(layers):
        x = F.conv2d(x, weights["convs.%d.weight" % i],
                     weights["convs.%d.bias" % i], dilation=dilation)
        x = F.batch_norm(x, weights["norms.%d.running_mean" % i],
                         weights["norms.%d.running_var" % i],
                         weights["norms.%d.weight" % i],
                         weights["norms.%d.bias" % i], False, 0.0, bn_eps)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x[0].permute(1, 2, 0).contiguous()


def segments(height, width, P_pinv, center, bbox):
    """(start, end) (N, 3) of every pixel's ray through the bbox, the rays
    in column-major order (ray r is pixel x = r // H, y = r % H); a ray
    whose line misses the box collapses to a point outside it."""
    device = center.device
    r = torch.arange(height * width, device=device)
    x = torch.div(r, height, rounding_mode="floor").to(torch.float32)
    y = torch.remainder(r, height).to(torch.float32)
    hom = [P_pinv[i, 0] * x + P_pinv[i, 1] * y + P_pinv[i, 2]
           for i in range(4)]
    dest = torch.stack([hom[0] / hom[3], hom[1] / hom[3], hom[2] / hom[3]],
                       dim=-1)
    d = dest - center[None]
    t1 = (bbox[None, :3] - center[None]) / d
    t2 = (bbox[None, 3:] - center[None]) / d
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    near_first = t_near.abs() < t_far.abs()
    t_a = torch.where(near_first, t_near, t_far)
    t_b = torch.where(near_first, t_far, t_near)
    miss = t_near > t_far
    t_mid = 0.5 * (t_near + t_far)
    t_mid = torch.where(torch.isfinite(t_mid), t_mid, torch.zeros_like(t_mid))
    t_a = torch.where(miss, t_mid, t_a)
    t_b = torch.where(miss, t_mid, t_b)
    return center[None] + t_a[:, None] * d, center[None] + t_b[:, None] * d


def _divisor(value, device):
    # an IEEE division by a device scalar, not a product by its reciprocal
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def plane_sweep(features, P, start, end, padding, height, width, planes):
    """(N, D) softmax over the planes of the mean pair dot product of the
    views' features at D points evenly spaced on each segment; ``features``
    (V, Hf, Wf, F), view 0 the reference view."""
    V = features.shape[0]
    device = start.device
    k = torch.arange(planes, dtype=torch.float32, device=device)
    frac = k / _divisor(planes - 1, device)
    pts = start[:, None, :] + frac[None, :, None] * (end - start)[:, None, :]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    offset = padding - (padding - 1) // 2
    views = []
    for v in range(V):
        p = P[v]
        u = p[0, 0] * x + p[0, 1] * y + p[0, 2] * z + p[0, 3]
        w = p[1, 0] * x + p[1, 1] * y + p[1, 2] * z + p[1, 3]
        d = p[2, 0] * x + p[2, 1] * y + p[2, 2] * z + p[2, 3]
        fx = (torch.round(u / d).to(torch.int64) + offset).clamp(0, width)
        fy = (torch.round(w / d).to(torch.int64) + offset).clamp(0, height)
        zero = (fx == 0) | (fy == 0)
        fx = torch.where(zero, 0, fx)
        fy = torch.where(zero, 0, fy)
        views.append(features[v][fy, fx].to(torch.float32))  # (N, D, F)
    pair_sum = torch.zeros_like(x)
    for i in range(V):
        for j in range(i + 1, V):
            pair_sum = pair_sum + (views[i] * views[j]).sum(dim=-1)
    n_pairs = V * (V - 1) // 2
    return torch.softmax(pair_sum / _divisor(n_pairs, device), dim=-1)


def march(bbox, start, end, grid_shape, max_voxels):
    """Amanatides-Woo march of N segments: ((N, M) int32 flat row-major
    voxel indices, zero past each count, (N,) int32 counts). A segment
    whose ends are equal (a ray that misses the box, or one that only
    touches it) has no length and visits no voxel. The endpoints are
    nudged a hundredth of a cell into the segment; the first voxel is
    kept iff it lies in the grid; leaving the grid ends the march without
    keeping the voxel; reaching the last voxel or M voxels ends it after."""
    device = start.device
    gx, gy, gz = (int(g) for g in grid_shape)
    grid = torch.tensor([gx, gy, gz], dtype=torch.int32, device=device)
    bin_size = (bbox[3:] - bbox[:3]) / grid.to(torch.float32)
    s = start - bbox[None, :3]
    e = end - bbox[None, :3]
    ray = e - s
    step = torch.where(ray >= 0, 1, -1).to(torch.int32)
    stepf = step.to(torch.float32)
    s = s + stepf * bin_size[None] * _EPS
    e = e - stepf * bin_size[None] * _EPS
    cur = torch.floor(s / bin_size[None]).to(torch.int32)
    last = torch.floor(e / bin_size[None]).to(torch.int32)
    inside = ((cur >= 0) & (cur < grid[None])).all(dim=-1) \
        & (ray != 0).any(dim=-1)
    cur_coord = cur.to(torch.float32) * bin_size[None]
    boundary = torch.where((step < 0) & (cur_coord < s), cur_coord,
                           cur_coord + stepf * bin_size[None])
    nonzero = ray != 0
    big = torch.full_like(ray, _FLT_MAX)
    t_max = torch.where(nonzero, (boundary - s) / ray, big)
    t_delta = torch.where(nonzero, stepf * bin_size[None] / ray, big)
    strides = torch.tensor([gy * gz, gz, 1], dtype=torch.int32, device=device)

    n = start.shape[0]
    out = torch.zeros((max_voxels, n), dtype=torch.int32, device=device)
    out[0] = torch.where(inside, (cur * strides).sum(dim=-1, dtype=torch.int32),
                         0)
    counts = inside.to(torch.int32)
    ncross = torch.zeros_like(cur)
    alive = inside
    # the rays still marching (``ids``); the others have ended, so the
    # state is cut down to these from time to time
    ids = torch.arange(n, device=device)
    for k in range(1, max_voxels):
        if k % 16 == 0:
            keep = torch.nonzero(alive).squeeze(1)
            if keep.numel() == 0:
                break
            if keep.numel() < 0.75 * ids.numel():
                ids, cur, last, ncross = (ids[keep], cur[keep], last[keep],
                                          ncross[keep])
                t_max, t_delta, step = t_max[keep], t_delta[keep], step[keep]
                alive = alive[keep]
        t_cur = t_max + ncross.to(torch.float32) * t_delta
        advance = alive & ~(cur == last).all(dim=-1)
        tx, ty, tz = t_cur[:, 0], t_cur[:, 1], t_cur[:, 2]
        axis = torch.where(tx < ty, torch.where(tx < tz, 0, 2),
                           torch.where(ty < tz, 1, 2))
        onehot = F.one_hot(axis, 3).to(torch.int32)
        new_cur = cur + onehot * step
        moved = new_cur.gather(1, axis[:, None])[:, 0]
        emit = advance & ~((moved < 0) | (moved >= grid[axis]))
        cur = torch.where(emit[:, None], new_cur, cur)
        ncross = ncross + torch.where(emit[:, None], onehot, 0)
        alive = emit
        out[k, ids] = torch.where(emit, (cur * strides).sum(
            dim=-1, dtype=torch.int32), 0)
        counts[ids] += emit.to(torch.int32)
    return out.t(), counts


def voxel_centers_distance(flat, bbox, grid_shape, center):
    """(N, M) centres of flat voxel indices (N, M), and their distances
    from the camera centre."""
    gx, gy, gz = (int(g) for g in grid_shape)
    grid = torch.tensor([gx, gy, gz], dtype=torch.float32,
                        device=flat.device)
    bin_size = (bbox[3:] - bbox[:3]) / grid
    idx = torch.stack([torch.div(flat, gy * gz, rounding_mode="floor"),
                       torch.remainder(torch.div(flat, gz,
                                                 rounding_mode="floor"), gy),
                       torch.remainder(flat, gz)], dim=-1)
    centres = bbox[:3] + idx.to(torch.float32) * bin_size + bin_size / 2
    d = centres - center
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    return centres, dist


def _valid(counts, m):
    return torch.arange(m, device=counts.device)[None, :] < counts[:, None]


def _masked_renorm(s, valid):
    s = torch.where(valid, s, torch.zeros_like(s))
    return torch.where(valid, s / s.sum(dim=1, keepdim=True).clamp_min(1e-30),
                       torch.zeros_like(s))


def hat_mapping(S_planes, centres, counts, start, end):
    """(N, M) plane scores mapped onto the visited voxels: each centre's
    parameter t on its segment (clipped to [1e-4, 1 - 1e-4]), the
    interpolation between the two planes that bracket t (the hat-function
    sum), zero past the count, renormalised over the ray."""
    D = S_planes.shape[1]
    ray = end - start
    vdir = centres - start[:, None, :]
    r = ray[:, None, :]
    num = vdir[..., 0] * r[..., 0] + vdir[..., 1] * r[..., 1] \
        + vdir[..., 2] * r[..., 2]
    den = ray[:, 0] * ray[:, 0] + ray[:, 1] * ray[:, 1] + ray[:, 2] * ray[:, 2]
    t = (num / den[:, None]).clamp(1e-4, 1 - 1e-4)
    xx = t * float(D - 1)
    lo = torch.nan_to_num(xx.floor(), nan=0.0).clamp(0, D - 2)
    f = xx - lo
    lo = lo.to(torch.int64)
    s_lo = torch.gather(S_planes, 1, lo)
    s_hi = torch.gather(S_planes, 1, lo + 1)
    return _masked_renorm(s_lo + (s_hi - s_lo) * f, _valid(counts,
                                                             t.shape[1]))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _bp_mask(counts, m):
    return _valid(counts, m) & (counts[:, None] > 1)


def _clip_renorm(S, mask):
    S = torch.where(mask, _clip(S, _CLIP_S, 1.0 - _CLIP_S),
                    torch.zeros_like(S))
    return S / torch.maximum(S.sum(dim=-1, keepdim=True),
                             S.new_full((), 1e-30))


def _sigmoid_clipped(pon):
    mx = torch.maximum(pon, pon.new_full((), 0.0))
    t1 = torch.exp(0.0 - mx)
    t2 = torch.exp(pon - mx)
    return _clip(t2 / (t1 + t2), _CLIP_MU, 1.0 - _CLIP_MU)


def _exclusive_cumprod(x):
    return torch.cat([torch.ones_like(x[..., :1]),
                      torch.cumprod(x, dim=-1)[..., :-1]], dim=-1)


def _mu(grid, flat, messages, mask):
    acc = grid.index_select(0, flat.reshape(-1).long()).reshape(flat.shape)
    return torch.where(mask, _sigmoid_clipped(acc - messages),
                       torch.zeros_like(messages))


def bp_messages(S_vox, flat, counts, messages, grid, prior, cells):
    """One sweep's new ray-to-occupancy messages (log-odds, float32) of N
    rays, and their sum over the grid of ``cells``. ``messages`` None: the
    first sweep, in which every occupancy message is sigmoid(``prior``).

    The per-voxel values (scores, mu, messages) are float32; the per-ray
    sums and products of the recurrences are float64. Where mu nears its
    clip 1 - 1e-4, (total - cumsum) / (1 - mu) turns float32 rounding of
    the cumulative sum into message errors of ~1e-2, which BP then spreads
    through the grid."""
    mask = _bp_mask(counts, S_vox.shape[1])
    S = _clip_renorm(S_vox, mask)
    if messages is None:
        mu = torch.where(mask, _sigmoid_clipped(S.new_full((), prior)),
                         torch.zeros_like(S))
    else:
        mu = _mu(grid, flat, messages, mask)
    one_minus = torch.where(mask, 1.0 - mu, torch.ones_like(mu)).double()
    S, mu = S.double(), mu.double()
    excl = _exclusive_cumprod(one_minus)
    contrib = mu * excl * S
    incl = torch.cumsum(contrib, dim=-1)
    before = incl - contrib
    pos = before + excl * S
    neg = before + (incl[..., -1:] - incl) / one_minus
    p = _clip((pos / torch.maximum(pos + neg, pos.new_full((), 1e-37))).float(),
              1e-37, 1.0 - 1e-7)
    new = torch.where(mask, torch.log(p) - torch.log1p(-p),
                      torch.zeros_like(p))
    scatter = torch.zeros(cells, dtype=new.dtype, device=new.device)
    idx = torch.where(mask, flat, torch.zeros_like(flat)).reshape(-1).long()
    scatter.index_add_(0, idx, new.reshape(-1))
    return new, scatter


def bp_posterior(S_vox, flat, counts, messages, grid):
    """(N, M) float64 posterior depth distribution over the visited voxels:
    mu_i prod_{j<i} (1 - mu_j) s_i, normalised over the ray (the product
    and the normalisation in float64, as in ``bp_messages``)."""
    mask = _bp_mask(counts, S_vox.shape[1])
    S = _clip_renorm(S_vox, mask)
    mu = _mu(grid, flat, messages, mask)
    one_minus = torch.where(mask, 1.0 - mu, torch.ones_like(mu)).double()
    post = mu.double() * _exclusive_cumprod(one_minus) * S.double()
    total = post.sum(dim=-1, keepdim=True)
    return torch.where(mask, post / torch.maximum(
        total, total.new_full((), 1e-300)), torch.zeros_like(post))


class Judge:
    """The numbers compared, of each contender (a list of (H, W) depth
    maps, one per reference view) against the reference.

    For every ray, from the reference's distribution over its visited
    voxels and their distances from the camera: the contender's voxel is
    the visited voxel at its depth (within 1e-5 of it, relative; the best
    such voxel where several are); its gap is by how much that voxel's
    reference probability lies below the reference's best, as a share of
    the best. A depth at no visited voxel, or a depth where the reference
    ray visits none (or none where it visits some), has the gap 1. Per
    contender: ``max_gap`` over all rays, and ``mismatch_share``, the share
    of rays whose depth differs from the reference's argmax depth by more
    than 1e-3 of it.
    """

    match_tolerance = 1e-5
    mismatch_tolerance = 1e-3

    def __init__(self, contenders):
        self.contenders = contenders
        self.max_gap = [0.0] * len(contenders)
        self.mismatches = [0] * len(contenders)
        self.rays = 0
        self.ref_maps = {}
        self._flat = {}

    def _ray_order(self, c, image, device):
        key = (c, image)
        if key not in self._flat:
            m = self.contenders[c][image]
            self._flat[key] = torch.as_tensor(m.T.reshape(-1).copy(),
                                              device=device)
        return self._flat[key]

    def add(self, image, lo, post, dist, counts):
        """Judge rays [lo, lo + N) of reference view ``image`` (its index in
        the pass's reference views): ``post`` (N, M) the reference's
        distribution, ``dist`` (N, M) its voxels' distances, ``counts``."""
        n, m = post.shape
        valid = _valid(counts, m)
        arg = torch.argmax(post, dim=1)  # the first maximum
        best = post.gather(1, arg[:, None])[:, 0]
        ref = torch.where(counts > 0, dist.gather(1, arg[:, None])[:, 0],
                          torch.zeros_like(best))
        ref_map = self.ref_maps.setdefault(image, [])
        ref_map.append(ref.cpu())
        empty = counts == 0
        for c in range(len(self.contenders)):
            d = self._ray_order(c, image, post.device)[lo:lo + n]
            cand = valid & ((dist - d[:, None]).abs()
                            <= self.match_tolerance * d[:, None].abs())
            chosen = torch.where(cand, post, post.new_full((), -1.0)).amax(1)
            gap = (best - chosen) / best.clamp_min(1e-30)
            gap = torch.where(cand.any(dim=1), gap, torch.ones_like(gap))
            gap = torch.where(empty, (d != 0).to(gap.dtype), gap)
            # a NaN anywhere (the contender's depth, the reference's
            # distribution) is no agreement
            gap = torch.nan_to_num(gap, nan=1.0)
            self.max_gap[c] = max(self.max_gap[c], float(gap.max()))
            off = ((d - ref).abs() > self.mismatch_tolerance * ref.abs()) \
                | ((d == 0) != (ref == 0)) | ~torch.isfinite(d)
            self.mismatches[c] += int(off.sum())
        self.rays += n

    def readings(self):
        return [{"max_gap": g, "mismatch_share": k / max(self.rays, 1)}
                for g, k in zip(self.max_gap, self.mismatches)]

    def reference_maps(self, height, width):
        """The reference's own argmax depth maps, (H, W) per view."""
        return [torch.cat(self.ref_maps[i]).numpy().reshape(width, height).T
                for i in sorted(self.ref_maps)]

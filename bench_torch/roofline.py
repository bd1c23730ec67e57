"""Operations, bytes and bounds of the measured work, counted from the
algorithm and not from any kernel's instructions.

A kernel's bound is the least time an NVIDIA H100 SXM could take for the
work: the larger of the bytes the algorithm must move (each input read
once, each output written once) over the memory rate, and its operations
over the peak rate of their type. The counts follow the equations of the
RayNet pass (RayNet, CVPR 2018; the port's plain versions), so a rewritten
kernel is held to the same work. Where the work depends on the geometry,
the counts come from closed forms over the scene's ray segments:

- ``closed_form_visits``: the cells a ray's march visits, 1 plus its
  crossings in x, y and z, capped at M (0 for a ray that misses the grid);
- ``touched_feature_rows``: the feature cells the plane sweep reads.

Both are the same for every seed of a traffic mix, whose geometry is
fixed.
"""
import collections
import subprocess

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit:
# HBM3 bytes/s and FLOP/s by arithmetic type (float32 outside the tensor
# cores, TF32 and bf16 on them).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

# Operations per unit of work, from the equations:
# a point on the segment, start + (k / (D - 1)) (end - start)
POINT_OPS = 7
# a point projected into a view: 3 rows of 3 multiply-adds, 2 divisions
PROJECT_OPS = 20
# the mean pair dot product and the softmax over planes, per plane
SOFTMAX_OPS = 4
# one step of the voxel march: next crossing time, axis choice, index
MARCH_OPS = 6
# a visited voxel's centre (3 multiply-adds, 3 adds), its projection t on
# the segment (3 subtractions, a 3-term dot product, a division, a clip),
# the hat interpolation between the two bracketing planes (6) and the
# renormalisations over the ray (6)
MAP_OPS = 32
# the occupancy-to-ray message: grid minus own message, clipped sigmoid
MU_OPS = 9
# the ray-potential recurrences (eq. 13/14 of Ulusoy et al. 3DV'15): 1-mu,
# the exclusive product, the contribution, the sums, pos, neg, the log-odds
MESSAGE_OPS = 18
# the scatter of a message into the grid
SCATTER_OPS = 1
# the posterior mu * prod(1 - mu) * s and its normalisation
POSTERIOR_OPS = 6
# the running argmax
ARGMAX_OPS = 1

Cost = collections.namedtuple("Cost", "nbytes ops")


def bound_seconds(cost, precision="float32"):
    """The least seconds the card could take for ``cost``."""
    return max(cost.nbytes / PEAK_BYTES_S, cost.ops / PEAK_FLOPS[precision])


def bound_by(cost, precision="float32"):
    """"bytes" or "operations": which side of ``cost`` sets its bound."""
    return ("bytes" if cost.nbytes / PEAK_BYTES_S
            >= cost.ops / PEAK_FLOPS[precision] else "operations")


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them (a
    share of a peak is stated against the 700 W part), or None where the
    tool is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


# --- the CNN -------------------------------------------------------------

def conv_stack_flops(layers, height, width, channels, padding):
    """2 x the multiply-accumulates of a VALID conv stack over one image
    zero-padded by ``padding`` on each side; ``layers`` are
    (filters, kernel, dilation)."""
    h, w, c = height + 2 * padding, width + 2 * padding, channels
    flops = 0
    for filters, kernel, dilation in layers:
        span = dilation * (kernel - 1)
        h, w = h - span, w - span
        flops += 2 * h * w * filters * c * kernel * kernel
        c = filters
    return flops


# --- K1: the plane sweep -------------------------------------------------

def n_pairs(views):
    return views * (views - 1) // 2


def plane_sweep_cost(n_rays, planes, views, feature_dim, feature_rows,
                     feature_bytes=4):
    """K1 over ``n_rays``: the endpoints and the V projections read, each
    touched feature row read once, the (N, D) scores written. Per (ray,
    plane): the point, its projection into each view, 2F per view pair
    (the pair dot products) and the softmax."""
    nbytes = (n_rays * 2 * 3 * 4 + views * 12 * 4
              + feature_rows * feature_dim * feature_bytes
              + n_rays * planes * 4)
    per = (POINT_OPS + views * PROJECT_OPS
           + n_pairs(views) * 2 * feature_dim + SOFTMAX_OPS)
    return Cost(nbytes, n_rays * planes * per)


# --- the march and the sweeps over it ------------------------------------

def _ray_bytes(n_rays, planes):
    """The endpoints and the (N, D) scores, read by every sweep."""
    return n_rays * (2 * 3 * 4 + planes * 4)


def bp_sweep_cost(mode, n_rays, planes, visits, grid_cells):
    """One BP sweep of ``mode`` ("first", "message", "depth") over
    ``n_rays`` that visit ``visits`` cells of a grid of ``grid_cells``:
    the visited messages read (message, depth) and written (first,
    message) once, the grid read (message, depth) and written (first,
    message) at most once per visit, the counts and the depths written."""
    cells = min(visits, grid_cells) * 4
    nbytes = _ray_bytes(n_rays, planes) + n_rays * 4 + {
        "first": visits * 4 + cells,
        "message": 2 * visits * 4 + 2 * cells,
        "depth": visits * 4 + cells + n_rays * 4,
    }[mode]
    per = MARCH_OPS + MAP_OPS + {
        "first": MESSAGE_OPS + SCATTER_OPS,
        "message": MU_OPS + MESSAGE_OPS + SCATTER_OPS,
        "depth": MU_OPS + POSTERIOR_OPS + ARGMAX_OPS,
    }[mode]
    return Cost(nbytes, visits * per)


def voxel_depth_cost(n_rays, planes, visits):
    """K3's voxel-depth mode: the endpoints and scores read, the depths
    and counts written; per visit the march, the hat mapping and the
    running argmax."""
    return Cost(_ray_bytes(n_rays, planes) + n_rays * 8 + 6 * 4 + 3 * 4,
                visits * (MARCH_OPS + MAP_OPS + ARGMAX_OPS))


def sweep_cost(mode, n_rays, planes, visits, grid_cells):
    """A sweep over a view's march: K3's "voxel_depth" mode or a BP sweep
    (K2) of ``mode``."""
    if mode == "voxel_depth":
        return voxel_depth_cost(n_rays, planes, visits)
    return bp_sweep_cost(mode, n_rays, planes, visits, grid_cells)


# --- a pass, from the counts of its work ---------------------------------
#
# ``work`` (counted by a driver from the scene's segments): "images", one
# {"rays", "visits", "feature_rows"} per reference view; "views", "planes",
# "feature_dim", "grid_cells"; "cnn_flops", the CNN over every image the
# pass needs, once each.

def plane_sweep_costs(work):
    """K1's cost of each reference view of a pass."""
    return [plane_sweep_cost(im["rays"], work["planes"], work["views"],
                             work["feature_dim"], im["feature_rows"])
            for im in work["images"]]


def pass_sweeps(config):
    """[mode, count] of the sweeps a pass of ``config`` makes over each
    view's march: the raynet pass's BP, a first sweep, ``bp_iterations``
    - 1 message sweeps and the depth sweep (K2); the voxel-space MVCNN
    pass's one voxel-depth sweep (K3)."""
    factory = config["factory"]
    if factory == "raynet":
        return [["first", 1], ["message", config["bp_iterations"] - 1],
                ["depth", 1]]
    if factory == "multi_view_cnn_voxel_space":
        return [["voxel_depth", 1]]
    raise ValueError("no sweeps known for the factory %r" % (factory,))


def sweep_costs(work, sweeps, modes=None):
    """The costs of a pass's sweeps over each view's march: ``sweeps``
    [mode, count] as ``pass_sweeps`` gives them, those of ``modes`` only
    where given."""
    return [sweep_cost(mode, im["rays"], work["planes"], im["visits"],
                       work["grid_cells"])
            for mode, count in sweeps if modes is None or mode in modes
            for im in work["images"] for _ in range(count)]


def pass_flops(work, sweeps):
    """The operations of one pass: the CNN (2 x its multiply-accumulates),
    the plane sweep and the sweeps over the march."""
    return (work["cnn_flops"] + sum(c.ops for c in plane_sweep_costs(work))
            + sum(c.ops for c in sweep_costs(work, sweeps)))


# --- closed-form counts --------------------------------------------------

_EPS = 1e-2


def closed_form_visits(ray_start, ray_end, bbox, grid_shape, max_voxels):
    """(N,) int64 cells each segment's march visits: 0 where its ends are
    equal or its nudged start lies outside the grid, else 1 + |crossings|
    in x, y and z, capped at ``max_voxels``. The endpoints are nudged into
    the segment by a hundredth of a cell, as the march nudges them."""
    grid = torch.tensor([int(g) for g in grid_shape], dtype=torch.float32,
                        device=ray_start.device)
    bbox = bbox.reshape(6).to(torch.float32)
    bin_size = (bbox[3:] - bbox[:3]) / grid
    ray = ray_end - ray_start
    step = torch.where(ray >= 0, 1.0, -1.0)
    start = ray_start - bbox[None, :3] + step * bin_size[None] * _EPS
    end = ray_end - bbox[None, :3] - step * bin_size[None] * _EPS
    first = torch.floor(start / bin_size[None])
    last = torch.floor(end / bin_size[None])
    inside = ((first >= 0) & (first < grid[None])).all(dim=-1) \
        & (ray != 0).any(dim=-1)
    crossings = (last - first).abs().sum(dim=-1).to(torch.int64)
    visits = torch.clamp(crossings + 1, max=int(max_voxels))
    return torch.where(inside, visits, torch.zeros_like(visits))


def touched_feature_rows(P, ray_start, ray_end, planes, padding, height,
                         width, feature_shape, block=1 << 16):
    """Distinct (view, feature cell) rows the plane sweep of these
    segments reads from features of ``feature_shape`` (V, Hf, Wf, F):
    each (ray, plane) point projected into each view and rounded to its
    cell, as the sweep's indexing does (half to even, offset by the
    padding, clamped, the zero cell where either coordinate clamps to
    0)."""
    V, Hf, Wf, _ = feature_shape
    seen = torch.zeros((V, Hf * Wf), dtype=torch.bool,
                       device=ray_start.device)
    k = torch.arange(planes, dtype=torch.float32, device=ray_start.device)
    frac = k / torch.tensor(float(planes - 1), device=ray_start.device)
    offset = padding - (padding - 1) // 2
    for lo in range(0, ray_start.shape[0], block):
        s, e = ray_start[lo:lo + block], ray_end[lo:lo + block]
        pts = s[:, None, :] + frac[None, :, None] * (e - s)[:, None, :]
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        for v in range(V):
            p = P[v]
            u = p[0, 0] * x + p[0, 1] * y + p[0, 2] * z + p[0, 3]
            w = p[1, 0] * x + p[1, 1] * y + p[1, 2] * z + p[1, 3]
            d = p[2, 0] * x + p[2, 1] * y + p[2, 2] * z + p[2, 3]
            fx = (torch.round(u / d).to(torch.int64) + offset).clamp(0, width)
            fy = (torch.round(w / d).to(torch.int64) + offset).clamp(0, height)
            zero = (fx == 0) | (fy == 0)
            row = torch.where(zero, 0, fy * Wf + fx)
            seen[v, row.reshape(-1)] = True
    return int(seen.sum())

"""Ray sharding over processes with ``torch.distributed``.

Port of ``raynet_tpu/parallel/sharding.py``. Rays are independent through
the plane sweep, the traversal, the depth->voxel mapping and the per-ray BP
recurrences; the only interaction between rays is the scatter into the
occupancy grid, once per BP sweep. So each rank of a ray group takes a
contiguous span of the rays, the CNN is replicated, and each sweep's grid
scatter, summed from zero on each rank, is summed over the ranks by one
all-reduce. The prior is added after that sum, once: a sum of grids that
each started from the prior would count it ``world_size`` times.

Counterparts of the JAX functions:

- ``make_ray_mesh`` :30 -> ``RayGroup`` (``make_ray_group``,
  ``ray_group_from_env``, ``launch``);
- ``shard_batch`` :39 / ``replicate`` :46 -> ``shard`` (a rank's span of an
  axis of any length: no padding and no ``n_valid``) / ``replicate``
  (a broadcast from rank 0);
- ``sharded_bp_update`` :50, ``sharded_raynet_message_step`` :70,
  ``sharded_raynet_depth_step`` :113, ``sharded_image_update`` :223 and
  ``sharded_image_depth`` :298 -> the same names, with K1 and K2 on the
  rank's rays (``ops/planesweep``, ``ops/bp_sweep``);
- ``shard_e2e_batch`` :339 / ``replicate_state`` :354 -> the same names.
  The end-to-end step itself is ``train_e2e.build_end_to_end_training``
  with a ``ray_group``: each BP sweep's scatter and each BatchNorm's sums
  go through ``all_reduce_sum`` (an all-reduce with its gradient), as
  GSPMD inserts them in the JAX step.

``sharded_beam_message_step`` :141 and ``sharded_beam_depth_step`` :190 are
not ported: the beam (slot-major messages in planned boxes) is the TPU
kernel's layout, which the port leaves behind with its planners; K2 sweeps
rays in DDA order under the same sharding.

Backends: NCCL for CUDA tensors, gloo for CPU tensors, or the one a caller
names. NCCL will not put two ranks on one GPU, so two ranks on one card
use gloo (which all-reduces and broadcasts CUDA tensors through the host),
and NCCL runs there at world size 1. Every process group gets a timeout,
so that a collective whose peer is gone raises instead of waiting.
"""
import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from ..ops import mrf
from ..ops.bp_sweep import bp_sweep
from ..ops.fused import raynet_image_depth, raynet_image_scatter
from ..ops.planesweep import plane_sweep_scores
from ..ops.sampling import segments_in_bbox
from ..utils.generic_utils import resolve_device

TIMEOUT_S = 60.0

_current = None


class RayGroup:
    """One process's place in a ray-sharded run over the default process
    group: ``rank``, ``world_size`` and its ``device``; ``owns``: whether
    it initialised that group (and destroys it on ``close``).

    ``all_reduce`` sums a tensor over the ranks in place and counts it:
    ``grid_all_reduces`` those of grid scatters, ``all_reduces`` all of
    them, ``collective_s`` the seconds spent in them (the device is
    synchronised before and after each, so kernel time is not counted)."""

    def __init__(self, rank, world_size, device, owns=False):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.owns = owns
        self.reset_counts()

    def reset_counts(self):
        self.grid_all_reduces = 0
        self.all_reduces = 0
        self.collective_s = 0.0

    def span(self, n):
        """This rank's rows [lo, hi) of an axis of length ``n``: contiguous
        spans in rank order whose sizes differ by at most one."""
        base, extra = divmod(int(n), self.world_size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + int(self.rank < extra)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_reduce(self, t, grid=False):
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        self._sync()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        self._sync()
        self.collective_s += time.perf_counter() - t0
        self.all_reduces += 1
        self.grid_all_reduces += int(grid)
        return t

    def close(self):
        """Destroy the default process group if this group initialised
        it."""
        global _current
        if _current is self:
            _current = None
        if self.owns and dist.is_initialized():
            dist.destroy_process_group()
        self.owns = False


def current_ray_group():
    """The ray group ``make_ray_group`` made last in this process, while
    it is open; else None."""
    if _current is not None and dist.is_initialized():
        return _current
    return None


def _rank_device(device, rank):
    device = resolve_device(device)  # a CUDA device without a card raises
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def make_ray_group(device="cuda", backend=None, timeout=TIMEOUT_S,
                   init_method=None, rank=None, world_size=None):
    """The ray group of this process.

    Uses the default process group where one is initialised; else
    initialises it, from ``init_method`` (e.g. ``"file:///tmp/rdzv"``)
    with ``rank`` and ``world_size``, or from the ``env://`` variables
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) that ``torchrun`` sets,
    with ``backend`` (by default NCCL for a CUDA device, gloo for the CPU)
    and a ``timeout`` in seconds. A CUDA device without an index is
    ``cuda:(LOCAL_RANK % device_count)``, made the current device; a CUDA
    device without a card raises.
    """
    global _current
    owns = not dist.is_initialized()
    if not owns:
        rank = dist.get_rank()
    elif init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    device = _rank_device(device, rank)
    if owns:
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
    _current = RayGroup(dist.get_rank(), dist.get_world_size(), device, owns)
    return _current


def ray_group_from_env(device="cuda"):
    """The open ray group; else one made from an initialised default
    process group or from torchrun's variables; else None (one process)."""
    group = current_ray_group()
    if group is not None:
        return group
    if dist.is_initialized() or (
            "RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return make_ray_group(device)
    return None


def _rank_main(rank, fn, world_size, init_file, device, backend, timeout,
               args):
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    group = make_ray_group(device, backend, timeout,
                           init_method="file://" + init_file, rank=rank,
                           world_size=world_size)
    try:
        fn(group, *args)
    finally:
        group.close()


def launch(fn, world_size, device="cuda", args=(), backend=None,
           timeout=TIMEOUT_S):
    """Run ``fn(ray_group, *args)`` in ``world_size`` spawned processes,
    which meet through a file in a new temporary directory. Returns when
    all have returned; if one raises, the others are terminated and this
    raises. ``fn`` must be importable by name (a module-level function)."""
    tmp = tempfile.mkdtemp(prefix="raynet_tpu_torch_rdzv_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, world_size, os.path.join(tmp, "rendezvous"), device,
                  backend, timeout, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard(ray_group, x, axis=0):
    """This rank's span of axis ``axis`` of ``x`` (an array or tensor)."""
    lo, hi = ray_group.span(x.shape[axis])
    return x[(slice(None),) * axis + (slice(lo, hi),)]


def replicate(ray_group, t, src=0):
    """``t`` broadcast from rank ``src`` to every rank, in place."""
    dist.broadcast(t, src)
    return t


def gather_rows(ray_group, local, n):
    """The (n, ...) tensor whose rows are every rank's ``local`` rows at
    its span, on every rank: a sum of zero-filled tensors in which each
    rank fills only its span, which is exact."""
    lo, hi = ray_group.span(n)
    full = local.new_zeros((n,) + tuple(local.shape[1:]))
    full[lo:hi] = local
    return ray_group.all_reduce(full)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ray_group, grid):
        ctx.ray_group, ctx.grid = ray_group, grid
        return ray_group.all_reduce(x.clone(), grid)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return ctx.ray_group.all_reduce(grad, ctx.grid), None, None


def all_reduce_sum(x, ray_group, grid=False):
    """The sum of ``x`` over the ranks, as autograd sees it: its gradient
    is the sum of the ranks' gradients, which reaches every rank's ``x``.
    Under ``torch.utils.checkpoint`` its recomputation all-reduces again,
    on every rank alike. ``grid``: count it as a grid all-reduce."""
    return _AllReduceSum.apply(x, ray_group, grid)


def sharded_bp_update(ray_group, S, flat_idx, counts, messages_pon,
                      grid_acc_flat, grid_size):
    """``mrf.bp_update`` on this rank's rays; the scatter summed over the
    ranks. Returns (this rank's new messages, the whole batch's scatter)."""
    msgs, scatter = mrf.bp_update(S, flat_idx, counts, messages_pon,
                                  grid_acc_flat, grid_size)
    return msgs, ray_group.all_reduce(scatter, grid=True)


def _segments_and_scores(ray_idxs, features, P, P_pinv, center, bbox,
                         height, width, padding, depth_planes):
    rs, re = segments_in_bbox(ray_idxs, P_pinv, center, bbox, height)
    return rs, re, plane_sweep_scores(features, P, rs, re, padding, height,
                                      width, depth_planes)


def sharded_raynet_message_step(
    ray_group, ray_idxs, features, P, P_pinv, camera_center, bbox,
    messages, grid_acc, height, width, padding, depth_planes, grid_shape,
    max_voxels, first_iteration=False,
):
    """One message sweep of this rank's rays ``ray_idxs``: K1, then K2 in
    its first or message mode (the first takes the prior from
    ``grid_acc[0]``, which is still uniformly the prior, as the JAX step
    does), the scatter summed over the ranks. Returns (this rank's
    messages (n, M), the scatter (G,))."""
    rs, re, S = _segments_and_scores(
        ray_idxs, features, P, P_pinv, camera_center, bbox, height, width,
        padding, depth_planes)
    scatter = torch.zeros_like(grid_acc)
    msgs, _, _ = bp_sweep(
        rs, re, S, None if first_iteration else messages,
        None if first_iteration else grid_acc, scatter, camera_center, bbox,
        grid_shape, max_voxels,
        float(grid_acc[0]) if first_iteration else 0.0,
        "first" if first_iteration else "message")
    return msgs, ray_group.all_reduce(scatter, grid=True)


def sharded_raynet_depth_step(
    ray_group, ray_idxs, features, P, P_pinv, camera_center, bbox,
    messages, grid_acc, height, width, padding, depth_planes, grid_shape,
    max_voxels,
):
    """The posterior depth (n,) of this rank's rays ``ray_idxs``: K1, then
    K2's depth mode. The sweep only reads the grid: no collective."""
    del ray_group
    rs, re, S = _segments_and_scores(
        ray_idxs, features, P, P_pinv, camera_center, bbox, height, width,
        padding, depth_planes)
    return bp_sweep(rs, re, S, messages, grid_acc, None, camera_center,
                    bbox, grid_shape, max_voxels, 0.0, "depth")[2]


def sharded_image_update(ray_group, messages, scores, scatter_total,
                         grid_acc, ray_start, ray_end, camera_center, bbox,
                         **kw):
    """``fused.raynet_image_update`` with this rank's rows of an image:
    K2 once over them (on the card) into a zero grid, that grid summed
    over the ranks by one all-reduce, and the sum added to
    ``scatter_total``. Keywords as ``raynet_image_update``'s."""
    part = raynet_image_scatter(messages, scores, grid_acc, ray_start,
                                ray_end, camera_center, bbox, **kw)
    scatter_total += ray_group.all_reduce(part, grid=True)
    return messages, scatter_total


def sharded_image_depth(ray_group, n_rays, messages, scores, grid_acc,
                        ray_start, ray_end, camera_center, bbox, **kw):
    """The posterior depth (n_rays,) of every ray of an image, on every
    rank, from each rank's rows: ``fused.raynet_image_depth`` on this
    rank's, then ``gather_rows``."""
    depth = raynet_image_depth(messages, scores, grid_acc, ray_start,
                               ray_end, camera_center, bbox, **kw)
    return gather_rows(ray_group, depth, n_rays)


def shard_e2e_batch(ray_group, batch):
    """This rank's part of a RayNet training batch: X (V, B, ...) split on
    axis 1, the other ray-major entries on axis 0, ``bbox`` and
    ``scene_idx`` kept whole."""
    out = {}
    for k, v in batch.items():
        if k == "X":
            out[k] = shard(ray_group, v, axis=1)
        elif k in ("bbox", "scene_idx"):
            out[k] = v
        else:
            out[k] = shard(ray_group, v)
    return out


def replicate_state(ray_group, state):
    """Broadcast an ``E2EState`` from rank 0, in place: the CNN's
    parameters and buffers (BatchNorm's running statistics), gamma, and the
    optimizer's moments and count."""
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    if state.gamma is not None:
        tensors.append(state.gamma)
    for moments in state.tx.state.values():
        tensors.extend(moments)
    with torch.no_grad():
        for t in tensors:
            replicate(ray_group, t.data)
        count = torch.tensor([state.tx.count], dtype=torch.int64,
                             device=ray_group.device)
        state.tx.count = int(replicate(ray_group, count)[0])
    return state


def all_reduce_grads(ray_group, params):
    """Sum every parameter's ``.grad`` over the ranks (one all-reduce of
    them all, flattened); a missing gradient counts as zeros."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = ray_group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).clone()
        off += g.numel()


def global_count(ray_group, n):
    """The sum of the ranks' ``n`` (an int), as an int."""
    t = torch.tensor([int(n)], dtype=torch.int64, device=ray_group.device)
    return int(ray_group.all_reduce(t)[0])


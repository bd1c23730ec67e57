"""Every kernel of the port timed alone on the card, beside its bound.

Counterpart of ``tools/time_kernels.py``. On the kernel rig (the 6-image
ring scene at 1600x1200, seeded ``simple_cnn`` bf16 features of one view
set: V=5, D=32, F=32; one batch of ``--rays`` rays through the grid
128x128x64 at M=384), it times K1 (plane sweep), K2 (BP sweep) in its
first, message and depth modes (each also with the first sweep's stored
ray sums, rows "K2 <mode> sums"), K3 (voxel traversal) in its rows mode
("K3") and its voxel-depth mode ("K3 depth"), P1 (TMA box copy, case D2)
and P2 (f32 product on the tensor cores, "rna" mode, 128^3 and, row "P2
1024", 1024^3), and beside P1 and P2 the one PyTorch call that computes
the same. K1, K2 and K3 (both modes) are timed again on one whole image
(the 1,920,000 rays of view 0, rows "... image"), as the passes launch
them, K1 also with the features in float32 ("K1 image f32"), as the
CLI's passes sweep them; K2 updates a message store in place, as the
raynet pass does. Each
time ("ms") is the median over ``--repeats`` CUDA-event runs of
``--iters`` launches each, per launch, after a warm-up. Bounds come from
``roofline`` with the counts of the rays at hand. ``chip_smoke.py`` takes
its kernel times from ``time_all`` with ``--iters 1 --repeats 7
--plain``.

A CUDA-event window reads the device's time only when the host enqueues
faster than the device works; for the probes, whose work is far below a
launch, it reads the host. So the probes' rows also split their time,
and their library call's, on a second line:

- ``host_us``: host microseconds per call, ``time.perf_counter`` around
  1,000 calls with no synchronisation inside the loop;
- ``device_ms``: device milliseconds per call, the kernel's own intervals
  (by name) in a ``torch.profiler`` trace of 100 calls; for the library
  call, every device operation its calls launched; None ("-") when the
  trace holds none.

A call whose ``host_us`` is above its ``device_ms`` is bound by the host.

    python -m raynet_tpu_torch.tools.time_kernels [--rays 65536]
        [--iters 10] [--repeats 5] [--plain] [--probes] [--host-steps]
        [--parent DIR ...]

``--plain`` also times each plain PyTorch version on the card, on the
batch only (K2's and K3's take ~0.1-0.3 s a batch). ``--probes`` times
only P1 and P2 (no rig). ``--host-steps`` also times each step of the
probes' launch path on the host (``host_steps``). ``--parent DIR``
(another checkout of the repository; repeatable) also times K1 on the
whole image as DIR builds it, beside this tree's, with bf16 and float32
features, in ``ROUNDS`` rounds of alternating order (``k1_against``).
Needs a CUDA card and
exits nonzero without one. The last line is a JSON object of the rows and
the card.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import types

import numpy as np
import torch

from ..ops import cuda_build
from . import roofline

N_RAYS = 65536
GRID = (128, 128, 64)
M = 384
D = 32
GAMMA = 0.05
PADDING = 11


def generation_params():
    return types.SimpleNamespace(
        depth_planes=D, neighbors=4, padding=PADDING,
        grid_shape=np.array(GRID, dtype=np.int32),
        max_number_of_marched_voxels=M, gamma_mrf=GAMMA,
    )


def kernel_rig(device, n_rays=N_RAYS):
    """The paper-resolution ring rig and one batch of it: the scene, the
    generation parameters, the seeded bf16 ``simple_cnn``, the features and
    cameras of reference view 0 and its 4 neighbours, and the bbox segments
    of ``n_rays`` rays around the image's middle. ``ps_args`` are K1's
    arguments."""
    from ..common.ring_scene import RingScene
    from ..models.feature_extractor import FeatureExtractor, zeropad_images
    from ..ops.sampling import segments_in_bbox

    scene = RingScene(6, 1200, 1600, 2750.0, angle_origin=1, seed=0)
    H, W = scene.image_shape
    gp = generation_params()
    model = FeatureExtractor("simple_cnn", seed=0,
                             output_dtype=torch.bfloat16, device=device)
    images = [scene.get_image(j) for j in scene.get_view_idxs(0, gp.neighbors)]
    features = torch.stack(
        [model.predict(zeropad_images([im], PADDING))[0] for im in images])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    P = f32(np.stack([im.camera.P for im in images]))
    P_pinv = f32(images[0].camera.P_pinv)
    center = f32(images[0].camera.center[:3, 0])
    bbox = torch.as_tensor(scene.bbox.reshape(-1), device=device)
    mid = H * W // 2
    ray_idxs = torch.arange(mid - n_rays // 2, mid + n_rays // 2,
                            dtype=torch.int32, device=device)
    rs, re = segments_in_bbox(ray_idxs, P_pinv, center, bbox, H)
    return types.SimpleNamespace(
        scene=scene, gp=gp, model=model, features=features, P=P,
        P_pinv=P_pinv, center=center, bbox=bbox, rs=rs, re=re, H=H, W=W,
        n_rays=n_rays,
        ps_args=(features, P, rs, re, PADDING, H, W, D),
    )


def time_ms(fn, iters=1, repeats=7, warmup=2):
    """Median milliseconds per call of ``fn`` over ``repeats`` CUDA-event
    runs of ``iters`` calls each, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


HOST_CALLS = 1000
ROUNDS = 4  # of the --parent comparison
DEVICE_CALLS = 100


def host_us(fn, calls=HOST_CALLS, clock=time.perf_counter, sync=None):
    """Host microseconds per call of ``fn``: ``clock`` around ``calls``
    calls with no synchronisation inside the loop, after one call and a
    ``sync`` (by default ``torch.cuda.synchronize``). Where the device
    keeps up with the calls, the host sets the pace and this is what one
    call costs it."""
    sync = sync or torch.cuda.synchronize
    fn()
    sync()
    t0 = clock()
    for _ in range(calls):
        fn()
    t1 = clock()
    sync()
    return (t1 - t0) / calls * 1e6


def kernel_device_ms(intervals, calls, name=None):
    """Device milliseconds per call: the summed durations of the
    ``profiling.device_intervals`` (name, start_us, end_us) whose name
    holds ``name`` (every interval when ``name`` is None), over
    ``calls``; None (not measured) when the trace holds no such
    interval."""
    spans = [end - start for n, start, end in intervals
             if name is None or name in n]
    return sum(spans) / calls / 1e3 if spans else None


def device_ms(fn, name=None, calls=DEVICE_CALLS):
    """Device milliseconds per call of ``fn``: ``calls`` calls traced with
    ``utils.profiling.trace`` after one untraced call, read by
    ``kernel_device_ms``: the kernels named ``name``, or every device
    operation the calls launched."""
    from ..utils import profiling

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = profiling.read_trace(os.path.join(tmp, profiling.TRACE_NAME))
    return kernel_device_ms(profiling.device_intervals(events), calls, name)


def host_device_split(kernel, library, name, host=host_us, device=device_ms):
    """A probe's time split into host and device, beside its library
    call's: {host_us, device_ms, library_host_us, library_device_ms}.
    ``device`` reads the kernel by its ``name``, and every device
    operation of the library call."""
    return {"host_us": host(kernel), "device_ms": device(kernel, name),
            "library_host_us": host(library),
            "library_device_ms": device(library)}


def box_rows_library(src, y0, xg0, sub0):
    """One PyTorch call computing P1's rows: the NSUB x-groups they come
    from, converted to float32 (as a (64, 128) view)."""
    from .probe_dma_align import BH, NSUB, WIDTH

    view = src[xg0 + sub0:xg0 + sub0 + NSUB, y0:y0 + BH]
    return view.to(torch.float32).reshape(NSUB * BH, WIDTH)


def image_segments(rig):
    """The (rows, 3) bbox segments of every ray of the rig's view 0, the
    rays of one whole image as the raynet pass sweeps them."""
    from ..ops.sampling import segments_in_bbox

    idxs = torch.arange(rig.H * rig.W, dtype=torch.int32,
                        device=rig.features.device)
    return segments_in_bbox(idxs, rig.P_pinv, rig.center, rig.bbox, rig.H)


def _k2_rows(row, suffix, rig, rs, re, S, visits, n_cells):
    """K2 in its three modes on segments ``rs``, ``re`` and scores ``S``,
    on the grids and messages of a real first and second sweep, each
    launch updating a message store in place as the forward pass does;
    then the three again with the first sweep's stored ray sums, as the
    forward pass launches them: written in first mode, read in the others
    (rows "K2 <mode> sums")."""
    from ..ops import bp_sweep as k2
    from ..ops.mrf import log_prior

    dev = rs.device
    n = rs.shape[0]
    prior = float(log_prior(GAMMA))
    scatter = torch.zeros(int(np.prod(GRID)), device=dev)

    def args(mode, grid_acc, msgs):
        return (rs, re, S, msgs, grid_acc, scatter, rig.center, rig.bbox,
                GRID, M, prior, mode)

    m1 = torch.zeros((n, M), device=dev)
    sums = (torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev))
    k2.bp_sweep(*args("first", None, None), messages_out=m1, ray_sums=sums)
    g1 = scatter + prior
    m2 = m1.clone()
    scatter.zero_()
    k2.bp_sweep(*args("message", g1, m2), messages_out=m2)
    g2 = scatter + prior
    out = torch.zeros((n, M), device=dev)
    # message mode drifts m1 from launch to launch; its work stays the same
    inputs = {"first": (None, None, out), "message": (g1, m1, m1),
              "depth": (g2, m2, None)}
    for mode in roofline.BP_MODES:
        grid_acc, msgs, store = inputs[mode]
        a = args(mode, grid_acc, msgs)
        row("K2 %s%s" % (mode, suffix),
            roofline.bp_sweep_cost(mode, n, D, visits, n_cells),
            lambda: k2.bp_sweep(*a, messages_out=store),
            (lambda: k2.bp_sweep_reference(*a)) if n <= N_RAYS else None,
            visits=visits, cells=n_cells, rays=n)
    for mode in roofline.BP_MODES:
        grid_acc, msgs, store = inputs[mode]
        a = args(mode, grid_acc, msgs)
        row("K2 %s sums%s" % (mode, suffix),
            roofline.bp_sweep_cost(mode, n, D, visits, n_cells),
            lambda: k2.bp_sweep(*a, messages_out=store, ray_sums=sums),
            None, visits=visits, cells=n_cells, rays=n)


SPLIT_KEYS = ("host_us", "device_ms", "library_host_us", "library_device_ms")
# the probes' kernels, by the name a trace gives them
P1_KERNEL, P2_KERNEL = "tma_box_kernel", "tf32_dot_kernel"
N_DOT_LARGE = 1024


def _row_timer(rows, iters, repeats, plain):
    """``row(name, cost, kernel, reference, library=None, split=None,
    **counts)`` appends to ``rows`` the timing of ``kernel`` alone and,
    with ``split`` (the kernel's name in a trace), its host/device split
    beside the library call's."""
    def row(name, cost, kernel, reference, library=None, split=None,
            **counts):
        ms = time_ms(kernel, iters, repeats)
        plain_ms = time_ms(reference, 1, 3, 1) if plain and reference else None
        library_ms = time_ms(library, iters, repeats) if library else None
        bound_ms, bound_by = roofline.bound(cost)
        r = {"name": name, "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "nbytes": cost.nbytes, "counts": counts}
        r.update(host_device_split(kernel, library, split) if split
                 else dict.fromkeys(SPLIT_KEYS))
        rows.append(r)
    return row


def time_all(rig, iters, repeats, plain):
    """Rows {name, ms, plain_ms, library_ms, bound_ms, bound_by, nbytes,
    counts, host_us, device_ms, library_host_us, library_device_ms} of
    every kernel on ``rig``, on its batch and (K1, K2, K3) on one whole
    image, then the probes' (``time_probes``). ``plain_ms`` (median of 3
    single calls) only with ``plain``, on the batch; ``library_ms`` where
    one PyTorch call computes the same function (P1: ``box_rows_library``;
    P2: ``torch.matmul`` with TF32 allowed), else None. ``counts`` are the
    counts the bound rests on. The host/device split (``host_device_split``)
    only for the probes, else None."""
    from ..ops.planesweep import plane_sweep_scores, plane_sweep_scores_reference
    from ..ops.ray_marching import (
        voxel_traversal_flat,
        voxel_traversal_flat_reference,
    )
    from ..ops.voxel_depth import (
        voxel_argmax_depth,
        voxel_argmax_depth_reference,
    )

    n = rig.n_rays
    rows = []
    row = _row_timer(rows, iters, repeats, plain)

    S, cells = plane_sweep_scores(*rig.ps_args, return_cells=True)
    f = rig.features
    n_rows = roofline.feature_rows(cells, f.shape)
    del cells
    row("K1", roofline.plane_sweep_cost(n, f.shape[0], D, f.shape[3],
                                        f.element_size(), n_rows),
        lambda: plane_sweep_scores(*rig.ps_args),
        lambda: plane_sweep_scores_reference(*rig.ps_args),
        feature_rows=n_rows)

    k3_args = (rig.bbox, rig.rs, rig.re, GRID, M)
    idx, counts = voxel_traversal_flat(*k3_args)
    visits, n_cells = roofline.march_counts(idx, counts)
    del idx
    row("K3", roofline.voxel_traversal_cost(n, M, visits),
        lambda: voxel_traversal_flat(*k3_args),
        lambda: voxel_traversal_flat_reference(*k3_args),
        visits=visits, cells=n_cells)
    depth_args = (rig.bbox, rig.rs, rig.re, S, rig.center, GRID, M)
    row("K3 depth", roofline.voxel_depth_cost(n, D, visits),
        lambda: voxel_argmax_depth(*depth_args),
        lambda: voxel_argmax_depth_reference(*depth_args), visits=visits)
    _k2_rows(row, "", rig, rig.rs, rig.re, S, visits, n_cells)
    del S, depth_args

    # one whole image, as the passes launch K1, K2 and K3: every ray of
    # view 0 (the plain versions are not timed at this size)
    rs, re = image_segments(rig)
    n_img = rs.shape[0]
    ps_args = (f, rig.P, rs, re, PADDING, rig.H, rig.W, D)
    S, cells = plane_sweep_scores(*ps_args, return_cells=True)
    n_rows = roofline.feature_rows(cells, f.shape)
    del cells
    row("K1 image", roofline.plane_sweep_cost(
        n_img, f.shape[0], D, f.shape[3], f.element_size(), n_rows),
        lambda: plane_sweep_scores(*ps_args), None, feature_rows=n_rows,
        rays=n_img)
    # the same in float32, as the CLI's passes sweep their features
    f32_args = (f.float(),) + ps_args[1:]
    row("K1 image f32", roofline.plane_sweep_cost(
        n_img, f.shape[0], D, f.shape[3], 4, n_rows),
        lambda: plane_sweep_scores(*f32_args), None, feature_rows=n_rows,
        rays=n_img)
    del f32_args
    idx, counts = voxel_traversal_flat(rig.bbox, rs, re, GRID, M)
    visits, n_cells = roofline.march_counts(idx, counts)
    del idx, counts
    row("K3 image", roofline.voxel_traversal_cost(n_img, M, visits),
        lambda: voxel_traversal_flat(rig.bbox, rs, re, GRID, M), None,
        visits=visits, cells=n_cells, rays=n_img)
    depth_args = (rig.bbox, rs, re, S, rig.center, GRID, M)
    row("K3 depth image", roofline.voxel_depth_cost(n_img, D, visits),
        lambda: voxel_argmax_depth(*depth_args), None, visits=visits,
        rays=n_img)
    del depth_args
    _k2_rows(row, " image", rig, rs, re, S, visits, n_cells)
    del S, rs, re
    return rows + time_probes(f.device, iters, repeats, plain)


def k1_launcher(lib, args):
    """A function that launches ``lib``'s K1 (``raynet_plane_sweep_scores``
    of a kernel library, this tree's or another checkout's) once on K1's
    wrapper arguments ``args``, through the wrapper's ctypes call, into one
    preallocated score buffer, and returns the buffer."""
    features, P, rs, re, padding, H, W, n_planes = args
    V, Hf, Wf, F = features.shape
    n = rs.shape[0]
    out = torch.empty((n, n_planes), dtype=torch.float32,
                      device=features.device)
    argv = (features.data_ptr(), int(features.dtype == torch.bfloat16),
            P.data_ptr(), rs.data_ptr(), re.data_ptr(), out.data_ptr(), None,
            V, Hf, Wf, F, n, n_planes, int(padding), int(H), int(W),
            cuda_build.raw_stream(features.get_device()))

    def launch():
        cuda_build.check(lib.raynet_plane_sweep_scores(*argv),
                         "raynet_plane_sweep_scores")
        return out
    launch.args = args  # alive while the kernel reads their memory
    return launch


def round_orders(names, rounds):
    """The order of ``names`` in each of ``rounds`` rounds: forward, then
    backward, and so on, so that no name always runs first or last."""
    return [list(names) if k % 2 == 0 else list(names)[::-1]
            for k in range(rounds)]


def k1_against(rig, parents, repeats, rounds=ROUNDS):
    """K1 on the whole image of view 0 as this tree builds it (``this``)
    and as each of ``parents`` ({label: another checkout's directory})
    builds it, with the rig's bf16 features and with them in float32:
    {"<label> <dtype>": {"ms": [a ``time_ms`` median of ``repeats`` one-
    launch runs per round], "max_abs_diff": from this tree's scores}}, the
    builds timed in ``round_orders``."""
    libs = {"this": cuda_build.library()}
    for label, checkout in parents.items():
        libs[label] = cuda_build.load_library(
            os.path.join(checkout, "raynet_tpu_torch", "csrc"))
    rs, re = image_segments(rig)
    runs = {}
    for dtype, features in (("bf16", rig.features),
                            ("f32", rig.features.float())):
        args = (features, rig.P, rs, re, PADDING, rig.H, rig.W, D)
        for label, lib in libs.items():
            runs["%s %s" % (label, dtype)] = k1_launcher(lib, args)
    out = {}
    for name, launch in runs.items():
        ref = runs["this " + name.split()[-1]]().clone()
        diff = (launch() - ref).abs().nan_to_num(nan=float("inf")).max()
        out[name] = {"ms": [], "max_abs_diff": float(diff)}
    for order in round_orders(runs, rounds):
        for name in order:
            out[name]["ms"].append(time_ms(runs[name], 1, repeats))
    return out


def time_probes(dev, iters, repeats, plain):
    """The probes' rows (as ``time_all``'s, with the host/device split):
    P1 on case D2 ("P1"); P2 in "rna" mode at
    128^3 ("P2") and at 1024^3 ("P2 1024"), beside ``torch.matmul`` with
    TF32 allowed."""
    from . import probe_dma_align as probes

    rows = []
    row = _row_timer(rows, iters, repeats, plain)
    src = probes.box_source(dev)
    offs = probes.case_offsets(*probes.CASES[-1])
    row("P1", roofline.tma_box_cost(),
        lambda: probes.tma_box_rows(src, *offs),
        lambda: probes.tma_box_rows_reference(src, *offs),
        lambda: box_rows_library(src, *offs), split=P1_KERNEL)

    # P2 in "rna" mode, whose plain version is what the card computes
    rng = np.random.RandomState(0)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for name, n in (("P2", probes.N_DOT), ("P2 1024", N_DOT_LARGE)):
            x, e = (torch.as_tensor(rng.randn(n, n).astype(np.float32),
                                    device=dev) for _ in range(2))
            row(name, roofline.tensor_core_dot_cost(n),
                lambda x=x, e=e: probes.tensor_core_dot(x, e, "rna"),
                lambda x=x, e=e: probes.tensor_core_dot_reference(
                    x, e, "tf32_rna"),
                lambda x=x, e=e: torch.matmul(x, e), split=P2_KERNEL, n=n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return rows


def host_steps(dev):
    """Host microseconds (``host_us``) of each step of the probes' launch
    path, alone: P2's checks, two ways to allocate its output
    (``torch.empty``; ``x.new_empty``), two device guards
    (``torch.cuda.device`` always; ``cuda_build.device_guard``),
    the two ways to the current stream (a ``torch.cuda.Stream`` object;
    ``cuda_build.raw_stream``), the bare ctypes launches of P2 and P1 with
    their arguments ready, and each whole wrapper."""
    from ..ops import cuda_build
    from . import probe_dma_align as probes

    lib = cuda_build.library()
    n = probes.N_DOT
    x = torch.randn((n, n), device=dev)
    out = torch.empty_like(x)
    src = probes.box_source(dev)
    box_out = torch.empty((probes.NSUB * probes.BH, probes.WIDTH),
                          device=dev)
    offs = probes.case_offsets(*probes.CASES[-1])
    stream = cuda_build.raw_stream(dev.index)
    wg, hf = src.shape[:2]

    def guard_always():
        with torch.cuda.device(dev):
            pass

    def guard_if_needed():
        with cuda_build.device_guard(dev.index):
            pass

    steps = {
        "P2 checks": lambda: probes._check_dot_args(x, x),
        "P2 output: torch.empty": lambda: torch.empty(
            (n, n), dtype=torch.float32, device=dev),
        "P2 output: x.new_empty": lambda: x.new_empty((n, n)),
        "device guard: torch.cuda.device": guard_always,
        "device guard: cuda_build.device_guard": guard_if_needed,
        "stream: torch.cuda.current_stream": lambda: (
            torch.cuda.current_stream(dev).cuda_stream),
        "stream: cuda_build.raw_stream": lambda: cuda_build.raw_stream(
            dev.index),
        "P2 ctypes launch": lambda: lib.raynet_probe_tf32_dot(
            x.data_ptr(), x.data_ptr(), out.data_ptr(), n, n, n, 1, stream),
        "P2 wrapper": lambda: probes.tensor_core_dot(x, x, "rna"),
        "P1 ctypes launch": lambda: lib.raynet_probe_tma_box(
            src.data_ptr(), box_out.data_ptr(), wg, hf, *offs, dev.index,
            stream),
        "P1 wrapper": lambda: probes.tma_box_rows(src, *offs),
    }
    return {name: host_us(fn) for name, fn in steps.items()}


def format_rows(rows):
    """The rows of ``time_all`` as a table, one line each; the host/device
    split, where a row has it, on a second line."""
    def opt(v, fmt="%.4f"):
        return "-" if v is None else fmt % v

    lines = ["%-18s %9s %11s %-10s %7s %10s %10s" % (
        "kernel", "ms", "bound ms", "bound by", "share", "plain ms",
        "library ms")]
    for r in rows:
        lines.append("%-18s %9.4f %11.7f %-10s %6.2f%% %10s %10s" % (
            r["name"], r["ms"], r["bound_ms"], r["bound_by"],
            100 * r["bound_ms"] / r["ms"], opt(r["plain_ms"]),
            opt(r["library_ms"])))
        if r.get("host_us") is not None:
            lines.append(
                "%-18s host %s us, device %s ms; library host %s us, "
                "device %s ms" % (
                    "", opt(r["host_us"], "%.2f"), opt(r["device_ms"], "%.5f"),
                    opt(r["library_host_us"], "%.2f"),
                    opt(r["library_device_ms"], "%.5f")))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--plain", action="store_true",
                    help="also time each kernel's plain PyTorch version")
    ap.add_argument("--probes", action="store_true",
                    help="time only the probes P1 and P2 (no rig)")
    ap.add_argument("--host-steps", action="store_true",
                    help="also time each step of the probes' launch path "
                         "on the host")
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="another checkout (repeatable): also time its K1 "
                         "on the whole image beside this tree's")
    args = ap.parse_args(argv)
    if args.parent and args.probes:
        ap.error("--parent times K1 on the rig, which --probes leaves out")
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.probes:
        rows = time_probes(device, args.iters, args.repeats, args.plain)
    else:
        rig = kernel_rig(device, args.rays)
        rows = time_all(rig, args.iters, args.repeats, args.plain)
    for line in format_rows(rows):
        print(line)
    steps = host_steps(device) if args.host_steps else None
    for name, us in (steps or {}).items():
        print("host step %-40s %8.2f us" % (name, us))
    against = None
    if args.parent:
        parents = {"parent%d" % i: d for i, d in enumerate(args.parent)}
        for label, checkout in parents.items():
            print("%s: %s" % (label, checkout))
        against = k1_against(rig, parents, args.repeats)
        for name, r in against.items():
            print("K1 image %-12s %s ms; max |diff| %.3e" % (
                name, " ".join("%.4f" % t for t in r["ms"]),
                r["max_abs_diff"]))
    print(json.dumps({
        "rays": args.rays, "iters": args.iters, "repeats": args.repeats,
        "device": torch.cuda.get_device_name(device), "kernels": rows,
        "host_steps_us": steps, "k1_against": against}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

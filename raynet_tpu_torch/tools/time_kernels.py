"""Every kernel of the port timed alone on the card, beside its bound.

Counterpart of ``tools/time_kernels.py``. On the kernel rig (the 6-image
ring scene at 1600x1200, seeded ``simple_cnn`` bf16 features of one view
set: V=5, D=32, F=32; one batch of ``--rays`` rays through the grid
128x128x64 at M=384), it times K1 (plane sweep), K2 (BP sweep) in its
first, message and depth modes, K3 (voxel traversal) in its rows mode
("K3") and its voxel-depth mode ("K3 depth"), P1 (TMA box copy, case D2)
and P2 (f32 product on the tensor cores, "rna" mode, 128^3), and beside P1
and P2 the one PyTorch call that computes the same. K1, K2 and K3 (both
modes) are timed again on one whole image (the 1,920,000 rays of view 0,
rows "... image"), as the passes launch them; K2 updates a message store
in place, as the raynet pass does. Each time is the median over
``--repeats`` CUDA-event runs of ``--iters`` launches each, per launch,
after a warm-up. Bounds come from ``roofline`` with the
counts of the rays at hand. ``chip_smoke.py`` takes its kernel times from
``time_all`` with ``--iters 1 --repeats 7 --plain``.

    python -m raynet_tpu_torch.tools.time_kernels [--rays 65536]
        [--iters 10] [--repeats 5] [--plain]

``--plain`` also times each plain PyTorch version on the card, on the
batch only (K2's and K3's take ~0.1-0.3 s a batch). Needs a CUDA card and
exits nonzero without one. The last line is a JSON object of the rows and
the card.
"""
import argparse
import json
import statistics
import sys
import types

import numpy as np
import torch

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
    launch updating a message store in place as the forward pass does."""
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
    k2.bp_sweep(*args("first", None, None), messages_out=m1)
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


def time_all(rig, iters, repeats, plain):
    """Rows {name, ms, plain_ms, library_ms, bound_ms, bound_by, nbytes,
    counts} of every kernel on ``rig``, on its batch and (K1, K2, K3) on
    one whole image. ``plain_ms`` (median of 3 single calls) only with
    ``plain``, on the batch; ``library_ms`` where one PyTorch call
    computes the same function (P1: ``box_rows_library``; P2:
    ``torch.matmul`` with TF32 allowed), else None. ``counts`` are the
    counts the bound rests on."""
    from ..ops.planesweep import plane_sweep_scores, plane_sweep_scores_reference
    from ..ops.ray_marching import (
        voxel_traversal_flat,
        voxel_traversal_flat_reference,
    )
    from ..ops.voxel_depth import (
        voxel_argmax_depth,
        voxel_argmax_depth_reference,
    )
    from .probe_dma_align import (
        CASES,
        N_DOT,
        box_source,
        case_offsets,
        tensor_core_dot,
        tensor_core_dot_reference,
        tma_box_rows,
        tma_box_rows_reference,
    )

    dev = rig.features.device
    n = rig.n_rays
    rows = []

    def row(name, cost, kernel, reference, library=None, **counts):
        ms = time_ms(kernel, iters, repeats)
        plain_ms = time_ms(reference, 1, 3, 1) if plain and reference else None
        library_ms = time_ms(library, iters, repeats) if library else None
        bound_ms, bound_by = roofline.bound(cost)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "nbytes": cost.nbytes,
                     "counts": counts})

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
    src = box_source(dev)
    offs = case_offsets(*CASES[-1])
    row("P1", roofline.tma_box_cost(),
        lambda: tma_box_rows(src, *offs),
        lambda: tma_box_rows_reference(src, *offs),
        lambda: box_rows_library(src, *offs))

    # P2 in "rna" mode, whose plain version is what the card computes
    rng = np.random.RandomState(0)
    x, e = (torch.as_tensor(rng.randn(N_DOT, N_DOT).astype(np.float32),
                            device=dev) for _ in range(2))
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        row("P2", roofline.tensor_core_dot_cost(N_DOT),
            lambda: tensor_core_dot(x, e, "rna"),
            lambda: tensor_core_dot_reference(x, e, "tf32_rna"),
            lambda: torch.matmul(x, e))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return rows


def format_rows(rows):
    """The rows of ``time_all`` as a table, one line each."""
    def opt(v):
        return "-" if v is None else "%.4f" % v

    lines = ["%-18s %9s %11s %-10s %7s %10s %10s" % (
        "kernel", "ms", "bound ms", "bound by", "share", "plain ms",
        "library ms")]
    for r in rows:
        lines.append("%-18s %9.4f %11.7f %-10s %6.2f%% %10s %10s" % (
            r["name"], r["ms"], r["bound_ms"], r["bound_by"],
            100 * r["bound_ms"] / r["ms"], opt(r["plain_ms"]),
            opt(r["library_ms"])))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--plain", action="store_true",
                    help="also time each kernel's plain PyTorch version")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rig = kernel_rig(device, args.rays)
    rows = time_all(rig, args.iters, args.repeats, args.plain)
    for line in format_rows(rows):
        print(line)
    print(json.dumps({
        "rays": args.rays, "iters": args.iters, "repeats": args.repeats,
        "device": torch.cuda.get_device_name(device), "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raynet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from ``raynet_tpu_torch/csrc`` and then, in
order, every phase failing loudly (nonzero exit):

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: seconds the nvcc build took; then every kernel timed alone by
   ``time_kernels.time_all`` on one 65,536-ray batch of the rig below
   (V=5, D=32, F=32, bf16 features; median of 7 one-launch CUDA-event
   runs, plain versions of 3), and K1, K2 and K3 on one whole image (the
   1,920,000 rays of view 0), with its bound and library time: the one
   code path that gives every kernel time below;
3. K1 (plane sweep) against its plain PyTorch version on the card, on the
   same batch and then on all rays of view 0 in one launch, as the raynet
   pass launches it (the plain version in 65,536-ray spans): feature cells
   and scores;
4. K2 (fused BP sweep) against its plain version on the card in its three
   modes (M=384, grid 128x128x64), on the same batch and then on all rays
   of view 0 in one launch (the plain version in spans), the kernel
   updating a message store in place as the raynet pass does: counts,
   messages, the scattered grid and depths, and every store entry past a
   ray's count still zero;
5. K3 (voxel traversal) against its plain versions: its rows mode on the
   same batch (indices and counts identical, counts equal to K2's); its
   voxel-depth mode on the batch and then on all rays of view 0 in one
   launch, as the voxel-space pass launches it (the plain version in spans):
   counts and zero masks identical, >= 0.999 of the depths within 1e-3
   relative, every other ray at a voxel whose plain mapped score is tied
   with the ray's maximum (rtol 1e-5), and the zero-length rays that visit
   voxels at their first voxel;
6. the three forward passes end to end through their user entry point
   (``forward_pass`` of ``RayNetForwardPass``, ``MultiViewCNNForwardPass``
   and ``MultiViewCNNVoxelSpaceForwardPass``) on the paper-resolution ring
   rig: 1600x1200, focal 2750, 6 images, 2 reference views, 4 neighbours,
   simple_cnn with seeded random weights and bf16 features, D=32, grid
   128x128x64, M=384, ``rays_batch`` 65,536 (it bounds only the plain
   versions on the CPU: on the card every pass sweeps whole images);
   raynet with gamma 0.05, 3 BP iterations and the depth sweep. For each:
   the kernel launch counts, set to 0 just before the pass and read just
   after, each exactly as expected (one launch per reference image and
   kernel, K2 once per image and sweep: raynet K1 2 and K2 8;
   multi_view_cnn K1 2; multi_view_cnn_voxel_space K1 2 and K3's
   voxel-depth mode 2; no other kernel), wall time, rays/s, phases, peak
   memory, the card's SM clock, temperature and power draw as it starts,
   and the depth maps' sanity (the timed pass follows one untimed pass of
   its own, so it finds the caching allocator warm); then the same pass
   at 400x300 (focal scaled) on the card and, with the plain versions, on
   the CPU, whose depth maps must agree;
7. the CLI (``raynet_tpu_torch.scripts.forward_pass.main``) with the
   ``multi_view_cnn_voxel_space`` factory on the card, on the 400x300 rig
   written to a temporary directory in Restrepo format: K1 and K3's
   voxel-depth mode launched once per image, and its depth maps equal to
   the pass's on the same rig;
8. the probes P1 (TMA box copy) and P2 (f32 product on the tensor cores)
   through their entry point (``raynet_tpu_torch.tools.probe_dma_align``),
   their launch counts set to 0 just before and read just after; then P1
   in all eight cases ``torch.equal`` to its plain version; P2's "rna"
   diagonal equal to the TF32 round-to-nearest emulation bit for bit and
   its "raw" diagonal matching a named rounding, then both modes on seeded
   random (128, 128) inputs within 2**-9 * (|x| @ |e|) of the float64
   product and within 2**-16 * (|x| @ |e|) of the plain version of the
   rounding their diagonal named; each probe's time split into host
   microseconds and device milliseconds a call, beside its library
   call's (``time_kernels.host_device_split``), P2 also at 1024^3; with
   ``--parent DIR`` (another checkout of the repository), P2's products
   ``torch.equal`` to those of its build from ``DIR``'s sources
   (``probe_dma_align.dot_equal_to_build``);
9. one more ``raynet`` pass at 1600x1200 under ``utils.profiling.trace``
   (``torch.profiler``): the device's busy and idle share over the pass
   and the five device operations with the most time;
10. the raynet pass with its messages in the host store
   (``message_store.HostMessageStore``): (a) on phase 6's rig with
   ``messages_device_budget`` lowered below its need, so that the store
   is memmap files in float16 (737,280,000 entries an image, over 2**28):
   launches exactly K1 2 and K2 8, ``staged_bytes`` equal to 2 *
   bp_iterations copies of each image's float16 block, the depth maps
   within rtol = atol = 1e-3 of phase 6's on >= 0.995 of the pixels (the
   JAX package's float16 bar), the spill directory gone; (b) a ring of 16
   images of 1600x1200, all reference views, at the default 40 GiB budget
   (51.9 GB of messages, scores and segments; a 23.6 GB float16 store on
   disk), its store chosen by size alone (fewer views, down to 14, the
   first count over the budget, if the disk cannot hold 16); each with its
   sweep wall time, bytes staged and host<->card GB/s, and (b) with the
   host's available memory and free disk before and after;
11. the evaluation layer on the 400x300 rig of phase 7 written with a
   cube ``gt_mesh.obj`` of 20,172 triangles around the bbox: the GT
   raycaster (``common.scene.mesh_depth_map``) on the card against the
   CPU for both reference views (hit masks identical, depths within 1e-5
   relative), its time there and at 1600x1200, beside the OctTree loop's
   (timed on one column, scaled to the image); ``raynet_forward_torch``
   (raynet), ``raynet_to_pcl_torch`` and ``raynet_compute_metrics_torch
   ppmde accuracy completeness`` on the card, then the last two with
   ``--device cpu`` on the same predictions and a copy of the scene holding
   the CPU raycast's GT depth maps: the PLY files parse, their points agree
   within rtol 1e-5, the printed means within 1e-4 relative; K3's rows
   mode launched once through ``ops.backends.perform_ray_marching`` on
   every ray of view 0, equal to its plain version. No module of JAX or of
   the JAX package may have been imported.

The rig, the kernel times and the bounds are ``raynet_tpu_torch.tools``'
(``time_kernels.kernel_rig``, ``time_kernels.time_all``, ``roofline``).
The last lines are a JSON summary of the passes, the probes, the trace,
the host store and the evaluation, the kernels' JSON line (times, bounds,
launches; K3's rows mode counted in phase 11), and the card's name and
power limit before the final JSON line ``{"ok": true, "device": ...}``.
Without a CUDA device, or
without the repository around it, the script exits nonzero and prints no
result.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def log(*args):
    print(*args, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def rel_agreement(a, b, rtol):
    """Share of entries with |a - b| <= rtol * |b|."""
    return float(np.mean(np.abs(a - b) <= rtol * np.abs(b)))


def write_restrepo_scene(scene, root):
    """Write an in-memory ring rig as a Restrepo scene directory (imgs/,
    cams_krt/, scene_info.xml) under ``root``; returns the dataset dir."""
    from PIL import Image

    scene_dir = os.path.join(root, "scene_1")
    os.makedirs(os.path.join(scene_dir, "imgs"))
    os.makedirs(os.path.join(scene_dir, "cams_krt"))
    for i in range(scene.n_images):
        im = scene.get_image(i)
        Image.fromarray(im.image_u8).save(
            os.path.join(scene_dir, "imgs", "frame%05d.png" % (i + 1,)))
        cam = im.camera
        rows = ([" ".join("%.9g" % v for v in row) for row in cam.K]
                + [" ".join("%.9g" % v for v in row) for row in cam.R]
                + [" ".join("%.9g" % v for v in cam.t.ravel())])
        with open(os.path.join(scene_dir, "cams_krt",
                               "frame%05d_cam.txt" % (i + 1,)), "w") as f:
            f.write("\n".join(rows) + "\n")
    lo, hi = scene.bbox[0, :3], scene.bbox[0, 3:]
    with open(os.path.join(scene_dir, "scene_info.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n<info>\n  <bbox minx="%r" miny="%r" '
                'minz="%r" maxx="%r" maxy="%r" maxz="%r"/>\n</info>\n'
                % tuple(float(v) for v in (*lo, *hi)))
    return root


def write_cube_mesh(path, half, n):
    """Write the surface of the cube [-half, half]^3 as an OBJ mesh, each
    face an n x n grid of squares cut into two triangles; returns the
    triangle count, 12 n^2."""
    g = np.linspace(-half, half, n + 1)
    a, b = (x.ravel() for x in np.meshgrid(g, g, indexing="ij"))
    lines, faces, base = [], [], 0
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    k = (i * (n + 1) + j).ravel()
    quads = np.stack([k, k + n + 1, k + n + 2, k + 1], axis=1)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            xyz = np.insert(np.stack([a, b], axis=1), axis, sign * half,
                            axis=1)
            lines += ["v %r %r %r" % tuple(float(c) for c in p) for p in xyz]
            q = quads + base + 1  # OBJ is 1-based
            faces += [q[:, [0, 1, 2]], q[:, [0, 2, 3]]]
            base += len(xyz)
    faces = np.concatenate(faces)
    lines += ["f %d %d %d" % tuple(f) for f in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(faces)


def host_memory_and_disk(path):
    """(available host memory, free disk space under ``path``) in GB."""
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    available = int(info["MemAvailable"].split()[0]) * 1024
    return available / 1e9, shutil.disk_usage(path).free / 1e9


def run_in_spill_dir(fp, scene, views, counters):
    """One pass of ``fp`` with the temporary files it makes in a directory
    of their own; returns (depth maps, wall seconds, launches, the names
    left in that directory afterwards)."""
    with tempfile.TemporaryDirectory() as spill:
        previous = tempfile.tempdir
        tempfile.tempdir = spill
        try:
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            maps = np.stack(list(fp.forward_pass(scene, views)))
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
        finally:
            tempfile.tempdir = previous
        left = os.listdir(spill)
    return maps, wall, launches, left


def staged_summary(fp, wall, n_views):
    """The staged pass's numbers: wall, sweep wall (BP and depth sweeps),
    bytes staged and host<->card GB/s over the sweeps."""
    sweep = (fp.timer.totals["Message passing"]
             + fp.timer.totals["Per-pixel depth estimation"])
    out = {"views": n_views, "store": fp.message_store, "wall_s": wall,
           "sweep_s": sweep, "staged_bytes": fp.staged_bytes,
           "staged_gb_per_s": fp.staged_bytes / sweep / 1e9,
           "phases_s": dict(fp.timer.totals)}
    log("  store %s, wall %.3f s, sweeps %.3f s, staged %d bytes, %.2f GB/s"
        % (out["store"], wall, sweep, fp.staged_bytes,
           out["staged_gb_per_s"]))
    for k, v in fp.timer.totals.items():
        log("  phase %-28s %.3f s" % (k, v))
    return out


def phase_host_store(check, dev, model, gp, scene, device_maps, counters,
                     expect):
    """Phase 10: the raynet pass with its messages in the host store."""
    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.tools.time_kernels import N_RAYS

    H, W = scene.image_shape
    M = int(gp.max_number_of_marched_voxels)
    D = int(gp.depth_planes)
    iters = RayNetForwardPass.bp_iterations
    per_view = H * W * (M + D + 6) * 4  # messages, scores, segments
    f16_block = H * W * M * 2
    out = {}

    log("== 10a. raynet through the host store: phase 6's rig, 2 reference "
        "views, messages_device_budget lowered below their %d bytes"
        % (2 * per_view))
    fp = RayNetForwardPass(model, gp, None, scene.image_shape, N_RAYS,
                           device=dev)
    fp.messages_device_budget = 2 * per_view - 1
    maps, wall, launches, left = run_in_spill_dir(fp, scene, (0, 2, 1),
                                                  counters)
    out["lowered_budget"] = staged_summary(fp, wall, 2)
    # 1,920,000 x 384 = 737,280,000 entries an image, over 2**28: memmap;
    # 2 images x 4 bytes x 737,280,000 over 1 GiB: float16
    check(fp.message_store == "memmap", "store %s (expect memmap)"
          % fp.message_store)
    check(launches == expect, "launches %s (expect %s)" % (launches, expect))
    # the first sweep downloads each image's (rays, M) float16 block, each
    # of the bp_iterations - 1 message sweeps uploads and downloads it, the
    # depth sweep uploads it: 2 * bp_iterations copies of each block
    staged = 2 * iters * 2 * f16_block
    check(fp.staged_bytes == staged, "staged_bytes %d = 2 * %d iterations "
          "* 2 views * %d bytes" % (fp.staged_bytes, iters, f16_block))
    close = float(np.isclose(maps, device_maps, rtol=1e-3, atol=1e-3).mean())
    same_mask = bool(np.array_equal(maps > 0, device_maps > 0))
    check(close >= 0.995, "depth maps against phase 6's device store: %.6f "
          "within rtol = atol = 1e-3 (bar 0.995); zero masks identical: %s"
          % (close, same_mask))
    check(left == [], "spill directory removed (left: %s)" % (left,))
    out["lowered_budget"].update(agreement=close, same_mask=same_mask)
    del fp, maps

    # 14 views of 1600x1200 are the first count over the 40 GiB budget
    need = {n: n * per_view for n in (16, 15, 14)}
    mem0, disk0 = host_memory_and_disk(tempfile.gettempdir())
    fits = [n for n in (16, 15, 14) if n * f16_block < 0.9e9 * disk0]
    log("== 10b. raynet through the host store at the default budget: a "
        "ring of %s images of %dx%d, all reference views; host memory "
        "available %.2f GB, disk free %.2f GB before"
        % (fits[0] if fits else "(none fit)", W, H, mem0, disk0))
    check(bool(fits), "a float16 store of 14-16 views (%.2f-%.2f GB) fits "
          "the free disk %.2f GB" % (14 * f16_block / 1e9,
                                     16 * f16_block / 1e9, disk0))
    if not fits:
        return out
    n = fits[0]
    ring = RingScene(n, H, W, 2750.0, seed=1)
    fp = RayNetForwardPass(model, gp, None, ring.image_shape, N_RAYS,
                           device=dev)
    check(need[n] > fp.messages_device_budget, "%d views need %d bytes, over "
          "the default budget %d" % (n, need[n], fp.messages_device_budget))
    maps, wall, launches, left = run_in_spill_dir(fp, ring, (0, n, 1),
                                                  counters)
    mem1, disk1 = host_memory_and_disk(tempfile.gettempdir())
    log("  host memory available %.2f GB, disk free %.2f GB after"
        % (mem1, disk1))
    out["default_budget"] = staged_summary(fp, wall, n)
    out["default_budget"].update(host_gb_before=[mem0, disk0],
                                 host_gb_after=[mem1, disk1])
    check(fp.message_store == "memmap", "store %s chosen by size (expect "
          "memmap)" % fp.message_store)
    check(launches == {k: v * n // 2 for k, v in expect.items()},
          "launches %s (K1 once per image, K2 once per image and sweep)"
          % (launches,))
    check(fp.staged_bytes == 2 * iters * n * f16_block,
          "staged_bytes %d = 2 * %d iterations * %d views * %d bytes"
          % (fp.staged_bytes, iters, n, f16_block))
    nz = maps[maps > 0]
    check(maps.shape == (n, H, W) and bool(np.isfinite(maps).all())
          and nz.size > 0.1 * maps.size and nz.min() >= 10.0
          and nz.max() <= 30.0,
          "depth maps %s finite, nonzero share %.4f, in [10, 30]"
          % (maps.shape, nz.size / maps.size))
    check(left == [], "spill directory removed (left: %s)" % (left,))
    return out


def phase_evaluation(check, dev, small, scene, counters, expect):
    """Phase 11: the GT raycaster on the card and the CPU; the forward,
    point-cloud and metrics CLIs chained on the card over the 400x300 rig
    with a GT mesh, and the point-cloud and metrics CLIs again on the CPU;
    K3's rows mode through ``ops.backends``. Returns (summary, K3 rows
    launches)."""
    import contextlib
    import io

    import torch

    from raynet_tpu_torch.common.parse_input_data import (
        parse_gt_mesh,
        parse_stl_file_to_pointcloud,
    )
    from raynet_tpu_torch.common.scene import RestrepoScene, mesh_depth_map
    from raynet_tpu_torch.ops import backends
    from raynet_tpu_torch.ops.ray_marching import (
        unflatten_voxel_indices,
        voxel_traversal_flat_reference,
    )
    from raynet_tpu_torch.ops.sampling import segments_in_bbox
    from raynet_tpu_torch.scripts import compute_metrics
    from raynet_tpu_torch.scripts import convert_to_pointcloud
    from raynet_tpu_torch.scripts import forward_pass as cli
    from raynet_tpu_torch.tools.time_kernels import D, GRID, M, N_RAYS

    h, w = small.image_shape
    H, W = scene.image_shape
    frames = (0, 1)
    out = {}
    log("== 11. evaluation: the GT raycaster, then raynet_forward_torch "
        "(raynet), raynet_to_pcl_torch and raynet_compute_metrics_torch on "
        "the %dx%d rig with a GT mesh" % (w, h))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        scene_dir = os.path.join(data, "scene_1")
        n_tris = write_cube_mesh(os.path.join(scene_dir, "gt_mesh.obj"),
                                 3.0, 41)
        tris = parse_gt_mesh(scene_dir)

        # the GT raycaster on the card against the CPU, and its times (it
        # returns numpy: its result is on the host)
        def timed(fn):
            t0 = time.perf_counter()
            res = fn()
            return res, time.perf_counter() - t0

        mesh_depth_map(small.get_image(0).camera, h, w, tris[:1], dev)
        gt_cpu, t_card, t_cpu = {}, [], []
        for i in frames:
            cam = small.get_image(i).camera
            card_map, t = timed(lambda: mesh_depth_map(cam, h, w, tris, dev))
            t_card.append(t)
            gt_cpu[i], t = timed(lambda: mesh_depth_map(cam, h, w, tris,
                                                        "cpu"))
            t_cpu.append(t)
            hit = gt_cpu[i] > 0
            rel = float((np.abs(card_map - gt_cpu[i])[hit]
                         / gt_cpu[i][hit]).max())
            check(bool(np.array_equal(card_map > 0, hit)) and rel <= 1e-5,
                  "GT depth map of view %d (%d triangles): card hit mask "
                  "equal to the CPU's (%d hits), max relative depth "
                  "difference %.3e (bar 1e-5)" % (i, n_tris, int(hit.sum()),
                                                  rel))
        gt_big, t_big = timed(lambda: mesh_depth_map(
            scene.get_image(0).camera, H, W, tris, dev))
        check(bool(np.isfinite(gt_big).all()) and (gt_big > 0).mean() > 0.1,
              "GT depth map at %dx%d: %.4f of the pixels hit"
              % (W, H, (gt_big > 0).mean()))
        disk_scene = RestrepoScene(scene_dir, device="cpu")
        t0 = time.perf_counter()
        disk_scene._get_oct_tree()
        t_tree = time.perf_counter() - t0
        t0 = time.perf_counter()
        column = [disk_scene.get_depth_for_pixel(0, y, w // 2)
                  for y in range(h)]
        t_column = time.perf_counter() - t0
        loop_est = t_column * w
        check(sum(d is not None for d in column) > 0,
              "the OctTree loop hits the mesh on column %d" % (w // 2))
        log("  GT raycaster, %d triangles: %dx%d %s s on the card, %s s on "
            "the CPU; %dx%d %.3f s on the card. OctTree loop: tree built in "
            "%.3f s, one column of %d pixels in %.3f s, so %.1f s for %dx%d "
            "(estimated from that column)"
            % (n_tris, w, h, ["%.3f" % t for t in t_card],
               ["%.3f" % t for t in t_cpu], W, H, t_big, t_tree, h, t_column,
               loop_est, w, h))
        out["raycast"] = {
            "triangles": n_tris, "card_s_%dx%d" % (w, h): t_card,
            "cpu_s_%dx%d" % (w, h): t_cpu, "card_s_%dx%d" % (W, H): t_big,
            "octtree_build_s": t_tree,
            "octtree_loop_s_%dx%d_estimated" % (w, h): loop_est}

        # the chain on the card
        pred = os.path.join(tmp, "pred")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cli.main([
            data, pred, "--scene_idx", "0", "--forward_pass_factory",
            "raynet", "--start_end", "0,2", "--depth_planes", str(D),
            "--grid_shape", ",".join(str(g) for g in GRID),
            "--maximum_number_of_marched_voxels", str(M),
            "--rays_batch", str(N_RAYS), "--device", str(dev),
        ])
        out["forward_s"] = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        check(launches == expect, "forward CLI launches %s (expect %s)"
              % (launches, expect))
        # the CPU chain reads the same predictions, and the GT depth maps
        # the CPU raycast above gave, from its own copy of the scene
        cpu_data = os.path.join(tmp, "cpu_data")
        shutil.copytree(data, cpu_data)
        os.makedirs(os.path.join(cpu_data, "scene_1", "gt"))
        for i in frames:
            np.save(os.path.join(cpu_data, "scene_1", "gt",
                                 "gt_depth_%d.npy" % (i,)), gt_cpu[i])
        chains = {}
        for label, device, root in (("card", str(dev), data),
                                    ("cpu", "cpu", cpu_data)):
            pcl = os.path.join(tmp, "pcl_" + label)
            t0 = time.perf_counter()
            convert_to_pointcloud.main([
                root, pred, pcl, "--scene_idx", "0", "--frame_idxs", "0:2",
                "--device", device])
            t_pcl = time.perf_counter() - t0
            met = os.path.join(tmp, "metrics_" + label)
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                compute_metrics.main([
                    root, pred, "ppmde", "accuracy", "completeness",
                    "--scene_idx", "0", "--frame_idxs", "0:2",
                    "--output_directory", met, "--device", device])
            t_met = time.perf_counter() - t0
            means = {}
            for line in printed.getvalue().splitlines():
                log("  %s: %s" % (label, line))
                if "mean=" in line:
                    means[line.split(":")[0]] = float(
                        line.split("mean=")[1].split()[0])
            plys = {}
            for path in (os.path.join(pcl, "pointcloud_s_0.ply"),
                         os.path.join(met, "predicted_pc_s_0.ply"),
                         os.path.join(met, "accuracy_colored_pc_s_0.ply"),
                         os.path.join(met, "completeness_colored_pc_s_0.ply")):
                pts = parse_stl_file_to_pointcloud(path)
                plys[os.path.basename(path)] = pts
                check(pts.ndim == 2 and pts.shape[1] == 3 and len(pts) > 0
                      and bool(np.isfinite(pts).all()),
                      "%s %s: %d finite points" % (label,
                                                   os.path.basename(path),
                                                   len(pts)))
            log("  %s: raynet_to_pcl_torch %.3f s, "
                "raynet_compute_metrics_torch %.3f s" % (label, t_pcl, t_met))
            chains[label] = {"means": means, "to_pcl_s": t_pcl,
                             "metrics_s": t_met, "plys": plys}
        card, cpu = chains["card"], chains["cpu"]
        check(sorted(card["means"]) == ["accuracy", "completeness", "ppmde"]
              and bool(np.isfinite(list(card["means"].values())).all()),
              "card metrics printed and finite: %s" % card["means"])
        for k, v in card["means"].items():
            ref = cpu["means"][k]
            # the printout has 6 decimals
            check(abs(v - ref) <= max(1e-4 * abs(ref), 1e-6),
                  "%s mean %.6f on the card, %.6f on the CPU (within 1e-4 "
                  "relative)" % (k, v, ref))
        for name, pts in card["plys"].items():
            other = cpu["plys"][name]
            check(pts.shape == other.shape and bool(np.allclose(
                pts, other, rtol=1e-5, atol=1e-6)),
                "%s: card points %s equal the CPU's %s within rtol 1e-5"
                % (name, pts.shape, other.shape))
        out["metrics"] = {d: c["means"] for d, c in chains.items()}
        out["seconds"] = {d: {"to_pcl": c["to_pcl_s"],
                              "metrics": c["metrics_s"]}
                          for d, c in chains.items()}

        # K3's rows mode through ops.backends on every ray of view 0
        im = small.get_image(0)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        bbox = f32(small.bbox.reshape(-1))
        rs, re = segments_in_bbox(
            torch.arange(h * w, dtype=torch.int32, device=dev),
            f32(im.camera.P_pinv), f32(im.camera.center[:3, 0]), bbox, h)
        starts, ends = rs.cpu().numpy(), re.cpu().numpy()
        for c in counters.values():
            c.launches = 0
        vox, cnt = backends.perform_ray_marching(
            RestrepoScene(scene_dir, device=dev), GRID, starts, ends, M)
        rows_launches = {k: c.launches for k, c in counters.items()}
        check(rows_launches == {k: int(k == "voxel_traversal_flat")
                                for k in counters},
              "ops.backends.perform_ray_marching launched K3's rows mode "
              "once: %s" % (rows_launches,))
        flat, pcnt = voxel_traversal_flat_reference(bbox, rs, re, GRID, M)
        pvox = unflatten_voxel_indices(flat, GRID).to(torch.int32)
        check(bool(np.array_equal(vox, pvox.cpu().numpy()))
              and bool(np.array_equal(cnt, pcnt.cpu().numpy())),
              "K3 rows through ops.backends: (%d, %d, 3) indices and counts "
              "equal the plain version's (mean count %.2f)"
              % (h * w, M, float(cnt.mean())))
        out["k3_rows_rays"] = h * w
    return out, rows_launches["voxel_traversal_flat"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout: hold P2 against its build of "
                         "P2, bit for bit")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.inference import (
        MultiViewCNNForwardPass,
        MultiViewCNNVoxelSpaceForwardPass,
        RayNetForwardPass,
    )
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
    from raynet_tpu_torch.ops import cuda_build
    from raynet_tpu_torch.ops.bp_sweep import bp_sweep, bp_sweep_reference
    from raynet_tpu_torch.ops.mrf import log_prior
    from raynet_tpu_torch.ops.planesweep import (
        plane_sweep_cells_reference,
        plane_sweep_scores,
        plane_sweep_scores_reference,
    )
    from raynet_tpu_torch.ops.ray_marching import (
        voxel_centers,
        voxel_traversal_flat,
        voxel_traversal_flat_reference,
    )
    from raynet_tpu_torch.ops.voxel_depth import (
        distance_to,
        plain_voxel_scores,
        voxel_argmax_depth,
        voxel_argmax_depth_reference,
    )
    from raynet_tpu_torch.scripts import forward_pass as cli
    from raynet_tpu_torch.tools import probe_dma_align as probes
    from raynet_tpu_torch.tools import time_kernels
    from raynet_tpu_torch.tools.time_kernels import (
        D,
        GAMMA,
        GRID,
        M,
        N_RAYS,
        kernel_rig,
    )
    from raynet_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    failures = []

    def check(ok, what):
        log("  %s: %s" % ("ok" if ok else "FAILED", what))
        if not ok:
            failures.append(what)

    # 1. environment
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    log("== 1. environment")
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    log(run([cuda_build.nvcc_path(), "--version"]).splitlines()[-1])
    log("card:", smi)

    # 2. build
    log("== 2. build")
    t0 = time.perf_counter()
    cuda_build.library()
    log("build_s %.3f (nvcc %s in this process, flags %s)" % (
        time.perf_counter() - t0,
        "ran" if cuda_build.build_seconds is not None else "reused",
        " ".join(cuda_build.NVCC_FLAGS),
    ))

    # the rig and one view set
    rig = kernel_rig(dev)
    scene, gp, model, features = rig.scene, rig.gp, rig.model, rig.features
    center, bbox, rs, re = rig.center, rig.bbox, rig.rs, rig.re
    H, W, ps_args = rig.H, rig.W, rig.ps_args

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # every kernel alone on the rig, timed and bounded by time_kernels; the
    # phases below check what each computes
    log("== kernel times: time_kernels.time_all, median of 7 one-launch "
        "CUDA-event runs (plain versions: of 3)")
    rows = time_kernels.time_all(rig, 1, 7, plain=True)
    for line in time_kernels.format_rows(rows):
        log("  " + line)
    times = {r["name"]: r for r in rows}

    def timing(name):
        # the kernel alone on the batch, and on one whole image
        image = times[name + " image"]
        out = {k: times[name][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        out.update(image_ms=image["ms"], image_bound_ms=image["bound_ms"],
                   image_rays=image["counts"]["rays"])
        return out

    # the whole of view 0, as the passes launch K1, K2 and K3's voxel-depth
    # mode on it; the plain versions take it in N_RAYS-ray spans
    rs_img, re_img = time_kernels.image_segments(rig)
    n_img = rs_img.shape[0]

    def spans(n):
        return [(lo, min(lo + N_RAYS, n)) for lo in range(0, n, N_RAYS)]

    # 3. K1
    log("== 3. K1 plane sweep vs plain, features %s %s: one %d-ray batch, "
        "then all %d rays of view 0 in one launch"
        % (tuple(features.shape), features.dtype, N_RAYS, n_img))

    def k1_check(label, rs_, re_):
        args = ps_args[:2] + (rs_, re_) + ps_args[4:]
        S_k, cells_k = plane_sweep_scores(*args, return_cells=True)
        mism, err, S_p = 0, 0.0, []
        for lo, hi in spans(rs_.shape[0]):
            part = args[:2] + (rs_[lo:hi], re_[lo:hi]) + args[4:]
            S_p.append(plane_sweep_scores_reference(*part))
            cells_p = plane_sweep_cells_reference(*part[1:])
            mism += int((cells_k[lo:hi] != cells_p).any(dim=-1).sum())
            # a NaN counts as an infinite error
            err = max(err, float((S_k[lo:hi] - S_p[-1]).abs().nan_to_num(
                nan=float("inf")).max()))
        torch.cuda.synchronize()
        check(mism == 0, "%s: feature-cell mismatches %d (expect 0)"
              % (label, mism))
        check(err <= 1e-5, "%s: max |score diff| %.3e <= 1e-5" % (label, err))
        return torch.cat(S_p), err

    S_p, k1_err = k1_check("batch", rs, re)
    S_img, k1_img_err = k1_check("image", rs_img, re_img)
    k1 = times["K1"]
    k1i = times["K1 image"]
    log("  K1 %.3f ms, plain %.3f ms; bound %.4f ms (%s: %d feature rows, "
        "%.1f MB); one whole image of %d rays %.3f ms, bound %.4f ms"
        % (k1["ms"], k1["plain_ms"], k1["bound_ms"], k1["bound_by"],
           k1["counts"]["feature_rows"], k1["nbytes"] / 1e6,
           k1i["counts"]["rays"], k1i["ms"], k1i["bound_ms"]))

    # 4. K2
    # Tolerances: counts exact. First iteration (mu is the constant
    # sigmoid(prior)): messages and the scattered grid allclose(rtol 1e-4,
    # atol 1e-5). Message mode on a seeded grid and messages that keep mu
    # moderate: >= 0.9999 of the messages and grid values within rtol 1e-4,
    # atol 1e-5 (the plain version's cumsums sum up to M=384 terms in
    # another order). On the grid a real first sweep leaves, mu sits at its
    # clip 1 - 1e-4 on occupied voxels and (total - cumsum) / (1 - mu)
    # turns the plain float32 version's rounding into errors up to ~1e-2;
    # the kernel carries those sums in double, so there both are held to a
    # float64 evaluation of the plain version instead: the kernel's max and
    # mean errors at most twice the plain float32 version's (+1e-5, +1e-6),
    # for the messages and the grid (checked on the moderate inputs too).
    # Depth: within 1e-3 relative on >= 0.999 of the rays, zero masks
    # identical. The batch takes all three kinds of input; the whole image
    # (one launch, as the raynet pass makes it) the real grids of its own
    # first and second sweeps, its first-mode grid held like the message
    # mode's (below).
    log("== 4. K2 BP sweep (in place) vs plain, M=%d, grid %s: one %d-ray "
        "batch, then all %d rays of view 0 in one launch"
        % (M, GRID, N_RAYS, n_img))
    prior = float(log_prior(GAMMA))
    G = int(np.prod(GRID))

    def plain_sweep(seg, msgs, grid_acc, grid_out, mode,
                    dtype=torch.float32):
        # the plain version over the rays in N_RAYS-ray spans, concatenated;
        # scores, messages and grid in ``dtype``
        if grid_acc is not None:
            grid_acc = grid_acc.to(dtype)
        parts = [bp_sweep_reference(
            seg[0][lo:hi], seg[1][lo:hi], seg[2][lo:hi].to(dtype),
            None if msgs is None else msgs[lo:hi].to(dtype), grid_acc,
            grid_out, center, bbox, GRID, M, prior, mode)
            for lo, hi in spans(seg[0].shape[0])]
        return tuple(None if parts[0][j] is None
                     else torch.cat([q[j] for q in parts]) for j in range(3))

    def sweep_both(label, seg, msgs, grid_acc, mode):
        # both scatter into a zero grid, as the raynet pass does per image;
        # the kernel updates a copy of the store in place (messages_in is
        # messages_out; in first mode the store starts at zero), the plain
        # version returns new messages
        n = seg[0].shape[0]
        gk = torch.zeros(G, device=dev)
        gpl = torch.zeros(G, device=dev)
        store = None
        if mode != "depth":
            store = (torch.zeros((n, M), device=dev) if msgs is None
                     else msgs.clone())
        k = bp_sweep(*seg, store if mode == "message" else msgs, grid_acc, gk,
                     center, bbox, GRID, M, prior, mode, messages_out=store)
        p_ = plain_sweep(seg, msgs, grid_acc, gpl, mode)
        torch.cuda.synchronize()
        check(bool(torch.equal(k[1], p_[1])),
              "%s %s: counts identical (mean count %.2f)"
              % (label, mode, float(p_[1].float().mean())))
        if store is not None:
            check(k[0] is store, "%s %s: messages written in place"
                  % (label, mode))
            tail = (torch.arange(M, device=dev)[None, :]
                    >= p_[1][:, None])
            check(not bool(torch.logical_and(store != 0, tail).any()),
                  "%s %s: every entry past a ray's count still zero"
                  % (label, mode))
        return k, gk, p_, gpl

    # NaN: the plain version (as the JAX package) maps a zero-length
    # segment that marches two or more cells to NaN scores (t = 0/0), so
    # a whole image has NaN messages and grid cells. The kernel must have
    # them in the same places; errors are taken over the other entries.
    def strict(label, a, b):
        nan = torch.isnan(b)
        err = float((a - b).abs().masked_fill(nan, 0).max())
        check(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5, equal_nan=True)),
              "%s allclose(rtol 1e-4, atol 1e-5, NaN in the same %d "
              "places), max err %.3e" % (label, int(nan.sum()), err))
        return err

    def mostly_close(label, a, b):
        close = float(torch.isclose(a, b, rtol=1e-4, atol=1e-5,
                                    equal_nan=True).float().mean())
        check(close >= 0.9999, "%s: %.7f within rtol 1e-4, atol 1e-5"
              % (label, close))

    def as_accurate(label, kern, plain, exact):
        # max and mean errors over row spans (an image's messages are
        # 0.7 G entries), where the float64 evaluation is not NaN; there
        # both float32 versions must be NaN too
        ek_max = ek_sum = ep_max = ep_sum = 0.0
        n_nan, same_nan = 0, True
        for lo, hi in spans(kern.shape[0]):
            e = exact[lo:hi]
            nan = torch.isnan(e)
            k, p = kern[lo:hi].double(), plain[lo:hi].double()
            same_nan &= bool(torch.equal(torch.isnan(k), nan)
                             and torch.equal(torch.isnan(p), nan))
            n_nan += int(nan.sum())
            ek = (k - e).abs().masked_fill(nan, 0)
            ep = (p - e).abs().masked_fill(nan, 0)
            ek_max, ep_max = max(ek_max, float(ek.max())), max(
                ep_max, float(ep.max()))
            ek_sum += float(ek.sum())
            ep_sum += float(ep.sum())
        n = kern.numel() - n_nan
        ek_mean, ep_mean = ek_sum / n, ep_sum / n
        ok = (same_nan and ek_max <= 2 * ep_max + 1e-5
              and ek_mean <= 2 * ep_mean + 1e-6)
        check(ok, "%s vs float64: kernel max %.3e mean %.3e, plain max %.3e "
              "mean %.3e; NaN in the same %d places: %s"
              % (label, ek_max, ek_mean, ep_max, ep_mean, n_nan, same_nan))

    def k2_checks(label, seg, moderate):
        """K2 in its three modes on segments and scores ``seg``: the first
        sweep, then message mode (if ``moderate``) on a seeded grid and
        messages that keep mu moderate and on the real grid of the first
        sweep, then depth on the second sweep's output (and on the moderate
        inputs). Returns the per-mode errors and the first sweep's
        counts."""
        out = {}
        (mk, counts, _), gk, (m1, _, _), g1 = sweep_both(label, seg, None,
                                                         None, "first")
        ray = seg[1] - seg[0]
        log("  %s: %d rays march two or more cells on a zero-length segment"
            % (label, int(((ray * ray).sum(1) == 0).logical_and(counts > 1)
                          .sum())))
        del ray
        err = strict("%s first: messages" % label, mk, m1)
        if label == "image":
            # the image's 58.6 M float32 messages add into 1 M cells in
            # another order than the plain version's spans do, and a cell's
            # sum can cancel below its terms' rounding: its grid is held to
            # the float64 evaluation, as the message mode's grids are
            g64 = torch.zeros(G, dtype=torch.float64, device=dev)
            plain_sweep(seg, None, None, g64, "first", torch.float64)
            mostly_close("%s first: grid" % label, gk, g1)
            as_accurate("%s first: grid" % label, gk, g1, g64)
            err = max(err, float((gk - g1).abs().masked_fill(
                torch.isnan(g1), 0).max()))
            del g64
        else:
            err = max(err, strict("%s first: grid" % label, gk, g1))
        out["first"] = {"max_abs_err": err}
        g1 = g1 + prior  # the next iteration's grid
        del mk
        inputs = [("real grid", (m1, g1))]
        if moderate:
            # zero past each ray's count, as in the pass's store
            rng = np.random.RandomState(1)
            g_mod = f32(prior + 2.0 + rng.randn(G))
            visited = torch.arange(M, device=dev)[None, :] < counts[:, None]
            m_mod = torch.where(visited, f32(0.5 * rng.randn(*visited.shape)),
                                0.0)
            inputs.insert(0, ("moderate mu", (m_mod, g_mod)))
            del visited
        errs = {}
        for what, (mi, gi) in inputs:
            (mk, _, _), gk, (mp, _, _), gpl = sweep_both(label, seg, mi, gi,
                                                         "message")
            g64 = torch.zeros(G, dtype=torch.float64, device=dev)
            m64, _, _ = plain_sweep(seg, mi, gi, g64, "message",
                                    torch.float64)
            name = "%s message (%s)" % (label, what)
            if what == "moderate mu":
                mostly_close(name + ": messages", mk, mp)
                mostly_close(name + ": grid", gk, gpl)
            errs[what] = float((mk - mp).abs().masked_fill(
                torch.isnan(mp), 0).max())
            as_accurate(name + ": messages", mk, mp, m64)
            as_accurate(name + ": grid", gk, gpl, g64)
            if what == "real grid":
                m2, g2 = mp, gpl + prior
            del mk, mp, m64
        del m1
        out["message"] = {"max_abs_err": errs.get("moderate mu"),
                          "real_grid_max_abs_err": errs["real grid"]}
        inputs = [("real grid", (m2, g2))] + inputs[:-1]
        agree = {}
        for what, (mi, gi) in inputs:
            (_, _, dk), _, (_, _, dp), _ = sweep_both(label, seg, mi, gi,
                                                      "depth")
            a, b = dk.cpu().numpy(), dp.cpu().numpy()
            agree[what] = rel_agreement(a, b, 1e-3)
            check(agree[what] >= 0.999 and np.array_equal(a > 0, b > 0),
                  "%s depth (%s): %.6f of rays within 1e-3 relative, zero "
                  "masks identical" % (label, what, agree[what]))
        out["depth"] = {"agreement": agree,
                        "max_abs_err": float(np.abs(a - b).max())}
        return out, counts

    k2, k2_counts = k2_checks("batch", (rs, re, S_p.contiguous()), True)
    k2_image, _ = k2_checks("image", (rs_img, re_img, S_img.contiguous()),
                            False)
    for mode in k2:
        k2[mode].update(timing("K2 " + mode))
        k2[mode]["image"] = k2_image[mode]

    # 5. K3
    log("== 5. K3 voxel traversal vs plain, M=%d, grid %s: rows mode on the "
        "batch; voxel-depth mode on the batch, then all %d rays of view 0 in "
        "one launch" % (M, GRID, n_img))
    idx_k, cnt_k = voxel_traversal_flat(bbox, rs, re, GRID, M)
    idx_p, cnt_p = voxel_traversal_flat_reference(bbox, rs, re, GRID, M)
    torch.cuda.synchronize()
    k3_mism = int((idx_k != idx_p).sum())
    k3_err = float((idx_k - idx_p).abs().max())
    check(k3_mism == 0 and torch.equal(idx_k, idx_p),
          "K3 indices identical to the plain version's (%d differ)" % k3_mism)
    check(bool(torch.equal(cnt_k, cnt_p)),
          "K3 counts identical (mean %.2f, max %d)"
          % (float(cnt_p.float().mean()), int(cnt_p.max())))
    check(bool(torch.equal(cnt_k, k2_counts)),
          "K3 counts equal K2's first-mode counts")
    del idx_k, idx_p
    # the bounds rest on this batch's march: visited and distinct cells
    k3, k3i = times["K3"], times["K3 image"]
    log("  K3 %.3f ms, plain %.3f ms; bound %.4f ms (%s); %d visits, %d "
        "distinct cells; one whole image %.3f ms, bound %.4f ms"
        % (k3["ms"], k3["plain_ms"], k3["bound_ms"], k3["bound_by"],
           k3["counts"]["visits"], k3["counts"]["cells"], k3i["ms"],
           k3i["bound_ms"]))

    def plain_voxels(rs_, re_, S_):
        # the plain version's visited voxels: their mapped scores, their
        # distances from the camera, and which entries are visited
        _, vox, cnt, S_vox = plain_voxel_scores(bbox, rs_, re_, S_, GRID, M)
        dists = distance_to(voxel_centers(vox, bbox, GRID).reshape(-1, 3),
                            center).reshape(vox.shape[:2])
        visited = torch.arange(M, device=dev)[None, :] < cnt[:, None]
        return S_vox, dists, visited

    # Tolerances: counts and zero masks exact; >= 0.999 of the depths
    # within 1e-3 relative; every other ray at a visited voxel whose plain
    # mapped score is within rtol 1e-5 of the ray's plain maximum (the
    # plain version's argmax of s / T can merge two scores an ulp apart,
    # the kernel compares s) and at that voxel's plain distance (rtol
    # 1e-6); zero-length segments that visit voxels (their scores are 0/0)
    # at their first voxel, as the plain version's argmax of an all-NaN
    # row takes it.
    def k3_depth_check(label, rs_, re_, S_):
        n = rs_.shape[0]
        dk, ck = voxel_argmax_depth(bbox, rs_, re_, S_, center, GRID, M)
        parts = [voxel_argmax_depth_reference(
            bbox, rs_[lo:hi], re_[lo:hi], S_[lo:hi], center, GRID, M)
            for lo, hi in spans(n)]
        dp = torch.cat([q[0] for q in parts])
        cp = torch.cat([q[1] for q in parts])
        torch.cuda.synchronize()
        check(bool(torch.equal(ck, cp)), "%s: K3 depth counts identical "
              "(mean %.2f)" % (label, float(cp.float().mean())))
        check(bool(torch.equal(dk > 0, dp > 0)),
              "%s: K3 depth zero masks identical" % label)
        close = (dk - dp).abs() <= 1e-3 * dp.abs()
        agree = float(close.float().mean())
        check(agree >= 0.999, "%s: K3 depth %.7f of %d rays within 1e-3 "
              "relative" % (label, agree, n))
        off = torch.nonzero(~close).flatten()
        S_vox, dists, visited = plain_voxels(rs_[off], re_[off], S_[off])
        best = S_vox.max(dim=1, keepdim=True).values
        tied = visited & (S_vox >= best - 1e-5 * best.abs())
        hit = (dists - dk[off, None]).abs() <= 1e-6 * dists
        n_tied = int((tied & hit).any(dim=1).sum())
        check(n_tied == off.numel(), "%s: the %d rays that disagree each at "
              "a voxel tied with the plain maximum (%d are)"
              % (label, off.numel(), n_tied))
        ray = re_ - rs_
        zero = ((ray * ray).sum(1) == 0) & (cp > 0)
        z = torch.nonzero(zero).flatten()
        _, dz, _ = plain_voxels(rs_[z], re_[z], S_[z])
        n_nan = int((zero & (cp > 1)).sum())
        check(bool(torch.allclose(dk[z], dz[:, 0], rtol=1e-6, atol=0)),
              "%s: %d zero-length rays that visit voxels (%d of them two or "
              "more: NaN scores) at their first voxel"
              % (label, z.numel(), n_nan))
        return {"agreement": agree, "disagreeing_rays": off.numel(),
                "nan_rays": n_nan,
                "max_abs_err": float((dk - dp).abs().max()),
                "max_abs_err_agreeing": float(
                    (dk - dp).abs().masked_fill(~close, 0).max())}

    k3_depth = k3_depth_check("batch", rs, re, S_p.contiguous())
    k3_depth["image"] = k3_depth_check("image", rs_img, re_img,
                                       S_img.contiguous())
    del S_img, rs_img, re_img
    k3_depth.update(timing("K3 depth"))
    k3d = times["K3 depth"]
    log("  K3 depth %.3f ms, plain %.3f ms; bound %.4f ms (%s); one whole "
        "image %.3f ms, bound %.4f ms"
        % (k3d["ms"], k3d["plain_ms"], k3d["bound_ms"], k3d["bound_by"],
           k3_depth["image_ms"], k3_depth["image_bound_ms"]))
    for mode in k2:
        r, ri = times["K2 " + mode], times["K2 %s image" % mode]
        log("  K2 %s: %.3f ms, plain %.3f ms; bound %.4f ms (%.1f MB); one "
            "whole image %.3f ms, bound %.4f ms (%.1f MB)"
            % (mode, r["ms"], r["plain_ms"], r["bound_ms"], r["nbytes"] / 1e6,
               ri["ms"], ri["bound_ms"], ri["nbytes"] / 1e6))
    del S_p, features

    # 6. the three passes end to end
    counters = {"plane_sweep_scores": plane_sweep_scores,
                "voxel_traversal_flat": voxel_traversal_flat,
                "voxel_argmax_depth": voxel_argmax_depth,
                "bp_sweep": bp_sweep}
    # the launches each pass makes on the 2 reference views: one per image
    # and kernel, K2 once per image and sweep; no other kernel
    passes = (
        ("raynet", RayNetForwardPass,
         {"plane_sweep_scores": 2,
          "bp_sweep": 2 * (RayNetForwardPass.bp_iterations + 1)}),
        ("multi_view_cnn", MultiViewCNNForwardPass, {"plane_sweep_scores": 2}),
        ("multi_view_cnn_voxel_space", MultiViewCNNVoxelSpaceForwardPass,
         {"plane_sweep_scores": 2, "voxel_argmax_depth": 2}),
    )
    small = RingScene(6, 300, 400, 2750.0 / 4, angle_origin=1, seed=0)
    total_launches = dict.fromkeys(counters, 0)
    results = {}
    n_rays = 2 * H * W
    for name, cls, used in passes:
        expect = {k: used.get(k, 0) for k in counters}
        log("== 6. %s forward pass, %dx%d, 2 reference views of 6 images"
            % (name, W, H))
        # one untimed pass on an instance of its own first, so that the
        # timed pass finds the caching allocator warm, whatever the checks
        # before it left cached; the timed instance computes its features
        # anew
        list(cls(model, gp, None, scene.image_shape, N_RAYS,
                 device=dev).forward_pass(scene, (0, 2, 1)))
        fp = cls(model, gp, None, scene.image_shape, N_RAYS, device=dev)
        torch.cuda.synchronize()
        # the card's SM clock, temperature and power draw as the pass starts
        card = run(["nvidia-smi",
                    "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                    "--format=csv,noheader"])
        log("  card before the pass (SM clock, temperature, power): " + card)
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        maps = list(fp.forward_pass(scene, (0, 2, 1)))
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        for k, v in launches.items():
            total_launches[k] += v
        log("  wall %.3f s, %.0f rays/s (%d rays)" % (wall, n_rays / wall,
                                                       n_rays))
        phases = {k: v["total_s"] for k, v in fp.timer.summary().items()}
        for k, v in fp.timer.summary().items():
            log("  phase %-28s %.3f s (%d)" % (k, v["total_s"], v["count"]))
        log("  launches", launches, "peak device memory %.2f GB" % peak_gb)
        check(launches == expect, "%s: launches %s" % (name, expect))
        allmaps = np.stack(maps)
        nz = allmaps[allmaps > 0]
        check(allmaps.shape == (2, H, W), "depth maps %s" % (allmaps.shape,))
        check(bool(np.isfinite(allmaps).all()), "all depths finite")
        share = nz.size / allmaps.size
        # the +-3 bbox covers roughly half the width and 70% of the height
        # of each view, so about a third of the rays reach the grid
        check(share > 0.1, "nonzero share %.4f" % share)
        if nz.size:
            log("  depth range [%.3f, %.3f]" % (nz.min(), nz.max()))
            check(nz.min() >= 10.0 and nz.max() <= 30.0,
                  "depths inside the ring's camera-to-bbox range [10, 30]")
        if name == "raynet":
            raynet_maps = allmaps  # phase 10 holds the host store to them
        del fp, maps, allmaps

        fp_k = cls(model, gp, None, small.image_shape, N_RAYS, device=dev)
        t0 = time.perf_counter()
        maps_k = np.stack(list(fp_k.forward_pass(small, (0, 2, 1))))
        t_k = time.perf_counter() - t0
        # the same CNN (on the card) feeds the CPU pass: only the kernels
        # differ
        fp_p = cls(model, gp, None, small.image_shape, N_RAYS, device="cpu")
        t0 = time.perf_counter()
        maps_p = np.stack(list(fp_p.forward_pass(small, (0, 2, 1))))
        t_p = time.perf_counter() - t0
        agree = rel_agreement(maps_k, maps_p, 1e-3)
        same_mask = bool(((maps_k > 0) == (maps_p > 0)).all())
        log("  400x300: kernels on the card %.3f s, plain on the CPU %.3f s"
            % (t_k, t_p))
        check(agree >= 0.999,
              "400x300 depth agreement %.6f within 1e-3 relative" % agree)
        check(same_mask, "400x300 zero/nonzero masks identical")
        results[name] = {"wall_s": wall, "rays_per_s": n_rays / wall,
                         "peak_device_gb": peak_gb, "phases_s": phases,
                         "launches": launches, "agreement_400x300": agree,
                         "card_before": card}
        if name == "multi_view_cnn_voxel_space":
            voxel_small = maps_k
        del fp_k, fp_p, maps_k, maps_p

    # 7. the CLI on a scene on disk
    log("== 7. CLI, multi_view_cnn_voxel_space on the 400x300 rig on disk")
    with tempfile.TemporaryDirectory() as tmp:
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        out = os.path.join(tmp, "out")
        for c in counters.values():
            c.launches = 0
        cli.main([
            data, out, "--scene_idx", "0",
            "--forward_pass_factory", "multi_view_cnn_voxel_space",
            "--start_end", "0,2", "--depth_planes", str(D),
            "--grid_shape", ",".join(str(g) for g in GRID),
            "--maximum_number_of_marched_voxels", str(M),
            "--rays_batch", str(N_RAYS), "--device", "cuda",
        ])
        cli_launches = {k: c.launches for k, c in counters.items()}
        cli_maps = np.stack([np.load(os.path.join(out, "depth_%03d.npy" % i))
                             for i in range(2)])
    # the CLI draws the same seed-0 weights, without the bf16 cast
    fp = MultiViewCNNVoxelSpaceForwardPass(
        FeatureExtractor("simple_cnn", seed=0, device=dev), gp, None,
        small.image_shape, N_RAYS, device=dev)
    ref_maps = np.stack(list(fp.forward_pass(small, (0, 2, 1))))
    cli_agree = rel_agreement(cli_maps, ref_maps, 1e-3)
    log("  launches", cli_launches, "identical to the pass: %s"
        % bool(np.array_equal(cli_maps, ref_maps)))
    cli_expect = {k: passes[2][2].get(k, 0) for k in counters}
    check(cli_launches == cli_expect,
          "CLI launched K1 and K3's voxel-depth mode once per image: %s"
          % (cli_expect,))
    check(cli_maps.shape == voxel_small.shape
          and bool(np.array_equal(cli_maps > 0, ref_maps > 0))
          and cli_agree >= 0.999,
          "CLI depth maps %s agree with the pass on the same rig: %.6f"
          % (cli_maps.shape, cli_agree))
    del fp

    # 8. the probes: their entry point, then each kernel against its plain
    # version on the card
    log("== 8. probes: P1 TMA box copy, P2 f32 product on the tensor cores")
    probe_counters = {"tma_box_rows": probes.tma_box_rows,
                      "tensor_core_dot": probes.tensor_core_dot}
    for c in probe_counters.values():
        c.launches = 0
    probe_rc = probes.main([])
    probe_launches = {k: c.launches for k, c in probe_counters.items()}
    check(probe_rc == 0 and all(probe_launches.values()),
          "probe_dma_align.main exit %d, launches %s"
          % (probe_rc, probe_launches))
    src = probes.box_source(dev)
    p1_err = 0.0
    for case in probes.CASES:
        offs = probes.case_offsets(*case)
        got = probes.tma_box_rows(src, *offs)
        ref = probes.tma_box_rows_reference(src, *offs)
        torch.cuda.synchronize()
        p1_err = max(p1_err, float((got - ref).abs().max()))
        check(bool(torch.equal(got, ref)),
              "P1 %s (y0, xg0, sub0) = %s torch.equal to plain" % (case[0], offs))
    # the last case, D2, is the one timed
    check(bool(torch.equal(time_kernels.box_rows_library(src, *offs), ref)),
          "P1's library call computes the same rows")
    p1 = times["P1"]
    log("  P1 %.4f ms, plain %.4f ms, library %.4f ms; bound %.7f ms (%s)"
        % (p1["ms"], p1["plain_ms"], p1["library_ms"], p1["bound_ms"],
           p1["bound_by"]))

    # P2: first the diagonals, which name the rounding each mode applies;
    # then non-symmetric random inputs (a transposed fragment shows), held
    # loosely to the float64 product (TF32 operands are off by < 2**-10
    # relative each, so each product by < 2**-9) and tightly to the plain
    # version of the named rounding: rounded operands have 11 significant
    # bits, their products are exact in f32, and only the f32 sums over
    # K = 128 round, by far less than 2**-16 * (|x| @ |e|)
    p2 = {}
    raw_roundings = {}
    eye = torch.eye(probes.N_DOT, device=dev)
    for label, step in probes.DIAGONALS.items():
        vals = f32(1.0 + np.arange(probes.N_DOT) * step)
        diag = torch.diagonal(probes.tensor_core_dot(torch.diag(vals), eye,
                                                     "rna"))
        emulated = probes.round_operand(vals, "tf32_rna")
        check(bool(torch.equal(diag, emulated)),
              "P2 rna diag(%s) equals the tf32-RNA emulation bit for bit"
              % label)
        raw = probes.dot_roundings(torch.diagonal(
            probes.tensor_core_dot(torch.diag(vals), eye, "raw")), vals)
        p2["raw " + label] = probes.dot_verdict(raw)
        check(bool(raw), "P2 raw, diag(%s): %s" % (label, p2["raw " + label]))
        raw_roundings[label] = raw
    # diag(1 + k 2^-13) tells the roundings apart
    held = {"raw": (raw_roundings["1 + k 2^-13"] or ["none"])[0],
            "rna": "tf32_rna"}
    rng = np.random.RandomState(2)
    x, e = (f32(rng.randn(probes.N_DOT, probes.N_DOT)) for _ in range(2))
    exact = x.double() @ e.double()
    scale = x.double().abs() @ e.double().abs()
    for mode in probes.MODES:
        got = probes.tensor_core_dot(x, e, mode)
        torch.cuda.synchronize()
        err = (got.double() - exact).abs()
        errs = {r: float((got - probes.tensor_core_dot_reference(x, e, r))
                         .abs().max())
                for r in ("none", *probes.ROUNDINGS)}
        tight = (got.double() - probes.tensor_core_dot_reference(
            x, e, held[mode]).double()).abs()
        check(bool((err <= 2.0 ** -9 * scale).all()),
              "P2 %s within 2**-9 * (|x| @ |e|) of the float64 product "
              "(max err %.3e, max err / tol %.3f); max err against each "
              "operand rounding %s" % (mode, float(err.max()),
                                       float((err / scale).max() * 2 ** 9),
                                       errs))
        check(bool((tight <= 2.0 ** -16 * scale).all()),
              "P2 %s within 2**-16 * (|x| @ |e|) of the plain %s version "
              "(max err %.3e, max err / tol %.3f)"
              % (mode, held[mode], float(tight.max()),
                 float((tight / scale).max() * 2 ** 16)))
        p2[mode] = {"held_to": held[mode],
                    "max_abs_err_held": float(tight.max()),
                    "max_abs_err_f64": float(err.max()),
                    "max_abs_err_by_rounding": errs}
    p2_t = times["P2"]
    log("  P2 (rna) %.4f ms, plain %.4f ms, library (TF32 matmul) %.4f ms; "
        "bound %.7f ms (%s)" % (p2_t["ms"], p2_t["plain_ms"],
                                p2_t["library_ms"], p2_t["bound_ms"],
                                p2_t["bound_by"]))
    # each probe's time, split: host microseconds and device milliseconds
    # a call, the kernel's and its library call's
    for name in ("P1", "P2", "P2 1024"):
        log("  %s split: %s; event window %.4f ms (library %.4f), bound "
            "%.7f ms" % (name, time_kernels.format_rows([times[name]])[-1]
                         .strip(), times[name]["ms"],
                         times[name]["library_ms"], times[name]["bound_ms"]))
    if args.parent:
        csrc = os.path.join(args.parent, "raynet_tpu_torch", "csrc")
        p2["parent_equal"] = probes.dot_equal_to_build(csrc, dev)
        for label, same in p2["parent_equal"].items():
            check(same, "P2 %s torch.equal to the build from %s"
                  % (label, csrc))

    # 9. one raynet pass under the profiler
    log("== 9. trace of one raynet pass, %dx%d" % (W, H))
    fp = RayNetForwardPass(model, gp, None, scene.image_shape, N_RAYS,
                           device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            with torch.profiler.record_function("raynet pass"):
                maps = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
        traced_wall = time.perf_counter() - t0
        trace_path = os.path.join(tmp, profiling.TRACE_NAME)
        trace_mb = os.path.getsize(trace_path) / 1e6
        events = profiling.read_trace(trace_path)
    intervals = profiling.device_intervals(events)
    check(len(intervals) > 0, "the trace holds %d device operations (%.1f MB)"
          % (len(intervals), trace_mb))
    window = profiling.annotation_window(events, "raynet pass")
    busy = profiling.device_busy_share([iv[1:] for iv in intervals], window)
    by_name = {}
    for name, t_start, t_end in intervals:
        by_name[name] = by_name.get(name, 0.0) + (t_end - t_start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log("  pass window %.3f s (wall with the profiler %.3f s): device busy "
        "%.4f, idle %.4f" % ((window[1] - window[0]) / 1e6, traced_wall,
                             busy, 1 - busy))
    for name, us in top:
        log("  %10.3f ms  %s" % (us / 1e3, name[:100]))
    check(maps.shape == (2, H, W) and bool(np.isfinite(maps).all()),
          "traced pass: depth maps %s, finite" % (maps.shape,))
    traced = {"window_s": (window[1] - window[0]) / 1e6, "busy_share": busy,
              "idle_share": 1 - busy, "device_ops": len(intervals),
              "top5_ms": {name: us / 1e3 for name, us in top}}
    del fp, maps, events

    # 10. raynet with the messages in the host store
    host_store = phase_host_store(
        check, dev, model, gp, scene, raynet_maps, counters,
        {k: passes[0][2].get(k, 0) for k in counters})
    del raynet_maps

    # 11. the evaluation CLIs on the card, and K3's rows mode through
    # ops.backends
    evaluation, rows_launches = phase_evaluation(
        check, dev, small, scene, counters,
        {k: passes[0][2].get(k, 0) for k in counters})

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "raynet_tpu"))
    check(not imported, "no JAX or raynet_tpu module imported %s" % imported)
    if failures:
        print("chip_smoke: %d check(s) failed: %s" % (len(failures), failures),
              file=sys.stderr)
        return 1

    def kernel(name, source, replaces, launches, err, row, image=None,
               **extra):
        out = {"name": name, "route": "cuda",
               "source": "raynet_tpu_torch/csrc/" + source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": row["ms"],
               "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if image is not None:  # one launch over a whole image
            out.update(image_ms=image["ms"], image_bound_ms=image["bound_ms"],
                       image_rays=image["counts"]["rays"])
        out.update(extra)
        return out

    def split(row):
        return {k: row[k] for k in time_kernels.SPLIT_KEYS}

    kernels = [
        kernel("plane_sweep_scores", "planesweep.cu",
               "raynet_tpu/ops/pallas/planesweep.py:84",
               total_launches["plane_sweep_scores"], max(k1_err, k1_img_err),
               times["K1"], times["K1 image"]),
        # first iteration (batch and image) and moderate-mu message mode;
        # per mode above
        kernel("bp_sweep", "bp_sweep.cu",
               "raynet_tpu/ops/pallas/bp_beam.py:1062",
               total_launches["bp_sweep"],
               max(k2["first"]["max_abs_err"],
                   k2["first"]["image"]["max_abs_err"],
                   k2["message"]["max_abs_err"]),
               times["K2 message"], times["K2 message image"]),
        # K3 in its two modes: the rows mode is launched by ops.backends
        # (phase 11), the voxel-depth mode by the voxel-space pass
        kernel("voxel_traversal_flat", "traversal.cu",
               "raynet_tpu/ops/pallas/traversal.py:28",
               rows_launches, k3_err, times["K3"],
               times["K3 image"], mode="rows"),
        kernel("voxel_argmax_depth", "traversal.cu",
               "raynet_tpu/ops/pallas/traversal.py:28",
               total_launches["voxel_argmax_depth"],
               max(k3_depth["max_abs_err"],
                   k3_depth["image"]["max_abs_err"]),
               times["K3 depth"], times["K3 depth image"],
               mode="voxel depth"),
        kernel("tma_box_rows", "probe_tma_box.cu",
               "tools/probe_dma_align.py:33",
               probe_launches["tma_box_rows"], p1_err, times["P1"],
               **split(times["P1"])),
        # the timed mode, rna, against its plain version
        kernel("tensor_core_dot", "probe_tf32_dot.cu",
               "tools/probe_dma_align.py:104",
               probe_launches["tensor_core_dot"],
               p2["rna"]["max_abs_err_held"], times["P2"],
               **split(times["P2"]),
               n1024={k: times["P2 1024"][k] for k in (
                   "ms", "bound_ms", "bound_by", "library_ms",
                   *time_kernels.SPLIT_KEYS)}),
    ]
    # strict JSON: a NaN here raises
    print(json.dumps({"bp_sweep_modes": k2, "voxel_depth": k3_depth,
                      "passes": results,
                      "probes": p2, "trace": traced,
                      "host_store": host_store, "evaluation": evaluation},
                     allow_nan=False))
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

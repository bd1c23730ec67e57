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
   ray's count still zero; then each launch again with the ray sums, as
   the raynet pass makes it (written by the first sweep, read by the
   message and depth sweeps), against the launch that counts: counts,
   messages and depths bit for bit, the grid within the atomics' order,
   and the stored totals against the plain float64 sums;
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
   kernel, K2 once per image and sweep: raynet K1 2 and K2 8, 6 of them
   reading the ray sums its first sweep of the image stored;
   multi_view_cnn K1 2; multi_view_cnn_voxel_space K1 2 and K3's
   voxel-depth mode 2; no other kernel), wall time, rays/s, phases, peak
   memory, the card's SM clock, temperature and power draw as it starts,
   and the depth maps' sanity (the timed pass follows one untimed pass of
   its own, so it finds the caching allocator warm); five more walls, each
   pass on an instance of its own, for the spread on this host; then the
   same pass
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
   every ray of view 0, equal to its plain version;
12. the ``hartmann_fp`` pass (``get_forward_pass_factory("hartmann_fp")``)
   with a ``HartmannModel`` at its published widths (32x32x3 patches,
   32 / 64 / 2048 / 2048 / 2, seeded weights) on the rig of phase 7 cut to
   200x150 (focal scaled), one reference view, 4 neighbours, D = 32
   (960,000 quintuples; at 400x300 the phase took 85 s): wall
   time, quintuples/s, phases, peak memory, the share of the float32 peak
   its net reaches (phase "Patch net", the patch gather apart), the card's
   clock, temperature and power as it starts, no port kernel launched;
   the scores of 1,024 rays of view 0 on the card against the CPU's (same
   weights, max abs diff <= 2e-5), their argmax planes (>= 0.999 agree,
   or the card's plane ties the CPU's maximum within rtol 1e-5); then ``raynet_forward_torch
   --forward_pass_factory hartmann_fp --cnn_factory hartmann_cnn`` on the
   rig on disk, its map within 1e-3 relative of the same pass's on >= 0.999
   of the pixels;
13. ``raynet_pretrain_torch`` (``scripts.pretrain_network.main``) on the
   card in the ``default`` (simple_cnn, 10 view pairs of 11x11x3 patches,
   D = 32, batch 32) and ``hartmann`` (32x32x3 quintuples, batch 32, SGD
   with momentum 0.9) modes, 2 epochs x 5 steps, on the 400x300 rig with
   phase 11's cube mesh as ground truth: steps/s, every loss finite, a run
   resumed from epoch 1's checkpoint repeating the second epoch's losses,
   the weight file of epoch 2 holding the trained CNN and mapped by
   ``raynet_forward_torch --weight_file``; each epoch's seconds split into
   waiting for samples and the steps themselves; then one training step of
   each mode from the same state and batch on the card and on the CPU: loss
   within rtol 1e-4, BatchNorm statistics within 1e-4 relative, and the
   gradient's relative L2 distance to the CPU's within ``STEP_GRAD_BAR``,
   which the same step with TF32 on must exceed;
14. ``raynet_train_torch`` (``scripts.train_raynet.main``) on the card at
   the JAX CLI's widths (simple_cnn, D = 32, 4 neighbours, 11x11x3
   patches, grid 256x256x128, M = 650, 1,000 rays a batch, 3 BP
   iterations, a trainable gamma from 0.05, EMD, Adam at 1e-3) on the rig
   of phase 13, ``--window 2``, 3 iterations: every loss finite, gamma
   inside its clip and moved, K3's rows mode launched exactly once per
   batch (3 training batches and the validation batch) and no other
   kernel, each iteration's seconds split into drawing samples, finishing
   them (the K3 launch) and the step, peak device memory, the weight file
   read back by ``raynet_forward_torch --weight_file``, ``--resume`` from
   iteration 2's checkpoint continuing at 2 with appended logs; then on a
   fixed 1,000-ray batch its traversal equal to the plain version's and
   the card's step alone (ms, rays/s), and one step on 64 of its rays on
   the card and on the CPU: loss within rtol 1e-4, the updated gamma within
   1e-5 relative, the gradient's relative L2 distance within
   ``E2E_GRAD_BAR``, which the same step with TF32 on must exceed;
15. (a) a Keras checkpoint on the card: an in-memory Keras tree of a
   seeded simple_cnn in the published checkpoints' layout (the CNN as a
   sub-model of the siamese net), and a Theano-ordered variant, mapped by
   ``models.keras_import`` into a FeatureExtractor on the card, its
   state_dict ``torch.equal`` to the CPU's mapping; the raynet pass on the
   rig of phase 7 with those weights and again after a ``save_weights`` ->
   ``load_weights`` msgpack round trip: launches exactly K1 2 and K2 8
   each, the depth maps agreeing on >= 0.999 of the pixels within 1e-3
   relative; where h5py is importable, ``raynet_forward_torch --weight_file
   x.hdf5`` on that rig written to disk, held to the in-memory route the
   same way (else one line says the .hdf5 read was not run);
   (b) the training-quality bench (``tools.bench_training_quality``) at
   bench.py's sizes on the card: bench.py's four metrics with the seconds
   of each run, beside the JAX package's TPU v5e figures (comparison
   only), every metric finite, ``pretrain_val_acc`` above chance (1/8),
   gamma moved by more than 1e-4, K3's rows mode launched once per
   end-to-end batch and no kernel in pretraining, and the end-to-end step
   lowering the loss on one fixed 8-ray batch (bench.py's own ratio
   compares fresh batches and is printed);
16. the multi-GPU path (``raynet_tpu_torch.parallel.sharding``): (a) the
   raynet pass of phase 6 with each image's rays split over 2 ranks, two
   spawned processes over gloo on the one card (NCCL will not put two
   ranks on one GPU): each rank's launches exactly K1 2 and K2 8, 6 of
   them reading the ray sums its first sweep of the image stored, 6 grid
   all-reduces (2 images x 3 sweeps), its wall, phases and seconds in
   collectives, every rank's maps equal and against phase 6's on >= 0.999
   of the pixels within 1e-3 relative with identical masks; (b) the same
   sharded code at world size 1 over NCCL in this process, the same
   checks, its wall beside phase 6's; (c) one end-to-end step on phase
   14's fixed 1,000-ray batch split over 2 gloo ranks against the card's
   step in one process: loss and gamma within rtol 1e-5 (the bars of
   ``tests/test_sharding.py:252-278``), BatchNorm statistics within rtol
   1e-5 / atol 1e-7, the ranks' parameters equal, and each gradient leaf
   held to the float64 gradient of the same step: no farther from it than
   twice the one-process step's error plus 1e-5 of the largest entry (the
   one-process step is itself up to 1.7e-5 of the largest entry from
   float64, so another summation order cannot meet that test's atol of
   1e-5 against it; the excess over its bars is printed);
   (d) ``raynet_forward_torch`` (raynet) under ``torchrun --standalone
   --nproc_per_node 1`` on the 400x300 rig on disk: its maps against the
   one-process CLI's at (a)'s bar. Two ranks on one card measure the
   sharded path's cost, not a speed-up;
17. the ``mvsnet`` pass (``get_forward_pass_factory("mvsnet")``) with an
   ``MVSNetModel`` at its published widths (feature net 8/16/32, U-Net
   8/16/32/64, seeded weights) on an 8-image 1600x1200 ring (focal 2750,
   bbox +-6.5), cropped to 1600x1184, every image a reference view with
   its 4 nearest, D = 256: after one untimed pass, the kernel launches set
   to 0 just before the timed pass and read just after (K4 exactly 8, K5
   exactly 24, K6 exactly 8, K7 exactly 8, no other kernel), ``volumes`` 8,
   wall time,
   phases, peak
   memory, the (8, 296, 400) maps finite and view 0's within its planes;
   then K4 on view 0's card features (5, 296, 400, 32), D = 256, against
   its plain version on the same card tensors (>= 0.999 of the values
   within rtol 1e-5, atol 1e-6), each timed (median of 7 launches, plain
   of 3) beside its bound (``bench_torch/mvs_roofline.py``'s count of K4's
   work); then K5 at the U-Net's c7, c9 and c11 (inputs (64, 32, 37, 50),
   (32, 64, 74, 100), (16, 128, 148, 200), seeded) against its plain
   version (within 2**-18 of each output's sum of absolute terms), timed
   beside its bound (``k5_cost``), its plain version, cuDNN's transposed
   conv with the ReLU and skip sum, and the 8 sub-pixel forward convs;
   then K6 at the U-Nets' entry layer c0 in the four shapes the passes run
   (``K6_SHAPES``: MVSNet's (32, 256, 296, 400) and CasMVSNet's three
   stages, seeded) and K7 at their prob layer in the same four
   (``K7_SHAPES``: (8, D, H, W), MVSNet's with its bias, CasMVSNet's
   without), each by ``_conv_kernel_phase``: against its plain version over
   the whole volume and the float64 conv3d at seven planes (within 2**-18
   of each output's sum of absolute terms), timed beside its bound
   (``conv3d_cost``), its plain version and cuDNN's conv3d with the bias
   (and K6's ReLU), what the pass ran before; then cuDNN alone at the
   U-Net's other forward convs (c1-c6, prob) on MVSNet's volume;
18. the ``casmvsnet`` pass on phase 17's rig with a ``CasMVSNetModel`` at
   its published widths (seeded weights): K4 24 times (16 of them in its
   per-pixel mode), K5 72 times, K6 24 times, K7 24 times, no other
   kernel; 24
   volumes; wall time,
   phases, peak memory, the (8, 1184, 1600) maps finite and within the
   depth range; then K4 at each stage's size on view 0's card features
   (296x400 planes, 592x800 and 1184x1600 per-pixel around the pass's own
   depths) against its plain version, timed beside its bound; then K4's
   plane mode at MVSNet's size equal to its per-pixel mode at a centre of
   0, bit for bit.
   No module of JAX or of the JAX package may have been imported.

The rig, the kernel times and the bounds are ``raynet_tpu_torch.tools``'
(``time_kernels.kernel_rig``, ``time_kernels.time_all``, ``roofline``).
The last lines are a JSON summary of the passes, the probes, the trace,
the host store and the evaluation, the kernels' JSON line (times, bounds,
launches; K3's rows mode counted in phases 11, 14 and 15, K4, K5, K6 and
K7 in phases 17 and 18's timed passes), and the card's name and
power limit before the final JSON line ``{"ok": true, "device": ...}``.
Without a CUDA device, or
without the repository around it, the script exits nonzero and prints no
result.
"""
import argparse
import json
import math
import os
import re
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


def hartmann_flops(patch_shape, views):
    """Multiply-adds x 2 of one HartmannSimilarityNet quintuple: conv5(32)
    and conv5(64) (each before a 2x2 pool) on every view, then the head's
    conv5(2048), conv1(2048) and conv1(2) on the mean of the views."""
    h, w, c = patch_shape
    flops = 0
    for out_c in (32, 64):
        h, w = h - 4, w - 4
        flops += views * h * w * out_c * 25 * c * 2
        h, w, c = h // 2, w // 2, out_c
    h, w = h - 4, w - 4
    return flops + h * w * (2048 * 25 * 64 + 2048 * 2048 + 2 * 2048) * 2


def card_state():
    """The card's SM clock, temperature and power draw."""
    return run(["nvidia-smi",
                "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                "--format=csv,noheader"])


def phase_hartmann(check, dev, small, counters):
    """Phase 12: the hartmann_fp pass on the card with a HartmannModel at
    its published widths on the rig ``small``, its scores against the CPU's
    on 1,024 rays, and the forward CLI's route (a
    FeatureExtractor('hartmann_cnn'))."""
    import torch

    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.common.sampling_schemes import SamplingInBboxScheme
    from raynet_tpu_torch.common.scene import RestrepoScene
    from raynet_tpu_torch.inference import get_forward_pass_factory
    from raynet_tpu_torch.models.feature_extractor import (
        FeatureExtractor,
        HartmannModel,
    )
    from raynet_tpu_torch.scripts import forward_pass as cli
    from raynet_tpu_torch.tools.roofline import PEAK_F32_FLOPS

    h, w = small.image_shape
    D, V, patch = 32, 5, (32, 32, 3)
    n_quint = h * w * D
    out = {}
    log("== 12. hartmann_fp on the card: HartmannModel (32x32x3 patches, "
        "widths 32/64/2048/2048/2, seeded weights), the %dx%d rig, 1 "
        "reference view, %d neighbours, D = %d: %d quintuples"
        % (w, h, V - 1, D, n_quint))
    gp = GenerationParameters(depth_planes=D, neighbors=V - 1,
                              patch_shape=patch, padding=patch[0],
                              sampling_type="sample_points_in_bbox")
    scheme = SamplingInBboxScheme(gp)
    flops = hartmann_flops(patch, V)
    with tempfile.TemporaryDirectory() as tmp:
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        scene = RestrepoScene(os.path.join(data, "scene_1"), device=dev)
        model = HartmannModel(seed=0, patch_shape=patch, device=dev)
        factory = get_forward_pass_factory("hartmann_fp")
        fp = factory(model, gp, scheme, scene.image_shape, device=dev)
        torch.cuda.synchronize()
        card = card_state()
        log("  card before the pass (SM clock, temperature, power): " + card)
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        (dm,) = list(fp.forward_pass(scene, (0, 1, 1)))
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        phases = dict(fp.timer.totals)
        net = phases["Patch net"]
        share = flops * n_quint / net / PEAK_F32_FLOPS
        log("  wall %.3f s, %.0f quintuples/s; peak device memory %.2f GB; "
            "chunk %d quintuples" % (wall, n_quint / wall, peak_gb,
                                     fp.quintuples_per_call))
        for k, v in phases.items():
            log("  phase %-28s %.3f s" % (k, v))
        log("  %d FLOP a quintuple; the net (phase \"Patch net\", the "
            "gather apart) at %.2f TFLOP/s, %.3f of the f32 peak (%.0f "
            "TFLOP/s, TF32 off)" % (flops, flops * n_quint / net / 1e12,
                                    share, PEAK_F32_FLOPS / 1e12))
        check(launches == dict.fromkeys(counters, 0),
              "no port kernel on the hartmann path: launches %s" % launches)
        check(dm.shape == (h, w) and bool(np.isfinite(dm).all())
              and dm.min() > 0 and dm.max() <= 800,
              "depth map %s finite in (0, 800], range [%.3f, %.3f]"
              % (dm.shape, dm.min(), dm.max()))
        out.update(wall_s=wall, quintuples=n_quint,
                   quintuples_per_s=n_quint / wall, phases_s=phases,
                   peak_device_gb=peak_gb, flops_per_quintuple=flops,
                   quintuples_per_call=fp.quintuples_per_call,
                   f32_peak_share=share, card_before=card)

        # 1,024 rays of view 0 on the card and on the CPU, same weights
        images = scene.get_image_with_neighbors(0, V - 1)
        points = np.asarray(scheme.sample_points_across_rays(scene, 0))[:3]
        rays = np.linspace(0, h * w - 1, 1024).astype(np.int64)
        sub = np.ascontiguousarray(points[:, rays])
        card_scores = fp.image_scores(images, sub).cpu().numpy()
        cpu_model = HartmannModel(state_dict={
            k: v.cpu() for k, v in model.model.state_dict().items()},
            patch_shape=patch, device="cpu")
        cpu_fp = factory(cpu_model, gp, scheme, scene.image_shape,
                         rays_batch=4096, device="cpu")
        t0 = time.perf_counter()
        cpu_scores = cpu_fp.image_scores(images, sub).numpy()
        t_cpu = time.perf_counter() - t0
        err = float(np.abs(card_scores - cpu_scores).max())
        # softmax probabilities from float32 convolutions summed over up to
        # 2048 x 25 terms, in other orders on the card and on the CPU
        check(err <= 2e-5, "scores of %d quintuples: card against CPU max "
              "abs diff %.3e (bar 2e-5); CPU %.3f s"
              % (card_scores.size, err, t_cpu))
        cb, pb = card_scores.argmax(1), cpu_scores.argmax(1)
        same = float((cb == pb).mean())
        picked = cpu_scores[np.arange(len(cb)), cb]
        tied = bool((picked >= cpu_scores.max(1) * (1 - 1e-5)).all())
        check(same >= 0.999 or tied, "argmax planes agree on %.4f of the "
              "rays (bar 0.999), or the card's plane ties the CPU's maximum "
              "within rtol 1e-5: %s" % (same, tied))
        d_rays = np.linalg.norm(points[:, rays, :][:, np.arange(len(cb)), cb].T
                                - images[0].camera.center[:3, 0][None],
                                axis=-1)
        # the pass scored them in chunks of another size
        ray_agree = rel_agreement(dm.T.reshape(-1)[rays],
                                  np.minimum(d_rays, 800), 1e-3)
        check(ray_agree >= 0.999, "the pass's depths of those rays are "
              "their argmax planes' on %.4f of them" % ray_agree)
        out.update(score_max_abs_err=err, argmax_agreement=same,
                   cpu_s_1024_rays=t_cpu)

        # the CLI's route: a FeatureExtractor('hartmann_cnn'), seed 0
        pred = os.path.join(tmp, "pred")
        t0 = time.perf_counter()
        cli.main([data, pred, "--scene_idx", "0", "--forward_pass_factory",
                  "hartmann_fp", "--cnn_factory", "hartmann_cnn",
                  "--patch_shape", "32,32,3", "--start_end", "0,1",
                  "--device", str(dev)])
        t_cli = time.perf_counter() - t0
        cli_map = np.load(os.path.join(pred, "depth_000.npy"))
        fe_fp = factory(FeatureExtractor("hartmann_cnn", seed=0, device=dev),
                        gp, scheme, scene.image_shape, device=dev)
        t0 = time.perf_counter()
        (ref,) = list(fe_fp.forward_pass(scene, (0, 1, 1)))
        t_fe = time.perf_counter() - t0
        agree = rel_agreement(cli_map, ref, 1e-3)
        log("  CLI (FeatureExtractor route) %.3f s, the same pass %.3f s; "
            "maps identical: %s" % (t_cli, t_fe,
                                    bool(np.array_equal(cli_map, ref))))
        check(cli_map.shape == (h, w) and agree >= 0.999,
              "CLI depth map %s agrees with the pass called the same way: "
              "%.6f within 1e-3 relative" % (cli_map.shape, agree))
        out.update(cli_s=t_cli, feature_route_pass_s=t_fe,
                   cli_agreement=agree)
    return out


def _epoch_rates(printed):
    """Each epoch's (steps/s, seconds waiting for samples, seconds of the
    steps, steps/s of the step alone) from the CLI's epoch lines."""
    return [tuple(float(v) for v in m.groups()) for m in re.finditer(
        r"\(([\d.]+) steps/s, .*?waiting for samples ([\d.]+) s, training "
        r"steps ([\d.]+) s \(([\d.]+) steps/s", printed)]


# The card's one-step gradient is held to the CPU's, ||g_card - g_cpu|| /
# ||g_cpu|| at most STEP_GRAD_BAR[mode]. Readings on an H100 80GB HBM3 and
# its machine's CPU: the step as the path runs it (TF32 off) 3.61e-4
# (default) and 1.90e-6 (hartmann); the same step with TF32 on 3.74e-2 and
# 3.07e-2. Each bar is 5-10x the first reading and lets the second fail.
STEP_GRAD_BAR = {"default": 2e-3, "hartmann": 2e-5}


def one_step_against_cpu(check, dev, mode):
    """One training step of pretraining ``mode`` from the same state and
    batch on the card and on the CPU: the losses, the BatchNorm statistics
    and the gradients compared, the last against ``STEP_GRAD_BAR``. A
    control runs the card's step with TF32 on and must exceed the bar.
    Then the card's step alone on this batch is timed.
    Per parameter it prints the gradient's norm, the card's and the TF32
    control's relative distance to the CPU's, and, on the CPU, the float32
    gradient's distance to the float64 one and the float64 gradient's move
    when the inputs take float32-sized relative noise."""
    import torch

    from raynet_tpu_torch.models.losses import categorical_crossentropy, emd
    from raynet_tpu_torch.train.pretrain import (
        create_hartmann_pretrain_state,
        create_pretrain_state,
        make_pretrain_step,
    )

    rng = np.random.RandomState(0)
    if mode == "default":
        shape = (32, 10, 11, 11, 3)
        args = (rng.rand(32, *shape).astype(np.float32),
                rng.rand(32, *shape).astype(np.float32),
                np.eye(32, dtype=np.float32)[rng.randint(0, 32, 32)])

        def make(device):
            model, state, loss_fn, wd = create_pretrain_state(
                27, shape, device=device)
            return model, state, make_pretrain_step(model, loss_fn, wd)[0]

        def loss64(model, x1, x2, y):
            return emd(y, model(x1.movedim(-1, -3),
                                x2.movedim(-1, -3))).mean()
    else:
        args = (rng.rand(32, 5, 32, 32, 3).astype(np.float32),
                np.eye(2, dtype=np.float32)[rng.randint(0, 2, 32)].reshape(
                    32, 1, 1, 2))

        def make(device):
            return create_hartmann_pretrain_state(27, (32, 32, 3), lr=1e-3,
                                                  device=device)

        def loss64(model, p, y):
            out = model(p.movedim(-1, -3)).permute(0, 2, 3, 1)
            return categorical_crossentropy(y.reshape(32, -1),
                                            out.reshape(32, -1)).mean()

    def grads(model):
        return {n: p.grad.detach().cpu().double()
                for n, p in model.named_parameters()}

    def step(device, tf32=False):
        model, state, train = make(device)
        # make() switched TF32 off on the card; the control turns it on
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            state, metrics = train(state, *args)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return (float(metrics["loss"]), grads(model),
                {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if "running" in k})

    def step64(inputs):
        model = make("cpu")[0].double().train()
        loss64(model, *(torch.as_tensor(a, dtype=torch.float64)
                        for a in inputs)).backward()
        return grads(model)

    def step_alone_ms(n=20):
        """The card's step on this batch, no sample producer running: the
        mean of ``n`` steps after two, each ending in a read of its loss
        as the CLI's do."""
        model, state, train = make(dev)
        for i in range(n + 2):
            if i == 2:
                t0 = time.perf_counter()
            float(train(state, *args)[1]["loss"])
        return (time.perf_counter() - t0) / n * 1e3

    (lc, gc, sc), (lt, gt, _), (lp, gp_, sp) = (
        step(dev), step(dev, tf32=True), step("cpu"))
    alone = step_alone_ms()
    g64 = step64(args)
    noise = np.random.RandomState(1)
    g64n = step64([args[0] * (1 + noise.uniform(-2.0 ** -24, 2.0 ** -24,
                                                args[0].shape))]
                  + list(args[1:]))

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def flat(g):
        return torch.cat([v.reshape(-1) for v in g.values()])

    log("  %s: per parameter, |g| on the CPU; relative distance of the "
        "card's, of the TF32 control's, and of the CPU's float32 to float64; "
        "float64 moved by input noise of 2^-24" % mode)
    for n in gp_:
        log("    %-20s %.3e  card %.3e  tf32 %.3e  f32-f64 %.3e  noise %.3e"
            % (n, float(gp_[n].norm()), rel(gc[n], gp_[n]),
               rel(gt[n], gp_[n]), rel(gp_[n], g64[n]), rel(g64n[n], g64[n])))
    err, err_tf32 = rel(flat(gc), flat(gp_)), rel(flat(gt), flat(gp_))
    serr = max([float(((sc[k] - sp[k]).abs() / (sp[k].abs() + 1e-2)).max())
                for k in sp] or [0.0])
    bar = STEP_GRAD_BAR[mode]
    log("  %s: one step, card / CPU: loss %.7f / %.7f (TF32 %.7f); "
        "gradient's relative distance to the CPU's %.3e (TF32 control "
        "%.3e, bar %.1e); float32 to float64 on the CPU %.3e; BatchNorm "
        "statistics max rel diff %.3e; the card's step alone on this batch "
        "%.2f ms (%.1f steps/s)"
        % (mode, lc, lp, lt, err, err_tf32, bar,
           rel(flat(gp_), flat(g64)), serr, alone, 1e3 / alone))
    check(abs(lc - lp) <= 1e-4 * abs(lp) and serr <= 1e-4 and err <= bar,
          "%s: one step on the card against the CPU: loss within rtol 1e-4, "
          "BatchNorm statistics within 1e-4 relative, gradient within %.1e "
          "relative" % (mode, bar))
    check(err_tf32 > bar, "%s: the TF32 control fails the gradient bar "
          "(%.3e > %.1e)" % (mode, err_tf32, bar))
    return {"step_loss": [lc, lp], "step_grad_rel_diff": err,
            "step_grad_rel_diff_tf32": err_tf32,
            "step_bn_max_rel_diff": serr, "step_alone_ms": alone}


def phase_pretrain(check, dev, small):
    """Phase 13: raynet_pretrain_torch on the card in the default and
    hartmann modes, resumed from epoch 1's checkpoint, its weight files
    read by raynet_forward_torch, and one step against the CPU's."""
    import contextlib
    import io

    import torch

    from raynet_tpu_torch.models.convert import (
        hartmann_state_dict_from_flax,
        read_flax_msgpack,
        similarity_state_dict_from_flax,
    )
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
    from raynet_tpu_torch.scripts import forward_pass as cli
    from raynet_tpu_torch.scripts import pretrain_network as pretrain
    from raynet_tpu_torch.scripts.experiments_utils import Metrics

    h, w = small.image_shape
    modes = {
        "default": ["--patch_shape", "11,11,3", "--batch_size", "32"],
        "hartmann": ["--input_output_dimensionality", "hartmann",
                     "--patch_shape", "32,32,3", "--batch_size", "32",
                     "--optimizer", "SGD", "--momentum", "0.9",
                     "--step_depth", "4"],
    }
    out = {}
    log("== 13. raynet_pretrain_torch on the card, %dx%d rig with a cube GT "
        "mesh, D = 32, 4 neighbours, 2 epochs x 5 steps" % (w, h))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        write_cube_mesh(os.path.join(data, "scene_1", "gt_mesh.obj"), 3.0, 41)
        for mode, extra in modes.items():
            flags = [data, data, None, "--device", str(dev), "--depth_planes",
                     "32", "--neighbors", "4", "--steps_per_epoch", "5",
                     "--training_cached_samples", "64", "--n_test_samples",
                     "32"] + extra

            def train(name, epochs, *more):
                root = os.path.join(tmp, mode, name)
                os.makedirs(root, exist_ok=True)
                args = list(flags)
                args[2] = root
                printed = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    pretrain.main(args + ["--epochs", str(epochs), *more])
                wall = time.perf_counter() - t0
                (exp,) = [os.path.join(root, d) for d in os.listdir(root)
                          if os.path.isdir(os.path.join(root, d))]
                return exp, wall, printed.getvalue()

            exp, wall, printed = train("full", 2)
            losses = Metrics(os.path.join(exp, "train.txt"),
                             os.path.join(exp, "val.txt")).train["loss"]
            rates = _epoch_rates(printed)
            log("  %s: %.3f s for the CLI; by epoch (steps/s, s waiting for "
                "samples, s of the steps, steps/s of the step alone) %s; "
                "losses %s" % (mode, wall, rates,
                               ["%.6f" % v for v in losses]))
            check(losses.shape == (10,) and bool(np.isfinite(losses).all())
                  and len(rates) == 2,
                  "%s: 10 finite losses, 2 epochs' rates" % mode)
            cut, _, _ = train("cut", 1)
            _, _, printed = train("cut", 2, "--resume", cut)
            resumed = Metrics(os.path.join(cut, "train.txt"),
                              os.path.join(cut, "val.txt")).train["loss"]
            diff = float(np.abs(resumed[5:] - losses[5:]).max())
            # cuDNN is held to deterministic algorithms: equal up to 1e-6
            check("resumed from checkpoint after epoch 0" in printed
                  and resumed.shape == (10,)
                  and diff <= 1e-6 * float(np.abs(losses).max()),
                  "%s: --resume from epoch 1's checkpoint reproduces the "
                  "second epoch's losses (max abs diff %.3e)" % (mode, diff))
            weights = os.path.join(exp, "weights", "weights.01.msgpack")
            tree = read_flax_msgpack(weights)
            fe_name = "hartmann_cnn" if mode == "hartmann" else "simple_cnn"
            fe = FeatureExtractor.from_weights(fe_name, weights, device="cpu")
            want = (hartmann_state_dict_from_flax(tree) if mode == "hartmann"
                    else similarity_state_dict_from_flax(tree))
            same = all(torch.equal(v, want["cnn." + k])
                       for k, v in fe.model.state_dict().items()
                       if "num_batches" not in k)
            pred = os.path.join(tmp, mode, "pred")
            cli.main([data, pred, "--scene_idx", "0", "--start_end", "0,1",
                      "--forward_pass_factory",
                      "hartmann_fp" if mode == "hartmann" else
                      "multi_view_cnn", "--cnn_factory", fe_name,
                      "--patch_shape", extra[extra.index("--patch_shape") + 1],
                      "--depth_planes", "4" if mode == "hartmann" else "32",
                      "--weight_file", weights, "--device", str(dev)])
            dm = np.load(os.path.join(pred, "depth_000.npy"))
            check(same and dm.shape == (h, w) and bool(np.isfinite(dm).all())
                  and (dm > 0).mean() > 0.1,
                  "%s: weights.01.msgpack holds the trained CNN and "
                  "raynet_forward_torch --weight_file maps it (%s, nonzero "
                  "%.4f)" % (mode, dm.shape, (dm > 0).mean()))
            out[mode] = {"cli_s": wall,
                         "steps_per_s": [r[0] for r in rates],
                         "sample_wait_s": [r[1] for r in rates],
                         "step_s": [r[2] for r in rates],
                         "step_alone_per_s": [r[3] for r in rates],
                         "losses": losses.tolist(), "resume_max_abs_diff":
                         diff}

    for mode in modes:
        out[mode].update(one_step_against_cpu(check, dev, mode))
    return out


# The card's one-step gradient of end-to-end training is held to the CPU's,
# ||g_card - g_cpu|| / ||g_cpu|| at most E2E_GRAD_BAR, on a 64-ray batch at
# the CLI's widths. Readings on an H100 80GB HBM3 and its machine's CPU: the
# step as the path runs it (TF32 off) 1.87e-5; the same step with TF32 on
# 1.45e-2. The bar is 5x the first reading and lets the second fail.
E2E_GRAD_BAR = 1e-4

# phase 14's widths: the JAX CLI's defaults (raynet_train), 3 BP iterations,
# a trainable gamma from 0.05, EMD, Adam at 1e-3
E2E = {"D": 32, "grid": (256, 256, 128), "M": 650, "rays": 1000,
       "iterations": 3, "cpu_rays": 64}


def e2e_flags():
    return ["--cnn_factory", "simple_cnn",
            "--depth_planes", str(E2E["D"]), "--neighbors", "4",
            "--patch_shape", "11,11,3",
            "--grid_shape", ",".join(str(g) for g in E2E["grid"]),
            "--maximum_number_of_marched_voxels", str(E2E["M"]),
            "--rays_batch_size", str(E2E["rays"]), "--bp_iterations", "3",
            "--train_with_gamma", "--initial_gamma_prior", "0.05",
            "--loss", "emd", "--optimizer", "Adam", "--lr", "1e-3",
            "--window", "2", "--validate_every", "3",
            "--snapshot_every", "3", "--checkpoint_every", "2"]


def _iteration_splits(printed):
    """Each iteration's (seconds drawing samples, seconds finishing them,
    traversal calls, seconds of the step) from the training CLI's lines."""
    return [(float(a), float(b), int(c), float(d)) for a, b, c, d in
            re.findall(r"drawing samples ([\d.]+) s, finishing them "
                       r"([\d.]+) s \((\d+) traversal call\(s\)\), the step "
                       r"([\d.]+) s", printed)]


def e2e_step_against_cpu(check, dev, batch):
    """One end-to-end training step from the same state and batch (64 rays
    at the CLI's widths) on the card and on the CPU: the losses, the updated
    gamma, the BatchNorm statistics and the gradients, the last against
    ``E2E_GRAD_BAR``; a control runs the card's step with TF32 on and must
    exceed the bar."""
    import torch

    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training

    gp = GenerationParameters(depth_planes=E2E["D"], neighbors=4,
                              patch_shape=(11, 11, 3))

    def step(device, tf32=False):
        state, train, _ = build_end_to_end_training(
            27, gp, E2E["grid"], lr=1e-3, gamma=0.05,
            train_with_gamma=True, bp_iterations=3, return_grads=True,
            device=device)
        # the build switched TF32 off on the card; the control turns it on
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            state, m = train(state, batch)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        grads = torch.cat([g.detach().cpu().double().reshape(-1) for g in
                           m["grads"]["cnn"].values()]
                          + [m["grads"]["gamma"].cpu().double().reshape(1)])
        stats = {k: v.detach().cpu() for k, v in
                 state.model.state_dict().items() if "running" in k}
        return float(m["loss"]), state.gamma.item(), grads, stats

    t0 = time.perf_counter()
    lp, gp_, g_cpu, sp = step("cpu")
    cpu_s = time.perf_counter() - t0
    lc, gc, g_card, sc = step(dev)
    lt, _, g_tf32, _ = step(dev, tf32=True)

    def rel(a):
        return float((a - g_cpu).norm() / g_cpu.norm())

    err, err_tf32 = rel(g_card), rel(g_tf32)
    serr = max(float(((sc[k] - sp[k]).abs() / (sp[k].abs() + 1e-2)).max())
               for k in sp)
    gerr = abs(gc - gp_) / abs(gp_)
    log("  one step on %d rays, card / CPU: loss %.7f / %.7f (TF32 %.7f); "
        "gamma after the update %.7f / %.7f; gradient's relative distance "
        "to the CPU's %.3e (TF32 control %.3e, bar %.1e); BatchNorm "
        "statistics max rel diff %.3e; the CPU's step %.3f s"
        % (batch["y"].shape[0], lc, lp, lt, gc, gp_, err, err_tf32,
           E2E_GRAD_BAR, serr, cpu_s))
    check(abs(lc - lp) <= 1e-4 * abs(lp) and gerr <= 1e-5 and serr <= 1e-4
          and err <= E2E_GRAD_BAR,
          "one e2e step on the card against the CPU: loss within rtol 1e-4, "
          "updated gamma within 1e-5 relative, BatchNorm statistics within "
          "1e-4 relative, gradient within %.1e relative" % E2E_GRAD_BAR)
    check(err_tf32 > E2E_GRAD_BAR, "the TF32 control fails the gradient bar "
          "(%.3e > %.1e)" % (err_tf32, E2E_GRAD_BAR))
    return {"step_loss": [lc, lp], "step_gamma": [gc, gp_],
            "step_grad_rel_diff": err, "step_grad_rel_diff_tf32": err_tf32,
            "step_bn_max_rel_diff": serr, "cpu_step_s": cpu_s}


def e2e_step_split(dev, gp, grid, batch, n=3):
    """The card's training step on ``batch`` cut at the CNN's features, each
    part ended by a device sync: the batch's upload, the CNN forward, the
    head forward (pair sums, mapping, BP, posterior, loss), the head
    backward (to the features and gamma) and the CNN backward. Median
    seconds of ``n`` steps after one."""
    import torch

    from raynet_tpu_torch.models.losses import emd
    from raynet_tpu_torch.train.train_e2e import (
        batch_to_device,
        build_end_to_end_training,
        patch_features,
        raynet_head,
    )

    state, _, _ = build_end_to_end_training(
        27, gp, grid, lr=1e-3, gamma=0.05, train_with_gamma=True,
        bp_iterations=3, device=dev)
    parts = []
    for _ in range(n + 1):
        clock = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            clock.append(time.perf_counter())

        t = batch_to_device(batch, dev)
        mark()
        f = patch_features(state.model, t["X"])
        mark()
        S, _ = raynet_head(f, state.gamma, t["points"],
                           t["ray_voxel_indices"], t["ray_voxel_count"],
                           t["bbox"], grid)
        loss = emd(t["y"], S).mean()
        mark()
        g_f, _ = torch.autograd.grad(loss, [f, state.gamma],
                                     retain_graph=True)
        mark()
        f.backward(g_f)
        mark()
        parts.append(np.diff(clock))
    names = ("upload", "cnn_forward", "head_forward", "head_backward",
             "cnn_backward")
    return dict(zip(names, np.median(parts[1:], axis=0).tolist()))

def trace_step(check, dev, gp, grid, batch):
    """One training step on ``batch`` (after one untraced) under
    ``utils.profiling.trace``: the device's busy share of the step and the
    eight device operations with the most time."""
    import torch

    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training
    from raynet_tpu_torch.utils import profiling

    state, train_fn, _ = build_end_to_end_training(
        27, gp, grid, lr=1e-3, gamma=0.05, train_with_gamma=True,
        bp_iterations=3, device=dev)
    float(train_fn(state, batch)[1]["loss"])
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            with torch.profiler.record_function("training step"):
                float(train_fn(state, batch)[1]["loss"])
        events = profiling.read_trace(os.path.join(tmp, profiling.TRACE_NAME))
    intervals = profiling.device_intervals(events)
    window = profiling.annotation_window(events, "training step")
    busy = profiling.device_busy_share([iv[1:] for iv in intervals], window)
    by_name = {}
    for name, t_start, t_end in intervals:
        by_name[name] = by_name.get(name, 0.0) + (t_end - t_start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    check(len(intervals) > 0, "the traced step holds %d device operations"
          % len(intervals))
    log("  traced step: window %.1f ms, device busy %.4f, idle %.4f; %d "
        "device operations, %.1f ms of device time"
        % ((window[1] - window[0]) / 1e3, busy, 1 - busy, len(intervals),
           sum(by_name.values()) / 1e3))
    for name, us in top:
        log("  %10.3f ms  %s" % (us / 1e3, name[:110]))
    return {"trace_window_ms": (window[1] - window[0]) / 1e3,
            "trace_busy_share": busy,
            "trace_top8_ms": {n: us / 1e3 for n, us in top}}

def phase_train(check, dev, small, counters):
    """Phase 14: raynet_train_torch on the card at the JAX CLI's widths on
    the rig ``small`` with a cube GT mesh, resumed from iteration 2's
    checkpoint, its weight file read by raynet_forward_torch, K3's rows
    mode counted exactly (one launch per batch) and held to its plain
    version on a batch, the card's step alone, and one step against the
    CPU's. Returns (summary, K3 rows launches of the two CLI runs, the
    fixed batch)."""
    import contextlib
    import io

    import torch

    from raynet_tpu_torch.common.dataset import RestrepoDataset
    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.common.sampling_schemes import make_sampling_scheme
    from raynet_tpu_torch.models.convert import read_cnn_weights
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
    from raynet_tpu_torch.ops.ray_marching import (
        flatten_voxel_indices,
        voxel_traversal_flat,
        voxel_traversal_flat_reference,
    )
    from raynet_tpu_torch.scripts import forward_pass as cli
    from raynet_tpu_torch.scripts import train_raynet
    from raynet_tpu_torch.tools import roofline
    from raynet_tpu_torch.tools.time_kernels import time_ms
    from raynet_tpu_torch.train.batch_provider import RayNetBatchProvider
    from raynet_tpu_torch.train.sample import RayNetRandomSampleGenerator
    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training

    h, w = small.image_shape
    iters, grid, M, rays = (E2E["iterations"], E2E["grid"], E2E["M"],
                            E2E["rays"])
    out = {}
    log("== 14. raynet_train_torch on the card: simple_cnn, D = %d, 4 "
        "neighbours, 11x11x3 patches, grid %s, M = %d, %d rays a batch, 3 "
        "BP iterations, trainable gamma from 0.05, EMD, Adam 1e-3; the "
        "%dx%d rig with a cube GT mesh, %d iterations"
        % (E2E["D"], "x".join(map(str, grid)), M, rays, w, h, iters))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        write_cube_mesh(os.path.join(data, "scene_1", "gt_mesh.obj"), 3.0, 41)
        root = os.path.join(tmp, "runs")
        os.makedirs(root)

        def train(iterations, *more):
            printed = io.StringIO()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                train_raynet.main([data, data, root, "--device", str(dev),
                                   "--iterations", str(iterations)]
                                  + e2e_flags() + list(more))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return wall, printed.getvalue(), {
                k: c.launches for k, c in counters.items()}

        torch.cuda.synchronize(dev)  # sets up the device before its stats
        torch.cuda.reset_peak_memory_stats(dev)
        wall, printed, launches = train(iters)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        (exp,) = [os.path.join(root, d) for d in os.listdir(root)]
        with open(os.path.join(exp, "train_statistics.txt")) as f:
            lines = f.read().split("\n")[1:-1]
        losses = [float(l.split()[1]) for l in lines]
        gammas = [float(l.split()[2]) for l in lines]
        splits = _iteration_splits(printed)
        final = read_cnn_weights(os.path.join(exp, "weights",
                                              "weights.final.msgpack"))
        ckpt = torch.load(os.path.join(exp, "checkpoints", "2", "state.pt"),
                          map_location="cpu", weights_only=True)
        g2 = float(ckpt["gamma"])
        log("  CLI %.3f s for %d iterations and the validation batch; peak "
            "device memory %.2f GB; losses %s; gamma by iteration %s, after "
            "2 steps %.7f" % (wall, iters, peak_gb,
                              ["%.6f" % v for v in losses],
                              ["%.6f" % v for v in gammas], g2))
        for i, (draw, fin, calls, st) in enumerate(splits):
            log("  iteration %d: drawing samples %.3f s, finishing them (K3) "
                "%.3f s in %d launch(es), the step %.3f s"
                % (i, draw, fin, calls, st))
        expect = {k: (iters + 1) * (k == "voxel_traversal_flat")
                  for k in counters}
        check(launches == expect and [s[2] for s in splits]
              == [1] * iters,
              "K3's rows mode launched once per batch (%d training batches "
              "and the validation batch), no other kernel: %s"
              % (iters, launches))
        check(len(losses) == iters and bool(np.isfinite(losses).all())
              and all(1e-5 <= g <= 1 - 1e-5 for g in gammas + [g2])
              and g2 != 0.05 and gammas[0] == 0.05,
              "%d finite losses; gamma inside [1e-5, 1 - 1e-5] and moved "
              "from 0.05" % iters)
        check(all(os.path.isfile(os.path.join(exp, "weights", n)) for n in
                  ("weights.2.msgpack", "weights.final.msgpack"))
              and os.path.getsize(os.path.join(exp, "val_loss.txt")) > 0,
              "weights.2 and weights.final written, a validation loss logged")

        # the weight file read back by raynet_forward_torch --weight_file
        fe = FeatureExtractor.from_weights(
            "simple_cnn", os.path.join(exp, "weights",
                                       "weights.final.msgpack"),
            device="cpu")
        same = all(torch.equal(v, final[k])
                   for k, v in fe.model.state_dict().items()
                   if "num_batches" not in k)
        pred = os.path.join(tmp, "pred")
        cli.main([data, pred, "--scene_idx", "0", "--start_end", "0,1",
                  "--forward_pass_factory", "multi_view_cnn",
                  "--depth_planes", "32", "--weight_file",
                  os.path.join(exp, "weights", "weights.final.msgpack"),
                  "--device", str(dev)])
        dm = np.load(os.path.join(pred, "depth_000.npy"))
        check(same and dm.shape == (h, w) and bool(np.isfinite(dm).all())
              and (dm > 0).mean() > 0.1,
              "weights.final.msgpack holds the trained CNN and "
              "raynet_forward_torch --weight_file maps it (%s, nonzero %.4f)"
              % (dm.shape, (dm > 0).mean()))

        # --resume from iteration 2's checkpoint
        r_wall, r_printed, r_launches = train(iters, "--resume", exp)
        with open(os.path.join(exp, "train_statistics.txt")) as f:
            n_lines = len(f.read().strip().split("\n"))
        with open(os.path.join(exp, "val_loss.txt")) as f:
            n_val = len(f.read().strip().split("\n"))
        check("resumed from checkpoint at iteration 2" in r_printed
              and n_lines == 1 + iters + 1 and n_val == 2
              and r_launches["voxel_traversal_flat"] == 2,
              "--resume continues at iteration 2 and appends to the logs "
              "(%d statistics lines, %d validation lines, K3 rows %d "
              "launches, %.3f s)" % (n_lines, n_val,
                                     r_launches["voxel_traversal_flat"],
                                     r_wall))
        out.update(cli_s=wall, resume_cli_s=r_wall, peak_device_gb=peak_gb,
                   losses=losses, gammas=gammas, gamma_after_2=g2,
                   iterations=[dict(zip(("draw_s", "finish_s", "launches",
                                         "step_s"), s)) for s in splits],
                   launches=launches)
        rows = launches["voxel_traversal_flat"] + r_launches[
            "voxel_traversal_flat"]

        # a fixed batch: its traversal against the plain version, the
        # card's step alone on it, and 64 of its rays on the CPU
        gp = GenerationParameters(
            depth_planes=E2E["D"], neighbors=4, patch_shape=(11, 11, 3),
            grid_shape=np.array(grid, np.int32),
            max_number_of_marched_voxels=M,
            sampling_type="sample_points_in_bbox")
        sg = RayNetRandomSampleGenerator(
            make_sampling_scheme("sample_in_bbox", gp, device=dev), gp, [0],
            [], [], window=2, rng=np.random.RandomState(0), device=dev)
        provider = RayNetBatchProvider(RestrepoDataset(data, device=dev), sg)
        batch = provider.get_batch_of_rays(rays)
        log("  a fixed batch of %d rays: drawing %.3f s, finishing %.3f s"
            % (rays, provider.timings["draw_s"],
               provider.timings["finish_s"]))
        f32 = {k: torch.as_tensor(batch[k], device=dev)
               for k in ("bbox", "points")}
        flat, cnt = voxel_traversal_flat_reference(
            f32["bbox"], f32["points"][:, 0, :3].contiguous(),
            f32["points"][:, -1, :3].contiguous(), grid, M)
        got = flatten_voxel_indices(torch.as_tensor(
            batch["ray_voxel_indices"], device=dev), grid)
        check(bool(torch.equal(cnt.cpu(), torch.as_tensor(
            batch["ray_voxel_count"]))) and bool(torch.equal(got, flat)),
              "the batch's traversal (K3 rows) equals the plain version's: "
              "counts and (%d, %d) indices; mean count %.1f"
              % (rays, M, float(cnt.float().mean())))
        # K3 rows alone at the training batch's shape, beside its bound
        starts = f32["points"][:, 0, :3].contiguous()
        ends = f32["points"][:, -1, :3].contiguous()
        k3 = {"ms": time_ms(lambda: voxel_traversal_flat(
                  f32["bbox"], starts, ends, grid, M)),
              "plain_ms": time_ms(lambda: voxel_traversal_flat_reference(
                  f32["bbox"], starts, ends, grid, M), repeats=3),
              "rays": rays, "M": M, "visits": int(cnt.sum())}
        k3["bound_ms"], k3["bound_by"] = roofline.bound(
            roofline.voxel_traversal_cost(rays, M, k3["visits"]))
        log("  K3 rows on the batch: %.4f ms (median of 7 one-launch "
            "CUDA-event runs), plain %.3f ms; bound %.5f ms (%s; %d visits)"
            % (k3["ms"], k3["plain_ms"], k3["bound_ms"], k3["bound_by"],
               k3["visits"]))
        out["k3_rows_batch"] = k3

        state, train_fn, _ = build_end_to_end_training(
            27, gp, grid, lr=1e-3, gamma=0.05, train_with_gamma=True,
            bp_iterations=3, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        n = 5
        for i in range(n + 2):
            if i == 2:
                t0 = time.perf_counter()
            float(train_fn(state, batch)[1]["loss"])
        alone_ms = (time.perf_counter() - t0) / n * 1e3
        step_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        log("  the card's step alone on the fixed batch: %.2f ms (%.0f "
            "rays/s), the mean of %d after 2; peak device memory %.2f GB"
            % (alone_ms, rays / alone_ms * 1e3, n, step_peak))
        del state, train_fn
        split = e2e_step_split(dev, gp, grid, batch)
        log("  the step cut at the CNN's features, median of 3 (s): %s; "
            "the head (pair sums, mapping, BP, posterior) %.3f of it"
            % (", ".join("%s %.4f" % kv for kv in split.items()),
               (split["head_forward"] + split["head_backward"])
               / sum(split.values())))
        out.update(step_split_s=split)
        out.update(trace_step(check, dev, gp, grid, batch))
        out.update(step_alone_ms=alone_ms,
                   step_alone_rays_per_s=rays / alone_ms * 1e3,
                   step_peak_device_gb=step_peak)
        k = E2E["cpu_rays"]
        small_batch = {name: (v[:, :k] if name == "X" else
                              v if name in ("bbox", "scene_idx") else v[:k])
                       for name, v in batch.items()}
        out.update(e2e_step_against_cpu(check, dev, small_batch))
    out["phase_s"] = time.perf_counter() - t_phase
    log("  phase 14: %.1f s" % out["phase_s"])
    return out, rows, batch


def keras_tree(seed, theano=False):
    """An in-memory Keras 2 checkpoint (``keras_import.read_keras_tree``'s
    form) of a simple_cnn with weights from ``seed``, in the layout of the
    published RayNet checkpoints (the CNN as a sub-model of the siamese
    net: ``model_weights/<submodel>/<layer>/<weight>:0``); ``theano``:
    conv kernels in Theano's OIHW order instead of HWIO."""
    rng = np.random.RandomState(seed)
    datasets = {}
    cin = 3
    for i in range(1, 6):
        kernel = (rng.randn(3, 3, cin, 32) / np.sqrt(9.0 * cin)).astype(
            np.float32)
        layer = {
            "conv2d_%d" % i: {
                "kernel": kernel.transpose(3, 2, 0, 1) if theano else kernel,
                "bias": 0.1 * rng.randn(32)},
            "batch_normalization_%d" % i: {
                "gamma": 0.5 + rng.rand(32), "beta": 0.1 * rng.randn(32),
                "moving_mean": 0.1 * rng.randn(32),
                "moving_variance": 0.5 + rng.rand(32)},
        }
        for name, weights in layer.items():
            for w, arr in weights.items():
                datasets["model_weights/sequential_1/%s/%s:0" % (name, w)] = (
                    np.asarray(arr, np.float32))
        cin = 32
    return {"datasets": datasets,
            "layer_names": {"": None, "model_weights": None}}


def phase_keras(check, dev, small, gp, counters):
    """Phase 15a: a Keras checkpoint on the card. An in-memory Keras tree of
    a seeded simple_cnn (and its Theano-ordered variant) mapped by
    ``keras_import`` into a FeatureExtractor on the card, its state_dict
    ``torch.equal`` to the CPU's mapping; the raynet pass on the rig
    ``small`` with those weights and again after a ``save_weights`` ->
    ``load_weights`` msgpack round trip (launches counted exactly, the
    depth maps held to each other); where h5py is importable,
    ``raynet_forward_torch --weight_file x.hdf5`` on the rig written to
    disk. Returns a summary."""
    import importlib.util

    import torch

    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.models.cnn import cnn_factory
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
    from raynet_tpu_torch.models.keras_import import keras_state_dict_for_cnn
    from raynet_tpu_torch.scripts import forward_pass as cli
    from raynet_tpu_torch.tools.time_kernels import D, GRID, M, N_RAYS

    h, w = small.image_shape
    log("== 15a. Keras checkpoint on the card: a seeded simple_cnn as the "
        "published checkpoints lay it out, the raynet pass at %dx%d" % (w, h))
    out = {}
    tree = keras_tree(11)
    cpu_sd = keras_state_dict_for_cnn(tree, cnn_factory("simple_cnn")())
    theano_sd = keras_state_dict_for_cnn(keras_tree(11, theano=True),
                                         cnn_factory("simple_cnn")())
    fe = FeatureExtractor("simple_cnn", seed=1, device=dev)
    fe.model.load_state_dict(keras_state_dict_for_cnn(tree, fe.model))

    def equal(sd, ref):
        return list(sd) == list(ref) and all(
            torch.equal(v.cpu(), ref[k]) for k, v in sd.items())

    check(equal(fe.model.state_dict(), cpu_sd)
          and next(fe.model.parameters()).device.type == "cuda",
          "the card's mapped state_dict torch.equal to the CPU's (%d "
          "tensors)" % len(cpu_sd))
    check(equal(theano_sd, cpu_sd),
          "the Theano-ordered (OIHW) variant maps to the same tensors")
    expect = {k: 0 for k in counters}
    expect.update(plane_sweep_scores=2,
                  bp_sweep=2 * (RayNetForwardPass.bp_iterations + 1))

    def raynet(model, label):
        fp = RayNetForwardPass(model, gp, None, small.image_shape, N_RAYS,
                               device=dev)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        maps = np.stack(list(fp.forward_pass(small, (0, 2, 1))))
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        log("  %s: raynet pass %.3f s, launches %s" % (label, wall, launches))
        check(launches == expect, "%s: launches K1 2, K2 8 exactly" % label)
        check(maps.shape == (2, h, w) and bool(np.isfinite(maps).all())
              and (maps > 0).mean() > 0.1,
              "%s: depth maps %s finite, nonzero share %.4f"
              % (label, maps.shape, (maps > 0).mean()))
        return maps, wall, launches

    maps_k, out["keras_pass_s"], out["launches"] = raynet(
        fe, "weights from keras_import")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cnn.msgpack")
        fe.save_weights(path)
        fe2 = FeatureExtractor.from_weights("simple_cnn", path, device=dev)
        check(equal(fe2.model.state_dict(), cpu_sd),
              "save_weights -> load_weights keeps every tensor")
        maps_m, out["msgpack_pass_s"], _ = raynet(fe2, "after the msgpack "
                                                       "round trip")
        agree = rel_agreement(maps_m, maps_k, 1e-3)
        out["agreement"] = agree
        out["identical_share"] = float(np.mean(maps_m == maps_k))
        check(agree >= 0.999 and bool(np.array_equal(maps_m > 0, maps_k > 0)),
              "round-trip depth maps agree with the keras_import pass: %.6f "
              "within 1e-3 relative (bit-identical %.6f), masks identical"
              % (agree, out["identical_share"]))

        if importlib.util.find_spec("h5py") is None:
            log("  the .hdf5 read was not run on the card: h5py is not "
                "installed here")
            out["hdf5_cli"] = None
            return out
        import h5py

        hdf5 = os.path.join(tmp, "published.hdf5")
        with h5py.File(hdf5, "w") as f:
            for name, arr in tree["datasets"].items():
                f.create_dataset(name, data=arr)
        check(equal(FeatureExtractor.from_weights(
            "simple_cnn", hdf5, device=dev).model.state_dict(), cpu_sd),
              "FeatureExtractor.load_weights of the .hdf5 file maps the same "
              "tensors")
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        pred = os.path.join(tmp, "pred")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cli.main([data, pred, "--scene_idx", "0",
                  "--forward_pass_factory", "raynet", "--start_end", "0,2",
                  "--depth_planes", str(D),
                  "--grid_shape", ",".join(str(g) for g in GRID),
                  "--maximum_number_of_marched_voxels", str(M),
                  "--rays_batch", str(N_RAYS), "--weight_file", hdf5,
                  "--device", str(dev)])
        cli_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        maps_c = np.stack([np.load(os.path.join(pred, "depth_%03d.npy" % i))
                           for i in range(2)])
    agree = rel_agreement(maps_c, maps_k, 1e-3)
    out["hdf5_cli"] = {"cli_s": cli_s, "launches": launches,
                       "agreement": agree,
                       "identical_share": float(np.mean(maps_c == maps_k))}
    log("  raynet_forward_torch --weight_file x.hdf5: %.3f s, launches %s"
        % (cli_s, launches))
    check(launches == expect, "the CLI launched K1 2, K2 8 exactly")
    check(maps_c.shape == maps_k.shape and agree >= 0.999
          and bool(np.array_equal(maps_c > 0, maps_k > 0)),
          "the CLI's depth maps agree with the in-memory route's: %.6f "
          "within 1e-3 relative (bit-identical %.6f; K2 adds with float "
          "atomics), masks identical"
          % (agree, out["hdf5_cli"]["identical_share"]))
    return out


# bench.py's sizes (bench.py:725)
QUALITY = {"steps": 2000, "n_train": 1024, "n_val": 256, "iterations": 12}
# the JAX package's own figures on a TPU v5e (BENCH_r05.json; the e2e pair
# from ROADMAP.md): printed beside the card's for comparison, not targets
TPU_QUALITY = {"pretrain_val_acc": 0.3086, "pretrain_val_mde": 0.7617,
               "e2e_train_loss_ratio": 0.6619, "e2e_gamma_moved": 0.0288}


def fixed_batch_losses(dev, steps=12):
    """The end-to-end step of ``e2e_quality`` taken ``steps`` times on one
    fixed 8-ray batch of its pipeline: the losses."""
    from raynet_tpu_torch.common.dataset import RestrepoDataset
    from raynet_tpu_torch.common.sampling_schemes import make_sampling_scheme
    from raynet_tpu_torch.scripts.arguments import get_input_output_shapes
    from raynet_tpu_torch.tools import bench_training_quality as bench
    from raynet_tpu_torch.train.batch_provider import RayNetBatchProvider
    from raynet_tpu_torch.train.sample import RayNetSampleGenerator
    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training

    gp = bench._generation_params(8, gamma_mrf=0.031)
    with tempfile.TemporaryDirectory() as root:
        bench.make_textured_scene(root + "/scene_1")
        sg = RayNetSampleGenerator(
            make_sampling_scheme("sample_in_bbox", gp, device=dev), gp, [0],
            *get_input_output_shapes("default")(gp), window=2,
            rng=np.random.RandomState(0), device=dev)
        batch = RayNetBatchProvider(RestrepoDataset(root, device=dev),
                                    sg).get_batch_of_rays(8)
    state, train_fn, _ = build_end_to_end_training(
        0, gp, gp.grid_shape, lr=5e-3, gamma=0.031, train_with_gamma=True,
        bp_iterations=2, device=dev)
    return [float(train_fn(state, batch)[1]["loss"]) for _ in range(steps)]


def phase_quality(check, dev, counters, smi):
    """Phase 15b: the training-quality bench on the card at bench.py's sizes
    (``tools.bench_training_quality``): bench.py's four metrics, the seconds
    of each run, the K3 launches of the end-to-end run. Returns (summary, K3
    rows launches)."""
    import torch

    from raynet_tpu_torch.tools import bench_training_quality as bench

    q = QUALITY
    log("== 15b. training quality on the card (bench.py's sizes): "
        "pretraining %d steps, %d training and %d validation samples, D = 8; "
        "end to end %d iterations of 8 rays, 2 BP iterations, gamma from "
        "0.031" % (q["steps"], q["n_train"], q["n_val"], q["iterations"]))
    launches = {}
    seconds = {}
    results = {}
    for part, fn, kwargs in (
            ("pretrain", bench.pretrain_quality,
             {k: q[k] for k in ("steps", "n_train", "n_val")}),
            ("e2e", bench.e2e_quality, {"iterations": q["iterations"]})):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[part] = fn(device=dev, **kwargs)
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t0
        launches[part] = {k: c.launches for k, c in counters.items()}
        log("  %s: %.3f s, %s, launches %s"
            % (part, seconds[part], results[part], launches[part]))
    metrics = {k: v for k, (v, _) in bench.quality_metrics(
        results["pretrain"], results["e2e"]).items()}
    log("  card: %s" % smi)
    for name, value in metrics.items():
        log("  %-22s %.6f (%.3f s); TPU v5e, BENCH_r05, comparison only: %s"
            % (name, value, seconds[name.split("_")[0]], TPU_QUALITY[name]))
    check(all(np.isfinite(v) for r in results.values() for v in r.values()),
          "every quality metric finite")
    check(metrics["pretrain_val_acc"] > 1.0 / 8,
          "pretrain_val_acc %.4f above chance, 1/8"
          % metrics["pretrain_val_acc"])
    check(metrics["e2e_gamma_moved"] > 1e-4,
          "gamma moved by %.6f > 1e-4" % metrics["e2e_gamma_moved"])
    rows = launches["e2e"]["voxel_traversal_flat"]
    check(not any(launches["pretrain"].values())
          and rows >= q["iterations"]
          and all(v == 0 for k, v in launches["e2e"].items()
                  if k != "voxel_traversal_flat"),
          "K3's rows mode launched once per e2e batch (%d launches for %d "
          "batches), no kernel in pretraining" % (rows, q["iterations"]))
    ratio = metrics["e2e_train_loss_ratio"]
    log("  bench.py's e2e ratio, last 3 over first 3 iterations (fresh "
        "8-ray batches): %.4f, the loss %s" % (
            ratio, "fell" if ratio < 1 else "did not fall"))
    fixed = fixed_batch_losses(dev)
    check(bool(np.isfinite(fixed).all())
          and np.mean(fixed[-3:]) < np.mean(fixed[:3]),
          "the e2e step lowers the loss on one fixed 8-ray batch: last 3 "
          "of 12 steps %.5f, first 3 %.5f" % (np.mean(fixed[-3:]),
                                             np.mean(fixed[:3])))
    return {"metrics": metrics, "seconds": seconds, "pretrain":
            results["pretrain"], "e2e": results["e2e"], "launches": launches,
            "fixed_batch_losses": fixed, "tpu_v5e_bench_r05": TPU_QUALITY,
            "sizes": q}, rows


# Phase 16: the multi-GPU path. Two ranks on the one card use gloo (NCCL
# will not put two ranks on one GPU); NCCL runs at world size 1.
MULTI_RANKS = 2


def _sharded_pass_rank(group, out_dir, rig):
    """Phase 16 (a), one rank: phase 6's raynet pass on the ring rig ``rig``
    (height, width, focal) on this rank's span of each image's rays, once
    untimed, then timed with the kernel counters and the group's collective
    counts set to 0 just before it."""
    import torch

    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
    from raynet_tpu_torch.tools import time_kernels

    scene = RingScene(6, *rig, angle_origin=1, seed=0)
    model = FeatureExtractor("simple_cnn", seed=0,
                             output_dtype=torch.bfloat16, device=group.device)
    out = _sharded_pass(group, model, time_kernels.generation_params(), scene)
    np.save(os.path.join(out_dir, "maps%d.npy" % group.rank), out.pop("maps"))
    with open(os.path.join(out_dir, "rank%d.json" % group.rank), "w") as f:
        json.dump(out, f)


def _sharded_pass(group, model, gp, scene):
    """The raynet pass through ``group`` (warm-up, then the timed pass):
    its maps, wall, phases, kernel launches and collectives."""
    import torch

    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.ops.bp_sweep import bp_sweep
    from raynet_tpu_torch.ops.cost_volume import cost_volume
    from raynet_tpu_torch.ops.entry_conv3d import entry_conv3d
    from raynet_tpu_torch.ops.planesweep import plane_sweep_scores
    from raynet_tpu_torch.ops.prob_conv3d import prob_conv3d
    from raynet_tpu_torch.ops.ray_marching import voxel_traversal_flat
    from raynet_tpu_torch.ops.transposed_conv3d import transposed_conv3d
    from raynet_tpu_torch.ops.voxel_depth import voxel_argmax_depth
    from raynet_tpu_torch.tools.time_kernels import N_RAYS

    counters = {"plane_sweep_scores": plane_sweep_scores,
                "voxel_traversal_flat": voxel_traversal_flat,
                "voxel_argmax_depth": voxel_argmax_depth,
                "bp_sweep": bp_sweep, "cost_volume": cost_volume,
                "transposed_conv3d": transposed_conv3d,
                "entry_conv3d": entry_conv3d, "prob_conv3d": prob_conv3d}
    list(RayNetForwardPass(model, gp, None, scene.image_shape, N_RAYS,
                           device=group.device).forward_pass(scene, (0, 2, 1)))
    fp = RayNetForwardPass(model, gp, None, scene.image_shape, N_RAYS,
                           device=group.device)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    for c in counters.values():
        c.launches = 0
    bp_sweep.sums_read = 0
    group.reset_counts()
    t0 = time.perf_counter()
    maps = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
    wall = time.perf_counter() - t0
    lo, hi = group.span(int(np.prod(scene.image_shape)))
    return {"maps": maps, "wall_s": wall, "rank": group.rank,
            "world_size": group.world_size, "rows_per_image": hi - lo,
            "sharded": fp.ray_group is group,
            "launches": {k: c.launches for k, c in counters.items()},
            "sums_read": bp_sweep.sums_read,
            "grid_all_reduces": group.grid_all_reduces,
            "all_reduces": group.all_reduces,
            "collective_s": group.collective_s,
            "phases_s": {k: v["total_s"]
                         for k, v in fp.timer.summary().items()}}


def _sharded_step_rank(group, out_dir, widths):
    """Phase 16 (c), one rank: one end-to-end step at ``widths`` (E2E's)
    on this rank's part of phase 14's fixed batch (``batch.npz``)."""
    import torch

    from raynet_tpu_torch.parallel import sharding

    batch = dict(np.load(os.path.join(out_dir, "batch.npz")))
    part = sharding.shard_e2e_batch(group, batch)
    t0 = time.perf_counter()
    result = _e2e_step(group.device, part, widths, group)
    result["wall_s"] = time.perf_counter() - t0
    result["rows"] = int(part["y"].shape[0])
    result["collective_s"] = group.collective_s
    result["grid_all_reduces"] = group.grid_all_reduces
    torch.save(result, os.path.join(out_dir, "step%d.pt" % group.rank))


def _e2e_step(dev, batch, widths, group=None):
    """One end-to-end step of phase 14's state (seed 27, gamma 0.05) at
    ``widths`` (E2E's D and grid) on ``batch``, in one process or through
    ``group``: the loss, gamma after the update, the gradients (in the
    state dict's names; gamma's as "gamma") and the CNN's state dict after
    the update, on the CPU."""
    import torch

    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training

    gp = GenerationParameters(depth_planes=widths["D"], neighbors=4,
                              patch_shape=(11, 11, 3))
    state, train, _ = build_end_to_end_training(
        27, gp, widths["grid"], lr=1e-3, gamma=0.05, train_with_gamma=True,
        bp_iterations=3, return_grads=True, device=dev, ray_group=group)
    if group is not None:
        group.reset_counts()
    state, m = train(state, batch)
    grads = {k: g.detach().cpu() for k, g in m["grads"]["cnn"].items()}
    grads["gamma"] = m["grads"]["gamma"].detach().cpu()
    return {"loss": float(m["loss"]), "gamma": state.gamma.item(),
            "grads": grads,
            "model": {k: v.detach().cpu()
                      for k, v in state.model.state_dict().items()}}


def _e2e_grads64(dev, batch, widths):
    """The float64 gradients of ``_e2e_step``'s step (the CNN, its
    patches and gamma in float64), on the CPU, in its names."""
    import torch

    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.models.losses import emd
    from raynet_tpu_torch.train.train_e2e import (
        batch_to_device,
        build_end_to_end_training,
        raynet_forward,
    )

    gp = GenerationParameters(depth_planes=widths["D"], neighbors=4,
                              patch_shape=(11, 11, 3))
    state, _, _ = build_end_to_end_training(
        27, gp, widths["grid"], lr=1e-3, gamma=0.05, train_with_gamma=True,
        bp_iterations=3, device=dev)
    model = state.model.double()
    gamma = torch.tensor(0.05, dtype=torch.float64, device=dev,
                         requires_grad=True)
    t = batch_to_device(batch, dev)
    S, _ = raynet_forward(model, gamma, t["X"].double(), t["points"],
                          t["ray_voxel_indices"], t["ray_voxel_count"],
                          t["bbox"], widths["grid"])
    emd(t["y"].double(), S).mean().backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    grads["gamma"] = gamma.grad.cpu()
    return grads


def phase_multi_gpu(check, dev, model, gp, scene, small, phase6, expect,
                    e2e_batch):
    """Phase 16: the sharded raynet pass on 2 gloo ranks on the card and at
    world size 1 over NCCL, both held to phase 6's maps (``phase6``: maps
    and wall) and its launches ``expect`` per rank; the sharded end-to-end
    step on 2 gloo ranks held to the card's step in one process;
    raynet_forward_torch under torchrun against the one-process CLI."""
    import contextlib
    import io

    import torch

    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.parallel import sharding
    from raynet_tpu_torch.scripts import forward_pass as cli

    out = {}
    sweeps = 2 * RayNetForwardPass.bp_iterations
    torch.cuda.empty_cache()

    def pass_checks(label, r, maps):
        agree = rel_agreement(maps, phase6["maps"], 1e-3)
        same = bool(np.array_equal(maps > 0, phase6["maps"] > 0))
        log("  %s rank %d of %d: wall %.4f s (phase 6: %.4f s), %d rays an "
            "image, collectives %.4f s (%d grid all-reduces of %d), phases %s"
            % (label, r["rank"], r["world_size"], r["wall_s"],
               phase6["wall_s"], r["rows_per_image"], r["collective_s"],
               r["grid_all_reduces"], r["all_reduces"],
               ", ".join("%s %.4f" % kv for kv in r["phases_s"].items())))
        check(r["sharded"] and r["launches"] == expect,
              "%s rank %d: sharded pass, launches %s (expect %s)"
              % (label, r["rank"], r["launches"], expect))
        check(r["sums_read"] == sweeps,
              "%s rank %d: %d K2 launches read the stored ray sums (2 "
              "images x the 3 sweeps after the first)"
              % (label, r["rank"], r["sums_read"]))
        check(r["grid_all_reduces"] == sweeps,
              "%s rank %d: %d grid all-reduces (2 images x 3 sweeps)"
              % (label, r["rank"], r["grid_all_reduces"]))
        check(maps.shape == phase6["maps"].shape and same and agree >= 0.999,
              "%s rank %d: maps %s against phase 6's: %.6f within 1e-3 "
              "relative, masks identical: %s"
              % (label, r["rank"], maps.shape, agree, same))
        return dict(r, agreement=agree)

    # (a) 2 ranks over gloo, both on the card
    log("== 16a. the sharded raynet pass, %d ranks over gloo on %s (NCCL "
        "will not put two ranks on one GPU): phase 6's configuration"
        % (MULTI_RANKS, dev))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sharding.launch(_sharded_pass_rank, MULTI_RANKS, str(dev),
                        args=(tmp, tuple(scene.image_shape) + (float(
                            scene.get_image(0).camera.K[0, 0]),)),
                        backend="gloo")
        launch_s = time.perf_counter() - t0
        ranks = []
        for r in range(MULTI_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res = json.load(f)
            maps = np.load(os.path.join(tmp, "maps%d.npy" % r))
            ranks.append(pass_checks("gloo", res, maps))
            if r == 0:
                maps0 = maps
            else:
                check(bool(np.array_equal(maps, maps0)),
                      "gloo rank %d holds rank 0's maps" % r)
        del maps0, maps
    log("  the launch (%d spawned processes, their set-up included): %.1f s"
        % (MULTI_RANKS, launch_s))
    out["gloo_pass"] = {"ranks": ranks, "launch_s": launch_s}

    # (b) world size 1 over NCCL, the same sharded code, in this process
    log("== 16b. the sharded raynet pass at world size 1 over NCCL")
    with tempfile.TemporaryDirectory() as tmp:
        # NCCL: make_ray_group's backend for a CUDA device
        group = sharding.make_ray_group(
            dev, init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=0, world_size=1)
        try:
            r = _sharded_pass(group, model, gp, scene)
        finally:
            group.close()
    out["nccl_pass"] = pass_checks("nccl", r, r.pop("maps"))

    # (c) the sharded end-to-end step on 2 gloo ranks
    log("== 16c. one end-to-end step on phase 14's fixed %d-ray batch split "
        "over %d gloo ranks (grid %s, M = %d, 3 BP iterations), against the "
        "card's step in one process"
        % (e2e_batch["y"].shape[0], MULTI_RANKS,
           "x".join(map(str, E2E["grid"])), E2E["M"]))
    widths = {"D": E2E["D"], "grid": E2E["grid"]}
    one = _e2e_step(dev, e2e_batch, widths)
    exact = _e2e_grads64(dev, e2e_batch, widths)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "batch.npz"), **e2e_batch)
        t0 = time.perf_counter()
        sharding.launch(_sharded_step_rank, MULTI_RANKS, str(dev),
                        args=(tmp, widths), backend="gloo")
        launch_s = time.perf_counter() - t0
        steps = [torch.load(os.path.join(tmp, "step%d.pt" % r))
                 for r in range(MULTI_RANKS)]
    scale = max(float(g.abs().max()) for g in exact.values())

    def err64(g, k):
        # a leaf's max error against float64, in units of the largest entry
        return float((g.double() - exact[k]).abs().max()) / scale

    one64 = {k: err64(g, k) for k, g in one["grads"].items()}
    worst, far = {}, {}
    for r, st in enumerate(steps):
        # the JAX test's bars against the one-process step: each leaf's
        # excess over rtol 1e-4 / atol 1e-5 of the largest entry (a reading)
        worst[r] = max(((k, float(((g - one["grads"][k]).abs() - 1e-4
                                   * one["grads"][k].abs()).max()) / scale
                         - 1e-5) for k, g in st["grads"].items()),
                       key=lambda kv: kv[1])
        # the check: each leaf no farther from float64 than twice the
        # one-process step's error plus 1e-5 of the largest entry
        errs = {k: err64(g, k) for k, g in st["grads"].items()}
        far[r] = max(errs[k] - 2 * one64[k] - 1e-5 for k in errs)
        leaf = max(errs, key=errs.get)
        stats = [k for k in one["model"] if "running" in k]
        bn = max(float(((st["model"][k] - one["model"][k]).abs()
                        - 1e-5 * one["model"][k].abs()).max())
                 for k in stats)
        log("  rank %d: %d rays, step %.3f s (cold, in a new process), "
            "collectives %.4f s (%d grid all-reduces); loss %.8f (one process "
            "%.8f), gamma %.8f (%.8f); gradients against float64: farthest "
            "leaf %s %.3e of the largest entry (one process %.3e; "
            "farthest of the one process %.3e); against the one-process "
            "step: worst leaf %s over the JAX test's bars by %.3e; BatchNorm "
            "statistics worst excess over rtol 1e-5 %.3e"
            % (r, st["rows"], st["wall_s"], st["collective_s"],
               st["grid_all_reduces"], st["loss"], one["loss"], st["gamma"],
               one["gamma"], leaf, errs[leaf], one64[leaf],
               max(one64.values()), worst[r][0], worst[r][1], bn))
        check(abs(st["loss"] - one["loss"]) <= 1e-6 + 1e-5 * abs(one["loss"])
              and abs(st["gamma"] - one["gamma"])
              <= 1e-7 + 1e-5 * abs(one["gamma"]),
              "rank %d: loss and gamma within rtol 1e-5 of the one-process "
              "step" % r)
        check(far[r] <= 0.0, "rank %d: every gradient leaf within twice "
              "the one-process step's error against float64 plus 1e-5 of "
              "the largest entry" % r)
        check(bn <= 1e-7, "rank %d: BatchNorm running statistics within "
              "rtol 1e-5, atol 1e-7" % r)
    check(all(torch.equal(v, steps[0]["model"][k])
              for st in steps[1:] for k, v in st["model"].items())
          and all(st["gamma"] == steps[0]["gamma"] for st in steps),
          "every rank's parameters, BatchNorm statistics and gamma equal")
    out["e2e_step"] = {
        "launch_s": launch_s, "loss": [st["loss"] for st in steps],
        "one_process_loss": one["loss"],
        "gamma": [st["gamma"] for st in steps], "one_process_gamma":
        one["gamma"], "step_s": [st["wall_s"] for st in steps],
        "collective_s": [st["collective_s"] for st in steps],
        "grad_err_f64_one_process": max(one64.values()),
        "grad_err_f64": {r: max(err64(g, k) for k, g in st["grads"].items())
                         for r, st in enumerate(steps)},
        "grad_excess_jax_bars": {r: w[1] for r, w in worst.items()}}
    del one, steps, exact

    # (d) raynet_forward_torch under torchrun against one process
    log("== 16d. raynet_forward_torch --forward_pass_factory raynet under "
        "torchrun --standalone --nproc_per_node 1 (NCCL), on the 400x300 "
        "rig on disk, against the CLI in one process")
    with tempfile.TemporaryDirectory() as tmp:
        data = write_restrepo_scene(small, os.path.join(tmp, "data"))
        flags = ["--scene_idx", "0", "--forward_pass_factory", "raynet",
                 "--start_end", "0,2", "--depth_planes", str(gp.depth_planes),
                 "--grid_shape", ",".join(str(g) for g in gp.grid_shape),
                 "--maximum_number_of_marched_voxels",
                 str(gp.max_number_of_marched_voxels), "--device", dev.type]
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([data, os.path.join(tmp, "one")] + flags)
        t0 = time.perf_counter()
        run_ = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m",
             "raynet_tpu_torch.scripts.forward_pass", data,
             os.path.join(tmp, "torchrun")] + flags,
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        torchrun_s = time.perf_counter() - t0
        check(run_.returncode == 0, "torchrun exit %d%s" % (
            run_.returncode, "" if run_.returncode == 0
            else ": " + run_.stderr[-2000:]))
        maps = {k: np.stack([np.load(os.path.join(tmp, k, "depth_%03d.npy"
                                                  % i)) for i in range(2)])
                for k in ("one", "torchrun")}
    agree = rel_agreement(maps["torchrun"], maps["one"], 1e-3)
    same = bool(np.array_equal(maps["torchrun"] > 0, maps["one"] > 0))
    log("  torchrun %.1f s (its processes' set-up included); %d 'saved' "
        "lines; maps %.6f within 1e-3 relative of the one-process CLI's, "
        "masks identical: %s" % (torchrun_s, run_.stdout.count("saved "),
                                  agree, same))
    check(run_.stdout.count("saved ") == 2 and same and agree >= 0.999,
          "the torchrun CLI printed 2 maps and they agree with the "
          "one-process CLI's")
    out["torchrun_cli"] = {"wall_s": torchrun_s, "agreement": agree}
    return out


MVS_PLANES = 256
MVS_VIEWS = 8


def phase_mvsnet(check, dev, counters):
    """Phase 17: the ``mvsnet`` pass (``get_forward_pass_factory``) on an
    8-image 1600x1200 ring, every image a reference view with its 4
    nearest, D = 256, an ``MVSNetModel`` at its published widths with
    seeded weights: the kernel launches set to 0 just before the timed
    pass and read just after (K4 once a view, K5 three times, K6 once, K7
    once, no other kernel), its ``volumes``, wall time, phases and peak
    memory, the
    maps' shape and range; then K4 on view 0's card features against its
    plain version on the same card tensors, each timed, beside its bound;
    then K5 at each of the U-Net's three upsampling layers (seeded inputs
    at the pass's shapes) against its plain version, timed beside its
    bound, the plain version, cuDNN's transposed conv with the ReLU and
    skip sum (what the pass ran before K5) and the 8 sub-pixel forward
    convs (a control); then K6 (``phase_k6``) and K7 (``phase_k7``)."""
    import torch

    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.inference import get_forward_pass_factory
    from raynet_tpu_torch.models.mvsnet import MVSNetModel
    from bench_torch import mvs_roofline, roofline
    from raynet_tpu_torch.ops import cost_volume as cv
    from raynet_tpu_torch.tools.time_kernels import time_ms

    scene = RingScene(MVS_VIEWS, 1200, 1600, 2750.0, angle_step=0.04,
                      bbox_half=6.5, seed=0)
    top, left, h, w = cv.crop_window(*scene.image_shape)
    H, W = h // cv.STRIDE, w // cv.STRIDE
    log("== 17. mvsnet on the card: MVSNetModel (feature net 8/16/32, "
        "U-Net 8/16/32/64, seeded weights), %d images of 1600x1200 cropped "
        "to %dx%d, each a reference view with its 4 nearest, D = %d"
        % (MVS_VIEWS, w, h, MVS_PLANES))
    gp = GenerationParameters(depth_planes=MVS_PLANES, neighbors=4)
    model = MVSNetModel(seed=5, device=dev)
    factory = get_forward_pass_factory("mvsnet")
    # one untimed pass first, so that the timed pass finds the allocator
    # and cuDNN's choices warm; the timed instance computes its features
    # anew
    list(factory(model, gp, None, scene.image_shape, device=dev)
         .forward_pass(scene, (0, MVS_VIEWS, 1)))
    fp = factory(model, gp, None, scene.image_shape, device=dev)
    torch.cuda.synchronize()
    card = card_state()
    log("  card before the pass (SM clock, temperature, power): " + card)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    maps = np.stack(list(fp.forward_pass(scene, (0, MVS_VIEWS, 1))))
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    phases = {k: v["total_s"] for k, v in fp.timer.summary().items()}
    pixels = MVS_VIEWS * H * W
    log("  wall %.3f s, %.0f depth pixels/s (%d); peak device memory %.2f "
        "GB; launches %s" % (wall, pixels / wall, pixels, peak_gb, launches))
    for k, v in phases.items():
        log("  phase %-28s %.3f s" % (k, v))
    per_view = {"cost_volume": 1, "transposed_conv3d": 3, "entry_conv3d": 1,
                "prob_conv3d": 1}
    expect = {k: MVS_VIEWS * per_view.get(k, 0) for k in counters}
    check(launches == expect, "mvsnet: K4 launched once a view, K5 three "
          "times, K6 once, K7 once, no other kernel: launches %s"
          % (launches,))
    check(fp.volumes == MVS_VIEWS, "mvsnet: %d cost volumes built, one a "
          "view" % fp.volumes)
    P0 = cv.feature_cameras([scene.get_image(0).camera.P], top, left)
    z = cv.plane_depths(P0[0], scene.bbox, MVS_PLANES)
    check(maps.shape == (MVS_VIEWS, H, W) and bool(np.isfinite(maps).all())
          and bool((maps[0] >= z[0] - 1e-3).all())
          and bool((maps[0] <= z[-1] + 1e-3).all()),
          "mvsnet: depth maps %s finite, view 0's within its planes "
          "[%.3f, %.3f]: [%.3f, %.3f]" % (maps.shape, z[0], z[-1],
                                          maps[0].min(), maps[0].max()))
    out = {"wall_s": wall, "px_per_s": pixels / wall, "phases_s": phases,
           "peak_device_gb": peak_gb, "launches": launches,
           "card_before": card}
    del fp, maps

    # K4 alone on view 0's view set, at the pass's shape
    views = scene.get_view_idxs(0, 4)
    images = np.stack([scene.get_image(j).image_u8[top:top + h,
                                                   left:left + w]
                       for j in views])
    feats = model.predict(images)
    P = cv.feature_cameras([scene.get_image(j).camera.P for j in views],
                           top, left)
    depths = torch.as_tensor(cv.plane_depths(P[0], scene.bbox, MVS_PLANES),
                             device=dev)
    homs = torch.as_tensor(cv.homographies(P), device=dev)
    before = cv.cost_volume.launches
    got = cv.cost_volume(feats, homs, depths)
    check(cv.cost_volume.launches == before + 1, "K4: one launch counted")
    want = cv.cost_volume_reference(feats, homs, depths)
    close = float(torch.isclose(got, want, rtol=1e-5, atol=1e-6)
                  .float().mean())
    err = float((got - want).abs().max())
    check(tuple(got.shape) == (1, 32, MVS_PLANES, H, W)
          and bool(torch.isfinite(got).all()) and close >= 0.999,
          "K4 on features %s, D = %d, against its plain version on the "
          "card: %.7f of the values within rtol 1e-5, atol 1e-6 (bar "
          "0.999), max abs err %.3e" % (tuple(feats.shape), MVS_PLANES,
                                         close, err))
    del got, want
    ms = time_ms(lambda: cv.cost_volume(feats, homs, depths))
    plain_ms = time_ms(lambda: cv.cost_volume_reference(feats, homs, depths),
                       repeats=3, warmup=1)
    # the benchmark's count of K4's work, behind cost_volume_roofline
    work = mvs_roofline.cost_volume_cost(len(views), feats.shape[-1],
                                         MVS_PLANES, H, W)
    bound_ms = 1e3 * roofline.bound_seconds(work)
    bound_by = roofline.bound_by(work)
    log("  K4 %.4f ms a launch, plain %.3f ms; bound %.4f ms (%s), %.1f%% "
        "of it" % (ms, plain_ms, bound_ms, bound_by, 100 * bound_ms / ms))
    out["k4"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "max_abs_err": err, "close_share": close}
    del feats, homs, depths
    out["k5"] = phase_k5(check, dev, (MVS_PLANES, H, W))
    out["k6"] = phase_k6(check, dev)
    out["k7"] = phase_k7(check, dev)
    return out


# K5's layers, MVSNet's c7, c9 and c11: (name, Cin, Cout, the input's
# downscale from the volume's (D, H, W))
K5_LAYERS = (("c7", 64, 32, 8), ("c9", 32, 16, 4), ("c11", 16, 8, 2))


def k5_cost(cin, cout, shape):
    """The work of K5 on a (cin, *shape) input: 2 x 27 x cin x cout
    multiply-adds an input voxel; bytes, the input, the weights and bias
    and the skip read once, the (cout, 2D, 2H, 2W) result written once."""
    from bench_torch import roofline

    voxels = math.prod(shape)
    nbytes = 4 * (cin * voxels + cin * cout * 27 + cout
                  + 2 * cout * 8 * voxels)
    return roofline.Cost(nbytes, 2 * 27 * cin * cout * voxels)


def subpixel_convs(x, w, out):
    """The control: a stride-2 transposed conv as 8 forward convs, one a
    parity class (per dim, the even outputs' 1 tap, the odd outputs' 2 on
    the input padded by one at the far end), each written into its class
    of ``out`` (1, Cout, 2D, 2H, 2W)."""
    import torch.nn.functional as F

    # the kernel's taps a class reads, in the forward conv's order
    taps = ([1], [2, 0])
    for pd in (0, 1):
        for ph in (0, 1):
            for pw in (0, 1):
                k = w[:, :, taps[pd]][:, :, :, taps[ph]][..., taps[pw]]
                y = F.conv3d(F.pad(x, (0, pw, 0, ph, 0, pd)),
                             k.transpose(0, 1))
                out[:, :, pd::2, ph::2, pw::2] = y
    return out


def phase_k5(check, dev, volume_shape):
    """K5 alone at each upsampling layer of the U-Net on a (D, H, W)
    volume: against its plain version (within 2**-18 of each output's sum
    of absolute terms, as the card test), each timed in place (the skip
    grows by the layer's output a call; the values stay finite), beside
    its bound, cuDNN's transposed conv with the ReLU and the skip sum, and
    the sub-pixel control."""
    import torch
    import torch.nn.functional as F

    from bench_torch import roofline
    from raynet_tpu_torch.ops import transposed_conv3d as tc
    from raynet_tpu_torch.tools.time_kernels import time_ms

    rows = {}
    for name, cin, cout, down in K5_LAYERS:
        shape = tuple(n // down for n in volume_shape)
        g = torch.Generator().manual_seed(cin)
        x = torch.relu(torch.randn((1, cin) + shape, generator=g)).to(dev)
        w = (torch.randn((cin, cout, 3, 3, 3), generator=g)
             * (2.0 / cin) ** 0.5).to(dev)
        b = (torch.randn((cout,), generator=g) * 0.1).to(dev)
        skip = torch.relu(torch.randn(
            (1, cout) + tuple(2 * n for n in shape), generator=g)).to(dev)
        scale = tc.transposed_conv3d_reference(x.abs(), w.abs(), b.abs(),
                                               skip.abs())
        want = tc.transposed_conv3d_reference(x, w, b, skip.clone())
        before = tc.transposed_conv3d.launches
        got = tc.transposed_conv3d(x, w, b, skip)
        launched = tc.transposed_conv3d.launches - before
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / scale).max())
        check(launched == 1 and bool(torch.isfinite(got).all())
              and rel <= 2.0 ** -18,
              "K5 %s (%d -> %d, input %s) against its plain version on the "
              "card: max abs err %.3e, %.3e of the terms' sum (bar 2**-18 = "
              "%.3e), launches %d" % (name, cin, cout, shape, err, rel,
                                      2.0 ** -18, launched))
        del scale, want
        # the subpixel control against the library layer, once
        ref = F.conv_transpose3d(x, w, None, stride=2, padding=1,
                                 output_padding=1)
        sub = subpixel_convs(x, w, torch.empty_like(ref))
        sub_err = float((sub - ref).abs().max())
        check(sub_err <= 1e-3 * float(ref.abs().max()),
              "K5 %s: the sub-pixel control computes the transposed conv "
              "(max abs err %.3e)" % (name, sub_err))
        del ref

        def library():
            y = F.conv_transpose3d(x, w, b, stride=2, padding=1,
                                   output_padding=1)
            return torch.relu_(y).add_(skip)

        ms = time_ms(lambda: tc.transposed_conv3d(x, w, b, skip))
        plain_ms = time_ms(lambda: tc.transposed_conv3d_reference(
            x, w, b, skip), repeats=3, warmup=1)
        library_ms = time_ms(library)
        subpixel_ms = time_ms(lambda: subpixel_convs(x, w, sub))
        work = k5_cost(cin, cout, shape)
        bound_ms = 1e3 * roofline.bound_seconds(work)
        bound_by = roofline.bound_by(work)
        log("  K5 %s %d -> %d, input %s: %.4f ms a launch, plain %.3f ms, "
            "cuDNN transposed conv + ReLU + skip %.4f ms, 8 sub-pixel convs "
            "%.4f ms; bound %.4f ms (%s), %.1f%% of it"
            % (name, cin, cout, shape, ms, plain_ms, library_ms,
               subpixel_ms, bound_ms, bound_by, 100 * bound_ms / ms))
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms,
                      "subpixel_ms": subpixel_ms, "max_abs_err": err,
                      "max_rel_err": rel, "input": list(shape)}
        del x, w, b, skip, got, sub
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "subpixel_ms")}
    total.update(bound_by="per layer", max_abs_err=max(
        r["max_abs_err"] for r in rows.values()), layers=rows)
    log("  K5 a volume (3 layers): %.4f ms, bound %.4f ms, %.1f%% of it; "
        "cuDNN %.4f ms" % (total["ms"], total["bound_ms"],
                           100 * total["bound_ms"] / total["ms"],
                           total["library_ms"]))
    return total


# K6's shapes, the U-Nets' entry layers c0: (name, Cin, (D, H, W))
K6_SHAPES = (("mvsnet", 32, (256, 296, 400)),
             ("cas_stage1", 32, (48, 296, 400)),
             ("cas_stage2", 16, (32, 592, 800)),
             ("cas_stage3", 8, (8, 1184, 1600)))
# the U-Net's other forward convs at MVSNet's volume: (name, Cin, Cout,
# stride, the input's downscale from the volume's (D, H, W), ReLU)
UNET_CONVS = (("c1", 8, 16, 2, 1, True), ("c2", 16, 16, 1, 2, True),
              ("c3", 16, 32, 2, 2, True), ("c4", 32, 32, 1, 4, True),
              ("c5", 32, 64, 2, 4, True), ("c6", 64, 64, 1, 8, True),
              ("prob", 8, 1, 1, 1, False))


def conv3d_cost(cin, cout, shape, stride=1):
    """The work of a 3x3x3 conv of padding 1 on a (cin, *shape) input:
    2 x 27 x cin x cout operations an output voxel; bytes, the input, the
    weights and bias read once, the output written once."""
    from bench_torch import roofline

    out = math.prod((n - 1) // stride + 1 for n in shape)
    nbytes = 4 * (cin * math.prod(shape) + cout * out + 27 * cin * cout
                  + cout)
    return roofline.Cost(nbytes, 2 * 27 * cin * cout * out)


def _float64_planes_err(x, w, b, got, relu):
    """The largest gap of a 3x3x3 conv's output planes (stride 1, padding
    1) to the float64 conv, as a share of each output's sum of absolute
    terms, at the first two, the middle three and the last two planes (at
    every plane of a volume of 8 or fewer): the float64 volume of MVSNet's
    whole layer would not fit beside it."""
    import torch
    import torch.nn.functional as F

    D = x.shape[2]
    spans = ([(0, 2), (D // 2 - 1, D // 2 + 2), (D - 2, D)] if D > 8
             else [(0, D)])
    wd = w.double()
    bd = None if b is None else b.double()
    rel = 0.0
    for lo, hi in spans:
        xs = x[:, :, max(lo - 1, 0):min(hi + 1, D)].double()
        xs = F.pad(xs, (0, 0, 0, 0, max(1 - lo, 0), max(hi + 1 - D, 0)))
        exact = F.conv3d(xs, wd, bd, padding=(0, 1, 1))
        if relu:
            exact = torch.relu(exact)
        scale = F.conv3d(xs.abs(), wd.abs(), None if bd is None else bd.abs(),
                         padding=(0, 1, 1))
        rel = max(rel, float(((got[:, :, lo:hi].double() - exact).abs()
                              / scale).max()))
    return rel


def _conv_kernel_phase(check, dev, tag, op, reference, cases, cout, relu):
    """A hand-written 3x3x3 conv kernel (stride 1, padding 1) alone at the
    shapes the passes run, on seeded inputs on the card: against its plain
    version over the whole volume and against the float64 conv3d at
    ``_float64_planes_err``'s planes, each within 2**-18 of each output's
    sum of absolute terms (as the card tests); one launch counted; timed
    beside its bound (``conv3d_cost``), the plain version and cuDNN's
    conv3d with the bias (and the ReLU where ``relu``), what the pass ran
    before the kernel. ``cases`` holds (name, Cin, (D, H, W), with a
    bias). Returns the rows by name and their totals."""
    import torch
    import torch.nn.functional as F

    from bench_torch import roofline
    from raynet_tpu_torch.tools.time_kernels import time_ms

    torch.backends.cudnn.allow_tf32 = False

    def library(x, w, b):
        y = F.conv3d(x, w, b, padding=1)
        return torch.relu_(y) if relu else y

    what = "conv3d + bias" + (" + ReLU" if relu else "")
    rows = {}
    for name, cin, shape, with_bias in cases:
        g = torch.Generator(device=dev).manual_seed(cin + shape[0])
        x = torch.relu(torch.randn((1, cin) + shape, generator=g,
                                   device=dev))
        w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
            * (2.0 / (27 * cin)) ** 0.5
        b = torch.randn((cout,), generator=g, device=dev) * 0.1 \
            if with_bias else None
        before = op.launches
        got = op(x, w, b)
        launched = op.launches - before
        want = reference(x, w, b)
        scale = reference(x, w.abs(), None if b is None else b.abs())
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / scale).max())
        del want
        lib = library(x, w, b)
        lib_rel = float(((got - lib).abs() / scale).max())
        del lib, scale
        rel64 = _float64_planes_err(x, w, b, got, relu)
        check(launched == 1 and bool(torch.isfinite(got).all())
              and rel <= 2.0 ** -18 and rel64 <= 2.0 ** -18,
              "%s %s (%d -> %d%s, input %s) on the card: against its plain "
              "version max abs err %.3e, %.3e of the terms' sum over the "
              "volume, against float64 %.3e at its planes (bar 2**-18 = "
              "%.3e; cuDNN %.3e), launches %d"
              % (tag, name, cin, cout, " + bias" if with_bias else "", shape,
                 err, rel, rel64, 2.0 ** -18, lib_rel, launched))
        del got
        ms = time_ms(lambda: op(x, w, b))
        library_ms = time_ms(lambda: library(x, w, b))
        plain_ms = time_ms(lambda: reference(x, w, b), repeats=1, warmup=0)
        work = conv3d_cost(cin, cout, shape)
        bound_ms = 1e3 * roofline.bound_seconds(work)
        bound_by = roofline.bound_by(work)
        log("  %s %s %d -> %d, input %s: %.4f ms a launch (%.1f TFLOP/s, "
            "%.0f GB/s), plain %.3f ms, cuDNN %s %.4f ms; bound %.4f ms "
            "(%s), %.1f%% of it (cuDNN %.1f%%)"
            % (tag, name, cin, cout, shape, ms, work.ops / ms / 1e9,
               work.nbytes / ms / 1e6, plain_ms, what, library_ms, bound_ms,
               bound_by, 100 * bound_ms / ms, 100 * bound_ms / library_ms))
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms,
                      "max_abs_err": err, "max_rel_err": rel,
                      "max_rel_err_float64": rel64,
                      "library_rel_err": lib_rel, "input": [cin, *shape],
                      "bias": with_bias}
        del x, w, b
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    total.update(bound_by="per shape", max_abs_err=max(
        r["max_abs_err"] for r in rows.values()), shapes=rows)
    log("  %s at the %d shapes: %.4f ms, bound %.4f ms, %.1f%% of it; "
        "cuDNN %.4f ms" % (tag, len(rows), total["ms"], total["bound_ms"],
                           100 * total["bound_ms"] / total["ms"],
                           total["library_ms"]))
    return total


def phase_k6(check, dev):
    """K6 at each U-Net entry layer c0 the passes run (MVSNet's and
    CasMVSNet's three stages), with its bias and ReLU, by
    ``_conv_kernel_phase``; then cuDNN alone at the U-Net's other forward
    convs (c1-c6, prob) on MVSNet's volume, each beside its bound: the
    split of the U-Net's forward convs by layer. TF32 off, as the port
    runs."""
    import torch
    import torch.nn.functional as F

    from bench_torch import roofline
    from raynet_tpu_torch.ops import entry_conv3d as ec
    from raynet_tpu_torch.tools.time_kernels import time_ms

    total = _conv_kernel_phase(
        check, dev, "K6", ec.entry_conv3d, ec.entry_conv3d_reference,
        [(name, cin, shape, True) for name, cin, shape in K6_SHAPES],
        cout=8, relu=True)
    convs = {}
    volume = K6_SHAPES[0][2]
    for name, cin, cout, stride, down, relu in UNET_CONVS:
        shape = tuple(n // down for n in volume)
        g = torch.Generator(device=dev).manual_seed(cout)
        x = torch.relu(torch.randn((1, cin) + shape, generator=g,
                                   device=dev))
        w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
            * (2.0 / (27 * cin)) ** 0.5
        b = torch.randn((cout,), generator=g, device=dev) * 0.1

        def conv():
            y = F.conv3d(x, w, b, stride=stride, padding=1)
            return torch.relu_(y) if relu else y

        ms = time_ms(conv)
        work = conv3d_cost(cin, cout, shape, stride)
        bound_ms = 1e3 * roofline.bound_seconds(work)
        log("  cuDNN %s %d -> %d, stride %d, input %s: %.4f ms (%.1f "
            "TFLOP/s); bound %.4f ms (%s), %.1f%% of it"
            % (name, cin, cout, stride, shape, ms, work.ops / ms / 1e9,
               bound_ms, roofline.bound_by(work), 100 * bound_ms / ms))
        convs[name] = {"library_ms": ms, "bound_ms": bound_ms,
                       "gflop": work.ops / 1e9, "input": [cin, *shape]}
        del x, w, b
    total["unet_convs"] = convs
    return total


# K7's shapes, the U-Nets' prob layers: (name, (D, H, W), with a bias)
K7_SHAPES = tuple((name, shape, name == "mvsnet")
                  for name, _, shape in K6_SHAPES)


def phase_k7(check, dev):
    """K7 at each U-Net prob layer the passes run (MVSNet's with its bias
    and CasMVSNet's three stages without), by ``_conv_kernel_phase``: no
    ReLU, cuDNN's conv3d with the bias what the pass ran before K7. TF32
    off, as the port runs."""
    from raynet_tpu_torch.ops import prob_conv3d as pc

    return _conv_kernel_phase(
        check, dev, "K7", pc.prob_conv3d, pc.prob_conv3d_reference,
        [(name, 8, shape, bias) for name, shape, bias in K7_SHAPES],
        cout=1, relu=False)


def phase_casmvsnet(check, dev, counters):
    """Phase 18: the ``casmvsnet`` pass on phase 17's 8-image 1600x1200
    ring (cropped to 1600x1184), every image a reference view with its 4
    nearest, a ``CasMVSNetModel`` at its published widths with seeded
    weights: the kernel launches set to 0 just before the timed pass and
    read just after (K4 three times a view, two of them in its per-pixel
    mode; K5 nine times a view; K6 three times; K7 three times; no other
    kernel), its
    ``volumes``, wall
    time, phases and peak memory, the maps' shape and range; then K4 at
    each stage's size on view 0's card features (stage 1 in the plane
    mode, stages 2 and 3 in the per-pixel mode around the pass's own
    depths) against its plain version, each timed beside its bound; then
    K4's plane mode at MVSNet's size against its per-pixel mode at a
    centre of 0, bit for bit."""
    import torch
    import torch.nn.functional as F

    from bench_torch import mvs_roofline, roofline
    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.inference import get_forward_pass_factory
    from raynet_tpu_torch.models import casmvsnet
    from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel
    from raynet_tpu_torch.ops import cost_volume as cv
    from raynet_tpu_torch.tools.time_kernels import time_ms

    scene = RingScene(MVS_VIEWS, 1200, 1600, 2750.0, angle_step=0.04,
                      bbox_half=6.5, seed=0)
    top, left, h, w = cv.crop_window(*scene.image_shape)
    log("== 18. casmvsnet on the card: CasMVSNetModel (FPN 8/16/32, three "
        "U-Nets of base 8, seeded weights), %d images of 1600x1200 cropped "
        "to %dx%d, each a reference view with its 4 nearest, D %s at "
        "interval ratios %s" % (MVS_VIEWS, w, h, casmvsnet.NDEPTHS,
                                casmvsnet.INTERVAL_RATIOS))
    gp = GenerationParameters(neighbors=4)
    model = CasMVSNetModel(seed=5, device=dev)
    factory = get_forward_pass_factory("casmvsnet")
    # an untimed pass first, as phase 17
    list(factory(model, gp, None, scene.image_shape, device=dev)
         .forward_pass(scene, (0, MVS_VIEWS, 1)))
    fp = factory(model, gp, None, scene.image_shape, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    cv.cost_volume.per_pixel_launches = 0
    t0 = time.perf_counter()
    maps = np.stack(list(fp.forward_pass(scene, (0, MVS_VIEWS, 1))))
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    per_pixel = cv.cost_volume.per_pixel_launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    phases = {k: v["total_s"] for k, v in fp.timer.summary().items()}
    pixels = MVS_VIEWS * h * w
    log("  wall %.3f s, %.0f depth pixels/s (%d); peak device memory %.2f "
        "GB; launches %s, %d of K4's per-pixel" % (
            wall, pixels / wall, pixels, peak_gb, launches, per_pixel))
    for k, v in phases.items():
        log("  phase %-28s %.3f s" % (k, v))
    per_view = {"cost_volume": 3, "transposed_conv3d": 9, "entry_conv3d": 3,
                "prob_conv3d": 3}
    expect = {k: MVS_VIEWS * per_view.get(k, 0) for k in counters}
    check(launches == expect and per_pixel == 2 * MVS_VIEWS,
          "casmvsnet: K4 three times a view (%d of them per-pixel, 2 a "
          "view), K5 nine times, K6 three times, K7 three times, no other "
          "kernel: launches %s" % (per_pixel, launches))
    check(fp.volumes == 3 * MVS_VIEWS, "casmvsnet: %d cost volumes built, "
          "three a view" % fp.volumes)
    P0 = cv.feature_cameras([scene.get_image(0).camera.P], top, left)
    near, far = cv.depth_range(P0[0], scene.bbox)
    # the last stage's hypotheses reach past the range by a few intervals
    slack = 8 * (far - near) / casmvsnet.NUM_DEPTH
    check(maps.shape == (MVS_VIEWS, h, w) and bool(np.isfinite(maps).all())
          and bool((maps >= near - slack).all())
          and bool((maps <= far + slack).all()),
          "casmvsnet: depth maps %s finite, within the depth range [%.3f, "
          "%.3f] and 8 intervals: [%.3f, %.3f]"
          % (maps.shape, near, far, maps.min(), maps.max()))
    out = {"wall_s": wall, "px_per_s": pixels / wall, "phases_s": phases,
           "peak_device_gb": peak_gb, "launches": launches,
           "per_pixel_launches": per_pixel}

    # K4 at each stage's size, on view 0's view set
    views = scene.get_view_idxs(0, 4)
    images = np.stack([scene.get_image(j).image_u8[top:top + h,
                                                   left:left + w]
                       for j in views])
    stage_feats = model.predict(images)
    depth0 = torch.as_tensor(maps[0], device=dev)
    rows = {}
    for stage, feats in enumerate(stage_feats):
        D = casmvsnet.NDEPTHS[stage]
        s = casmvsnet.STRIDES[stage]
        H, W = h // s, w // s
        P = cv.feature_cameras([scene.get_image(j).camera.P for j in views],
                               top, left, s)
        homs = torch.as_tensor(cv.homographies(P), device=dev)
        if stage == 0:
            depths = torch.as_tensor(cv.plane_depths(P[0], scene.bbox, D),
                                     device=dev)
            centre = None
        else:
            depths = casmvsnet.hypothesis_offsets(near, far, stage).to(dev)
            centre = F.interpolate(depth0[None, None], size=(H, W),
                                   mode="bilinear",
                                   align_corners=False)[0, 0].contiguous()
        args = (feats, homs, depths) + (() if centre is None else (centre,))
        got = cv.cost_volume(*args)
        want = cv.cost_volume_reference(*args)
        close = float(torch.isclose(got, want, rtol=1e-5, atol=1e-6)
                      .float().mean())
        err = float((got - want).abs().max())
        mode = "planes" if centre is None else "per-pixel"
        check(tuple(got.shape) == (1, feats.shape[-1], D, H, W)
              and bool(torch.isfinite(got).all()) and close >= 0.999,
              "K4 stage %d (%s) on features %s, D = %d, against its plain "
              "version on the card: %.7f of the values within rtol 1e-5, "
              "atol 1e-6 (bar 0.999), max abs err %.3e"
              % (stage + 1, mode, tuple(feats.shape), D, close, err))
        del got, want
        ms = time_ms(lambda: cv.cost_volume(*args))
        plain_ms = time_ms(lambda: cv.cost_volume_reference(*args),
                           repeats=3, warmup=1)
        work = mvs_roofline.cost_volume_cost(len(views), feats.shape[-1], D,
                                             H, W)
        if centre is not None:
            work = roofline.Cost(work.nbytes + 4 * H * W, work.ops)
        bound_ms = 1e3 * roofline.bound_seconds(work)
        log("  K4 stage %d (%s, %dx%d, C %d, D %d): %.4f ms a launch, plain "
            "%.3f ms; bound %.4f ms (%s), %.1f%% of it"
            % (stage + 1, mode, W, H, feats.shape[-1], D, ms, plain_ms,
               bound_ms, roofline.bound_by(work), 100 * bound_ms / ms))
        rows["stage%d" % (stage + 1)] = {
            "mode": mode, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": roofline.bound_by(work),
            "max_abs_err": err, "close_share": close}
    out["k4"] = rows
    del stage_feats, feats

    # the plane mode at MVSNet's size is the per-pixel mode at a centre of 0
    P = cv.feature_cameras([scene.get_image(j).camera.P for j in views],
                           top, left)
    H, W = h // cv.STRIDE, w // cv.STRIDE
    g = torch.Generator().manual_seed(7)
    feats = torch.randn((len(views), H, W, 32), generator=g).to(dev)
    homs = torch.as_tensor(cv.homographies(P), device=dev)
    depths = torch.as_tensor(cv.plane_depths(P[0], scene.bbox, MVS_PLANES),
                             device=dev)
    zero = torch.zeros((H, W), dtype=torch.float32, device=dev)
    same = bool(torch.equal(cv.cost_volume(feats, homs, depths),
                            cv.cost_volume(feats, homs, depths, zero)))
    check(same, "K4 at MVSNet's size (%dx%d, D %d, C 32): the plane mode "
          "equals the per-pixel mode at a centre of 0 bit for bit"
          % (W, H, MVS_PLANES))
    out["k4"]["plane_equals_per_pixel_at_zero"] = same
    return out


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
    from raynet_tpu_torch.ops import (
        cost_volume,
        cuda_build,
        entry_conv3d,
        prob_conv3d,
        transposed_conv3d,
    )
    from raynet_tpu_torch.ops.bp_sweep import (
        bp_sweep,
        bp_sweep_reference,
        ray_totals,
    )
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

    def bits(t):
        return t.view(torch.int32)

    def with_sums(label, seg, msgs, grid_acc, mode, k, gk, sums=None):
        # the launch the raynet pass makes: the first sweep of an image
        # writes its ray sums, the later sweeps read them. Held to the
        # counting launch ``k`` (grid ``gk``) on the same inputs: counts,
        # messages and depths bit for bit (NaN included), the grid as the
        # float atomics' order leaves it. Returns the sums.
        n = seg[0].shape[0]
        if sums is None:
            sums = (torch.zeros(n, dtype=torch.int32, device=dev),
                    torch.zeros(n, device=dev))
        gs = torch.zeros(G, device=dev)
        store = None
        if mode != "depth":
            store = (torch.zeros((n, M), device=dev) if msgs is None
                     else msgs.clone())
        read = bp_sweep.sums_read
        s_ = bp_sweep(*seg, store if mode == "message" else msgs, grid_acc,
                      gs, center, bbox, GRID, M, prior, mode,
                      messages_out=store, ray_sums=sums)
        torch.cuda.synchronize()
        name = "%s %s with stored ray sums" % (label, mode)
        check(s_[1] is sums[0] and bool(torch.equal(s_[1], k[1])),
              "%s: counts are the stored ones, equal to the counting "
              "launch's" % name)
        check(bp_sweep.sums_read == read + (mode != "first"),
              "%s: sums_read %d -> %d" % (name, read, bp_sweep.sums_read))
        if store is None:
            check(bool(torch.equal(bits(s_[2]), bits(k[2]))),
                  "%s: depths bit for bit the counting launch's" % name)
            return sums
        check(bool(torch.equal(bits(store), bits(k[0]))),
              "%s: messages bit for bit the counting launch's" % name)
        mostly_close(name + ": grid against the counting launch's", gs, gk)
        if mode == "first":
            t64 = torch.cat([
                ray_totals(seg[2][lo:hi], plain_voxel_scores(
                    bbox, seg[0][lo:hi], seg[1][lo:hi], seg[2][lo:hi], GRID,
                    M)[1], sums[0][lo:hi], seg[0][lo:hi], seg[1][lo:hi],
                    bbox, GRID)
                for lo, hi in spans(n)])
            same = float((bits(sums[1]) == bits(t64)).float().mean())
            check(bool(torch.allclose(sums[1], t64, rtol=1e-6, atol=0,
                                      equal_nan=True)),
                  "%s: totals within rtol 1e-6 of the plain float64 sums "
                  "(%.7f bit for bit)" % (name, same))
        return sums

    def k2_checks(label, seg, moderate):
        """K2 in its three modes on segments and scores ``seg``: the first
        sweep, then message mode (if ``moderate``) on a seeded grid and
        messages that keep mu moderate and on the real grid of the first
        sweep, then depth on the second sweep's output (and on the moderate
        inputs). Returns the per-mode errors and the first sweep's
        counts."""
        out = {}
        k, gk, (m1, _, _), g1 = sweep_both(label, seg, None, None, "first")
        mk, counts = k[0], k[1]
        sums = with_sums(label, seg, None, None, "first", k, gk)
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
        del mk, k
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
            k, gk, (mp, _, _), gpl = sweep_both(label, seg, mi, gi,
                                                "message")
            mk = k[0]
            with_sums(label, seg, mi, gi, "message", k, gk, sums)
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
            del mk, k, mp, m64
        del m1
        out["message"] = {"max_abs_err": errs.get("moderate mu"),
                          "real_grid_max_abs_err": errs["real grid"]}
        inputs = [("real grid", (m2, g2))] + inputs[:-1]
        agree = {}
        for what, (mi, gi) in inputs:
            k, gk, (_, _, dp), _ = sweep_both(label, seg, mi, gi, "depth")
            dk = k[2]
            with_sums(label, seg, mi, gi, "depth", k, gk, sums)
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
        rsi = times["K2 %s sums image" % mode]
        k2[mode]["sums_image_ms"] = rsi["ms"]
        log("  K2 %s: %.3f ms, plain %.3f ms; bound %.4f ms (%.1f MB); one "
            "whole image %.3f ms, with stored ray sums %.3f ms, bound %.4f ms "
            "(%.1f MB)"
            % (mode, r["ms"], r["plain_ms"], r["bound_ms"], r["nbytes"] / 1e6,
               ri["ms"], rsi["ms"], ri["bound_ms"], ri["nbytes"] / 1e6))
    del S_p, features

    # 6. the three passes end to end
    counters = {"plane_sweep_scores": plane_sweep_scores,
                "voxel_traversal_flat": voxel_traversal_flat,
                "voxel_argmax_depth": voxel_argmax_depth,
                "bp_sweep": bp_sweep,
                "cost_volume": cost_volume.cost_volume,
                "transposed_conv3d": transposed_conv3d.transposed_conv3d,
                "entry_conv3d": entry_conv3d.entry_conv3d,
                "prob_conv3d": prob_conv3d.prob_conv3d}
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
    # the extractor's folded BatchNorm is built once for all the passes
    fold_builds = model.fold_builds
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
        bp_sweep.sums_read = 0
        folded = model.folded_layers
        t0 = time.perf_counter()
        maps = list(fp.forward_pass(scene, (0, 2, 1)))
        wall = time.perf_counter() - t0
        folded = model.folded_layers - folded
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
        # view 0's map is waited for after view 1's work was queued
        check(fp.overlapped_views == 1, "%s: views overlapped %d of 2"
              % (name, fp.overlapped_views))
        # every K2 sweep of an image after its first reads the stored sums
        sums_expect = 2 * RayNetForwardPass.bp_iterations \
            if name == "raynet" else 0
        check(bp_sweep.sums_read == sums_expect,
              "%s: K2 launches reading stored ray sums %d of %d"
              % (name, bp_sweep.sums_read, launches["bp_sweep"]))
        # every conv of every image featurised runs with its BatchNorm folded
        images = fp.timer.counts["Features computation"]
        convs = len(model.model.convs)
        check(folded == convs * images,
              "%s: folded conv layers %d, %d for each of %d images"
              % (name, folded, convs, images))
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
            # phase 10 holds the host store to them, phase 16 the sharded
            # passes
            raynet_maps = allmaps
        del fp, maps, allmaps
        # five more walls, each of a pass with its features computed anew:
        # the spread a single wall hides on a shared host
        walls = []
        for _ in range(5):
            fp = cls(model, gp, None, scene.image_shape, N_RAYS, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            list(fp.forward_pass(scene, (0, 2, 1)))
            walls.append(time.perf_counter() - t0)
            del fp
        log("  5 more walls: median %.4f s [%.4f-%.4f]"
            % (float(np.median(walls)), min(walls), max(walls)))

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
        results[name] = {"wall_s": wall, "more_walls_s": walls,
                         "rays_per_s": n_rays / wall,
                         "peak_device_gb": peak_gb, "phases_s": phases,
                         "launches": launches, "agreement_400x300": agree,
                         "card_before": card}
        if name == "multi_view_cnn_voxel_space":
            voxel_small = maps_k
        del fp_k, fp_p, maps_k, maps_p

    check(model.fold_builds == fold_builds,
          "phase 6: BatchNorm fold built %d times before the passes, %d after"
          % (fold_builds, model.fold_builds))

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

    # 11. the evaluation CLIs on the card, and K3's rows mode through
    # ops.backends
    evaluation, rows_launches = phase_evaluation(
        check, dev, small, scene, counters,
        {k: passes[0][2].get(k, 0) for k in counters})

    # 12. hartmann_fp, on phase 7's rig cut to 200x150; 13. pretraining
    hartmann = phase_hartmann(
        check, dev, RingScene(6, 150, 200, 2750.0 / 8, angle_origin=1,
                              seed=0), counters)
    pretraining = phase_pretrain(check, dev, small)
    # 14. end-to-end training on phase 7's rig
    training, train_rows_launches, e2e_batch = phase_train(
        check, dev, small, counters)
    # 15. a Keras checkpoint through the raynet pass on phase 7's rig; the
    # training-quality bench
    keras = phase_keras(check, dev, small, gp, counters)
    quality, quality_rows_launches = phase_quality(check, dev, counters, smi)
    # 16. the multi-GPU path
    multi_gpu = phase_multi_gpu(
        check, dev, model, gp, scene, small,
        {"maps": raynet_maps, "wall_s": results["raynet"]["wall_s"]},
        {k: passes[0][2].get(k, 0) for k in counters}, e2e_batch)
    del raynet_maps, e2e_batch
    # 17. the mvsnet pass, K4, K5, K6 and K7
    mvsnet = phase_mvsnet(check, dev, counters)
    # 18. the casmvsnet pass and K4's per-pixel mode
    casmvs = phase_casmvsnet(check, dev, counters)

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
        # (phase 11) and once per batch by end-to-end training (phases 14
        # and 15b), the voxel-depth mode by the voxel-space pass
        kernel("voxel_traversal_flat", "traversal.cu",
               "raynet_tpu/ops/pallas/traversal.py:28",
               rows_launches + train_rows_launches + quality_rows_launches,
               k3_err, times["K3"],
               times["K3 image"], mode="rows",
               training_batch={k: training["k3_rows_batch"][k] for k in (
                   "ms", "plain_ms", "bound_ms", "bound_by", "rays")}),
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
        # one launch over a view set of the pass (phase 17)
        kernel("cost_volume", "cost_volume.cu",
               "none: new in the port, no TPU counterpart",
               mvsnet["launches"]["cost_volume"]
               + casmvs["launches"]["cost_volume"],
               mvsnet["k4"]["max_abs_err"], mvsnet["k4"],
               cascade_stages=casmvs["k4"]),
        # the three upsampling layers of a volume (phase 17), summed; per
        # layer under "layers"
        kernel("transposed_conv3d", "transposed_conv3d.cu",
               "none: new in the port, no TPU counterpart",
               mvsnet["launches"]["transposed_conv3d"]
               + casmvs["launches"]["transposed_conv3d"],
               mvsnet["k5"]["max_abs_err"], mvsnet["k5"],
               subpixel_ms=mvsnet["k5"]["subpixel_ms"],
               layers=mvsnet["k5"]["layers"]),
        # the entry conv c0 at its four shapes (phase 17), summed; per
        # shape under "shapes", cuDNN's other U-Net convs under
        # "unet_convs"
        kernel("entry_conv3d", "entry_conv3d.cu",
               "none: new in the port, no TPU counterpart",
               mvsnet["launches"]["entry_conv3d"]
               + casmvs["launches"]["entry_conv3d"],
               mvsnet["k6"]["max_abs_err"], mvsnet["k6"],
               shapes=mvsnet["k6"]["shapes"],
               unet_convs=mvsnet["k6"]["unet_convs"]),
        # the prob conv at its four shapes (phase 17), summed; per shape
        # under "shapes"
        kernel("prob_conv3d", "prob_conv3d.cu",
               "none: new in the port, no TPU counterpart",
               mvsnet["launches"]["prob_conv3d"]
               + casmvs["launches"]["prob_conv3d"],
               mvsnet["k7"]["max_abs_err"], mvsnet["k7"],
               shapes=mvsnet["k7"]["shapes"]),
    ]
    # strict JSON: a NaN here raises
    print(json.dumps({"bp_sweep_modes": k2, "voxel_depth": k3_depth,
                      "passes": results,
                      "probes": p2, "trace": traced,
                      "host_store": host_store, "evaluation": evaluation,
                      "hartmann_fp": hartmann, "pretraining": pretraining,
                      "training": training, "keras": keras,
                      "training_quality": quality, "multi_gpu": multi_gpu,
                      "mvsnet": mvsnet, "casmvsnet": casmvs},
                     allow_nan=False))
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

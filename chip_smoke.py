#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raynet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``raynet_tpu_torch/csrc`` and then, in
order, every phase failing loudly (nonzero exit):

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: seconds the nvcc build took;
3. K1 (plane sweep) against its plain PyTorch version on the card, on one
   65,536-ray batch of the rig below (V=5, D=32, F=32, bf16 features):
   feature cells, scores, and the median time of each;
4. K2 (fused BP sweep) against its plain version on the card in its three
   modes on the same batch (M=384, grid 128x128x64): counts, messages, the
   scattered grid, depths, and the times;
5. the raynet forward pass end to end through its user entry point
   (``RayNetForwardPass.forward_pass``) on the paper-resolution ring rig:
   1600x1200, focal 2750, 6 images, 2 reference views, 4 neighbours,
   simple_cnn with seeded random weights and bf16 features, D=32, grid
   128x128x64, M=384, 65,536-ray batches, gamma 0.05, 3 BP iterations and
   the depth sweep. Wall time, rays/s, phases, kernel launch counts (must
   be > 0), peak memory and the depth maps' sanity; then the same pass at
   400x300 (focal scaled) on the card and, with the plain versions, on the
   CPU, whose depth maps must agree.

The last two lines are the kernels' JSON summary and the card's name and
power limit before the final JSON line ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the repository around it, the script
exits nonzero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np

N_RAYS = 65536
GRID = (128, 128, 64)
M = 384
D = 32
GAMMA = 0.05
PADDING = 11


def log(*args):
    print(*args, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def cuda_ms(torch, fn, reps=7, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def generation_params():
    return types.SimpleNamespace(
        depth_planes=D, neighbors=4, padding=PADDING,
        grid_shape=np.array(GRID, dtype=np.int32),
        max_number_of_marched_voxels=M, gamma_mrf=GAMMA,
    )


def rel_agreement(a, b, rtol):
    """Share of entries with |a - b| <= rtol * |b|."""
    return float(np.mean(np.abs(a - b) <= rtol * np.abs(b)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from raynet_tpu_torch.common.ring_scene import RingScene
    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.models.feature_extractor import (
        FeatureExtractor,
        zeropad_images,
    )
    from raynet_tpu_torch.ops import cuda_build
    from raynet_tpu_torch.ops.bp_sweep import bp_sweep, bp_sweep_reference
    from raynet_tpu_torch.ops.mrf import log_prior
    from raynet_tpu_torch.ops.planesweep import (
        plane_sweep_cells_reference,
        plane_sweep_scores,
        plane_sweep_scores_reference,
    )
    from raynet_tpu_torch.ops.sampling import segments_in_bbox

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
    scene = RingScene(6, 1200, 1600, 2750.0, angle_origin=1, seed=0)
    H, W = scene.image_shape
    gp = generation_params()
    model = FeatureExtractor("simple_cnn", seed=0, output_dtype=torch.bfloat16,
                             device=dev)
    view_idxs = scene.get_view_idxs(0, gp.neighbors)
    images = [scene.get_image(j) for j in view_idxs]
    features = torch.stack(
        [model.predict(zeropad_images([im], PADDING))[0] for im in images]
    )

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    P = f32(np.stack([im.camera.P for im in images]))
    P_pinv = f32(images[0].camera.P_pinv)
    center = f32(images[0].camera.center[:3, 0])
    bbox = torch.as_tensor(scene.bbox.reshape(-1), device=dev)
    mid = H * W // 2
    ray_idxs = torch.arange(mid - N_RAYS // 2, mid + N_RAYS // 2,
                            dtype=torch.int32, device=dev)
    rs, re = segments_in_bbox(ray_idxs, P_pinv, center, bbox, H)
    ps_args = (features, P, rs, re, PADDING, H, W, D)

    # 3. K1
    log("== 3. K1 plane sweep vs plain, %d rays, features %s %s"
        % (N_RAYS, tuple(features.shape), features.dtype))
    S_k, cells_k = plane_sweep_scores(*ps_args, return_cells=True)
    S_p = plane_sweep_scores_reference(*ps_args)
    cells_p = plane_sweep_cells_reference(*ps_args[1:])
    torch.cuda.synchronize()
    cell_mism = int((cells_k != cells_p).any(dim=-1).sum())
    k1_err = float((S_k - S_p).abs().max())
    check(cell_mism == 0, "feature-cell mismatches %d (expect 0)" % cell_mism)
    check(k1_err <= 1e-5, "max |score diff| %.3e <= 1e-5" % k1_err)
    k1_ms = cuda_ms(torch, lambda: plane_sweep_scores(*ps_args))
    k1_plain_ms = cuda_ms(torch, lambda: plane_sweep_scores_reference(*ps_args))
    log("  K1 %.3f ms, plain %.3f ms (median of 7)" % (k1_ms, k1_plain_ms))

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
    # identical.
    log("== 4. K2 BP sweep vs plain, M=%d, grid %s" % (M, GRID))
    prior = float(log_prior(GAMMA))
    G = int(np.prod(GRID))
    valid = torch.ones(N_RAYS, dtype=torch.int32, device=dev)
    S = S_p.contiguous()
    k2 = {}

    def bp_args(msgs, grid_acc, grid_out, mode, S=S):
        return (rs, re, valid, S, msgs, grid_acc, grid_out, center, bbox,
                GRID, M, prior, mode)

    def sweep_both(msgs, grid_acc, mode):
        # both scatter the batch into a zero grid, as the forward pass does
        gk = torch.zeros(G, device=dev)
        gpl = torch.zeros(G, device=dev)
        k = bp_sweep(*bp_args(msgs, grid_acc, gk, mode))
        p_ = bp_sweep_reference(*bp_args(msgs, grid_acc, gpl, mode))
        torch.cuda.synchronize()
        check(bool(torch.equal(k[1], p_[1])),
              "%s: counts identical (mean count %.2f)"
              % (mode, float(p_[1].float().mean())))
        return k, gk, p_, gpl

    def strict(label, a, b):
        err = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5)),
              "%s allclose(rtol 1e-4, atol 1e-5), max err %.3e" % (label, err))
        return err

    def mostly_close(label, a, b):
        close = float(torch.isclose(a, b, rtol=1e-4, atol=1e-5).float().mean())
        check(close >= 0.9999, "%s: %.7f within rtol 1e-4, atol 1e-5"
              % (label, close))

    def as_accurate(label, kern, plain, exact):
        ek = (kern.double() - exact).abs()
        ep = (plain.double() - exact).abs()
        ok = bool(ek.max() <= 2 * ep.max() + 1e-5
                  and ek.mean() <= 2 * ep.mean() + 1e-6)
        check(ok, "%s vs float64: kernel max %.3e mean %.3e, plain max %.3e "
              "mean %.3e" % (label, ek.max(), ek.mean(), ep.max(), ep.mean()))

    def timed(mode, msgs, grid_acc):
        scratch = torch.zeros(G, device=dev)
        ms = cuda_ms(torch, lambda: bp_sweep(
            *bp_args(msgs, grid_acc, scratch, mode)))
        plain_ms = cuda_ms(torch, lambda: bp_sweep_reference(
            *bp_args(msgs, grid_acc, scratch, mode)), reps=5, warmup=1)
        log("  %s: K2 %.3f ms, plain %.3f ms" % (mode, ms, plain_ms))
        return ms, plain_ms

    # first iteration
    (mk, _, _), gk, (m1, _, _), g1 = sweep_both(None, None, "first")
    err = max(strict("first: messages", mk, m1), strict("first: grid", gk, g1))
    g1 = g1 + prior  # the next iteration's grid
    ms, plain_ms = timed("first", None, None)
    k2["first"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # message mode, well conditioned (seeded grid and messages)
    rng = np.random.RandomState(1)
    g_mod = f32(prior + 2.0 + rng.randn(G))
    m_mod = f32(0.5 * rng.randn(N_RAYS, M))
    errs = {}
    for label, (mi, gi) in (("moderate mu", (m_mod, g_mod)),
                            ("real grid", (m1, g1))):
        (mk, _, _), gk, (mp, _, _), gpl = sweep_both(mi, gi, "message")
        g64 = torch.zeros(G, dtype=torch.float64, device=dev)
        m64, _, _ = bp_sweep_reference(*bp_args(
            mi.double(), gi.double(), g64, "message", S=S.double()))
        if label == "moderate mu":
            mostly_close("message (%s): messages" % label, mk, mp)
            mostly_close("message (%s): grid" % label, gk, gpl)
        errs[label] = float((mk - mp).abs().max())
        as_accurate("message (%s): messages" % label, mk, mp, m64)
        as_accurate("message (%s): grid" % label, gk, gpl, g64)
        if label == "real grid":
            m2, g2 = mp, gpl + prior
        del mk, mp, m64
    ms, plain_ms = timed("message", m1, g1)
    k2["message"] = {"max_abs_err": errs["moderate mu"],
                     "real_grid_max_abs_err": errs["real grid"],
                     "ms": ms, "plain_ms": plain_ms}

    # depth on the second sweep's output, and on the moderate inputs
    depth_agree = {}
    for label, (mi, gi) in (("real grid", (m2, g2)),
                            ("moderate mu", (m_mod, g_mod))):
        (_, _, dk), _, (_, _, dp), _ = sweep_both(mi, gi, "depth")
        a, b = dk.cpu().numpy(), dp.cpu().numpy()
        depth_agree[label] = rel_agreement(a, b, 1e-3)
        check(depth_agree[label] >= 0.999 and np.array_equal(a > 0, b > 0),
              "depth (%s): %.6f of rays within 1e-3 relative, zero masks "
              "identical" % (label, depth_agree[label]))
    ms, plain_ms = timed("depth", m2, g2)
    k2["depth"] = {"agreement": depth_agree, "max_abs_err": float(
        np.abs(a - b).max()), "ms": ms, "plain_ms": plain_ms}
    del S_k, S_p, cells_k, cells_p, features, m_mod, m1, m2

    # 5. end to end
    log("== 5. raynet forward pass, %dx%d, 2 reference views of 6 images" % (W, H))
    fp = RayNetForwardPass(model, gp, None, scene.image_shape, N_RAYS,
                           device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    plane_sweep_scores.launches = 0
    bp_sweep.launches = 0
    t0 = time.perf_counter()
    maps = list(fp.forward_pass(scene, (0, 2, 1)))
    wall = time.perf_counter() - t0
    launches = {"plane_sweep": plane_sweep_scores.launches,
                "bp_sweep": bp_sweep.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_rays = 2 * H * W
    log("  wall %.3f s, %.0f rays/s (%d rays x 4 sweeps + plane sweep)"
        % (wall, n_rays / wall, n_rays))
    phases = {k: v["total_s"] for k, v in fp.timer.summary().items()}
    for k, v in fp.timer.summary().items():
        log("  phase %-28s %.3f s (%d)" % (k, v["total_s"], v["count"]))
    log("  launches", launches, "peak device memory %.2f GB" % peak_gb)
    check(all(v > 0 for v in launches.values()), "both kernels launched")
    allmaps = np.stack(maps)
    nz = allmaps[allmaps > 0]
    check(allmaps.shape == (2, H, W), "depth maps %s" % (allmaps.shape,))
    check(bool(np.isfinite(allmaps).all()), "all depths finite")
    share = nz.size / allmaps.size
    # the +-3 bbox covers roughly half the width and 70% of the height of
    # each view, so about a third of the rays reach the grid
    check(share > 0.1, "nonzero share %.4f" % share)
    if nz.size:
        log("  depth range [%.3f, %.3f]" % (nz.min(), nz.max()))
        check(nz.min() >= 10.0 and nz.max() <= 30.0,
              "depths inside the ring's camera-to-bbox range [10, 30]")
    del fp, maps

    small = RingScene(6, 300, 400, 2750.0 / 4, angle_origin=1, seed=0)
    fp_k = RayNetForwardPass(model, gp, None, small.image_shape, N_RAYS,
                             device=dev)
    t0 = time.perf_counter()
    maps_k = np.stack(list(fp_k.forward_pass(small, (0, 2, 1))))
    t_k = time.perf_counter() - t0
    # the same CNN (on the card) feeds the CPU pass: only the kernels differ
    fp_p = RayNetForwardPass(model, gp, None, small.image_shape, N_RAYS,
                             device="cpu")
    t0 = time.perf_counter()
    maps_p = np.stack(list(fp_p.forward_pass(small, (0, 2, 1))))
    t_p = time.perf_counter() - t0
    agree = rel_agreement(maps_k, maps_p, 1e-3)
    same_mask = bool(((maps_k > 0) == (maps_p > 0)).all())
    log("  400x300: kernels on the card %.3f s, plain on the CPU %.3f s" % (t_k, t_p))
    check(agree >= 0.999, "400x300 depth agreement %.6f within 1e-3 relative" % agree)
    check(same_mask, "400x300 zero/nonzero masks identical")

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "raynet_tpu"))
    check(not imported, "no JAX or raynet_tpu module imported %s" % imported)
    if failures:
        print("chip_smoke: %d check(s) failed: %s" % (len(failures), failures),
              file=sys.stderr)
        return 1

    kernels = [
        {"name": "plane_sweep_scores", "route": "cuda",
         "source": "raynet_tpu_torch/csrc/planesweep.cu",
         "replaces": "raynet_tpu/ops/pallas/planesweep.py:84",
         "launches": launches["plane_sweep"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "bp_sweep", "route": "cuda",
         "source": "raynet_tpu_torch/csrc/bp_sweep.cu",
         "replaces": "raynet_tpu/ops/pallas/bp_beam.py:1062",
         "launches": launches["bp_sweep"],
         # first iteration and moderate-mu message mode; per mode below
         "max_abs_err": max(k2["first"]["max_abs_err"],
                            k2["message"]["max_abs_err"]),
         "ms": k2["message"]["ms"], "plain_ms": k2["message"]["plain_ms"]},
    ]
    print(json.dumps({
        "bp_sweep_modes": k2,
        "end_to_end": {"wall_s": wall, "rays_per_s": n_rays / wall,
                       "peak_device_gb": peak_gb, "phases_s": phases,
                       "agreement_400x300": agree},
    }))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

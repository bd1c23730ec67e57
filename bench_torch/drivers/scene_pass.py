"""Driver of the forward-pass cells: one scene pass after another through
the program's own entry (``get_forward_pass_factory(config["factory"])``,
``forward_pass(scene, images_range)``), each with a new pass object, so
that every pass computes its features anew and nothing carries over.

Set-up: the scene and the CNN's weights from the seed (on the device),
the program's model and one warm-up pass, which builds the kernel library
on a checkout's first run and touches every shape the window uses. The
window: passes back to back for ``seconds``; a pass ends when its last
depth map is on the host. After it: the peak memory, then (``trace``)
the trace and the counts of the work, then, with the program's state
freed, the reference judges the depth maps of the first pass, the last
and one drawn from the seed.
"""
import contextlib
import random
import statistics
import time
import types

import numpy as np
import torch

from bench_torch import roofline
from bench_torch import scene as generator
from bench_torch import trace as tracing
from bench_torch.reference import plain

PASS = "bench.pass"


class Cell:
    """The scene, the weights and the program's model of one seed, and a
    pass through the program."""

    def __init__(self, config, traffic, seed, device):
        from raynet_tpu_torch.common.generation_parameters import (
            GenerationParameters,
        )
        from raynet_tpu_torch.inference.forward_pass import (
            get_forward_pass_factory,
        )
        from raynet_tpu_torch.models.feature_extractor import (
            FeatureExtractor,
        )

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.scene = generator.make_scene(traffic, seed, self.device)
        self.weights = generator.cnn_weights(config["cnn"]["layers"], 3,
                                             seed, self.device)
        self.model = FeatureExtractor(config["cnn"]["name"],
                                      state_dict=self.weights,
                                      device=self.device)
        self.params = GenerationParameters(
            depth_planes=config["depth_planes"],
            neighbors=config["neighbors"],
            patch_shape=tuple(config["patch_shape"]),
            grid_shape=np.array(config["grid_shape"], dtype=np.int32),
            max_number_of_marched_voxels=config["max_marched_voxels"],
            padding=config["padding"], gamma_mrf=config["gamma"])
        self.factory = get_forward_pass_factory(config["factory"])
        self.images_range = tuple(traffic["images_range"])

    def one_pass(self):
        """(depth maps, the pass's phase times) of one pass through a new
        pass object."""
        fp = self.factory(self.model, self.params, None,
                          self.scene.image_shape, self.config["rays_batch"],
                          device=self.device)
        if "bp_iterations" in self.config:
            fp.bp_iterations = self.config["bp_iterations"]
        with torch.profiler.record_function(PASS):
            maps = list(fp.forward_pass(self.scene, self.images_range))
        return maps, fp.timer.summary()

    @property
    def pixels_per_pass(self):
        H, W = self.scene.image_shape
        return len(range(*self.images_range)) * H * W


class Keep:
    """The depth maps the reference judges: the first pass's, the last's
    and one drawn from the seed among the others (reservoir sampling)."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.first = self.drawn = self.last = None
        self.seen = 0

    def offer(self, maps):
        if self.first is None:
            self.first = maps
            return
        if self.last is not None:
            # the pass that stops being the last joins the draw
            self.seen += 1
            if self.rng.random() * self.seen < 1.0:
                self.drawn = self.last
        self.last = maps

    def maps(self):
        out = []
        for m in (self.first, self.drawn, self.last):
            if m is not None and all(m is not o for o in out):
                out.append(m)
        return out


def _launches():
    from raynet_tpu_torch.ops import bp_sweep, planesweep, voxel_depth

    return {"K1": planesweep.plane_sweep_scores.launches,
            "K2": bp_sweep.bp_sweep.launches,
            "K3_depth": voxel_depth.voxel_argmax_depth.launches}


def count_work(cell):
    """The counts the roofline arithmetic takes (``roofline`` "work"),
    from the scene's segments, computed by the benchmark's own code."""
    config, scene, dev = cell.config, cell.scene, cell.device
    H, W = scene.image_shape
    layers = config["cnn"]["layers"]
    pad = config["padding"]
    shrink = sum(d * (k - 1) for _, k, d in layers)
    V = config["neighbors"] + 1
    fshape = (V, H + 2 * pad - shrink, W + 2 * pad - shrink, layers[-1][0])
    bbox = plain.f32(scene.bbox.reshape(-1), dev)
    refs = range(*cell.images_range)
    images, needed = [], set()
    for i in refs:
        views = scene.get_view_idxs(i, config["neighbors"])
        needed.update(views)
        cams = [scene.get_image(j).camera for j in views]
        center = plain.f32(cams[0].center[:3, 0], dev)
        start, end = plain.segments(H, W, plain.f32(cams[0].P_pinv, dev),
                                    center, bbox)
        visits = roofline.closed_form_visits(start, end, bbox,
                                             config["grid_shape"],
                                             config["max_marched_voxels"])
        rows = roofline.touched_feature_rows(
            plain.f32([c.P for c in cams], dev), start, end,
            config["depth_planes"], pad, H, W, fshape)
        images.append({"rays": H * W, "visits": int(visits.sum()),
                       "feature_rows": rows})
    gx, gy, gz = config["grid_shape"]
    return {"images": images, "views": V, "planes": config["depth_planes"],
            "feature_dim": layers[-1][0], "grid_cells": gx * gy * gz,
            "cnn_flops": len(needed) * roofline.conv_stack_flops(
                layers, H, W, 3, pad)}


def run(bench, cell_entry, config, traffic, seed, seconds, trace, device,
        t0, err):
    """One run of a cell: set-up, the window, the check."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.set_num_threads(4)
    t_imports = time.perf_counter()
    cell = Cell(config, traffic, seed, device)
    t_cell = time.perf_counter()
    cell.one_pass()
    t_warm = time.perf_counter()
    from raynet_tpu_torch.ops import cuda_build

    if device.type == "cuda":
        print("kernel library: %s" % (
            "built in %.1f s" % cuda_build.build_seconds
            if cuda_build.build_seconds is not None else "from its cache"),
            file=err)
    print("set-up (s): start to driver %.2f, scene, weights and model %.2f, "
          "warm-up pass %.2f" % (t_imports - t0, t_cell - t_imports,
                                 t_warm - t_cell), file=err)
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = _launches()
    setup_s = time.perf_counter() - t0

    keep, passes = Keep(seed), []
    prof = tracing.profile() if trace else contextlib.nullcontext()
    with prof:
        with torch.profiler.record_function(tracing.WINDOW):
            w0 = time.perf_counter()
            while time.perf_counter() - w0 < seconds:
                s = time.perf_counter()
                maps, phases = cell.one_pass()
                passes.append(types.SimpleNamespace(
                    start=s - w0, end=time.perf_counter() - w0,
                    phases=phases))
                keep.offer(maps)
                del maps
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = _launches()
    n = len(passes)
    print("launches per pass: %s" % ", ".join(
        "%s %g" % (k, (after[k] - before[k]) / max(n, 1)) for k in after),
        file=err)
    phase_totals = {}
    for p in passes:
        for k, v in p.phases.items():
            phase_totals[k] = phase_totals.get(k, 0.0) + v["total_s"]
    print("phases per pass (s): %s" % ", ".join(
        "%s %.4f" % (k, v / max(n, 1)) for k, v in phase_totals.items()),
        file=err)

    power = roofline.power_limit() if cuda else None
    run = types.SimpleNamespace(
        config=config, traffic=traffic, cell=cell_entry, passes=passes,
        setup_s=setup_s, window_peak=window_peak,
        pixels_per_pass=cell.pixels_per_pass, trace=None, work=None,
        breakdown=None, attempted=n, failed=0)
    run.device = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": max(setup_peak, window_peak),
        "power_limit": power}
    if trace:
        t = run.trace = tracing.Trace(tracing.events_of(prof))
        run.device["busy_s"] = t.busy_s()
        run.device["window_s"] = t.window_s
        run.breakdown = {"device_ops": t.top_operations(),
                         "idle_gaps": t.idle_gaps()}
        run.work = count_work(cell)
        print("work per pass: %r" % (run.work,), file=err)
        for name, costs in (
                ("K1", roofline.plane_sweep_costs(run.work)),
                ("sweeps", roofline.sweep_costs(
                    run.work, roofline.pass_sweeps(config)))):
            ops = sum(c.ops for c in costs)
            nbytes = sum(c.nbytes for c in costs)
            print("%s per pass: %.4g FLOP, %.4g B, bound %.4f ms by %s" % (
                name, ops, nbytes,
                1e3 * sum(roofline.bound_seconds(c) for c in costs),
                roofline.bound_by(roofline.Cost(nbytes, ops))), file=err)

    # the program's state goes before the reference runs
    contenders = keep.maps()
    del keep, cell.model
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    judge = bench.reference(config).run(cell.scene, cell.weights, config,
                                        traffic, contenders, device)
    readings = judge.readings()
    print("reference: %.1f s over %d passes' maps; readings %r"
          % (time.perf_counter() - r0, len(contenders), readings), file=err)
    run.checks = {name: {"value": max(r[name] for r in readings),
                         "limit": limit}
                  for name, limit in config["limits"].items()}
    run.correct = bool(n > 0 and all(c["value"] <= c["limit"]
                                     for c in run.checks.values()))
    return run


def end_to_end(run):
    """The end-to-end metrics of a forward-pass cell."""
    durations = [p.end - p.start for p in run.passes]
    if len(durations) > 1:
        p90 = statistics.quantiles(durations, n=10, method="inclusive")[8]
    else:
        p90 = durations[0]
    return {
        # from the window's start to the last pass's completion
        "px_per_s": len(run.passes) * run.pixels_per_pass
        / run.passes[-1].end,
        "pass_p90_s": p90,
        "peak_mem_GB": run.window_peak / 1e9,
        "setup_s": run.setup_s,
    }

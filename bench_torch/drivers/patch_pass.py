"""Driver of the patch-scoring cells: one pass of the ``hartmann_fp``
factory after another through the program's own entry
(``get_forward_pass_factory(config["factory"])``, ``forward_pass(scene,
images_range)``) with a ``HartmannModel`` and the in-bbox sampling
scheme, each pass through a new pass object.

Set-up: the scene and the network's weights from the seed (on the
device), the program's model and one warm-up pass, which touches every
shape the window uses. The window: passes back to back for ``seconds``;
a pass ends when its last depth map is on the host. After it: the peak
memory, then (``trace``) the trace and the work of a pass counted by the
benchmark (``patch_roofline.pass_work``: H x W x D quintuples a reference
view, not the program's counter), then, with the program's state freed,
the reference judges the depth maps of the first pass, the last and one
drawn from the seed. The end-to-end metrics are ``scene_pass``'s.
"""
import contextlib
import math
import time
import types

import torch

from bench_torch import patch_roofline, roofline
from bench_torch import scene as generator
from bench_torch import trace as tracing
# end_to_end: the harness takes a cell's end-to-end metrics from its driver
from bench_torch.drivers.scene_pass import PASS, Keep, end_to_end  # noqa: F401


def net_weights(config, seed, device):
    """The ``HartmannSimilarityNet`` state dict of ``config["net"]`` drawn
    from ``seed`` on ``device`` in one call: He-uniform kernels (variance
    2 / fan_in) and biases in +-0.05.

    With random images the views' patches agree at no plane, so the match
    probability of a quintuple is a random function of its patches. At
    this scale it moves from plane to plane by about 0.02 (the median
    ray's best less its worst), far above float32 rounding, and stays off
    the softmax's saturation, so the argmax plane is a property of the
    network and not of the summation order (the reference reports the
    spread it sees)."""
    net = config["net"]
    shapes, c = [], config["patch_shape"][2]
    for filters, k in net["branch"]:
        shapes.append(("cnn.convs.%d" % len(shapes), (filters, c, k, k)))
        c = filters
    for i, (filters, k) in enumerate(net["head"]):
        shapes.append(("head.%d" % i, (filters, c, k, k)))
        c = filters
    total = sum(math.prod(s) + s[0] for _, s in shapes)
    u = torch.rand(total, dtype=torch.float32, device=device,
                   generator=generator.generator(seed, device, 1))
    sd, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        bound = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
        sd[name + ".weight"] = (u[off:off + n].reshape(shape) * 2 - 1) * bound
        off += n
        sd[name + ".bias"] = (u[off:off + shape[0]] * 2 - 1) * 0.05
        off += shape[0]
    return sd


class Cell:
    """The scene, the weights and the program's model of one seed, and a
    pass through the program."""

    def __init__(self, config, traffic, seed, device):
        from raynet_tpu_torch.common.generation_parameters import (
            GenerationParameters,
        )
        from raynet_tpu_torch.common.sampling_schemes import (
            get_sampling_scheme,
        )
        from raynet_tpu_torch.inference.forward_pass import (
            get_forward_pass_factory,
        )
        from raynet_tpu_torch.models.feature_extractor import HartmannModel

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.scene = generator.make_scene(traffic, seed, self.device)
        self.weights = net_weights(config, seed, self.device)
        shape = tuple(config["patch_shape"])
        self.model = HartmannModel(state_dict=self.weights,
                                   patch_shape=shape, device=self.device)
        self.params = GenerationParameters(
            depth_planes=config["depth_planes"],
            neighbors=config["neighbors"], patch_shape=shape,
            padding=config["padding"], sampling_type=config["sampling"])
        self.scheme = get_sampling_scheme(config["sampling"])(self.params)
        self.factory = get_forward_pass_factory(config["factory"])
        self.images_range = tuple(traffic["images_range"])

    def one_pass(self):
        """(depth maps, the pass's phase times) of one pass through a new
        pass object."""
        fp = self.factory(self.model, self.params, self.scheme,
                          self.scene.image_shape, self.config["rays_batch"],
                          device=self.device)
        with torch.profiler.record_function(PASS):
            maps = list(fp.forward_pass(self.scene, self.images_range))
        return maps, fp.timer.summary()

    @property
    def pixels_per_pass(self):
        H, W = self.scene.image_shape
        return len(range(*self.images_range)) * H * W


def run(bench, cell_entry, config, traffic, seed, seconds, trace, device,
        t0, err):
    """One run of a cell: set-up, the window, the check."""
    from raynet_tpu_torch.ops import bp_sweep, planesweep, voxel_depth

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.set_num_threads(4)
    t_imports = time.perf_counter()
    cell = Cell(config, traffic, seed, device)
    t_cell = time.perf_counter()
    cell.one_pass()
    t_warm = time.perf_counter()
    print("set-up (s): start to driver %.2f, scene, weights and model %.2f, "
          "warm-up pass %.2f" % (t_imports - t0, t_cell - t_imports,
                                 t_warm - t_cell), file=err)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    kernels = (planesweep.plane_sweep_scores, bp_sweep.bp_sweep,
               voxel_depth.voxel_argmax_depth)
    before = [k.launches for k in kernels]
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
    n = len(passes)
    print("port kernel launches in the window (K1, K2, K3): %s"
          % [k.launches - b for k, b in zip(kernels, before)], file=err)
    totals, counts = {}, {}
    for p in passes:
        for k, v in p.phases.items():
            totals[k] = totals.get(k, 0.0) + v["total_s"]
            counts[k] = counts.get(k, 0) + v["count"]
    print("pass seconds: %s" % " ".join(
        "%.4f" % (p.end - p.start) for p in passes), file=err)
    print("phases per pass (s, entries): %s" % ", ".join(
        "%s %.4f %g" % (k, v / max(n, 1), counts[k] / max(n, 1))
        for k, v in totals.items()), file=err)

    run = types.SimpleNamespace(
        config=config, traffic=traffic, cell=cell_entry, passes=passes,
        setup_s=setup_s, window_peak=window_peak,
        pixels_per_pass=cell.pixels_per_pass, trace=None, work=None,
        breakdown=None, attempted=n, failed=0)
    run.device = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": max(setup_peak, window_peak),
        "power_limit": roofline.power_limit() if cuda else None}
    if trace:
        t = run.trace = tracing.Trace(tracing.events_of(prof))
        run.device["busy_s"] = t.busy_s()
        run.device["window_s"] = t.window_s
        run.breakdown = {"device_ops": t.top_operations(),
                         "idle_gaps": t.idle_gaps()}
        run.work = patch_roofline.pass_work(config, traffic)
        for name in ("net", "gather"):
            c = run.work[name]
            print("%s per pass: %.4g FLOP, %.4g B, bound %.4f s by %s" % (
                name, c.ops, c.nbytes, roofline.bound_seconds(c),
                roofline.bound_by(c)), file=err)

    # the program's state goes before the reference runs
    contenders = keep.maps()
    del keep, cell.model
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    judge = bench.reference(config).run(cell.scene, cell.weights, config,
                                        traffic, contenders, device)
    readings = judge.readings()
    print("reference: %.1f s over %d passes' maps; readings %r; its scores "
          "over the planes %r" % (time.perf_counter() - r0, len(contenders),
                                  readings, judge.spread), file=err)
    run.checks = {name: {"value": max(r[name] for r in readings),
                         "limit": limit}
                  for name, limit in config["limits"].items()}
    run.correct = bool(n > 0 and all(c["value"] <= c["limit"]
                                     for c in run.checks.values()))
    return run

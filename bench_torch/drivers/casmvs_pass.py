"""Driver of the CasMVSNet cells: one pass of the ``casmvsnet`` factory
after another through the program's own entry
(``get_forward_pass_factory(config["factory"])``, ``forward_pass(scene,
images_range)``) with a ``CasMVSNetModel``, each pass through a new pass
object, so that every pass computes its features anew.

Set-up: the scene and the network's weights from the seed (on the
device), the program's model and one warm-up pass, which builds the
kernel library on a checkout's first run and touches every shape the
window uses. The window: passes back to back for ``seconds``; a pass ends
when its last depth map is on the host. After it: the peak memory, then
(``trace``) the trace and the work of a pass counted by the benchmark
(``cas_roofline.pass_work``), then one more pass that keeps each stage's
maps, then, with the program's state freed, the reference judges that
pass's maps a stage at a time, and the last maps of the first timed pass,
the last and one drawn from the seed on its stage-2 maps. The end-to-end
metrics are ``scene_pass``'s.
"""
import contextlib
import math
import time
import types

import torch

from bench_torch import cas_roofline, roofline
from bench_torch import scene as generator
from bench_torch import trace as tracing
# end_to_end: the harness takes a cell's end-to-end metrics from its driver
from bench_torch.drivers.scene_pass import PASS, Keep, end_to_end  # noqa: F401
from bench_torch.reference.mvsnet import crop


def weight_shapes(config):
    """(name, shape, fan_in, norm) of every conv weight and bias of
    ``config``'s layers, under cascade-stereo's names: fan_in None for a
    bias, norm (its names' prefix, its channels) for a weight that a
    BatchNorm follows, else None. A stride-2 transposed conv's output
    takes in x k^3 / 8 products on average."""
    groups = [("feature", config["feature_net"] + config["fpn"], 2)] + [
        ("cost_regularization.%d" % s, layers, 3)
        for s, layers in enumerate(config["cost_regularization"])]
    out = []
    for prefix, layers, dims in groups:
        for name, cin, cout, k, stride, kind in layers:
            kernel = (k,) * dims
            base = "%s.%s" % (prefix, name)
            if kind == "deconv_bn_relu":
                out.append((base + ".conv.weight", (cin, cout) + kernel,
                            cin * k ** dims / stride ** dims,
                            (base + ".bn.", cout)))
            elif kind == "conv_bn_relu":
                out.append((base + ".conv.weight", (cout, cin) + kernel,
                            cin * k ** dims, (base + ".bn.", cout)))
            else:
                out.append((base + ".weight", (cout, cin) + kernel,
                            cin * k ** dims, None))
                if kind == "conv":
                    out.append((base + ".bias", (cout,), None, None))
    return out


def casmvsnet_weights(config, seed, device):
    """The ``CasMVSNet`` state dict of ``config``'s layers drawn from
    ``seed`` on ``device`` in one call, as ``mvs_pass.mvsnet_weights``
    draws MVSNet's: He-uniform kernels (variance 2 / fan_in), biases in
    +-0.05, BatchNorm scales in [0.8, 1.2], shifts in +-0.1, running means
    in +-0.1 and variances in [0.8, 1.2]; stage s's U-Net's last kernel
    ``prob_kernel_scale[s]`` times wider (the configuration says why)."""
    shapes = weight_shapes(config)
    last = {"cost_regularization.%d.%s.weight" % (s, layers[-1][0]): scale
            for s, (layers, scale) in enumerate(zip(
                config["cost_regularization"], config["prob_kernel_scale"]))}
    total = sum(math.prod(s) + (4 * norm[1] if norm else 0)
                for _, s, _, norm in shapes)
    u = torch.rand(total, dtype=torch.float32, device=device,
                   generator=generator.generator(seed, device, 1))
    sd, off = {}, 0

    def take(shape, lo, hi):
        nonlocal off
        n = math.prod(shape)
        out = u[off:off + n].reshape(shape) * (hi - lo) + lo
        off += n
        return out

    for name, shape, fan_in, norm in shapes:
        if fan_in is None:
            sd[name] = take(shape, -0.05, 0.05)
            continue
        bound = math.sqrt(6.0 / fan_in)
        bound *= last.get(name, 1)
        sd[name] = take(shape, -bound, bound)
        if norm is None:
            continue
        prefix, f = norm
        sd[prefix + "weight"] = take((f,), 0.8, 1.2)
        sd[prefix + "bias"] = take((f,), -0.1, 0.1)
        sd[prefix + "running_mean"] = take((f,), -0.1, 0.1)
        sd[prefix + "running_var"] = take((f,), 0.8, 1.2)
        sd[prefix + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
    return sd


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
        from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.scene = generator.make_scene(traffic, seed, self.device)
        self.weights = casmvsnet_weights(config, seed, self.device)
        self.model = CasMVSNetModel(state_dict=self.weights,
                                    device=self.device)
        self.params = GenerationParameters(neighbors=config["neighbors"])
        self.factory = get_forward_pass_factory(config["factory"])
        self.images_range = tuple(traffic["images_range"])
        self.crop_shape = tuple(crop(*self.scene.image_shape)[2:])

    def _pass(self):
        return self.factory(self.model, self.params, None,
                            self.scene.image_shape, device=self.device)

    def timed_pass(self):
        """(depth maps, the pass's phase times) of one pass through a new
        pass object."""
        fp = self._pass()
        with torch.profiler.record_function(PASS):
            maps = list(fp.forward_pass(self.scene, self.images_range))
        return maps, fp.timer.summary()

    def one_pass(self):
        """(each reference view's three stage maps, the pass's phase
        times) of one pass through a new pass object, by the same stages
        (``stage_depths``): a contender that the reference judges a stage
        at a time."""
        fp = self._pass()
        maps = [[d.cpu().numpy() for d in fp.stage_depths(self.scene, i)]
                for i in range(*self.images_range)]
        return maps, fp.timer.summary()

    @property
    def pixels_per_pass(self):
        h, w = self.crop_shape
        return len(range(*self.images_range)) * h * w


def _launches():
    from raynet_tpu_torch.ops import cost_volume, transposed_conv3d

    return (cost_volume.cost_volume.launches,
            cost_volume.cost_volume.per_pixel_launches,
            transposed_conv3d.transposed_conv3d.launches)


def run(bench, cell_entry, config, traffic, seed, seconds, trace, device,
        t0, err):
    """One run of a cell: set-up, the window, the check."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.set_num_threads(4)
    t_imports = time.perf_counter()
    cell = Cell(config, traffic, seed, device)
    t_cell = time.perf_counter()
    cell.timed_pass()
    t_warm = time.perf_counter()
    print("set-up (s): start to driver %.2f, scene, weights and model %.2f, "
          "warm-up pass %.2f" % (t_imports - t0, t_cell - t_imports,
                                 t_warm - t_cell), file=err)
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
                maps, phases = cell.timed_pass()
                passes.append(types.SimpleNamespace(
                    start=s - w0, end=time.perf_counter() - w0,
                    phases=phases))
                keep.offer(maps)
                del maps
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n = len(passes)
    print("K4 launches (per-pixel of them), K5 launches per pass: %s"
          % " ".join("%g" % ((b - a) / max(n, 1))
                     for a, b in zip(before, _launches())), file=err)
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
        run.work = cas_roofline.pass_work(config, traffic, cell.scene,
                                          cell.crop_shape)
        for name in ("feature_net", "k4", "unet", "fine_unet"):
            c = run.work[name]
            print("%s per pass: %.4g FLOP, %.4g B, bound %.4f ms by %s" % (
                name, c.ops, c.nbytes, 1e3 * roofline.bound_seconds(c),
                roofline.bound_by(c)), file=err)

    # each stage's maps of one more pass, whose last two stages' inputs
    # the timed passes' last maps are judged on; then the program's state
    # goes before the reference runs
    contenders = [cell.one_pass()[0]] + keep.maps()
    del keep, cell.model
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    judge = bench.reference(config).run(cell.scene, cell.weights, config,
                                        traffic, contenders, device)
    readings = judge.readings()
    print("reference: %.1f s over %d passes' maps; readings %r; its depths "
          "in intervals of the last stage %r"
          % (time.perf_counter() - r0, len(contenders), readings,
             judge.spread()), file=err)
    run.checks = {name: {"value": max(r[name] for r in readings),
                         "limit": limit}
                  for name, limit in config["limits"].items()}
    run.correct = bool(n > 0 and all(c["value"] <= c["limit"]
                                     for c in run.checks.values()))
    return run

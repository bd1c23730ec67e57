"""Reference of the ``casmvsnet`` configuration: CasMVSNet (Gu, Fan, Zhu,
Dai, Tan and Tan, "Cascade Cost Volume for High-Resolution Multi-View
Stereo and Stereo Matching", CVPR 2020), as the authors' code
cascade-stereo computes it (``CasMVSNet/models/cas_mvsnet.py``:
``CasMVSNet.forward``, ``DepthNet``; ``CasMVSNet/models/module.py``:
``FeatureNet`` in its "fpn" mode, ``CostRegNet``, ``homo_warping``,
``get_depth_range_samples``, ``get_cur_depth_range_samples``,
``depth_regression``).

For each reference view and its neighbours: each image centre-cropped to
multiples of 32 (DTU's 1600 x 1200 to 1600 x 1184); the FPN on every
image (convs with "same" padding, ``F.batch_norm`` with the running
statistics, ReLU, nearest upsampling and the lateral sums), three maps at
a quarter, a half and the whole of the crop's resolution; then three
stages, each with the cameras at its maps' resolution (the intrinsics
divided by 4, 2 and 1) and the crop's offset taken off, each scaled so
that its third row gives camera z. A stage's hypotheses are cascade-stereo's
sequence itself: stage 1's, D planes uniform from the nearest to the
farthest depth; a later stage's, the previous depth bilinearly up to the
crop's size (``F.interpolate``, ``align_corners=False``), the hypotheses
``cur - D / 2 i + k (cur_max - cur_min) / (D - 1)`` around it at the
stage's interval i, then the (D, H, W) hypotheses trilinearly down to the
stage's maps (``align_corners=False``). Each source view is warped by
``homo_warping`` (the source's 4 x 4 projection times the inverse of the
reference's, the pixel grid times each pixel's hypothesis) and sampled by
``F.grid_sample`` (bilinear, zero padding, ``align_corners=True``); the
variance over the views (the reference view unwarped); the stage's 3D
U-Net (``F.conv3d``, ``F.conv_transpose3d``, ``F.batch_norm``, ReLU, the
skip sums, ``prob`` without a bias); the softmax over the hypotheses and
the expected depth.

Plain ``torch`` in float32 with TF32 off for convolutions and products
(``common.precision``). The hypotheses and the warp (the homography, the
grid and the sampling) are float64, each warped value then cast to
float32, for the reason ``reference/mvsnet.py`` gives; the regression
weighs the hypotheses cast to float32, as cascade-stereo's float32
hypotheses. Departures from cascade-stereo: the float64 hypotheses and
warp; the photometric confidence is left out (the configuration says
why). It imports nothing of the program; the benchmark gives it the scene
and the weights it drew from the seed, and the layers from the
configuration.

``run`` returns a ``Judge`` of each stage's maps, each stage run on the
contender's own input: stage s > 1 from the contender's stage s - 1 map
(``Judge`` says why), in the stage's intervals; and of the last stage's
maps against the reference's own chain, with ``reference/mvsnet.py``'s
``scaled_gap`` (a pixel's spread that of its own hypotheses under the
softmax).
"""
import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference import common
from bench_torch.reference.mvsnet import crop


def projection(P, top, left, stride):
    """The 4 x 4 float64 projection of a camera P (3 x 4) into the pixels
    of a map ``stride`` pixels apart: the crop's offset taken off the
    principal point, the first two rows divided by ``stride``, the matrix
    scaled so that its third row gives camera z, and (0, 0, 0, 1) below."""
    P = np.asarray(P, np.float64).copy()
    P[0] -= left * P[2]
    P[1] -= top * P[2]
    P[:2] /= stride
    P /= np.linalg.norm(P[2, :3])
    return np.vstack([P, [0.0, 0.0, 0.0, 1.0]])


def depth_bounds(proj_ref, bbox):
    """The nearest and the farthest camera z of the bbox's corners."""
    lo, hi = np.asarray(bbox, np.float64).reshape(2, 3)
    z = [proj_ref[2] @ np.array([x, y, w, 1.0])
         for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for w in (lo[2], hi[2])]
    return min(z), max(z)


def layer(x, weights, prefix, spec, eps, dims):
    """One layer of ``spec`` [name, in, out, kernel, stride, kind] on x,
    under cascade-stereo's names: its conv ("same" padding; a transposed one
    of stride 2 doubles every dim), then BatchNorm and ReLU unless it is a
    plain conv ("conv" with a bias, "conv_nobias" without)."""
    name, _, _, kernel, stride, kind = spec
    base = "%s.%s." % (prefix, name)
    pad = kernel // 2
    if kind in ("conv", "conv_nobias"):
        conv = F.conv2d if dims == 2 else F.conv3d
        return conv(x, weights[base + "weight"],
                    weights[base + "bias"] if kind == "conv" else None,
                    stride=stride, padding=pad)
    if kind == "deconv_bn_relu":
        x = F.conv_transpose3d(x, weights[base + "conv.weight"], None,
                               stride=stride, padding=pad,
                               output_padding=stride - 1)
    else:
        conv = F.conv2d if dims == 2 else F.conv3d
        x = conv(x, weights[base + "conv.weight"], None, stride=stride,
                 padding=pad)
    norm = base + "bn."
    x = F.batch_norm(x, weights[norm + "running_mean"],
                     weights[norm + "running_var"], weights[norm + "weight"],
                     weights[norm + "bias"], False, 0.0, eps)
    return torch.relu_(x)


def features(image_u8, weights, config):
    """[(32, H / 4, W / 4), (16, H / 2, W / 2), (8, H, W)] float32 maps of
    one cropped (H, W, 3) uint8 image on the device: ``FeatureNet.forward``
    in its "fpn" mode."""
    eps = config["bn_eps"]
    x = image_u8.permute(2, 0, 1)[None].to(torch.float32) / 255.0
    convs = {}
    for spec in config["feature_net"]:
        x = layer(x, weights, "feature", spec, eps, 2)
        convs[spec[0].split(".")[0]] = x
    # an FPN row's fifth entry is its map's stride; its conv's is 1
    by = {name: [name, cin, cout, k, 1, kind]
          for name, cin, cout, k, _, kind in config["fpn"]}

    def run(name, x):
        return layer(x, weights, "feature", by[name], eps, 2)

    out1 = run("out1", convs["conv2"])
    intra = F.interpolate(convs["conv2"], scale_factor=2, mode="nearest") \
        + run("inner1", convs["conv1"])
    out2 = run("out2", intra)
    intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
        + run("inner2", convs["conv0"])
    return [out1[0], out2[0], run("out3", intra)[0]]


def regularize(volume, weights, layers, prefix, eps):
    """(1, 1, D, H, W) logits of a (1, C, D, H, W) cost volume:
    ``CostRegNet.forward`` over its named layers."""
    by = {spec[0]: spec for spec in layers}

    def run(name, x):
        return layer(x, weights, prefix, by[name], eps, 3)

    conv0 = run("conv0", volume)
    conv2 = run("conv2", run("conv1", conv0))
    conv4 = run("conv4", run("conv3", conv2))
    x = run("conv6", run("conv5", conv4))
    x = conv4 + run("conv7", x)
    x = conv2 + run("conv9", x)
    x = conv0 + run("conv11", x)
    return run("prob", x)


def hypotheses(depth, config, stage, shape, near, far, device):
    """(D, H / s, W / s) float64 hypotheses on ``device`` of stage
    ``stage`` on a crop of ``shape`` (H, W), s the stage's stride:
    ``get_depth_range_samples`` at the crop's size around the previous
    stage's ``depth`` (None in stage 1, whose hypotheses span [``near``,
    ``far``]), trilinearly down to the stage's maps, as
    ``CasMVSNet.forward`` computes them."""
    D = config["ndepths"][stage]
    s = config["stage_strides"][stage]
    H, W = shape
    k = torch.arange(D, dtype=torch.float64, device=device)
    if depth is None:
        interval = (far - near) / (D - 1)
        samples = (near + k * interval)[:, None, None].repeat(1, H, W)
    else:
        cur = F.interpolate(depth.to(torch.float64)[None, None], [H, W],
                            mode="bilinear", align_corners=False)[0, 0]
        i = config["depth_interval_ratios"][stage] * (far - near) \
            / config["numdepth"]
        cur_min, cur_max = cur - D / 2 * i, cur + D / 2 * i
        interval = (cur_max - cur_min) / (D - 1)
        samples = cur_min[None] + k[:, None, None] * interval[None]
    return F.interpolate(samples[None, None], [D, H // s, W // s],
                         mode="trilinear", align_corners=False)[0, 0]


def cost_volume(feats, projs, z, block=1 << 26):
    """(1, C, D, H, W) float32 variance volume of the views' features
    ``feats`` (V, C, H, W), the reference first, by ``homo_warping``
    (``projs`` (V, 4, 4)) at each pixel's hypotheses ``z`` (D, H, W)
    float64, about ``block`` warped values at a time; the warp in
    float64."""
    V, C, H, W = feats.shape
    D = z.shape[0]
    dev = feats.device
    f64 = torch.float64
    volume = torch.empty((1, C, D, H, W), dtype=torch.float32, device=dev)
    y, x = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                          torch.arange(W, dtype=f64, device=dev),
                          indexing="ij")
    inv_ref = np.linalg.inv(projs[0])
    ref = feats[0][:, None]  # (C, 1, H, W)
    chunk = max(1, block // (C * H * W))
    for d0 in range(0, D, chunk):
        zz = z[d0:d0 + chunk]
        s, q = ref, ref * ref
        for v in range(1, V):
            proj = torch.as_tensor(projs[v] @ inv_ref, device=dev)
            rot, trans = proj[:3, :3], proj[:3, 3]
            p = [(rot[i, 0] * x + rot[i, 1] * y + rot[i, 2]) * zz + trans[i]
                 for i in range(3)]
            gx = p[0] / p[2] / ((W - 1) / 2) - 1
            gy = p[1] / p[2] / ((H - 1) / 2) - 1
            grid = torch.stack([gx, gy], dim=-1).reshape(1, -1, W, 2)
            warped = F.grid_sample(feats[v][None].to(f64), grid,
                                   mode="bilinear", padding_mode="zeros",
                                   align_corners=True)
            warped = warped.to(torch.float32).reshape(C, -1, H, W)
            s = s + warped
            q = q + warped * warped
        volume[0, :, d0:d0 + zz.shape[0]] = q / V - (s / V) ** 2
    return volume


def depth_map(logits, hyps):
    """(H, W) expected depth of (1, 1, D, H, W) logits over (D, H, W)
    float32 hypotheses, and (H, W) its spread, the standard deviation of
    the hypotheses under the softmax."""
    prob = F.softmax(logits[0, 0], dim=0)
    depth = torch.sum(prob * hyps, dim=0)
    var = torch.sum(prob * (hyps - depth) ** 2, dim=0)
    return depth, torch.sqrt(var)


class Judge:
    """The numbers compared, of each contender against the reference.

    A contender is a list with one entry per reference view: the view's
    three stage maps [(H / 4, W / 4), (H / 2, W / 2), (H, W)], or its last
    stage's map alone. Each stage's map is judged against the reference's
    stage run on the same input, in that stage's intervals: stage 1 has
    none; a later stage takes the contender's own previous map, or, for a
    contender of last-stage maps alone, the first contender's. So what a
    stage hands on is judged once, in the stage that made it: the cascade
    can carry a float32 difference of one stage into a later stage's
    depth several times as far (each stage's depth moves with its centre
    and with the volume sampled around it). The chain readings judge the
    last stage's map against the reference's own three stages.
    """

    mismatch_tolerance = 1e-2  # of a stage's interval

    def __init__(self, contenders, stages):
        n = len(contenders)
        self.contenders = contenders
        self.mismatches = [[0] * stages for _ in range(n)]
        self.pixels = [[0] * stages for _ in range(n)]
        self.gap = [0.0] * n
        self.chain_gap = [0.0] * n
        self.chain_mismatches = [0] * n
        self.scaled_gap = [0.0] * n
        self.chain_pixels = 0
        self.maps, self.intervals, self.logit_scales = [], [], []

    def _diff(self, got, ref, interval, hypotheses):
        if got.shape != ref.shape:
            raise ValueError("a depth map of %s, the reference's %s"
                             % (tuple(got.shape), tuple(ref.shape)))
        return torch.nan_to_num((got - ref).abs() / interval,
                                nan=hypotheses, posinf=hypotheses)

    def stage(self, c, stage, got, ref, interval, hypotheses):
        """Judge contender ``c``'s map ``got`` of stage ``stage`` against
        the reference's ``ref`` from the same input, ``interval`` the
        stage's, ``hypotheses`` its count."""
        diff = self._diff(got, ref, interval, hypotheses)
        self.gap[c] = max(self.gap[c], float(diff.max()))
        self.mismatches[c][stage] += int(
            (diff > self.mismatch_tolerance).sum())
        self.pixels[c][stage] += ref.numel()

    def chain(self, finals, ref, spread, interval, logit_scale, hypotheses):
        """Judge the contenders' last-stage maps ``finals`` of one view
        against the reference's own chain's ``ref``, ``spread`` its
        spread, ``interval`` the last stage's, ``logit_scale`` the largest
        |logit| of its last volume; ``scaled_gap`` is
        ``reference/mvsnet.py``'s."""
        scale = torch.clamp(spread / interval, min=1.0) * logit_scale
        for c, got in enumerate(finals):
            diff = self._diff(got, ref, interval, hypotheses)
            self.chain_gap[c] = max(self.chain_gap[c], float(diff.max()))
            self.scaled_gap[c] = max(self.scaled_gap[c],
                                     float((diff / scale).max()))
            self.chain_mismatches[c] += int(
                (diff > self.mismatch_tolerance).sum())
        self.chain_pixels += ref.numel()

    def readings(self):
        """Per contender: ``mismatch_share``, the largest share over the
        judged stages of a stage's pixels more than ``mismatch_tolerance``
        of its interval from the reference; ``depth_gap``, the largest
        difference, in the stage's intervals; and the chain's
        ``chain_mismatch_share``, ``chain_gap`` and ``scaled_gap``."""
        return [{"mismatch_share": max(k / p for k, p in zip(ks, ps) if p),
                 "depth_gap": g, "chain_mismatch_share":
                 m / max(self.chain_pixels, 1), "chain_gap": cg,
                 "scaled_gap": sg}
                for ks, ps, g, m, cg, sg in zip(
                    self.mismatches, self.pixels, self.gap,
                    self.chain_mismatches, self.chain_gap, self.scaled_gap)]

    def spread(self):
        """How far the reference's last-stage depths move over a view, in
        the last stage's intervals: the smallest and the median standard
        deviation of a view's map, and the widest range of one; and the
        largest logit scale of a view's last volume."""
        std = sorted(float(m[-1].std()) / i
                     for m, i in zip(self.maps, self.intervals))
        return {"std_min": std[0], "std_median": std[len(std) // 2],
                "range_max": max(float(m[-1].max() - m[-1].min()) / i
                                 for m, i in zip(self.maps, self.intervals)),
                "logit_scale_max": max(self.logit_scales)}

    def reference_maps(self, height, width):
        """The reference's own chain's three stage maps of each view, a
        contender of stage maps; the image's size is not needed."""
        del height, width
        return [[s.numpy() for s in m] for m in self.maps]


def run(scene, weights, config, traffic, contenders, device, tf32=False):
    """The ``Judge`` of ``contenders`` against this reference over the
    reference views of ``traffic``."""
    eps = config["bn_eps"]
    H, W = scene.image_shape
    top, left, h, w = crop(H, W)
    ndepths = config["ndepths"]
    stages = range(len(ndepths))
    last = stages[-1]
    judge = Judge(contenders, len(ndepths))
    feats = {}

    def as_map(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    with common.precision(tf32):
        for n, i in enumerate(range(*traffic["images_range"])):
            views = scene.get_view_idxs(i, config["neighbors"])
            for j in views:
                if j not in feats:
                    image = torch.as_tensor(scene.get_image(j).image_u8,
                                            device=device)
                    feats[j] = features(image[top:top + h, left:left + w],
                                        weights, config)
            near, far = depth_bounds(
                projection(scene.get_image(i).camera.P, top, left, 1),
                scene.bbox)
            intervals = [r * (far - near) / config["numdepth"]
                         for r in config["depth_interval_ratios"]]

            def stage(s, previous):
                """(depth, spread, largest |logit|) of the reference's
                stage s from the previous stage's map (None in stage 1)."""
                projs = np.stack([projection(
                    scene.get_image(j).camera.P, top, left,
                    config["stage_strides"][s]) for j in views])
                z = hypotheses(previous, config, s, (h, w), near, far,
                               device)
                volume = cost_volume(
                    torch.stack([feats[j][s] for j in views]), projs, z)
                logits = regularize(
                    volume, weights, config["cost_regularization"][s],
                    "cost_regularization.%d" % s, eps)
                del volume
                depth, spread = depth_map(logits, z.to(torch.float32))
                return depth, spread, float(logits.abs().max())

            chain = []
            for s in stages:
                chain.append(stage(s, chain[-1][0] if chain else None))
            runs = []

            def judged(s, previous):
                """The reference's stage s from ``previous``, run once
                for each distinct input."""
                if not s:
                    return chain[0][0]
                for t, x, depth in runs:
                    if t == s and torch.equal(x, previous):
                        return depth
                runs.append((s, previous, stage(s, previous)[0]))
                return runs[-1][2]

            finals = []
            for c, maps in enumerate(contenders):
                entry = maps[n]
                staged = isinstance(entry, (list, tuple))
                source = entry if staged else contenders[0][n]
                if not isinstance(source, (list, tuple)):
                    raise ValueError("a contender of last-stage maps alone "
                                     "takes the first contender's stage "
                                     "maps, which has none")
                for s in (stages if staged else [last]):
                    got = as_map(entry[s] if staged else entry)
                    previous = as_map(source[s - 1]) if s else None
                    judge.stage(c, s, got, judged(s, previous), intervals[s],
                                ndepths[s])
                finals.append(got)
            depth, spread, logit_scale = chain[-1]
            judge.chain(finals, depth, spread, intervals[last], logit_scale,
                        ndepths[last])
            judge.maps.append([d.cpu() for d, _, _ in chain])
            judge.intervals.append(intervals[last])
            judge.logit_scales.append(logit_scale)
            del chain, runs, finals
    return judge

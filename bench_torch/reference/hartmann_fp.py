"""Reference of the ``hartmann_fp`` configuration: the multi-patch
similarity network of Hartmann, Galliani, Havlena, Van Gool and
Schindler ("Learned Multi-Patch Similarity", ICCV 2017), as the RayNet
code builds it (raynet/models.py:406-470), scoring every (pixel, plane)
of each reference view.

For every pixel of a reference view: D points evenly spaced between its
ray's bbox entry and exit (float64, then float32); each projected into
the V views in float64 and rounded half to even; around each projection
a patch cut from the view zero-bordered by the patch size (so a patch
that leaves its image reads zeros); each view's patch through the shared
branch (conv 5x5 to 32, tanh, 2x2 max-pool, conv 5x5 to 64, tanh, 2x2
max-pool), the mean over the views, the head (conv 5x5 to 2048, ReLU,
conv 1x1 to 2048, ReLU, conv 1x1 to 2, softmax over the two channels).
A quintuple's score is channel 0, the match probability. The depth of a
pixel is the camera-centre distance of its first best plane; the program
caps it at 800, which no ray of a cell's framed rig reaches.

Plain ``torch`` (``F.conv2d``, ``tanh``, ``max_pool2d``, ``relu``,
``softmax``) in float32 with TF32 off, the patches cut by slicing each
view's windows (``Tensor.unfold``), in blocks of quintuples. It imports
nothing of the program; the benchmark gives it the scene and the weights
it drew from the seed. ``plain.Judge`` gets each ray's D scores and the
planes' distances, with a count of D for every ray; the judge it returns
also carries ``spread``, how far the scores move over the planes and how
near each ray's best two planes come.
"""
import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference import common, plain


def sample_points(scene, i, planes):
    """(N, D, 3) float32 points of reference view ``i``, rays column-major
    (ray r is pixel x = r // H, y = r % H): D evenly spaced from each
    pixel's ray's bbox entry to its exit, in float64."""
    H, W = scene.image_shape
    cam = scene.get_image(i).camera
    x = np.repeat(np.arange(W), H)
    y = np.tile(np.arange(H), W)
    hom = np.dot(cam.P_pinv, np.stack([x, y, np.ones_like(x)])
                 .astype(np.float64))
    center = cam.center[:3]  # (3, 1) float32, as the cameras hold it
    d = hom[:3] / hom[3:] - center
    box = scene.bbox.reshape(-1)
    # the bbox's offsets from the centre in the cameras' float32, as the
    # sampling scheme takes them
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (box[:3, None] - center) / d
        t2 = (box[3:, None] - center) / d
    t_near = np.minimum(t1, t2).max(axis=0)
    t_far = np.maximum(t1, t2).min(axis=0)
    t = np.linspace(t_near, t_far, planes, axis=-1)  # (N, D)
    pts = center.T[:, None, :] + d.T[:, None, :] * t[..., None]
    return pts.astype(np.float32)


def windows(scene, views, patch_shape, device):
    """(V, Hp - ph + 1, Wp - pw + 1, C, ph, pw) views of every ph x pw
    window of each view's float32 image zero-bordered by (ph, pw)."""
    ph, pw = patch_shape[:2]
    out = []
    for j in views:
        image = torch.as_tensor(scene.get_image(j).image, device=device)
        padded = F.pad(image, (0, 0, pw, pw, ph, ph))
        out.append(padded.unfold(0, ph, 1).unfold(1, pw, 1))
    return out


def patches(wins, P, pts, patch_shape):
    """(K, V, C, ph, pw) patches around the projections of ``pts`` (K, 3)
    float32 into each view (P (V, 3, 4) float64)."""
    ph, pw = patch_shape[:2]
    x, y, z = (pts[:, k].to(torch.float64) for k in range(3))
    out = []
    for v, win in enumerate(wins):
        p = P[v]
        u = p[0, 0] * x + p[0, 1] * y + p[0, 2] * z + p[0, 3]
        w = p[1, 0] * x + p[1, 1] * y + p[1, 2] * z + p[1, 3]
        s = p[2, 0] * x + p[2, 1] * y + p[2, 2] * z + p[2, 3]
        # the window's first row and column in the bordered image; a patch
        # wholly outside its image reads a window of the zero border
        r0 = (torch.round(w / s).to(torch.int64) - ph // 2 + ph).clamp(
            0, win.shape[0] - 1)
        c0 = (torch.round(u / s).to(torch.int64) - pw // 2 + pw).clamp(
            0, win.shape[1] - 1)
        out.append(win[r0, c0])
    return torch.stack(out, dim=1)


def scores(quint, weights):
    """(K,) match probabilities of (K, V, C, ph, pw) quintuples."""
    k, v = quint.shape[:2]
    x = quint.reshape((k * v,) + quint.shape[2:])
    for i in range(2):
        x = F.conv2d(x, weights["cnn.convs.%d.weight" % i],
                     weights["cnn.convs.%d.bias" % i])
        x = F.max_pool2d(torch.tanh(x), 2)
    x = x.reshape((k, v) + x.shape[1:]).mean(dim=1)
    for i in range(2):
        x = torch.relu(F.conv2d(x, weights["head.%d.weight" % i],
                                weights["head.%d.bias" % i]))
    x = torch.softmax(F.conv2d(x, weights["head.2.weight"],
                               weights["head.2.bias"]), dim=1)
    return x[:, 0].reshape(k, -1).mean(dim=1)


def run(scene, weights, config, traffic, contenders, device, tf32=False,
        block=1 << 13):
    """The ``plain.Judge`` of ``contenders`` against this reference over
    the reference views of ``traffic``; ``block`` quintuples at a time
    (whole rays)."""
    D = config["depth_planes"]
    shape = config["patch_shape"]
    rays_per_block = max(1, block // D)
    judge = plain.Judge(contenders)
    spread, tie = [], []
    for n, i in enumerate(range(*traffic["images_range"])):
        views = scene.get_view_idxs(i, config["neighbors"])
        P = torch.as_tensor(np.stack([scene.get_image(j).camera.P
                                      for j in views]),
                            device=device).to(torch.float64)
        center = plain.f32(scene.get_image(i).camera.center[:3, 0], device)
        pts = torch.as_tensor(sample_points(scene, i, D), device=device)
        wins = windows(scene, views, shape, device)
        for lo in range(0, pts.shape[0], rays_per_block):
            block_pts = pts[lo:lo + rays_per_block]
            b = block_pts.shape[0]
            with common.precision(tf32):
                s = scores(patches(wins, P, block_pts.reshape(-1, 3), shape),
                           weights).reshape(b, D)
            dist = torch.linalg.vector_norm(block_pts - center, dim=-1)
            judge.add(n, lo, s, dist, torch.full((b,), D, device=device))
            top = s.topk(min(2, D), dim=1).values
            spread.append((top[:, 0] - s.min(dim=1).values).cpu())
            tie.append(((top[:, 0] - top[:, -1]) / top[:, 0]).cpu())
    # how far the scores move over the planes, and how near the best two
    # come, against float32 rounding
    spread, tie = torch.cat(spread), torch.cat(tie)
    judge.spread = {"median_max_minus_min": float(spread.median()),
                    "min_max_minus_min": float(spread.min()),
                    "share_best_two_within_1e-5": float((tie < 1e-5).double()
                                                        .mean()),
                    "share_best_two_within_1e-3": float((tie < 1e-3).double()
                                                        .mean())}
    return judge

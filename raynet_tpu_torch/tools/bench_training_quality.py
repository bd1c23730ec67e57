"""Training quality: does the port's MVCNN learn, and does end-to-end
training through unrolled BP lower its loss and move gamma?

Counterpart of the root ``tools/bench_training_quality.py``, whose numbers
``bench.py`` reports as ``pretrain_val_acc``, ``pretrain_val_mde``,
``e2e_train_loss_ratio`` and ``e2e_gamma_moved``. No dataset ships with
the repository, so both runs use the synthetic textured-quad ring scene
(``make_textured_scene``) through the training pipeline a user runs:

- ``pretrain_quality``: ``DefaultSampleGenerator`` -> ``BatchProvider``
  (its forked producer) -> ``MultiViewSimilarityNet`` training steps over
  a fixed training set kept on the device, then one pass over a fixed
  validation set (acc: argmax-plane match; mde: mean |argmax_y -
  argmax_pred| in planes);
- ``e2e_quality``: ``RayNetSampleGenerator`` -> ``RayNetBatchProvider``
  (each batch's voxel traversal in one ``voxel_traversal_flat`` call: K3's
  rows mode on a card) -> the unrolled-BP training step with a trainable
  gamma.

    python -m raynet_tpu_torch.tools.bench_training_quality [--device cuda]

prints the four metrics as bench.py derives them, each with the seconds
of its run; ``--device`` defaults to ``cuda`` and raises without a card.

One difference from the JAX tool: its validation and training sets share
one generator drawn by a producer thread; the port's producer is a forked
process, which would draw the same samples twice from one generator, so
the two sets come from generators of their own, seeded as
``raynet_pretrain_torch`` seeds its test set and first epoch.
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def make_textured_scene(root, h=48, w=64, n_frames=6, focal=110.0):
    """Restrepo-format ring scene around a textured quad at z = 0 (the test
    mock's geometry, radius 20 and bbox +-3, with the focal raised so that
    the quad fills the frame). The texture is lightly smoothed noise, so
    that patch correlation tells nearby depth planes apart. The same files
    as the JAX tool's: PNGs of the same pixels (written with Pillow), the
    camera text, ``scene_info.xml`` and ``gt_mesh.obj`` byte for byte."""
    from PIL import Image

    os.makedirs(root + "/imgs")
    os.makedirs(root + "/cams_krt")
    rng = np.random.RandomState(3)
    # one shared world texture: project the quad's (x, y) into each view
    tex = rng.rand(128, 128, 3)
    tex = 0.25 * (
        tex
        + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, -1, 0)
    )
    tex = (tex - tex.min()) / (tex.max() - tex.min())

    def cam(angle):
        K = np.array(
            [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64
        )
        c = np.array([20.0 * np.sin(angle), 0.0, -20.0 * np.cos(angle)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        return K, R, (-R @ c.reshape(3, 1))

    for i in range(n_frames):
        K, R, t = cam((i - n_frames / 2) * 0.05)
        P = K @ np.hstack([R, t])
        # render the z = 0 quad: intersect each pixel's ray with z = 0 and
        # sample the texture (black outside the quad)
        ys, xs = np.mgrid[0:h, 0:w]
        pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)
        Pp = np.linalg.pinv(P)  # (4, 3)
        rays = pix @ Pp.T  # homogeneous backprojection, (h, w, 4)
        pts = rays[..., :3] / rays[..., 3:]
        c_pos = -np.linalg.inv(R) @ t
        d = pts - c_pos.ravel()
        tz = -c_pos.ravel()[2] / np.where(np.abs(d[..., 2]) < 1e-9, 1e-9,
                                          d[..., 2])
        hit = c_pos.ravel() + tz[..., None] * d
        u = ((hit[..., 0] + 3) / 6 * 127).clip(0, 127)
        v = ((hit[..., 1] + 3) / 6 * 127).clip(0, 127)
        inside = (
            (np.abs(hit[..., 0]) <= 3) & (np.abs(hit[..., 1]) <= 3)
            & (tz > 0)
        )
        img = tex[v.astype(int), u.astype(int)] * inside[..., None]
        Image.fromarray((img * 255).astype(np.uint8)).save(
            root + "/imgs/frame%05d.png" % (i + 1,))
        rows = (
            [" ".join("%.9g" % val for val in row) for row in K]
            + [" ".join("%.9g" % val for val in row) for row in R]
            + [" ".join("%.9g" % val for val in t.ravel())]
        )
        with open(root + "/cams_krt/frame%05d_cam.txt" % (i + 1,), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(root + "/scene_info.xml", "w") as f:
        f.write(
            '<?xml version="1.0"?>\n<info>\n'
            '  <bbox minx="-3" miny="-3" minz="-3" maxx="3" maxy="3" '
            'maxz="3"/>\n</info>\n'
        )
    with open(root + "/gt_mesh.obj", "w") as f:
        f.write(
            "v -3 -3 0\nv 3 -3 0\nv 3 3 0\nv -3 3 0\n"
            "vn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\n"
            "f 1//1 2//2 3//3\nf 1//1 3//3 4//4\n"
        )


def _generation_params(depth_planes, **extra):
    from ..common.generation_parameters import (
        GenerationParameters,
        get_target_distribution_factory,
    )

    return GenerationParameters(
        depth_planes=depth_planes,
        neighbors=4,
        patch_shape=(11, 11, 3),
        grid_shape=np.array([12, 12, 12], np.int32),
        max_number_of_marched_voxels=24,
        padding=11,
        target_distribution_factory=get_target_distribution_factory(
            "dirac", 1.0, False
        ),
        **extra,
    )


def _rng(*key):
    return np.random.RandomState(list(key))


def pretrain_quality(steps=600, batch_size=32, depth_planes=8,
                     n_train=512, n_val=128, lr=1e-3, seed=0, device="cuda"):
    """Train a MultiViewSimilarityNet on patches sampled from the textured
    scene; return the validation metrics (val_acc, val_mde, val_loss) and
    the first and last training losses (the last: the mean of the last 20).

    The training set (``n_train`` samples, in whole batches) and the
    validation set stay on ``device`` as whole stacks; the steps run an
    epoch-style loop over them, and the metrics come to the host once, at
    the end."""
    from ..common.dataset import RestrepoDataset
    from ..common.sampling_schemes import make_sampling_scheme
    from ..scripts.arguments import default_input_output_shape
    from ..scripts.pretrain_network import collect_test_set
    from ..train.batch_provider import BatchProvider
    from ..train.pretrain import create_pretrain_state, make_pretrain_step
    from ..train.sample import DefaultSampleGenerator
    from ..utils.generic_utils import resolve_device

    device = resolve_device(device)
    gp = _generation_params(depth_planes)
    scheme = make_sampling_scheme("sample_in_bbox", gp, device=device)
    in_shapes, out_shapes = default_input_output_shape(gp)

    def generator(rng):
        return DefaultSampleGenerator(scheme, gp, [0], in_shapes, out_shapes,
                                      rng=rng)

    with tempfile.TemporaryDirectory(prefix="quality_scene_") as root:
        make_textured_scene(root + "/scene_1")
        dataset = RestrepoDataset(root, device=device)
        val_X, val_y = collect_test_set(dataset, generator(_rng(seed)),
                                        n_val, batch_size, _rng(seed, 1))
        provider = BatchProvider(dataset, generator(_rng(seed, 0, 0)),
                                 cache_size=n_train, batch_size=batch_size,
                                 rng=_rng(seed, 0, 1))
        try:
            provider.ready()
            n_batches = max(n_train // batch_size, 1)
            host = [provider.get_batch() for _ in range(n_batches)]
        finally:
            provider.stop()

    def stack(arrays):
        return torch.as_tensor(np.stack(arrays), device=device)

    tX1 = stack([b[0][0] for b in host])
    tX2 = stack([b[0][1] for b in host])
    tY = stack([b[1][0] for b in host])
    vX1, vX2, vY = (torch.as_tensor(a, device=device)
                    for a in (val_X[0], val_X[1], val_y[0]))

    model, state, loss_fn, wd = create_pretrain_state(
        seed, (depth_planes, gp.neighbors + 1) + tuple(gp.patch_shape),
        lr=lr, device=device)
    train_step, eval_step = make_pretrain_step(model, loss_fn, wd)

    losses = []
    for i in range(steps):
        b = i % n_batches
        state, m = train_step(state, tX1[b], tX2[b], tY[b])
        losses.append(m["loss"])

    # one validation pass in whole batches
    val = []
    for off in range(0, int(vY.shape[0]) - batch_size + 1, batch_size):
        sl = slice(off, off + batch_size)
        vm = eval_step(state, vX1[sl], vX2[sl], vY[sl])
        val.append(torch.stack([vm["acc"], vm["mde"], vm["loss"]]))
    # one host sync for the whole run
    losses = torch.stack(losses).cpu().numpy()
    acc, mde, vloss = torch.stack(val).mean(dim=0).cpu().tolist()
    return {
        "val_acc": acc,
        "val_mde": mde,
        "val_loss": vloss,
        "train_loss_first": float(losses[0]),
        "train_loss_last": float(np.mean(losses[-20:])),
    }


def e2e_quality(iterations=12, lr=5e-3, seed=0, device="cuda"):
    """A short end-to-end run (the unrolled-BP training step on RayNet
    batches of 8 rays, 2 BP iterations, gamma trained from 0.031): the mean
    loss of the first and of the last 3 iterations, and how far gamma
    moved."""
    from ..common.dataset import RestrepoDataset
    from ..common.sampling_schemes import make_sampling_scheme
    from ..scripts.arguments import get_input_output_shapes
    from ..train.batch_provider import RayNetBatchProvider
    from ..train.sample import RayNetSampleGenerator
    from ..train.train_e2e import build_end_to_end_training
    from ..utils.generic_utils import resolve_device

    device = resolve_device(device)
    gp = _generation_params(8, gamma_mrf=0.031)
    scheme = make_sampling_scheme("sample_in_bbox", gp, device=device)
    in_shapes, out_shapes = get_input_output_shapes("default")(gp)
    state, train_fn, _ = build_end_to_end_training(
        seed, gp, gp.grid_shape, lr=lr, gamma=0.031, train_with_gamma=True,
        bp_iterations=2, device=device,
    )
    gamma0 = float(state.gamma.detach())
    losses = []
    with tempfile.TemporaryDirectory(prefix="quality_e2e_") as root:
        make_textured_scene(root + "/scene_1")
        sg = RayNetSampleGenerator(
            scheme, gp, [0], in_shapes, out_shapes, window=2,
            rng=np.random.RandomState(seed), device=device,
        )
        provider = RayNetBatchProvider(RestrepoDataset(root, device=device),
                                       sg)
        for _ in range(iterations):
            state, metrics = train_fn(state, provider.get_batch_of_rays(8))
            losses.append(metrics["loss"])
    losses = torch.stack(losses).cpu().numpy()
    return {
        "loss_first": float(np.mean(losses[:3])),
        "loss_last": float(np.mean(losses[-3:])),
        "gamma_delta": abs(float(state.gamma.detach()) - gamma0),
    }


def quality_metrics(pretrain, e2e):
    """bench.py's four metrics (``bench.py:714-753``) from the two runs'
    results: name -> (value, unit)."""
    return {
        "pretrain_val_acc": (pretrain["val_acc"], "fraction"),
        "pretrain_val_mde": (pretrain["val_mde"], "planes"),
        "e2e_train_loss_ratio": (
            e2e["loss_last"] / max(e2e["loss_first"], 1e-9), "x"),
        "e2e_gamma_moved": (e2e["gamma_delta"], "abs"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n_train", type=int, default=1024)
    ap.add_argument("--n_val", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=12,
                    help="end-to-end training iterations")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    pretrain = pretrain_quality(steps=args.steps, n_train=args.n_train,
                                n_val=args.n_val, seed=args.seed,
                                device=args.device)
    t1 = time.perf_counter()
    e2e = e2e_quality(iterations=args.iterations, seed=args.seed,
                      device=args.device)
    t2 = time.perf_counter()
    print("pretrain quality (%.3f s):" % (t1 - t0), pretrain)
    print("e2e quality (%.3f s):" % (t2 - t1), e2e)
    seconds = {"pretrain": t1 - t0, "e2e": t2 - t1}
    for name, (value, unit) in quality_metrics(pretrain, e2e).items():
        print(json.dumps({"metric": name, "value": value, "unit": unit,
                          "seconds": seconds[name.split("_")[0]],
                          "device": str(args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

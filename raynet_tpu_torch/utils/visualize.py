"""Matplotlib plots of images, depth maps, depth distributions and patches,
for debugging samples and eyeballing predictions.

Port of ``raynet_tpu/utils/visualize.py``. matplotlib is imported (with
the non-interactive Agg backend) when a plot is drawn, never when this
module is imported. Every array argument may be a numpy array or a tensor
on any device; images may also be ``common.image.Image`` objects.
"""
import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    """A numpy array of ``x``: an array, a tensor on any device (bfloat16
    as float32), or an Image (its ``image``)."""
    if hasattr(x, "image"):
        x = x.image
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _finish(plt, fig, output_file):
    if output_file:
        fig.savefig(output_file, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_image(image, output_file=None, title=None):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.imshow(_np(image).squeeze())
    if title:
        ax.set_title(title)
    ax.axis("off")
    return _finish(plt, fig, output_file)


def plot_depth_map(depth_map, output_file=None, cmap="viridis"):
    plt = _plt()
    fig, ax = plt.subplots()
    im = ax.imshow(_np(depth_map), cmap=cmap)
    fig.colorbar(im, ax=ax)
    ax.axis("off")
    return _finish(plt, fig, output_file)


def plot_image_with_projected_points(image, pixels, output_file=None):
    """Overlay projected patch centres on an image; pixels: (N, 2) (x, y)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.imshow(_np(image).squeeze())
    pixels = _np(pixels)
    ax.scatter(pixels[:, 0], pixels[:, 1], s=6, c="r", marker="x")
    ax.axis("off")
    return _finish(plt, fig, output_file)


def plot_depth_distribution(s, target=None, output_file=None):
    """Bar plot of a per-ray depth distribution, with an optional target."""
    plt = _plt()
    fig, ax = plt.subplots()
    s = _np(s).ravel()
    ax.bar(np.arange(len(s)), s, alpha=0.7, label="predicted")
    if target is not None:
        target = _np(target).ravel()
        ax.bar(np.arange(len(target)), target, alpha=0.4, label="target")
    ax.set_xlabel("depth hypothesis")
    ax.set_ylabel("probability")
    ax.legend()
    return _finish(plt, fig, output_file)


def plot_batch_of_patches(patches, output_file=None, max_cols=8):
    """Grid plot of an (N, H, W, C) patch batch."""
    plt = _plt()
    patches = _np(patches)
    n = len(patches)
    cols = min(n, max_cols)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(patches[i].squeeze())
    return _finish(plt, fig, output_file)

"""BPInference facade: a uniform OO API over belief-propagation backends.

Port of ``raynet_tpu/ops/bp_inference.py``: ``get_bp_backend(name)`` returns
an inference object with ``update_bp_messages`` /
``estimate_depth_probabilities`` / ``mrf_inference`` / ``reconstruct_scene``.
The reference's backends collapse to the PyTorch one (``TorchBPInference``:
``mrf.belief_propagation`` and ``mrf.depth_estimate`` on ``device``), which
the names "xla", "jax", "tf" and "cuda" select, and the numpy
oracle ``NPBPInference`` stays for verification. ``XLABPInference`` is an
alias name of the PyTorch backend, so configs naming it keep working.
"""
import os

import numpy as np
import torch

from ..utils.generic_utils import resolve_device
from . import mrf
from .ray_marching import flatten_voxel_indices


class BPInference:
    """Base: clip/renorm + message updates against an accumulator grid."""

    def __init__(self, gamma=0.05, bp_iterations=3):
        self.gamma = gamma
        self.bp_iterations = bp_iterations

    def update_bp_messages(
        self, S, ray_voxel_indices, ray_voxel_count, grid_shape,
        messages=None,
    ):
        """Run ``bp_iterations`` sweeps over one batch of rays.

        Returns (grid_acc (D1,D2,D3), messages (N, M)).
        """
        raise NotImplementedError()

    def estimate_depth_probabilities(
        self, S, ray_voxel_indices, ray_voxel_count, grid_acc, messages
    ):
        """Posterior (occlusion-aware) depth distributions S_new (N, M)."""
        raise NotImplementedError()

    def mrf_inference(
        self, S, ray_voxel_indices, ray_voxel_count, grid_shape
    ):
        """update_bp_messages + estimate_depth_probabilities in one call."""
        grid_acc, messages = self.update_bp_messages(
            S, ray_voxel_indices, ray_voxel_count, grid_shape
        )
        S_new = self.estimate_depth_probabilities(
            S, ray_voxel_indices, ray_voxel_count, grid_acc, messages
        )
        return S_new, grid_acc, messages

    def reconstruct_scene(
        self,
        scene,
        forward_pass,
        images_range,
        output_directory,
        fmt="depth_mrf_%03d.npy",
    ):
        """Run a forward pass over a scene and persist per-view depth maps
        (parity: bp_inference.py:42-59)."""
        os.makedirs(output_directory, exist_ok=True)
        start, end, skip = images_range
        paths = []
        for i, depth_map in zip(
            range(start, end, skip),
            forward_pass.forward_pass(scene, images_range),
        ):
            path = os.path.join(output_directory, fmt % (i,))
            np.save(path, depth_map.astype(np.float32))
            paths.append(path)
        return paths


class TorchBPInference(BPInference):
    """The PyTorch backend, on ``device`` (default the card)."""

    def __init__(self, gamma=0.05, bp_iterations=3, device="cuda"):
        super().__init__(gamma, bp_iterations)
        self.device = resolve_device(device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def update_bp_messages(
        self, S, ray_voxel_indices, ray_voxel_count, grid_shape,
        messages=None,
    ):
        grid_acc, msgs = mrf.belief_propagation(
            self._tensor(S), self._tensor(ray_voxel_indices),
            self._tensor(ray_voxel_count), tuple(int(g) for g in grid_shape),
            gamma=self.gamma, bp_iterations=self.bp_iterations,
        )
        return grid_acc.cpu().numpy(), msgs.cpu().numpy()

    def estimate_depth_probabilities(
        self, S, ray_voxel_indices, ray_voxel_count, grid_acc, messages
    ):
        grid_shape = np.asarray(grid_acc).shape
        flat_idx = flatten_voxel_indices(
            self._tensor(ray_voxel_indices), grid_shape
        )
        return mrf.depth_estimate(
            self._tensor(S), flat_idx, self._tensor(ray_voxel_count),
            self._tensor(messages), self._tensor(grid_acc).reshape(-1),
        ).cpu().numpy()


# the JAX package's name for its accelerated backend
XLABPInference = TorchBPInference


class NPBPInference(BPInference):
    """Sequential numpy oracle (test/verification backend)."""

    def update_bp_messages(
        self, S, ray_voxel_indices, ray_voxel_count, grid_shape,
        messages=None,
    ):
        grid_shape = tuple(int(g) for g in grid_shape)
        grid_size = int(np.prod(grid_shape))
        d2, d3 = grid_shape[1], grid_shape[2]
        flat = (
            ray_voxel_indices[..., 0] * (d2 * d3)
            + ray_voxel_indices[..., 1] * d3
            + ray_voxel_indices[..., 2]
        )
        n, m = S.shape
        msgs = np.zeros((n, m), dtype=np.float64)
        prior = np.log(self.gamma) - np.log(1 - self.gamma)
        grid_prev = np.full(grid_size, prior, dtype=np.float64)
        for _ in range(self.bp_iterations):
            grid_new = np.full(grid_size, prior, dtype=np.float64)
            for r in range(n):
                c = int(ray_voxel_count[r])
                if c <= 1:
                    continue
                pon = self._single_ray(
                    grid_prev, flat[r, :c], msgs[r, :c],
                    self._clip_renorm(S[r, :c].astype(np.float64)),
                )
                np.add.at(grid_new, flat[r, :c], pon)
                msgs[r, :c] = pon
            grid_prev = grid_new
        return (
            grid_prev.reshape(grid_shape).astype(np.float32),
            msgs.astype(np.float32),
        )

    @staticmethod
    def _clip_renorm(x, eps=1e-5):
        x = np.clip(x, eps, 1 - eps)
        return x / x.sum()

    @staticmethod
    def _occupancy_to_ray(grid_acc, flat_idx, msgs):
        pon = grid_acc[flat_idx] - msgs
        mx = np.maximum(0.0, pon)
        t1 = np.exp(0.0 - mx)
        t2 = np.exp(pon - mx)
        return np.clip(t2 / (t2 + t1), 1e-4, 1 - 1e-4)

    def _single_ray(self, grid_acc, flat_idx, msgs, s):
        mu = self._occupancy_to_ray(grid_acc, flat_idx, msgs)
        neg_cumprod = np.hstack([[1.0], (1 - mu).cumprod()])
        contrib = mu * neg_cumprod[:-1] * s
        cumsum_incl = contrib.cumsum()
        cumsum_excl = cumsum_incl - contrib
        total = contrib.sum()
        pos = cumsum_excl + neg_cumprod[:-1] * s
        neg = cumsum_excl + (total - cumsum_incl) / (1 - mu)
        p = pos / (pos + neg)
        return np.log(p) - np.log(1 - p)

    def estimate_depth_probabilities(
        self, S, ray_voxel_indices, ray_voxel_count, grid_acc, messages
    ):
        grid_shape = np.asarray(grid_acc).shape
        d2, d3 = grid_shape[1], grid_shape[2]
        flat_grid = np.asarray(grid_acc, dtype=np.float64).reshape(-1)
        flat = (
            ray_voxel_indices[..., 0] * (d2 * d3)
            + ray_voxel_indices[..., 1] * d3
            + ray_voxel_indices[..., 2]
        )
        n, m = S.shape
        out = np.zeros((n, m), dtype=np.float32)
        for r in range(n):
            c = int(ray_voxel_count[r])
            if c <= 1:
                continue
            mu = self._occupancy_to_ray(
                flat_grid, flat[r, :c], messages[r, :c]
            )
            neg_cumprod = np.hstack([[1.0], (1 - mu).cumprod()])
            p = mu * neg_cumprod[:-1] * self._clip_renorm(
                S[r, :c].astype(np.float64)
            )
            out[r, :c] = p / p.sum()
        return out


_BACKENDS = {
    "numpy": NPBPInference,
    "xla": TorchBPInference,
    "jax": TorchBPInference,
    "tf": TorchBPInference,
    "cuda": TorchBPInference,
}


def get_bp_backend(name, gamma=0.05, bp_iterations=3, device="cuda"):
    """Backend factory: "numpy" is the oracle; the JAX package's "xla",
    "jax", "tf" and "cuda" are the PyTorch backend on ``device``. Another
    name raises KeyError."""
    cls = _BACKENDS[name]
    if cls is NPBPInference:
        return cls(gamma=gamma, bp_iterations=bp_iterations)
    return cls(gamma=gamma, bp_iterations=bp_iterations, device=device)

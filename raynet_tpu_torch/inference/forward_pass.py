"""Inference orchestration: the ``multi_view_cnn``,
``multi_view_cnn_voxel_space`` and ``raynet`` forward passes.

Port of ``raynet_tpu/inference/forward_pass.py``: the ``ForwardPass`` base
(:109-583), ``MultiViewCNNForwardPass`` (:587),
``MultiViewCNNVoxelSpaceForwardPass`` (:621) and ``RayNetForwardPass``
(:658). The first two run
one fused step per ray batch of each reference view (the plane sweep and
its argmax depth; with the voxel traversal and the depth->voxel mapping in
between for the voxel-space pass). The raynet pass follows the reference
schedule (raynet/forward_pass.py:579-748); for each call it

1. computes the CNN features of every image it needs, once, cached per image;
2. computes the bbox segments and the plane-sweep scores of every ray of
   every reference view once (neither depends on the BP messages);
3. runs ``bp_iterations`` message sweeps over all reference views against
   one shared voxel log-odds grid, reset to the prior log(g/(1-g)) at every
   iteration, with the per-image messages kept on the device in float32,
   (rays, M) in DDA order, and updated in place;
4. runs one depth sweep and yields a ``(W, H).T`` depth map per view.

On the card each of these sweeps is one kernel launch per image (K1 once
per image, K2 once per image and sweep); on the CPU the plain versions run
``rays_batch`` rays at a time.

What the JAX package adds on top of this — beam/band planners, box classes,
host staging, the plan prefetcher, the sharded scan and the VMEM retry —
exists because Mosaic has no in-kernel gather, and is not ported.
"""
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..models.feature_extractor import zeropad_images
from ..ops import fused
from ..ops.mrf import log_prior
from ..ops.sampling import segments_in_bbox
from ..utils.profiling import PhaseTimer


def resolve_device(device):
    """torch.device for ``device``; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %s requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path" % (device,)
        )
    return device


class ForwardPass:
    """Shared plumbing: feature caching, ray enumeration, ray batches (of
    the per-view passes; ``rays_batch`` bounds the raynet pass's plain
    versions on the CPU).

    The arguments are the JAX package's, plus ``device``; the ported passes
    sample along bbox segments and read neither ``sampling_scheme`` nor
    ``image_shape`` (the scene gives the shape).
    """

    def __init__(self, model, generation_params, sampling_scheme,
                 image_shape, rays_batch=50000, filter_out_rays=False,
                 device="cuda"):
        del sampling_scheme, image_shape
        self.device = resolve_device(device)
        self._model = model
        self._generation_params = generation_params
        self.rays_batch = rays_batch
        self._filter_out_rays = filter_out_rays
        self._feature_cache = OrderedDict()
        self.max_cached_view_sets = 12
        self._image_feature_cache = OrderedDict()
        self.max_cached_image_features = generation_params.neighbors + 2
        self._scene_token = None
        self.timer = PhaseTimer(verbose=False, device=self.device)

    def _check_scene(self, scene):
        """Drop per-scene caches when called on a different scene."""
        token = self._scene_token
        if token is None or token() is not scene:
            try:
                self._scene_token = weakref.ref(scene)
            except TypeError:
                self._scene_token = lambda s=scene: s
            self._feature_cache.clear()
            self._image_feature_cache.clear()

    def get_valid_rays_per_image(self, scene, i):
        """Column-major ray indices of image ``i``; with ``filter_out_rays``
        only the rays whose ground-truth depth is nonzero."""
        H, W = scene.image_shape
        idxs = np.arange(H * W, dtype=np.int32)
        if self._filter_out_rays:
            grid = idxs.reshape(W, H).T
            G = scene.get_depth_map(i)
            idxs = grid[G != 0].ravel()
        return idxs

    def _image_features(self, scene, img_idx):
        """Feature map of ONE image on ``self.device``, cached per image."""
        cache = self._image_feature_cache
        if img_idx in cache:
            cache.move_to_end(img_idx)
            return cache[img_idx]
        image = scene.get_image(img_idx)
        padded = zeropad_images([image], self._generation_params.padding)
        with self.timer.phase("Features computation"):
            feats = self._model.predict(padded)[0].to(self.device)
        cache[img_idx] = feats
        while len(cache) > self.max_cached_image_features:
            cache.popitem(last=False)
        return feats

    def _features_and_cameras(self, scene, ref_idx):
        """(features (V, Hf, Wf, F), P (V, 3, 4), P_pinv (4, 3),
        center (3,)) of a reference view set, cached."""
        if ref_idx in self._feature_cache:
            self._feature_cache.move_to_end(ref_idx)
        else:
            view_idxs = scene.get_view_idxs(
                ref_idx, self._generation_params.neighbors
            )
            images = [scene.get_image(j) for j in view_idxs]
            features = torch.stack(
                [self._image_features(scene, j) for j in view_idxs]
            )

            def f32(a):
                return torch.as_tensor(
                    np.asarray(a, np.float32), device=self.device
                )

            P = f32(np.stack([im.camera.P for im in images]))
            P_pinv = f32(images[0].camera.P_pinv)
            center = f32(images[0].camera.center[:3, 0])
            self._feature_cache[ref_idx] = (features, P, P_pinv, center)
            while len(self._feature_cache) > self.max_cached_view_sets:
                self._feature_cache.popitem(last=False)
        return self._feature_cache[ref_idx]

    def _ray_batches(self, ray_idxs):
        """(offset, n_valid, chunk) per ``rays_batch`` rays; the last chunk
        is padded with its last ray, and the steps mask the padded rows
        (n_valid) out of every scatter."""
        b = self.rays_batch
        out = []
        for off in range(0, len(ray_idxs), b):
            chunk = ray_idxs[off:off + b]
            n_valid = len(chunk)
            if n_valid < b:
                chunk = np.concatenate(
                    [chunk, np.full(b - n_valid, chunk[-1], np.int32)]
                )
            out.append((
                off, n_valid,
                torch.as_tensor(np.ascontiguousarray(chunk),
                                device=self.device),
            ))
        return out

    def forward_pass(self, scene, images_range):
        raise NotImplementedError()


def _check_images_range(images_range):
    if not isinstance(images_range, tuple) or len(images_range) != 3:
        raise TypeError("images_range must be a (start, end, skip) tuple")
    return images_range


class _PerViewDepthPass(ForwardPass):
    """A pass whose depth of a ray depends only on its own view set: one
    step per ray batch, a ``(W, H).T`` depth map per reference view."""

    def _depth_step(self, chunk, features, P, P_pinv, center, bbox, H, W):
        """(N,) float32 depths of the rays of ``chunk``."""
        raise NotImplementedError()

    def forward_pass(self, scene, images_range):
        """Yield one (H, W) float32 depth map per reference image of
        ``images_range`` = (start, end, skip)."""
        start, end, skip = _check_images_range(images_range)
        self._check_scene(scene)
        H, W = scene.image_shape
        bbox = torch.as_tensor(
            np.asarray(scene.bbox, np.float32).reshape(-1), device=self.device
        )
        for ref_idx in range(start, end, skip):
            ray_idxs = self.get_valid_rays_per_image(scene, ref_idx)
            features, P, P_pinv, center = self._features_and_cameras(
                scene, ref_idx
            )
            depth = torch.zeros(len(ray_idxs), dtype=torch.float32,
                                device=self.device)
            with self.timer.phase("Per-pixel depth estimation"):
                for off, n_valid, chunk in self._ray_batches(ray_idxs):
                    d = self._depth_step(chunk, features, P, P_pinv, center,
                                         bbox, H, W)
                    depth[off:off + n_valid] = d[:n_valid]
                depth = depth.cpu().numpy()
            depth_map = np.zeros(H * W, dtype=np.float32)
            depth_map[ray_idxs] = depth
            yield depth_map.reshape(W, H).T


class MultiViewCNNForwardPass(_PerViewDepthPass):
    """Plane-sweep scoring + argmax depth (factory name: multi_view_cnn)."""

    def _depth_step(self, chunk, features, P, P_pinv, center, bbox, H, W):
        gp = self._generation_params
        _, depth = fused.mvcnn_depth_step(
            chunk, features, P, P_pinv, center, bbox, H, W, gp.padding,
            gp.depth_planes,
        )
        return depth


class MultiViewCNNVoxelSpaceForwardPass(_PerViewDepthPass):
    """Plane sweep + voxel traversal + depth->voxel argmax
    (factory name: multi_view_cnn_voxel_space)."""

    def _depth_step(self, chunk, features, P, P_pinv, center, bbox, H, W):
        gp = self._generation_params
        *_, depth = fused.mvcnn_voxel_depth_step(
            chunk, features, P, P_pinv, center, bbox, H, W, gp.padding,
            gp.depth_planes, tuple(int(g) for g in gp.grid_shape),
            int(gp.max_number_of_marched_voxels),
        )
        return depth


class RayNetForwardPass(ForwardPass):
    """Full pipeline with MRF BP over all views (factory name: raynet)."""

    bp_iterations = 3
    # Device bytes the per-image messages and cached scores may take. Over
    # it the pass raises: the host message store of the JAX package
    # (f16 / memmap) is not ported yet, and nothing falls back silently.
    messages_device_budget = 40 << 30

    def forward_pass(self, scene, images_range):
        """Yield one (H, W) float32 depth map per reference image of
        ``images_range`` = (start, end, skip)."""
        start, end, skip = _check_images_range(images_range)
        self._check_scene(scene)
        H, W = scene.image_shape
        gp = self._generation_params
        gamma = gp.gamma_mrf if gp.gamma_mrf is not None else 0.05
        prior = float(log_prior(gamma))
        grid_shape = tuple(int(g) for g in gp.grid_shape)
        grid_size = int(np.prod(grid_shape))
        M = int(gp.max_number_of_marched_voxels)
        D = int(gp.depth_planes)
        dev = self.device
        bbox = torch.as_tensor(
            np.asarray(scene.bbox, np.float32).reshape(-1), device=dev
        )
        ref_indices = list(range(start, end, skip))
        ray_idxs = {
            i: self.get_valid_rays_per_image(scene, i) for i in ref_indices
        }
        # per ray: the messages, the scores and the two segment endpoints
        need = sum(len(r) * (M + D + 6) * 4 for r in ray_idxs.values())
        if need > self.messages_device_budget:
            raise RuntimeError(
                "the messages, scores and segments of %d views need %.2f GB "
                "of device memory, over messages_device_budget = %.2f GB; run "
                "fewer views per call (the host message store is not ported "
                "yet)" % (len(ref_indices), need / 1e9,
                          self.messages_device_budget / 1e9)
            )
        common = dict(height=H, width=W, padding=gp.padding, depth_planes=D,
                      rays_batch=self.rays_batch)
        bp = dict(grid_shape=grid_shape, max_voxels=M,
                  rays_batch=self.rays_batch)

        for i in ref_indices:
            self._features_and_cameras(scene, i)
        segments, scores = {}, {}
        with self.timer.phase("Plane sweep"):
            for i in ref_indices:
                features, P, P_pinv, center = self._features_and_cameras(
                    scene, i
                )
                idxs = torch.as_tensor(
                    np.ascontiguousarray(ray_idxs[i]), device=dev
                )
                segments[i] = segments_in_bbox(
                    idxs, P_pinv, center, bbox, H
                )
                scores[i] = fused.raynet_image_scores(
                    *segments[i], features, P, **common,
                )
        # DDA order; a ray's count is the same in every sweep, so the
        # entries past it stay zero
        messages = {
            i: torch.zeros((len(ray_idxs[i]), M), dtype=torch.float32,
                           device=dev)
            for i in ref_indices
        }

        grid_acc = torch.full((grid_size,), prior, dtype=torch.float32,
                              device=dev)
        with self.timer.phase("Message passing"):
            for iteration in range(self.bp_iterations):
                scatter_total = torch.full(
                    (grid_size,), prior, dtype=torch.float32, device=dev
                )
                for i in ref_indices:
                    center = self._features_and_cameras(scene, i)[3]
                    fused.raynet_image_update(
                        messages[i], scores[i], scatter_total, grid_acc,
                        *segments[i], center, bbox, **bp,
                        first_iteration=(iteration == 0), prior=prior,
                    )
                grid_acc = scatter_total

        for i in ref_indices:
            with self.timer.phase("Per-pixel depth estimation"):
                center = self._features_and_cameras(scene, i)[3]
                depth = fused.raynet_image_depth(
                    messages[i], scores[i], grid_acc, *segments[i], center,
                    bbox, **bp,
                ).cpu().numpy()
            depth_map = np.zeros(H * W, dtype=np.float32)
            depth_map[ray_idxs[i]] = depth
            yield depth_map.reshape(W, H).T


_FACTORIES = {
    "multi_view_cnn": MultiViewCNNForwardPass,
    "multi_view_cnn_voxel_space": MultiViewCNNVoxelSpaceForwardPass,
    "raynet": RayNetForwardPass,
}


def get_forward_pass_factory(name):
    """The forward-pass class for ``name``; ``hartmann_fp`` is not ported
    yet and raises."""
    if name not in _FACTORIES:
        raise NotImplementedError(
            "forward pass factory %r is not ported to raynet_tpu_torch yet "
            "(have: %s)" % (name, ", ".join(sorted(_FACTORIES)))
        )
    return _FACTORIES[name]

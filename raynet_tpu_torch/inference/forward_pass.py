"""Inference orchestration: the ``multi_view_cnn``,
``multi_view_cnn_voxel_space``, ``raynet``, ``hartmann_fp``, ``mvsnet`` and
``casmvsnet`` forward passes.

Port of ``raynet_tpu/inference/forward_pass.py``: the ``ForwardPass`` base
(:109-583), ``MultiViewCNNForwardPass`` (:587),
``MultiViewCNNVoxelSpaceForwardPass`` (:621), ``RayNetForwardPass`` (:658)
and ``HartmannForwardPass`` (:2001). The first two compute each reference
view's bbox segments once and its depths over all of its rays
(``fused.mvcnn_image_depth``: the plane sweep and its argmax depth;
``fused.mvcnn_voxel_image_depth``: the plane sweep, then the voxel
traversal, depth->voxel mapping and argmax in K3's voxel-depth mode). The
raynet pass follows the reference schedule (raynet/forward_pass.py:579-748);
for each call it

1. computes the CNN features of every image it needs, once, cached per image;
2. computes the bbox segments and the plane-sweep scores of every ray of
   every reference view once (neither depends on the BP messages);
3. runs ``bp_iterations`` message sweeps over all reference views against
   one shared voxel log-odds grid, reset to the prior log(g/(1-g)) at every
   iteration, with the per-image messages (rays, M) in DDA order updated
   in place in float32 on the device, each sweep one loop over the blocks
   of the call's ``message_store`` (kept on the device, or staged from
   the host); the first sweep also keeps each ray's march count and
   mapped-score total on the device (``bp_sweep``'s ``ray_sums``), which
   the later sweeps read;
4. runs one depth sweep and yields a ``(W, H).T`` depth map per view.

The Hartmann pass scores patch quintuples instead, the MVSNet pass
regularises a dense cost volume, and the CasMVSNet pass a cascade of three
(see their classes).

On the card each of these sweeps is one kernel launch per image (K1 once
per image in every pass, K3's voxel-depth mode once per image in the
voxel-space pass, K2 once per image and sweep in the raynet pass); on the
CPU the plain versions run ``rays_batch`` rays at a time.

With a ray group (``parallel.sharding``: ``torchrun``'s ranks, or a group
made by ``make_ray_group``), the raynet pass splits each image's rays over
the ranks, as the JAX package's sharded scan does: each rank computes the
features of every view, K1 and K2 on its span of each image's rays, and
its own message store; each image's grid scatter of each sweep is summed
over the ranks by one all-reduce, and the depth maps are assembled whole
on every rank.

Each host step of a pass (the raynet and per-view passes' set-up of a
call, ``pass.setup``: the scene check, the bbox, every ray's index; an
image's pad, upload and CNN launches; a view set's feature stack and
camera uploads; a view's ray indices, their upload and segments; each
kernel call; a view's depth map, built on the device and queued for the
host, and the wait for it) is a ``utils.profiling.span`` of a fixed name,
a ``record_function`` range only while a profiler records, nested in its
phase or directly in the pass, and closed before the pass yields. A pass
queues the next view's device work (the raynet pass: every view's) before
the host waits for a map, so that the card is not left idle behind the
host's wait.

What the JAX package adds on top of this — beam/band planners, box classes,
the plan prefetcher and the VMEM retry — exists because Mosaic has no
in-kernel gather, and is not ported.
"""
import contextlib
import functools
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..common.image import gather_patches, padded_images
from ..models import casmvsnet, mvsnet
from ..models.feature_extractor import zeropad_images
from ..ops import cost_volume, fused
from ..ops.mrf import log_prior
from ..ops.sampling import get_sampling_scheme_op, segments_in_bbox
from ..parallel import sharding
from ..utils.generic_utils import resolve_device
from ..utils.profiling import PhaseTimer, span
from . import message_store


class ForwardPass:
    """Shared plumbing: feature caching and ray enumeration. ``rays_batch``
    bounds the rays the plain versions take at a time on the CPU; on the
    card every kernel takes a whole image.

    The arguments are the JAX package's, plus ``device``; the plane-sweep
    passes sample along bbox segments and read no ``sampling_scheme`` (the
    Hartmann pass does), and none reads ``image_shape`` (the scene gives
    the shape).
    """

    def __init__(self, model, generation_params, sampling_scheme,
                 image_shape, rays_batch=50000, filter_out_rays=False,
                 device="cuda"):
        del image_shape
        self.device = resolve_device(device)
        self._sampling_scheme = sampling_scheme
        self._model = model
        self._generation_params = generation_params
        self.rays_batch = rays_batch
        self._filter_out_rays = filter_out_rays
        self._feature_cache = OrderedDict()
        self.max_cached_view_sets = 12
        self._image_feature_cache = OrderedDict()
        self.max_cached_image_features = generation_params.neighbors + 2
        self._scene_token = None
        self._scene_bbox = None
        self._all_rays = {}
        self.timer = PhaseTimer(device=self.device)
        # views whose map the host waited for after a later view's device
        # work was queued, over the object's calls
        self.overlapped_views = 0

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
            self._scene_bbox = None

    def _bbox(self, scene):
        """The scene's bbox (6,) float32 on the device, uploaded once a
        scene."""
        if self._scene_bbox is None:
            self._scene_bbox = torch.as_tensor(
                np.asarray(scene.bbox, np.float32).reshape(-1),
                device=self.device)
        return self._scene_bbox

    @staticmethod
    def create_depth_map_from_distribution(
        scene, img_idx, S, truncate=800, sampling_scheme="sample_in_bbox",
        device="cuda",
    ):
        """(H, W) depth map of the argmax of a per-ray plane distribution
        ``S`` (N, D), the points sampled on ``device`` by the scheme's op."""
        device = resolve_device(device)
        H, W = scene.image_shape
        image = scene.get_image(img_idx)
        n, d = S.shape

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        extra = (scene.bbox.reshape(-1) if "bbox" in sampling_scheme
                 else scene.depth_range)
        points = get_sampling_scheme_op(sampling_scheme)(
            torch.arange(n, dtype=torch.int32, device=device),
            f32(image.camera.P_pinv), f32(image.camera.center[:3, 0]),
            f32(extra), H, d,
        ).cpu().numpy()
        best = np.asarray(S).argmax(axis=1)
        pts = points[np.arange(n), best]
        depth = np.linalg.norm(
            pts - image.camera.center[:3, 0][None], axis=-1
        )
        return np.minimum(depth.reshape(W, H).T, truncate)

    @staticmethod
    def create_depth_map_from_distribution_with_voting(
        scene, img_idx, points, S, truncate=800
    ):
        """Expectation ("voting") depth instead of the argmax: ``points``
        (4, N, D) homogeneous, ``S`` (N, D)."""
        H, W = scene.image_shape
        center = scene.get_image(img_idx).camera.center
        dists = np.sqrt(
            ((center.reshape(-1, 1, 1) - points) ** 2).sum(axis=0)
        )
        D = (np.asarray(S) * dists).sum(axis=-1)
        return np.minimum(D.reshape(W, H).T, truncate)

    def get_valid_rays_per_image(self, scene, i):
        """Column-major ray indices of image ``i``; with ``filter_out_rays``
        only the rays whose ground-truth depth is nonzero."""
        H, W = scene.image_shape
        idxs = self._every_ray(H, W)
        if self._filter_out_rays:
            grid = idxs.reshape(W, H).T
            G = scene.get_depth_map(i)
            idxs = grid[G != 0].ravel()
        return idxs

    def _every_ray(self, height, width):
        """Column-major indices of every ray of a (height, width) image:
        one read-only array per shape, which ``_DepthMaps`` knows by its
        identity."""
        key = (height, width)
        if key not in self._all_rays:
            idxs = np.arange(height * width, dtype=np.int32)
            idxs.flags.writeable = False
            self._all_rays[key] = idxs
        return self._all_rays[key]

    def _wait_map(self, maps, pending, overlapped):
        """The host's wait for a view's map queued by ``maps.start``;
        ``overlapped``: a later view's device work was queued before it."""
        with self.timer.phase("Per-pixel depth estimation"):
            with span("depth.download"):
                depth_map = maps.wait(pending)
        self.overlapped_views += overlapped
        return depth_map

    def _image_features(self, scene, img_idx):
        """Feature map of ONE image on ``self.device``, cached per image."""
        cache = self._image_feature_cache
        if img_idx in cache:
            cache.move_to_end(img_idx)
            return cache[img_idx]
        image = scene.get_image(img_idx)
        with span("cnn.pad"):
            padded = self._image_input(image)
        with self.timer.phase("Features computation"):
            with span("cnn.upload"):
                padded = torch.as_tensor(padded, device=self.device)
            with span("cnn.net"):
                feats = self._featurise(padded)
        cache[img_idx] = feats
        while len(cache) > self.max_cached_image_features:
            cache.popitem(last=False)
        return feats

    def _image_input(self, image):
        """The (1, H', W', C) host array of one image that the model
        takes: the image zero-padded by ``padding``."""
        return zeropad_images([image], self._generation_params.padding)

    def _featurise(self, image):
        """What the feature cache holds of one image: the model's feature
        map of the (1, H', W', C) device tensor ``image``."""
        return self._model.predict(image)[0].to(self.device)

    def _features_and_cameras(self, scene, ref_idx):
        """(features (V, Hf, Wf, F), P (V, 3, 4), P_pinv (4, 3),
        center (3,)) of a reference view set, cached. A view set built
        anew opens ``views.stack`` (the stack of its cached feature maps)
        and ``views.cameras`` (the cameras' pageable uploads), each after
        every image's features."""
        if ref_idx in self._feature_cache:
            self._feature_cache.move_to_end(ref_idx)
        else:
            view_idxs = scene.get_view_idxs(
                ref_idx, self._generation_params.neighbors
            )
            images = [scene.get_image(j) for j in view_idxs]
            features = [self._image_features(scene, j) for j in view_idxs]
            with span("views.stack"):
                features = torch.stack(features)

            def f32(a):
                return torch.as_tensor(
                    np.asarray(a, np.float32), device=self.device
                )

            with span("views.cameras"):
                P = f32(np.stack([im.camera.P for im in images]))
                P_pinv = f32(images[0].camera.P_pinv)
                center = f32(images[0].camera.center[:3, 0])
            self._feature_cache[ref_idx] = (features, P, P_pinv, center)
            while len(self._feature_cache) > self.max_cached_view_sets:
                self._feature_cache.popitem(last=False)
        return self._feature_cache[ref_idx]

    def forward_pass(self, scene, images_range):
        raise NotImplementedError()


def _check_images_range(images_range):
    if not isinstance(images_range, tuple) or len(images_range) != 3:
        raise TypeError("images_range must be a (start, end, skip) tuple")
    return images_range


def _upload(values, device):
    """A float64 host array ``values`` on ``device``, through one
    page-locked buffer on a card, without blocking the host."""
    cuda = device.type == "cuda"
    host = torch.empty(len(values), dtype=torch.float64, pin_memory=cuda)
    host.numpy()[:] = values
    return host.to(device, non_blocking=cuda)


class _DepthMaps:
    """The (H, W) depth maps of one call's views, each built on the
    call's device from the view's depths and ray indices, and copied to
    the host without blocking it: ``start`` queues a view's map and its
    copy, ``wait`` hands the map over once the copy is done.

    A view whose rays are ``every_ray`` (every ray in column-major order,
    as ``get_valid_rays_per_image`` gives them without
    ``filter_out_rays``) takes its ray indices from a range made on the
    device once a call, and its depths already are the (W, H) map; any
    other view's indices are uploaded, and its depths scattered on the
    device into a zeroed map. On a CUDA device each map lands in
    page-locked host memory of its own, since the caller may keep every
    map, and an event marks the end of its copy; on the CPU it is a plain
    copy. The map is the (W, H) array's transpose, as the numpy scatter
    made it."""

    def __init__(self, device, height, width, every_ray):
        self.device, self.height, self.width = device, height, width
        self.every_ray = every_ray
        self._range = None

    def rays(self, idxs):
        """A view's ray indices ``idxs`` as int32 on the device."""
        if idxs is not self.every_ray:
            return torch.tensor(idxs, dtype=torch.int32, device=self.device)
        if self._range is None:
            self._range = torch.arange(len(idxs), dtype=torch.int32,
                                       device=self.device)
        return self._range

    def start(self, depth, rays):
        """Queue the map of the depths ``depth`` of the rays ``rays`` (as
        ``rays`` gave them) and its copy to the host."""
        n = self.height * self.width
        if rays is not self._range:
            full = torch.zeros(n, dtype=torch.float32, device=self.device)
            depth = full.index_copy_(0, rays.long(),
                                     depth.to(torch.float32))
        cuda = self.device.type == "cuda"
        host = torch.empty(n, dtype=torch.float32, pin_memory=cuda)
        host.copy_(depth, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return host, done

    def wait(self, pending):
        """The (H, W) float32 map of a view ``start`` queued."""
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy().reshape(self.width, self.height).T


class _PerViewDepthPass(ForwardPass):
    """A pass whose depth of a ray depends only on its own view set: one
    per-image depth of every reference view, a ``(W, H).T`` depth map
    each."""

    def _image_depth(self, segments, features, P, center, bbox, H, W):
        """(rows,) float32 depths of the rays of one image, from their
        bbox ``segments`` (ray_start, ray_end)."""
        raise NotImplementedError()

    def forward_pass(self, scene, images_range):
        """Yield one (H, W) float32 depth map per reference image of
        ``images_range`` = (start, end, skip). Each view's work is queued
        before the host waits for the previous view's map."""
        start, end, skip = _check_images_range(images_range)
        with span("pass.setup"):
            self._check_scene(scene)
            H, W = scene.image_shape
            bbox = self._bbox(scene)
            maps = _DepthMaps(self.device, H, W, self._every_ray(H, W))
        pending = None
        for ref_idx in range(start, end, skip):
            with span("rays.index"):
                ray_idxs = self.get_valid_rays_per_image(scene, ref_idx)
            features, P, P_pinv, center = self._features_and_cameras(
                scene, ref_idx
            )
            with self.timer.phase("Per-pixel depth estimation"):
                with span("rays.upload"):
                    idxs = maps.rays(ray_idxs)
                with span("rays.segments"):
                    segments = segments_in_bbox(idxs, P_pinv, center, bbox, H)
                depth = self._image_depth(segments, features, P, center,
                                          bbox, H, W)
            with span("depth.scatter"):
                queued = maps.start(depth, idxs)
            if pending is not None:
                yield self._wait_map(maps, pending, overlapped=True)
            pending = queued
        if pending is not None:
            yield self._wait_map(maps, pending, overlapped=False)


class MultiViewCNNForwardPass(_PerViewDepthPass):
    """Plane-sweep scoring + argmax depth (factory name: multi_view_cnn)."""

    def _image_depth(self, segments, features, P, center, bbox, H, W):
        gp = self._generation_params
        return fused.mvcnn_image_depth(
            *segments, features, P, center, height=H, width=W,
            padding=gp.padding, depth_planes=gp.depth_planes,
            rays_batch=self.rays_batch,
        )


class MultiViewCNNVoxelSpaceForwardPass(_PerViewDepthPass):
    """Plane sweep + voxel traversal + depth->voxel argmax
    (factory name: multi_view_cnn_voxel_space)."""

    def _image_depth(self, segments, features, P, center, bbox, H, W):
        gp = self._generation_params
        with span("voxel_depth"):
            return fused.mvcnn_voxel_image_depth(
                *segments, features, P, center, bbox, height=H, width=W,
                padding=gp.padding, depth_planes=gp.depth_planes,
                grid_shape=tuple(int(g) for g in gp.grid_shape),
                max_voxels=int(gp.max_number_of_marched_voxels),
                rays_batch=self.rays_batch,
            )


class RayNetForwardPass(ForwardPass):
    """Full pipeline with MRF BP over all views (factory name: raynet).

    The per-image messages live in the store that
    ``message_store.choose_store`` picks by size alone (the JAX package's
    attributes and defaults below), and the pass records its choice in
    ``message_store``: "device", "host_f32", "host_f16" or "memmap".
    """

    bp_iterations = 3
    # Device bytes the per-image messages, scores and segments may take.
    # Over it the messages go to the host store (staged through two image
    # blocks of float32 on the device, outside this budget); the scores and
    # segments must still fit, or the pass raises.
    messages_device_budget = 40 << 30
    # Host store dtype: None = float32 while the store takes at most
    # messages_f16_threshold bytes in float32, float16 above it.
    messages_dtype = None
    messages_f16_threshold = 1 << 30
    # Images with more entries than this spill to np.memmap files.
    messages_memmap_threshold = 2 ** 28
    # Bytes moved between the host store and the device, over all calls.
    staged_bytes = 0
    # The store the last call used: "device", "host_f32", "host_f16" or
    # "memmap".
    message_store = None
    # "auto": split each image's rays over the ranks of the ray group when
    # there is one (``sharding.ray_group_from_env``), as the JAX package
    # shards over every visible device; "off": one process. Unlike the JAX
    # package, which shards only from 2 devices on, the sharded path runs
    # at world size 1 too, so that NCCL at world size 1 takes the same code.
    multichip = "auto"
    # The ray group of the last call; None where it ran in one process.
    ray_group = None

    def _ray_group(self):
        if self.multichip == "off":
            return None
        if self.multichip != "auto":
            raise ValueError("multichip must be 'auto' or 'off', got %r"
                             % (self.multichip,))
        return sharding.ray_group_from_env(self.device)

    def forward_pass(self, scene, images_range):
        """Yield one (H, W) float32 depth map per reference image of
        ``images_range`` = (start, end, skip). Every view's depth sweep
        and map are queued before the host waits for the first map."""
        start, end, skip = _check_images_range(images_range)
        with span("pass.setup"):
            self._check_scene(scene)
            H, W = scene.image_shape
            bbox = self._bbox(scene)
            maps = _DepthMaps(self.device, H, W, self._every_ray(H, W))
        ref_indices = list(range(start, end, skip))
        depths, idxs = self._sweeps(scene, ref_indices, maps, bbox)
        pending = []
        for i in ref_indices:
            with span("depth.scatter"):
                pending.append(maps.start(depths.pop(i), idxs[i]))
        for k, queued in enumerate(pending):
            yield self._wait_map(maps, queued,
                                 overlapped=k + 1 < len(pending))

    def _sweeps(self, scene, ref_indices, maps, bbox):
        """The plane sweep, the BP sweeps and the depth sweep of the views
        ``ref_indices`` in the scene's ``bbox`` (on the device):
        ({view: depths (rows,) float32 on the device},
        {view: its ray indices as ``maps.rays`` gave them}), every sweep
        queued and none waited for. The message store, its spill files
        included, is gone when this returns or raises."""
        H, W = scene.image_shape
        gp = self._generation_params
        gamma = gp.gamma_mrf if gp.gamma_mrf is not None else 0.05
        prior = float(log_prior(gamma))
        grid_shape = tuple(int(g) for g in gp.grid_shape)
        grid_size = int(np.prod(grid_shape))
        M = int(gp.max_number_of_marched_voxels)
        D = int(gp.depth_planes)
        dev = self.device
        ray_idxs = {}
        for i in ref_indices:
            with span("rays.index"):
                ray_idxs[i] = self.get_valid_rays_per_image(scene, i)
        group = self.ray_group = self._ray_group()
        # the image sweeps of this call, looked up on their modules now
        if group is None:
            update, depth = fused.raynet_image_update, fused.raynet_image_depth
        else:
            update = functools.partial(sharding.sharded_image_update, group)
            depth = functools.partial(sharding.sharded_image_depth, group)
        # this process's rays of each image: all of them, or its span; a
        # ray group's depth sweep takes the image's ray count first
        mine = {i: group.span(len(r)) if group else (0, len(r))
                for i, r in ray_idxs.items()}
        lead = {i: (len(r),) if group else () for i, r in ray_idxs.items()}
        rows = {i: hi - lo for i, (lo, hi) in mine.items()}
        # per ray: the scores, the two segment endpoints and the march's
        # count and total stay on the device beside the messages
        open_store = message_store.choose_store(
            rows, M, (D + 8) * 4, self.messages_device_budget,
            self.messages_dtype, self.messages_f16_threshold,
            self.messages_memmap_threshold, dev, self.timer)
        bp = dict(grid_shape=grid_shape, max_voxels=M,
                  rays_batch=self.rays_batch)

        def prior_grid():
            return torch.full((grid_size,), prior, dtype=torch.float32,
                              device=dev)

        for i in ref_indices:
            self._features_and_cameras(scene, i)
        idxs, scores, rays, ray_sums = {}, {}, {}, {}
        with self.timer.phase("Plane sweep"):
            for i in ref_indices:
                features, P, P_pinv, center = self._features_and_cameras(
                    scene, i
                )
                with span("rays.upload"):
                    idxs[i] = maps.rays(ray_idxs[i])
                with span("rays.segments"):
                    segments = segments_in_bbox(
                        idxs[i][slice(*mine[i])], P_pinv, center, bbox, H
                    )
                with span("scores"):
                    scores[i] = fused.raynet_image_scores(
                        *segments, features, P, height=H, width=W,
                        padding=gp.padding, depth_planes=D,
                        rays_batch=self.rays_batch)
                # the rays' segments, camera centre and bbox, as the
                # sweeps take them after the scores and grids
                rays[i] = (*segments, center, bbox)
                if self.bp_iterations:
                    # each ray's march count and mapped-score total: the
                    # first sweep writes them, the later sweeps read them
                    ray_sums[i] = (
                        torch.zeros(rows[i], dtype=torch.int32, device=dev),
                        torch.zeros(rows[i], dtype=torch.float32, device=dev),
                    )

        with open_store() as store:
            self.message_store = store.kind
            try:
                with span("messages.alloc"):
                    grid_acc = prior_grid()
                # the first sweep writes the messages, a message sweep
                # reads and writes them, the depth sweep only reads them; a
                # phase's end follows a host store's copies: the current
                # stream waits for each upload, the host for each download
                with self.timer.phase("Message passing"):
                    for iteration in range(self.bp_iterations):
                        first = iteration == 0
                        with span("messages.alloc"):
                            scatter_total = prior_grid()
                        for i, block in store.blocks(
                                ref_indices, upload=not first, download=True):
                            with span("sweep.first" if first
                                      else "sweep.message"):
                                update(block, scores[i], scatter_total,
                                       grid_acc, *rays[i], **bp,
                                       first_iteration=first, prior=prior,
                                       ray_sums=ray_sums[i])
                        grid_acc = scatter_total
                depths = {}
                with self.timer.phase("Per-pixel depth estimation"):
                    for i, block in store.blocks(ref_indices, upload=True,
                                                 download=False):
                        # without a message sweep no sweep wrote the sums:
                        # it counts
                        with span("sweep.depth"):
                            depths[i] = depth(*lead[i], block, scores[i],
                                              grid_acc, *rays[i], **bp,
                                              ray_sums=ray_sums.get(i))
            finally:
                self.staged_bytes += store.staged_bytes
        return depths, idxs


class HartmannForwardPass(ForwardPass):
    """Patch-based Hartmann et al. baseline (factory name: hartmann_fp).

    For each reference view: its view set ``scene.get_view_idxs`` (the
    reference first), the scheme's points of every (ray, plane), all
    projected into every view in float64 and rounded half to even (as
    ``np.round``); each chunk of quintuples gathered on the device from the
    zero-bordered views (``common.image.gather_patches``) and scored by one
    ``model.predict`` call; the score of a quintuple is channel 0 of the
    prediction, averaged over all but the batch axis; depth is the
    camera-centre distance of the first best plane, capped at 800 (only
    this pass caps it).

    The model is a ``HartmannModel`` (channel 0: the match probability) or,
    as the JAX package's CLI hands it, a ``FeatureExtractor`` (channel 0 of
    its features, averaged over views and cells). On the card a chunk holds
    as many quintuples as ``memory_fraction`` of the free memory allows;
    on the CPU ``rays_batch`` quintuples; ``quintuples_per_call`` records
    the last chunk, ``quintuples`` and ``predict_calls`` count the
    quintuples scored and the model calls over the object's calls.

    Spans: ``patch.sample`` (the host's sampling), ``patch.project`` and
    ``patch.pad`` (the projection; the view stack's upload and zero
    border), ``patch.gather`` and ``patch.net`` once a chunk, each in its
    phase ("Patch gather", "Patch net"), ``depth.download`` (the argmax to
    the host) and ``patch.depth`` (the host's point selection and norm).
    """

    memory_fraction = 0.5
    quintuples_per_call = None

    def __init__(self, model, generation_params, sampling_scheme,
                 image_shape, rays_batch=8192, filter_out_rays=False,
                 device="cuda"):
        super().__init__(model, generation_params, sampling_scheme,
                         image_shape, rays_batch, filter_out_rays, device)
        self.quintuples = 0
        self.predict_calls = 0

    def _chunk(self, views, patch_shape):
        """Quintuples per model call."""
        if self.device.type != "cuda":
            return max(1, self.rays_batch)
        ph, pw, c = patch_shape
        # a quintuple's bytes: the gathered patches twice (gather, NCHW copy)
        # with their int64 indices, and the first conv's output twice (conv,
        # activation), the largest activations of a patch CNN
        first = getattr(self._model, "first_conv_channels", 32)
        per = views * ph * pw * (4 * (2 * c + 2 * first) + 8)
        free, _ = torch.cuda.mem_get_info(self.device)
        return max(1, int(self.memory_fraction * free) // per)

    def project_pixels(self, images, points):
        """(V, K, 2) int32 pixel centres of (3, K) points in every view:
        float64 projections on the device, rounded half to even."""
        pts = torch.as_tensor(np.asarray(points), device=self.device)
        pts = torch.cat([pts.to(torch.float64),
                         torch.ones_like(pts[:1], dtype=torch.float64)])
        P = torch.as_tensor(np.stack([im.camera.P for im in images]),
                            device=self.device).to(torch.float64)
        hom = P @ pts  # (V, 3, K)
        xy = hom[:, :2] / hom[:, 2:]
        return torch.round(xy).to(torch.int32).permute(0, 2, 1)

    def image_scores(self, images, points):
        """(N, D) float32 scores on the device of the (3, N, D) ``points``
        of a reference view set ``images`` (reference first)."""
        gp = self._generation_params
        _, n, d = points.shape
        ps = tuple(gp.patch_shape[:2])
        with self.timer.phase("Projection"):
            with span("patch.project"):
                pixels = self.project_pixels(images,
                                             points.reshape(3, n * d))
            with span("patch.pad"):
                padded = padded_images(torch.as_tensor(
                    np.stack([im.image for im in images]),
                    device=self.device), ps)
        scores = torch.empty(n * d, dtype=torch.float32, device=self.device)
        chunk = self.quintuples_per_call = self._chunk(len(images),
                                                        gp.patch_shape)
        for off in range(0, n * d, chunk):
            with self.timer.phase("Patch gather"), span("patch.gather"):
                quint = gather_patches(padded, pixels[:, off:off + chunk], ps)
            with self.timer.phase("Patch net"), span("patch.net"):
                pred = self._model.predict(quint)
                pred = torch.as_tensor(pred, device=self.device)
                scores[off:off + len(quint)] = pred[..., 0].reshape(
                    len(quint), -1).mean(dim=1)
            self.quintuples += len(quint)
            self.predict_calls += 1
        return scores.reshape(n, d)

    def forward_pass(self, scene, images_range):
        """Yield one (H, W) depth map per reference image of
        ``images_range`` = (start, end, skip)."""
        start, end, skip = _check_images_range(images_range)
        H, W = scene.image_shape
        gp = self._generation_params
        for ref_idx in range(start, end, skip):
            images = [scene.get_image(j)
                      for j in scene.get_view_idxs(ref_idx, gp.neighbors)]
            with self.timer.phase("Sampling"), span("patch.sample"):
                points = np.asarray(
                    self._sampling_scheme.sample_points_across_rays(
                        scene, ref_idx))[:3]
            _, n, _ = points.shape
            scores = self.image_scores(images, points)
            with self.timer.phase("Per-pixel depth estimation"):
                with span("depth.download"):
                    best = scores.argmax(dim=1).cpu().numpy()
            with span("patch.depth"):
                pts = points[:, np.arange(n), best].T
                center = images[0].camera.center[:3, 0]
                depth = np.linalg.norm(pts - center[None], axis=-1)
                depth_map = np.minimum(depth.reshape(W, H).T, 800)
            yield depth_map


class MVSNetForwardPass(ForwardPass):
    """MVSNet, Yao et al., ECCV 2018 (factory name: mvsnet).

    The model is a ``models.mvsnet.MVSNetModel``. Each image is centre
    cropped to multiples of 32 (``cost_volume.crop_window``: DTU's 1600 x
    1200 to 1600 x 1184, as MVSNet crops it) and its 32-channel
    quarter-resolution features come from the per-image cache the other
    passes use. For each reference view of ``images_range``, with its
    ``scene.get_view_idxs`` neighbours: ``depth_planes`` fronto-parallel
    planes uniform in the reference camera's z over the bbox
    (``cost_volume.plane_depths``), the plane homographies, both float64
    and uploaded through one page-locked buffer; K4's variance cost volume
    (``cost_volume.cost_volume``); the U-Net's plane logits
    (``MVSNetModel.regularize``); and the soft-argmin depth
    (``mvsnet.soft_argmin``), handed to the host as a (H / 4, W / 4) map
    of camera z. The next view's work is queued before the host waits for
    a map. ``depth_planes`` must be a multiple of 8; ``rays_batch`` is
    not read.

    Phases "Cost volume" (K4's launch), "Cost regularization" (the U-Net's
    launches; while a profiler records, each of its 11 layers also a
    phase of its own, ``unet.conv0`` ... ``unet.prob``, by
    ``PhaseTimer.layer``) and "Depth regression" (with its span
    ``mvs.regress``); ``mvs.planes`` the host's planes and homographies
    and their upload. ``volumes`` counts the cost volumes built over the
    object's calls.
    """

    def __init__(self, model, generation_params, sampling_scheme,
                 image_shape, rays_batch=1 << 20, filter_out_rays=False,
                 device="cuda"):
        super().__init__(model, generation_params, sampling_scheme,
                         image_shape, rays_batch, filter_out_rays, device)
        self.volumes = 0
        self._crop = None

    def _image_input(self, image):
        top, left, h, w = self._crop
        pixels = getattr(image, "image_u8", None)
        if pixels is None:
            pixels = image.image
        return np.ascontiguousarray(pixels[top:top + h, left:left + w])[None]

    def _planes(self, scene, views, planes):
        """(depths (D,), homographies (V - 1, 12)) float64 on the device of
        a view set (the reference first)."""
        top, left = self._crop[:2]
        P = cost_volume.feature_cameras(
            [scene.get_image(j).camera.P for j in views], top, left)
        dev = _upload(np.concatenate([
            cost_volume.plane_depths(P[0], scene.bbox, planes),
            cost_volume.homographies(P).ravel()]), self.device)
        return dev[:planes], dev[planes:].view(len(views) - 1, 12)

    def forward_pass(self, scene, images_range):
        """Yield one (H / 4, W / 4) float32 depth map per reference image
        of ``images_range`` = (start, end, skip), H x W the crop."""
        start, end, skip = _check_images_range(images_range)
        self._check_scene(scene)
        gp = self._generation_params
        D = int(gp.depth_planes)
        if D % 8:
            raise ValueError("mvsnet: depth_planes must be a multiple of 8, "
                             "got %d" % D)
        self._crop = cost_volume.crop_window(*scene.image_shape)
        H, W = (n // cost_volume.STRIDE for n in self._crop[2:])
        maps = _DepthMaps(self.device, H, W, self._every_ray(H, W))
        rays = maps.rays(maps.every_ray)
        pending = None
        for ref_idx in range(start, end, skip):
            views = scene.get_view_idxs(ref_idx, gp.neighbors)
            features = torch.stack([self._image_features(scene, j)
                                    for j in views])
            with span("mvs.planes"):
                depths, homs = self._planes(scene, views, D)
            with self.timer.phase("Cost volume"):
                volume = cost_volume.cost_volume(features, homs, depths)
            self.volumes += 1
            del features
            with self.timer.phase("Cost regularization"):
                logits = self._model.regularize(volume, timer=self.timer)
            del volume
            with self.timer.phase("Depth regression"), span("mvs.regress"):
                depth = mvsnet.soft_argmin(logits, depths.to(torch.float32))
            del logits
            with span("depth.scatter"):
                # the (W, H) order of the maps' rays
                queued = maps.start(depth.t().reshape(-1), rays)
            if pending is not None:
                yield self._wait_map(maps, pending, overlapped=True)
            pending = queued
        if pending is not None:
            yield self._wait_map(maps, pending, overlapped=False)


class CasMVSNetForwardPass(MVSNetForwardPass):
    """CasMVSNet, Gu et al., CVPR 2020 (factory name: casmvsnet).

    The model is a ``models.casmvsnet.CasMVSNetModel``. Each image is
    centre cropped as the MVSNet pass crops it (DTU's 1600 x 1200 to 1600
    x 1184), and its FPN's three maps (32 channels at a quarter of the
    crop's resolution, 16 at a half, 8 at full) come from the per-image
    cache the other passes use. For each reference view of
    ``images_range``, with its ``scene.get_view_idxs`` neighbours, three
    stages, each with its own cameras (the intrinsics divided by the
    stage's stride), homographies and hypotheses, uploaded as the MVSNet
    pass uploads them; K4's variance cost volume; the stage's U-Net; and
    the soft-argmin depth over the stage's hypotheses. Stage 1's are
    ``casmvsnet.NDEPTHS[0]`` planes uniform in the reference camera's z
    over the bbox, K4's plane mode; a later stage's are each pixel's
    centre depth (``casmvsnet.centre_depth`` of the previous stage's depth,
    on the device) plus ``casmvsnet.hypothesis_offsets``, K4's per-pixel
    mode, so no stage waits for the host. The last stage's depth, a (H,
    W) map of camera z of the crop, goes to the host as the MVSNet pass's
    does; ``depth_planes`` and ``rays_batch`` are not read.

    Spans, phases and layer timers are the MVSNet pass's, once a stage,
    and ``cas.hypotheses`` the centre depth and the hypotheses of a later
    stage; the phase "Fine regularization" nests in "Cost regularization"
    around the last stage's U-Net. ``volumes`` counts the cost volumes
    built over the object's calls, 3 a view. ``stage_depths`` gives the
    three stages' maps of one reference view, by the same stages.
    """

    def _featurise(self, image):
        return [m[0] for m in self._model.predict(image)]

    def _stage_planes(self, scene, views, stage):
        """(depths (D,), homographies (V - 1, 12)) float64 on the device of
        stage ``stage`` of a view set (the reference first): the planes'
        depths in stage 1, else the hypotheses' offsets from a pixel's
        centre depth."""
        top, left = self._crop[:2]
        P = cost_volume.feature_cameras(
            [scene.get_image(j).camera.P for j in views], top, left,
            casmvsnet.STRIDES[stage])
        D = casmvsnet.NDEPTHS[stage]
        if stage == 0:
            depths = cost_volume.plane_depths(P[0], scene.bbox, D)
        else:
            depths = casmvsnet.hypothesis_offsets(
                *cost_volume.depth_range(P[0], scene.bbox), stage).numpy()
        dev = _upload(np.concatenate(
            [depths, cost_volume.homographies(P).ravel()]), self.device)
        return dev[:D], dev[D:].view(len(views) - 1, 12)

    def stage_depths(self, scene, ref_idx):
        """[stage 1's (H / 4, W / 4), stage 2's (H / 2, W / 2), stage 3's
        (H, W)] float32 depth maps on the device of reference image
        ``ref_idx``, H x W the crop: the stages ``forward_pass`` runs, each
        one's map kept, so that each can be checked on its own input."""
        self._check_scene(scene)
        self._crop = cost_volume.crop_window(*scene.image_shape)
        return self._cascade(scene, ref_idx)

    def _cascade(self, scene, ref_idx):
        """Each stage's depth map of reference image ``ref_idx``."""
        shape = self._crop[2:]
        views = scene.get_view_idxs(ref_idx,
                                    self._generation_params.neighbors)
        feats = [self._image_features(scene, j) for j in views]
        last = len(casmvsnet.NDEPTHS) - 1
        out, depth = [], None
        for stage in range(last + 1):
            features = torch.stack([f[stage] for f in feats])
            with span("mvs.planes"):
                depths, homs = self._stage_planes(scene, views, stage)
            centre, hypotheses = None, depths
            if stage:
                with span("cas.hypotheses"):
                    centre = casmvsnet.centre_depth(depth, shape, stage)
                    hypotheses = centre.to(torch.float64) \
                        + depths[:, None, None]
            with self.timer.phase("Cost volume"):
                volume = cost_volume.cost_volume(features, homs, depths,
                                                 centre)
            self.volumes += 1
            del features
            fine = (self.timer.phase("Fine regularization")
                    if stage == last else contextlib.nullcontext())
            with self.timer.phase("Cost regularization"), fine:
                logits = self._model.regularize(volume, stage,
                                                timer=self.timer)
            del volume
            with self.timer.phase("Depth regression"), span("mvs.regress"):
                depth = mvsnet.soft_argmin(logits,
                                           hypotheses.to(torch.float32))
            out.append(depth)
            del logits, centre, hypotheses
        return out

    def forward_pass(self, scene, images_range):
        """Yield one (H, W) float32 depth map per reference image of
        ``images_range`` = (start, end, skip), H x W the crop."""
        start, end, skip = _check_images_range(images_range)
        self._check_scene(scene)
        self._crop = cost_volume.crop_window(*scene.image_shape)
        shape = self._crop[2:]
        maps = _DepthMaps(self.device, *shape, self._every_ray(*shape))
        rays = maps.rays(maps.every_ray)
        pending = None
        for ref_idx in range(start, end, skip):
            depth = self._cascade(scene, ref_idx)[-1]
            with span("depth.scatter"):
                # the (W, H) order of the maps' rays
                queued = maps.start(depth.t().reshape(-1), rays)
            if pending is not None:
                yield self._wait_map(maps, pending, overlapped=True)
            pending = queued
        if pending is not None:
            yield self._wait_map(maps, pending, overlapped=False)


_FACTORIES = {
    "multi_view_cnn": MultiViewCNNForwardPass,
    "multi_view_cnn_voxel_space": MultiViewCNNVoxelSpaceForwardPass,
    "raynet": RayNetForwardPass,
    "hartmann_fp": HartmannForwardPass,
    "mvsnet": MVSNetForwardPass,
    "casmvsnet": CasMVSNetForwardPass,
}


def get_forward_pass_factory(name):
    """The forward-pass class for ``name``."""
    return _FACTORIES[name]

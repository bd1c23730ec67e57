"""The prefetching batch provider of pretraining, and the RayNet batch
providers of end-to-end training.

``BatchProvider`` is the port of ``raynet_tpu/train/batch_provider.py:15-111``:
a producer draws samples from a sample generator while the trainer runs,
into a cyclic cache of ``cache_size`` samples, and a batch is
``batch_size`` random cache entries. ``ready()`` blocks until the cache has
been filled once.

Two changes. Runs are reproducible: the JAX package's producer writes into
the cache whenever it has a sample, so what a batch holds depends on
thread timing. Here the producer only queues its samples (in the order its
generator draws them) and each ``get_batch()`` after the first fill moves
the next ``batch_size`` of them into the cache: the cache is a shuffle
buffer, and a batch waits for ``batch_size`` fresh samples. With a seeded
generator and ``rng`` the batches are a function of the seeds alone, and a
resumed run sees the batches of an uninterrupted one. And the producer is
a forked process, not a thread: sample generation is Python and numpy
that holds the GIL, and a producer thread slowed the training step it
overlapped (each time the step gave up the GIL, for a device sync or the
autograd engine, it waited a switch interval to get it back). The
generator must therefore stay on the host: the child may not touch CUDA.

``RayNetBatchProvider`` (``:114``) and ``MultiThreadRayNetBatchProvider``
(``:187``) assemble whole single-scene batches in the calling process: they
draw samples on the host and finish all of a batch's rays together, one
voxel traversal launch for the batch (see ``sample.RayNetSampleGenerator``).
"""
import copy
import multiprocessing
import queue
import threading
import time
import traceback

import numpy as np
import torch


def _split_parts(value, n_parts):
    """A sample's X/y may be a list of per-input arrays or one stacked
    ndarray whose first axis enumerates the inputs (the Hartmann generator
    returns the latter)."""
    if isinstance(value, (list, tuple)):
        return value
    if n_parts == 1:
        return [value]
    return list(value)


class _Failure:
    """The producer's exception, as its formatted traceback."""

    def __init__(self, text):
        self.text = text


def _produce(dataset, sample_generator, n_inputs, n_outputs, out):
    """The producer process: queue the generator's kept samples in order,
    until the parent terminates it; an exception is queued as a
    ``_Failure`` and ends it."""
    torch.set_num_threads(1)
    try:
        while True:
            sample = sample_generator.get_sample(dataset)
            if sample.X is None or sample.y is None:
                continue
            out.put((_split_parts(sample.X, n_inputs),
                     _split_parts(sample.y, n_outputs)))
    except Exception:  # the consumer raises it
        out.put(_Failure(traceback.format_exc()))


class BatchProvider:
    """Cyclic sample cache fed by one producer process; ``get_batch()``
    returns (X, y), lists of (batch_size, ...) float32 arrays, one per model
    input and output. ``rng``: the ``np.random.RandomState`` of the batch
    indices. Iterable (infinite) for training loops; ``stop()`` ends the
    producer."""

    _POLL_S = 0.1

    def __init__(self, dataset, sample_generator, cache_size=500,
                 batch_size=32, *, rng):
        self._batch_size = batch_size
        self._rng = rng
        self._inputs = [
            np.empty((cache_size,) + tuple(s), dtype=np.float32)
            for s in sample_generator.input_shapes
        ]
        self._outputs = [
            np.empty((cache_size,) + tuple(s), dtype=np.float32)
            for s in sample_generator.output_shapes
        ]
        self._cache_size = cache_size
        self._filled = 0
        self._write_idx = 0
        self._stopped = False
        ctx = multiprocessing.get_context("fork")
        self._queue = ctx.Queue(maxsize=cache_size)
        self._producer = ctx.Process(
            target=_produce, daemon=True,
            args=(dataset, sample_generator, len(self._inputs),
                  len(self._outputs), self._queue))
        self._producer.start()

    def _take(self, n):
        """Move the next ``n`` queued samples into the cache."""
        for _ in range(n):
            while True:
                if self._stopped:
                    raise RuntimeError("batch provider stopped")
                try:
                    item = self._queue.get(timeout=self._POLL_S)
                    break
                except queue.Empty:
                    if not self._producer.is_alive():
                        raise RuntimeError("batch producer exited") from None
            if isinstance(item, _Failure):
                raise RuntimeError("batch producer failed:\n" + item.text)
            xs, ys = item
            i = self._write_idx
            for buf, x in zip(self._inputs, xs):
                buf[i] = x
            for buf, y in zip(self._outputs, ys):
                buf[i] = y
            self._write_idx = (i + 1) % self._cache_size
            self._filled = min(self._filled + 1, self._cache_size)

    def ready(self):
        """Block until the cache has been filled once."""
        self._take(self._cache_size - self._filled)
        return True

    def stop(self):
        """End the producer process and wait for it."""
        self._stopped = True
        self._producer.terminate()
        self._producer.join(timeout=60)
        self._queue.close()

    def get_batch(self):
        if self._filled < self._cache_size:
            self.ready()
        else:
            self._take(self._batch_size)
        idxs = self._rng.randint(0, self._filled, self._batch_size)
        X = [buf[idxs].copy() for buf in self._inputs]
        y = [buf[idxs].copy() for buf in self._outputs]
        return X, y

    def __iter__(self):
        return self

    def __next__(self):
        return self.get_batch()


class RayNetBatchProvider:
    """Assembles whole-batch RayNet training arrays from one scene.

    Batch layout (that of ``raynet_tpu/train/batch_provider.py:117-125``):
        X: (views, B, D) + patch_shape
        points: (B, D, 4)
        ray_voxel_indices: (B, M, 3) int32
        ray_voxel_count: (B,) int32
        y: (B, M) one-hot over visited voxels
        camera_centers: (B, 4)
        bbox: (6,) of the batch's single scene

    It draws the candidates it still needs, finishes them in one traversal
    launch and accepts them in order; at the first one whose ray visits no
    voxel it drops the rest, returns the generator to that candidate's
    snapshot and draws again, so that the batch and the generator's state
    are the JAX provider's. ``timings`` holds the last batch's seconds of
    drawing (``draw_s``) and finishing (``finish_s``) and its number of
    finish calls (``finishes``).
    """

    def __init__(self, dataset, sample_generator):
        self._dataset = dataset
        self._sg = sample_generator
        self.timings = {}

    def _candidates(self, n):
        """The generator's next ``n`` draws that the host keeps."""
        out = []
        while len(out) < n:
            d = self._sg.draw(self._dataset)
            if d.X is not None:
                out.append(d)
        return out

    def get_batch_of_rays(self, batch_size):
        samples = []
        draw_s = finish_s = 0.0
        finishes = 0
        while len(samples) < batch_size:
            t0 = time.perf_counter()
            draws = self._candidates(batch_size - len(samples))
            t1 = time.perf_counter()
            finished = self._sg.finish(draws)
            finish_s += time.perf_counter() - t1
            draw_s += t1 - t0
            finishes += 1
            for d, s in zip(draws, finished):
                if s.X is None:
                    self._sg.restore(d.snapshot)
                    break
                samples.append(s)
        self.timings = {"draw_s": draw_s, "finish_s": finish_s,
                        "finishes": finishes}
        return self._assemble(samples)

    def _assemble(self, samples):
        gp = self._sg.generation_params
        views = gp.neighbors + 1
        b = len(samples)
        D = gp.depth_planes
        M = gp.max_number_of_marched_voxels
        ps = tuple(gp.patch_shape)

        X = np.empty((views, b, D) + ps, dtype=np.float32)
        points = np.empty((b, D, 4), dtype=np.float32)
        indices = np.zeros((b, M, 3), dtype=np.int32)
        counts = np.zeros((b,), dtype=np.int32)
        y = np.zeros((b, M), dtype=np.float32)
        centers = np.empty((b, 4), dtype=np.float32)
        scene_idx = samples[0].scene_idx
        for i, s in enumerate(samples):
            assert s.scene_idx == scene_idx, (
                "a RayNet batch must come from a single scene"
            )
            X[:, i] = s.X
            points[i] = s.points
            indices[i] = s.ray_voxel_indices
            counts[i] = s.Nr
            y[i] = s.y
            centers[i] = s.camera_center[:, 0]
        scene = self._dataset.get_scene(scene_idx)
        return {
            "X": X,
            "points": points,
            "ray_voxel_indices": indices,
            "ray_voxel_count": counts,
            "y": y,
            "camera_centers": centers,
            "bbox": scene.bbox.reshape(-1).astype(np.float32),
            "scene_idx": scene_idx,
        }


# The reference's class name.
SingleThreadRayNetBatchProvider = RayNetBatchProvider


class MultiThreadRayNetBatchProvider(RayNetBatchProvider):
    """Batch assembly with concurrent draws, as the JAX package's.

    The batch's (scene, image window) is pinned from the shared generator's
    schedule up front, and each of ``n_workers`` threads draws rays with
    its own clone of the generator (``np.random.RandomState(seed + i)``),
    so that the per-sample host work runs outside any lock. The provider
    then finishes all the draws in one traversal launch (again for any
    that visit no voxel) and advances the shared schedule by the accepted
    samples, as the serial provider would have. Which worker's samples
    come first depends on the threads' timing.
    """

    def __init__(self, dataset, sample_generator, n_workers=4, seed=1234):
        super().__init__(dataset, sample_generator)
        self._n_workers = n_workers
        self._worker_sgs = [
            self._clone_generator(seed + i) for i in range(n_workers)
        ]

    def _clone_generator(self, seed):
        sg = copy.copy(self._sg)
        sg._rng = np.random.RandomState(seed)
        return sg

    def _draw_concurrently(self, scene, scene_idx, n):
        sg = self._sg
        lock = threading.Lock()
        draws = []
        errors = []

        def worker(wsg):
            # the clone's schedule is the shared one's: _draw_img_idx sees
            # the current image window
            wsg._scene_idx = sg._scene_idx
            wsg._img_idx = sg._img_idx
            try:
                while True:
                    with lock:
                        if len(draws) >= n or errors:
                            return
                    d = wsg._draw(scene, scene_idx,
                                  wsg._draw_img_idx(scene, wsg._rng))
                    if d.X is None:
                        continue
                    with lock:
                        if len(draws) < n:
                            draws.append(d)
            except BaseException as e:
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=worker, args=(wsg,))
                   for wsg in self._worker_sgs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError("batch worker failed") from errors[0]
        return draws

    def get_batch_of_rays(self, batch_size):
        sg = self._sg
        scene_idx = sg._scenes_range[sg._scene_idx]
        scene = self._dataset.get_scene(scene_idx)
        samples = []
        draw_s = finish_s = 0.0
        finishes = 0
        while len(samples) < batch_size:
            t0 = time.perf_counter()
            draws = self._draw_concurrently(scene, scene_idx,
                                            batch_size - len(samples))
            t1 = time.perf_counter()
            samples += [s for s in sg.finish(draws) if s.X is not None]
            finish_s += time.perf_counter() - t1
            draw_s += t1 - t0
            finishes += 1
        for _ in samples:
            sg._rays_cnt += 1
            sg._advance(scene)
        self.timings = {"draw_s": draw_s, "finish_s": finish_s,
                        "finishes": finishes}
        return self._assemble(samples)

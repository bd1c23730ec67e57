"""The prefetching batch provider of pretraining.

Port of ``raynet_tpu/train/batch_provider.py:15-111`` (``BatchProvider``):
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
"""
import multiprocessing
import queue
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

"""The raynet pass's message stores.

Port of the JAX package's stores of BP messages
(``raynet_tpu/inference/forward_pass.py:666-680`` and ``:930-990``),
chosen by ``choose_store``: the per-image (rays, M) messages of all
reference views stay on the device (``DeviceMessageStore``) while they fit
the device budget; over it they live in host memory (``HostMessageStore``),
one array per image,

- float32 while the whole store is at most ``messages_f16_threshold``
  bytes in float32, float16 above it (or the caller's ``messages_dtype``);
- an ``np.memmap`` spill file per image above ``messages_memmap_threshold``
  entries, in a temporary directory that ``close`` removes.

Both stores' ``blocks`` yield each image's messages as a (rays, M) float32
block on the device that K2 updates in place. ``HostMessageStore.blocks``
stages them through the device one image at a time. On a CUDA
device each image's block goes host -> pinned buffer -> card and back on
two copy streams (one each way), ordered by CUDA events, with two slots so
that the next image's upload runs while the current image sweeps. A
float16 store crosses the link as float16 and is widened on the card after
the upload and narrowed there before the download (``Tensor.copy_`` rounds
to nearest even, as ``np.float16`` does). A memmap block is copied into
the pinned buffer; its pages are never pinned themselves. On the CPU the
blocks are plain copies in and out of one float32 work tensor.
"""
import contextlib
import functools
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..utils.profiling import span


def choose_store(rows, max_voxels, ray_bytes, budget, dtype, f16_threshold,
                 memmap_threshold, device, timer):
    """A function that opens the message store of the images ``rows``
    ({image: number of rays}) as a context that closes it: on the device
    while the messages fit ``budget`` beside the ``ray_bytes`` a ray keeps
    there, else on the host (``timer`` times its set-up and release).
    Raises RuntimeError when those bytes alone are over ``budget``."""
    n_rays = sum(rows.values())
    fixed = n_rays * ray_bytes
    if fixed > budget:
        raise RuntimeError(
            "the scores, segments and march sums of %d views need %.2f "
            "GB of device memory, over messages_device_budget = %.2f GB; "
            "run fewer views per call" % (len(rows), fixed / 1e9,
                                          budget / 1e9)
        )
    if fixed + n_rays * max_voxels * 4 <= budget:
        return functools.partial(_device_store, rows, max_voxels, device)
    dtype = host_messages_dtype(dtype, n_rays * max_voxels, f16_threshold)
    return functools.partial(_host_store, timer, rows, max_voxels, dtype,
                             memmap_threshold, device)


def _device_store(rows, max_voxels, device):
    with span("messages.alloc"):
        return contextlib.closing(
            DeviceMessageStore(rows, max_voxels, device))


@contextlib.contextmanager
def _host_store(timer, *args):
    with timer.phase("Message store set-up"):
        store = HostMessageStore(*args)
    try:
        yield store
    finally:
        t0 = time.perf_counter()
        store.close()
        timer.add("Message store release", time.perf_counter() - t0)


def host_messages_dtype(messages_dtype, total_entries, f16_threshold):
    """The store's numpy dtype: ``messages_dtype`` when given, else float32
    while ``total_entries`` float32 values take at most ``f16_threshold``
    bytes and float16 above it (the JAX package's ``_host_msgs_dtype``)."""
    if messages_dtype is not None:
        return np.dtype(messages_dtype)
    if total_entries * 4 > f16_threshold:
        return np.dtype(np.float16)
    return np.dtype(np.float32)


class DeviceMessageStore:
    """Per-image (rows, M) float32 messages on ``device``, zeros at first;
    ``blocks`` yields them, whatever ``upload`` and ``download`` say."""

    kind = "device"
    staged_bytes = 0

    def __init__(self, rows, max_voxels, device):
        self._blocks = {i: torch.zeros((n, int(max_voxels)),
                                       dtype=torch.float32, device=device)
                        for i, n in rows.items()}

    def blocks(self, order, upload, download):
        for i in order:
            yield i, self._blocks[i]

    def close(self):
        self._blocks = {}


class HostMessageStore:
    """Per-image (rows, M) messages in host memory, zero-initialised.

    Arguments
    ---------
        rows: {image: number of rays}
        max_voxels: M
        dtype: numpy float32 or float16
        memmap_threshold: images with more than this many entries spill to
            an ``np.memmap`` file
        device: where the blocks are staged to (CUDA or CPU)
    """

    def __init__(self, rows, max_voxels, dtype, memmap_threshold, device):
        self.rows = dict(rows)
        self.max_voxels = int(max_voxels)
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float16)):
            raise ValueError("host message store: float32 or float16, got %s"
                             % (self.dtype,))
        self.device = torch.device(device)
        self.staged_bytes = 0
        self.arrays = {}
        self.spill_dir = None
        self._cuda = self.device.type == "cuda"
        try:
            for i, n in self.rows.items():
                shape = (int(n), self.max_voxels)
                if shape[0] * shape[1] > memmap_threshold:
                    if self.spill_dir is None:
                        self.spill_dir = tempfile.mkdtemp(
                            prefix="raynet_tpu_torch_msgs_")
                    self.arrays[i] = np.memmap(
                        os.path.join(self.spill_dir,
                                     "messages_pon_%d.dat" % (i,)),
                        dtype=self.dtype, mode="w+", shape=shape,
                    )
                else:
                    self.arrays[i] = np.zeros(shape, self.dtype)
            self._alloc_staging()
        except BaseException:
            self.close()
            raise

    @property
    def kind(self):
        """"memmap" when any image spilled, else "host_f16" or
        "host_f32"."""
        if self.spill_dir is not None:
            return "memmap"
        return "host_f16" if self.dtype == np.float16 else "host_f32"

    @property
    def _f16(self):
        return self.dtype == np.float16

    def _alloc_staging(self):
        shape = (max(self.rows.values(), default=0), self.max_voxels)
        f32 = torch.float32
        if not self._cuda:
            self._work = torch.empty(shape, dtype=f32)
            return
        raw = torch.float16 if self._f16 else f32
        self._pinned = [torch.empty(shape, dtype=raw, pin_memory=True)
                        for _ in range(2)]
        self._raw = [torch.empty(shape, dtype=raw, device=self.device)
                     for _ in range(2)]
        self._work = (torch.empty(shape, dtype=f32, device=self.device)
                      if self._f16 else None)
        self._up = torch.cuda.Stream(self.device)
        self._down = torch.cuda.Stream(self.device)

    def _host(self, i):
        """Image ``i``'s store as a CPU tensor sharing its memory."""
        return torch.from_numpy(np.asarray(self.arrays[i]))

    def _count(self, i):
        self.staged_bytes += self.rows[i] * self.max_voxels \
            * self.dtype.itemsize

    def blocks(self, order, upload, download):
        """Yield ``(image, block)`` for each image of ``order``: ``block``
        is the image's (rows, M) float32 messages on the device, its store
        uploaded (``upload``) or zeros. The caller queues work on the
        current stream that reads or updates ``block`` in place before
        asking for the next image; with ``download`` the block then goes
        back to the store. Bytes crossing between the store and the
        device add to ``staged_bytes``."""
        if self._cuda:
            yield from self._cuda_blocks(list(order), upload, download)
            return
        for i in order:
            block = self._work[:self.rows[i]]
            host = self._host(i)
            if upload:
                block.copy_(host)
                self._count(i)
            else:
                block.zero_()
            yield i, block
            if download:
                host.copy_(block)
                self._count(i)

    def _cuda_blocks(self, order, upload, download):
        cur = torch.cuda.current_stream(self.device)
        uploaded = [None, None]  # the last upload from/into each slot
        freed = [None, None]  # each slot's last reader on the device done
        pending = None  # (image, slot, event) of a download to finish

        def start_upload(i, s):
            # the pinned slot is free once its last upload was read; its
            # last download was finished before this is called
            if uploaded[s] is not None:
                uploaded[s].synchronize()
            n = self.rows[i]
            self._pinned[s][:n].copy_(self._host(i))
            with torch.cuda.stream(self._up):
                if freed[s] is not None:
                    self._up.wait_event(freed[s])
                self._raw[s][:n].copy_(self._pinned[s][:n], non_blocking=True)
                uploaded[s] = self._up.record_event()
            self._count(i)

        def finish_download(i, s, done):
            done.synchronize()
            self._host(i).copy_(self._pinned[s][:self.rows[i]])
            self._count(i)

        if upload and order:
            start_upload(order[0], 0)
        for k, i in enumerate(order):
            s, n = k % 2, self.rows[i]
            if freed[s] is not None:
                cur.wait_event(freed[s])
            raw = self._raw[s][:n]
            block = self._work[:n] if self._f16 else raw
            if upload:
                cur.wait_event(uploaded[s])
                if self._f16:
                    block.copy_(raw)
            else:
                block.zero_()
            yield i, block
            if download:
                if self._f16:
                    raw.copy_(block)
                swept = cur.record_event()
                with torch.cuda.stream(self._down):
                    self._down.wait_event(swept)
                    self._pinned[s][:n].copy_(raw, non_blocking=True)
                    freed[s] = self._down.record_event()
                if pending is not None:
                    finish_download(*pending)
                pending = (i, s, freed[s])
            else:
                freed[s] = cur.record_event()
            if upload and k + 1 < len(order):
                start_upload(order[k + 1], 1 - s)
        if pending is not None:
            finish_download(*pending)

    def close(self):
        """Wait for the copies in flight, drop the staging buffers and the
        arrays, and remove the spill directory. Safe to call twice."""
        if self._cuda and hasattr(self, "_up"):
            self._up.synchronize()
            self._down.synchronize()
        for name in ("_pinned", "_raw", "_work", "_up", "_down"):
            self.__dict__.pop(name, None)
        self.arrays = {}
        if self.spill_dir is not None:
            shutil.rmtree(self.spill_dir, ignore_errors=True)
            self.spill_dir = None

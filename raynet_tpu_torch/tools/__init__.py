"""The port's measurement tools, run on a CUDA card.

Counterparts of the JAX package's ``tools/``:

- ``python -m raynet_tpu_torch.tools.probe_dma_align``: the two probes,
  P1 (``csrc/probe_tma_box.cu``: can the copy engine, TMA, fetch a bf16
  box at arbitrary offsets?) and P2 (``csrc/probe_tf32_dot.cu``: what does
  a float32 product on the tensor cores round its operands to?);
- ``python -m raynet_tpu_torch.tools.time_kernels``: every kernel of the
  port timed alone with CUDA events, beside its bound;
- ``roofline``: the H100's peaks and each kernel's bytes and operations;
- ``utils.profiling.trace``: a ``torch.profiler`` trace and the device's
  busy share;
- ``python -m raynet_tpu_torch.tools.bench_training_quality``: the
  training-quality bench, bench.py's four metrics (``--device``, default
  ``cuda``).

The first two entry points exit nonzero without a card; none falls back
to the CPU. The wrappers ``probe_dma_align.tma_box_rows`` and
``probe_dma_align.tensor_core_dot`` take their plain versions for CPU
tensors, as every kernel wrapper of the port does.
"""

"""raynet_tpu_torch — the PyTorch / CUDA port of raynet_tpu.

RayNet inference (the ``multi_view_cnn``, ``multi_view_cnn_voxel_space`` and
``raynet`` forward-pass factories) on one NVIDIA H100: plain PyTorch for the
tensor glue, and hand-written CUDA C++ kernels (``csrc/``, built for
``sm_90a`` at first use) for the plane sweep, the voxel traversal and the
fused BP sweep. Every kernel has a plain-PyTorch version beside it; a
wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors, never one in place of the other. ``tools/`` holds the measurement
tools: the probes P1 (TMA box copy) and P2 (f32 product on the tensor
cores), each a CUDA kernel too, the H100 roofline, and a kernel timer.

The JAX package ``raynet_tpu`` is the reference. This package imports
nothing of it and never ``jax``: it keeps its own copies of the data layer
(scenes, cameras, images, dataset readers, generation parameters) in
``common/`` and ``utils/``.
"""

__version__ = "0.1.0"

"""raynet_tpu_torch — the PyTorch / CUDA port of raynet_tpu.

RayNet inference (the ``raynet`` forward-pass factory) on one NVIDIA H100:
plain PyTorch for the tensor glue, and hand-written CUDA C++ kernels
(``csrc/``, built for ``sm_90a`` at first use) for the plane sweep and the
fused BP sweep. Every kernel has a plain-PyTorch version beside it; a
wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors, never one in place of the other.

The JAX package ``raynet_tpu`` is the reference; this package imports only
its framework-free numpy modules (cameras, generation parameters, dataset
readers, numpy utilities) and never ``jax``.
"""

__version__ = "0.1.0"

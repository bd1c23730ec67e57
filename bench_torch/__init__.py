"""The benchmark of ``raynet_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards: ``python3 -m bench_torch.run --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``.

Nothing here imports the JAX package or JAX."""

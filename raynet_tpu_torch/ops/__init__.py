"""Tensor operations of the port; the kernels' wrappers are
``planesweep.plane_sweep_scores`` (K1) and ``bp_sweep.bp_sweep`` (K2)."""

"""Readers of the per-layer metrics, one module per reader: a metric is
read by the module named by its name up to the first ".", with
``read(run)``."""

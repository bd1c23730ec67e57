"""Drivers of the benchmark's cells, one module per driver, named by a
configuration's ``driver`` key."""

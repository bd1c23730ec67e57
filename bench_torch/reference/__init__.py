"""Plain PyTorch references of the benchmark's configurations, one module
per reference, named by a configuration's ``reference`` key."""

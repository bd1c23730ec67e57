"""Small assertion helpers of the data layer.

Port of ``raynet_tpu/utils/checks.py``. The checks raise
``AssertionError`` with the JAX package's messages, also under ``python
-O``, which strips ``assert`` statements.
"""


def _check(ok, message):
    if not ok:
        raise AssertionError(message)


def assert_col_vectors(a, b):
    """``a`` and ``b`` are column vectors (n, 1) of one shape."""
    _check(a.ndim == 2 and a.shape[1] == 1,
           "expected column vector, got %r" % (tuple(a.shape),))
    _check(b.ndim == 2 and b.shape[1] == 1,
           "expected column vector, got %r" % (tuple(b.shape),))
    _check(a.shape == b.shape, "shape mismatch %r vs %r"
           % (tuple(a.shape), tuple(b.shape)))


def assert_vector_with_wrong_size(v, size):
    """``v`` has ``size`` entries."""
    _check(len(v) == size,
           "expected vector of size %d, got %d" % (size, len(v)))

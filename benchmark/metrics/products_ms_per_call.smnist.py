"""GP math, S-MNIST prediction: device ms per ``predict`` call of the library's
products and triangular solves."""

from benchmark.readers import products_ms_per_unit as read  # noqa: F401

"""GP math, S-MNIST prediction: the device ms per call launched inside the posterior."""

from benchmark.spans import posterior_device_ms as read  # noqa: F401

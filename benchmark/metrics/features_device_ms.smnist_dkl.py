"""Deep kernel feature map, S-MNIST prediction under DKL: the device ms per call
launched inside phi's ``features`` spans."""

from benchmark.spans_dkl import features_device_ms as read  # noqa: F401

"""Device, S-MNIST prediction: the idle share of the traced slice while predict runs, in %."""

from benchmark.spans import predict_idle_share as read  # noqa: F401

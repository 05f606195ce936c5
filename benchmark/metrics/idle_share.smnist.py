"""Device, S-MNIST prediction: the card's idle share of the traced slice, in %."""

from benchmark.readers import idle_share as read  # noqa: F401

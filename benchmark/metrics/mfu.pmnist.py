"""The whole call, P-MNIST prediction: the model FLOPs a call times the
window's calls per second over the f32-accurate peak, in %."""

from benchmark.readers import mfu as read  # noqa: F401

"""Kernels, S-MNIST prediction: the hand-written kernels' share of their
roofline, in %."""

from benchmark.readers import kernels_roofline as read  # noqa: F401

"""Deep kernel feature map, S-MNIST prediction under DKL: phi's ``features`` spans
per ``predict`` call."""

from benchmark.spans_dkl import features_per_call as read  # noqa: F401

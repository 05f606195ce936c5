"""Host dispatch, S-MNIST prediction: the card's events per ``predict`` call."""

from benchmark.readers import launches_per_unit as read  # noqa: F401

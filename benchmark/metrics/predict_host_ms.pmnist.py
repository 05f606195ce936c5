"""Host dispatch, P-MNIST prediction: the host ms per call inside predict."""

from benchmark.spans import predict_host_ms as read  # noqa: F401

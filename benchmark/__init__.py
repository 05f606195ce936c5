"""The benchmark of vargp_tpu_torch, the PyTorch and CUDA port (see README.md)."""

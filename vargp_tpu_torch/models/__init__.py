"""Models; counterpart of ``vargp_tpu/models`` (VAR-GP, non-DKL)."""

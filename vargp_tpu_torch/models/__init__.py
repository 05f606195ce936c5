"""Models; counterpart of ``vargp_tpu/models`` (VAR-GP forward only)."""

"""Experiments; counterpart of ``vargp_tpu/experiments`` (the chain-reload
analysis so far)."""

"""Experiments; counterpart of ``vargp_tpu/experiments``: the VAR-GP
drivers (``vargp_run``), their command line (``cli``) and the
chain-reload analysis."""

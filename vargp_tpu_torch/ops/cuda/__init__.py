"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

A module per kernel: ``sym_gram`` (K1), ``sym_gram_tri`` (K2),
``diag_chol`` (K3, and K8 as ``diag_chol_chunked``), ``cross_gram`` (K4),
``rbf_gram`` (K5), ``chol_inv`` (K6) and ``chol`` (K7).  Each
wrapper launches its kernel for CUDA tensors and takes its plain PyTorch
version for CPU tensors; ``<wrapper>.launches`` counts kernel launches.  ``build``
compiles and loads the library.
"""

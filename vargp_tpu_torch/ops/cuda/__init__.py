"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

One module per kernel: ``sym_gram`` (K1), ``sym_gram_tri`` (K2),
``diag_chol`` (K3), ``cross_gram`` (K4) and ``rbf_gram`` (K5).  Each
wrapper launches its kernel for CUDA tensors and takes its plain PyTorch
version for CPU tensors; ``<wrapper>.launches`` counts kernel launches.  ``build``
compiles and loads the library.
"""

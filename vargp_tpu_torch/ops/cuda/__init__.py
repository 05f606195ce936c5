"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

A module per kernel: ``sym_gram`` (K1), ``sym_gram_tri`` (K2),
``diag_chol`` (K3, and K8 as ``diag_chol_chunked``), ``cross_gram`` (K4),
``rbf_gram`` (K5), ``chol_inv`` (K6), ``chol`` (K7), ``tri_mm`` (K9,
the triangular product of the predictive marginal) and
``marginal_moments`` (K10, the marginal's readers of that product), which
replace no Pallas kernel.  Each kernel is a
PyTorch operator in the ``vargp_torch`` namespace (``build.kernel_op``):
it launches its kernel for CUDA tensors, takes its plain PyTorch version
for CPU tensors, gives shapes alone for fake tensors and refuses any
other device, and bills its work by a cost function (``build.COSTS``,
read through ``build.cost``: operations, bytes and precision class).
``utils.tracing.LAUNCHES`` counts the launches by launcher symbol.  The
four Grams run one tensor-core tile, ``csrc/rbf_mma.cuh``; the
factorisations share ``csrc/chol_tile.cuh``.  ``build`` compiles and loads
the library.
"""

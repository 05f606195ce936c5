"""Dispatch between the hand-written CUDA kernels and their plain versions,
by the tensors' device; counterpart of ``vargp_tpu/ops``.  The JAX
package's ``get_backend`` / ``set_backend`` have no counterpart: a CUDA
tensor takes the kernel, a CPU tensor the plain version."""

from vargp_tpu_torch.ops.dispatch import batched_cholesky, rbf_gram, sq_dist

__all__ = ["rbf_gram", "sq_dist", "batched_cholesky"]

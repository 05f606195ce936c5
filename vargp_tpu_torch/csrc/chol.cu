// K7: batched dense lower Cholesky of (G, S, S) SPD matrices.
//
// Replaces vargp_tpu/ops/pallas/chol.py::cholesky_pallas (body
// _chol_kernel): one thread block per matrix, a right-looking blocked
// factorisation in 128-column panels (chol_tile.cuh::blocked_chol).  Each
// panel step factors its diagonal block in shared memory (the K8 routine),
// inverts it by substitution, solves the panel below it as a product with
// that inverse, and updates the trailing lower triangle by L21 L21^T on
// 64 x 64 tiles staged through shared memory.  The factor is worked in the
// output buffer in device memory (at S = 1000 a matrix is 4 MB; it stays
// in the 50 MB L2 while 30 of them are worked).  Only the lower triangle
// of K is read.  A ragged last panel is masked to the identity in shared
// memory; nothing is padded in device memory, as the TPU had to.
//
// What bounds it: at S = 300 the bytes are few (0.005 ms at 3.35 TB/s)
// and the latency of the panel steps rules; at S = 1000 the S^3/3 FMAs of
// the trailing updates (10 GFLOP over 30 matrices, 0.15 ms at the card's
// f32 peak).  One block per matrix fills only G of the 132 SMs, so this
// simple design runs at about G/132 of the card's FMA rate at best; a
// card-wide grid is later work.

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

__global__ void __launch_bounds__(kThreads)
    chol_kernel(const float* __restrict__ K, float* __restrict__ L, int S) {
  extern __shared__ float smem[];
  const size_t base = (size_t)blockIdx.x * S * S;
  blocked_chol(K + base, L + base, nullptr, S, smem);
}

}  // namespace

extern "C" int vargp_chol(const float* K, float* L, int G, int S, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBlockedSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_kernel<<<G, kThreads, kBlockedSmemBytes, static_cast<cudaStream_t>(stream)>>>(K, L, S);
  return static_cast<int>(cudaGetLastError());
}

// K8: batched lower Cholesky of (G, 128, 128) SPD blocks, chunked design.
//
// Replaces vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas (bodies
// _diag_chol_kernel and _diag_chol_kernel_unrolled, which compute one
// function; one Hopper kernel stands for both).  It computes K3's function
// in the TPU v2 design's shape: 32-column chunks, each factored by one
// warp with shuffles and no block barrier per column, then a rank-32
// update of the trailing lower triangle by the whole block
// (chol_tile.cuh::chol_block, which K7 and K6 run on their diagonal
// blocks).  One thread block per matrix, the matrix in 66 KB of shared
// memory.  Only the lower triangle of the input is read.
//
// What bounds it: latency, as K3.  128 dependent column steps (now inside
// one warp) and 4 block-wide updates, with G blocks (30 at the flagship
// shapes) on 132 SMs; the 21 MFLOP and 3 MB it needs are far below the
// card's rates.

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

constexpr size_t kSmemBytes = sizeof(float) * kBlockFloats;

__global__ void __launch_bounds__(kThreads)
    diag_chol_chunked_kernel(const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ float sD[];
  const size_t base = (size_t)blockIdx.x * kN * kN;
  for (int idx = threadIdx.x; idx < kN * kN; idx += kThreads) {
    const int r = idx / kN, c = idx % kN;
    sD[r * kLd + c] = (c <= r) ? in[base + idx] : 0.f;
  }
  __syncthreads();
  chol_block(sD);
  for (int idx = threadIdx.x; idx < kN * kN; idx += kThreads) {
    const int r = idx / kN, c = idx % kN;
    out[base + idx] = (c <= r) ? sD[r * kLd + c] : 0.f;
  }
}

}  // namespace

extern "C" int vargp_diag_chol_chunked(const float* in, float* out, int G, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(diag_chol_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  diag_chol_chunked_kernel<<<G, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}

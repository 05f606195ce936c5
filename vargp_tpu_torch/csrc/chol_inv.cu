// K6: fused Cholesky factor and lower-triangular inverse of (G, S, S) SPD
// matrices, (L, L^-1) in one launch.
//
// Replaces vargp_tpu/ops/pallas/chol_inv.py::_chol_inv_call (body
// _chol_inv_kernel, with _substitution_inv).  One thread block per
// matrix, three stages as on the TPU:
//   1. K7's blocked factorisation (chol_tile.cuh::blocked_chol), which
//      also inverts each 128 x 128 diagonal block by substitution and
//      writes the inverses into L^-1's diagonal blocks;
//   2. (done in 1) the diagonal blocks D_i^-1;
//   3. the off-diagonal row blocks, block row by block row:
//        X[i, :i] = -D_i^-1 (L[i, :i] X[:i, :i]),
//      as 64-column tiles: P = L[i, :i] X[:i, tile] with operands staged
//      through shared memory (X's zero upper triangle is skipped), kept
//      transposed in shared memory, then -D_i^-1 P.
// Products are plain f32 FMAs on the CUDA cores.  A ragged last block row
// is masked in shared memory.
//
// What bounds it: as K7, the latency of the panel steps at S = 300 and the
// FMAs at S = 1000 (about 2 S^3 / 3 over the two stages), with one block
// per matrix on G of the 132 SMs.

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

__global__ void __launch_bounds__(kThreads)
    chol_inv_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ X,
                    int S) {
  extern __shared__ float smem[];
  const size_t base = (size_t)blockIdx.x * S * S;
  K += base;
  L += base;
  X += base;
  for (size_t idx = threadIdx.x; idx < (size_t)S * S; idx += kThreads) X[idx] = 0.f;
  __syncthreads();
  blocked_chol(K, L, X, S, smem);

  float* sPT = smem;  // P^T, 64 x 128: the diagonal block's slot, free now
  float* sDinv = smem + kBlockFloats;
  float* sA = sDinv + kBlockFloats;
  float* sB = sA + kTileFloats;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int r0 = kN; r0 < S; r0 += kN) {
    const int h = min(kN, S - r0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kN * kN; idx += kThreads) {
      const int r = idx / kN, c = idx % kN;
      sDinv[r * kLd + c] = (r < h && c <= r) ? X[(size_t)(r0 + r) * S + r0 + c] : 0.f;
    }
    for (int jt = 0; jt < r0; jt += kTile) {
      for (int half = 0; half < 2; ++half) {
        float acc[4][4];
        zero_acc(acc);
        for (int k0 = jt; k0 < r0; k0 += kN) {
          const int kv = min(kN, r0 - k0);
          __syncthreads();
          stage_rows(sA, L, S, r0 + half * kTile, S, k0, kv);
          stage_cols(sB, X, S, k0, kv, jt);
          __syncthreads();
          mma_tile(sA, sB, acc);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sPT[(tx + 16 * j) * kLd + half * kTile + ty + 16 * i] = acc[i][j];
      }
      __syncthreads();
      for (int half = 0; half < 2; ++half) {
        float acc[4][4];
        zero_acc(acc);
        mma_tile(sDinv + half * kTile * kLd, sPT, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + half * kTile + ty + 16 * i;
          if (r >= S) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) X[(size_t)r * S + jt + tx + 16 * j] = -acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" int vargp_chol_inv(const float* K, float* L, float* X, int G, int S, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(chol_inv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBlockedSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_kernel<<<G, kThreads, kBlockedSmemBytes, static_cast<cudaStream_t>(stream)>>>(K, L, X,
                                                                                         S);
  return static_cast<int>(cudaGetLastError());
}

// K6: fused Cholesky factor and lower-triangular inverse of (G, S, S) SPD
// matrices, (L, L^-1) in one launch.
//
// Replaces vargp_tpu/ops/pallas/chol_inv.py::_chol_inv_call (body
// _chol_inv_kernel, with _substitution_inv).  One thread-block cluster of
// C blocks per matrix (the wrapper picks C as for K7), three stages as on
// the TPU:
//   1. K7's blocked factorisation (chol_tile.cuh::cluster_chol), whose
//      diagonal step also inverts each 128 x 128 diagonal block (blockwise,
//      chol_tile.cuh::diag_step) and writes it into L^-1's diagonal block;
//   2. (done in 1) the diagonal blocks D_i^-1;
//   3. the off-diagonal row blocks X[i, :i] = -D_i^-1 (L[i, :i] X[:i, :i]),
//      spread over the cluster by 64-column tiles: each block owns the
//      tiles jt = 64 (rank + C m) and walks down the block rows, computing
//      P = L[i, jt:r0] X[jt:r0, tile] (X's zero upper triangle skipped;
//      X read N-major from its rows, no transposed copy) and then
//      -D_i^-1 P.  A tile needs only its own columns higher up, so no
//      cluster barrier separates the block rows.
// Every product is 3xTF32 on the tensor cores.  A ragged last block row
// is masked in shared memory.
//
// What bounds it, at A (30, 300, 300) and B (30, 1000, 1000):
//   operations: 2 S^3/3 flops per matrix (the factor and the inverse),
//     three TF32 products each at 495 TFLOP/s (165 effective): 0.0033 ms
//     at A, 0.12 ms at B;
//   bytes at 3.35 TB/s (the lower triangle read, L and L^-1 written):
//     0.0081 ms at A, 0.09 ms at B;
//   latency: as K7, the diagonal steps of the factorisation lie on the
//     critical path, then ceil(S/128) - 1 block rows of two products.
// What stays in L2: at A the 30 pairs (21.6 MB) stay in the 50 MB L2; at
// B (240 MB) they do not: the factorisation streams A22 through device
// memory, and stage 3 re-reads L's block rows and X's tiles from it.

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

// block_mma's ring: kStages stages, each A's 128 rows of a 32-deep slice
// and B's 32 rows of 64 columns
constexpr int kStages = 3;
constexpr int kStageFloats = 128 * kLdK + 32 * kLdN;
static_assert(kDFloats + 128 * kLdN + kStages * kStageFloats <= kSmemFloats, "stage 3 fits");

// acc (the warp's 32 x 32 part of a 128 x 64 block tile; warp w takes rows
// 32 (w / 2), columns 32 (w % 2)) = sum over k < K (a multiple of 32) of
// A(m, k) B(k, n), A(m, k) = gA[m * lda + k] (rows m >= a_rows read as
// zero), B(k, n) = gB[k * ldb + n].  The operands stream through `ring`
// (kStages x kStageFloats) in 32-deep slices, kStages - 1 slices ahead of
// the one that multiplies.  Starts and ends with a block barrier.
__device__ void block_mma(float (&acc)[2][4][4], const float* gA, int lda, int a_rows,
                          const float* gB, int ldb, int K, float* ring, bool vec) {
  constexpr int kBOff = 128 * kLdK;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const int ns = K / 32;
  auto load = [&](int s) {
    if (s < ns) {
      float* st = ring + (s % kStages) * kStageFloats;
      stage(st, kLdK, gA + 32 * s, lda, 128, a_rows, 32, vec);
      stage(st + kBOff, kLdN, gB + (size_t)32 * s * ldb, ldb, 32, 32, 64, vec);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  zero_acc(acc);
  __syncthreads();  // the ring is free
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int s = 0; s < ns; ++s) {
    load(s + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* st = ring + (s % kStages) * kStageFloats;
    warp_mma<true>(acc, st + 32 * wm * kLdK, kLdK, st + kBOff + 32 * wn, kLdN, 32);
    __syncthreads();  // the stage is consumed before it is loaded again
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    chol_inv_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ X,
                    int S) {
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t base = (size_t)(blockIdx.x / C) * S * S;
  K += base;
  L += base;
  X += base;
  cluster_chol(K, L, X, S, smem);  // ends with a cluster barrier

  float* sDinv = smem;
  float* sP = sDinv + kDFloats;  // P, 128 x 64, stride kLdN
  float* ring = sP + 128 * kLdN;
  const bool vec = (S % 4) == 0;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  for (int r0 = kN; r0 < S; r0 += kN) {
    const int h = min(kN, S - r0);
    __syncthreads();
    load_square(sDinv, X + (size_t)r0 * S + r0, S, h, 0.f, vec);  // D_i^-1, zero outside h x h
    for (int jt = 64 * rank; jt < r0; jt += 64 * C) {
      float acc[2][4][4];
      block_mma(acc, L + (size_t)r0 * S + jt, S, h, X + (size_t)jt * S + jt, S, r0 - jt, ring, vec);
      const float* v = &acc[0][0][0];
      for_frag([&](int r, int c, int i) { sP[(32 * wm + r) * kLdN + 32 * wn + c] = v[i]; });
      __syncthreads();
      zero_acc(acc);
      warp_mma<true>(acc, sDinv + 32 * wm * kLdD, kLdD, sP + 32 * wn, kLdN, kN);
      for_frag([&](int r, int c, int i) {
        if (32 * wm + r < h) X[(size_t)(r0 + 32 * wm + r) * S + jt + 32 * wn + c] = -v[i];
      });
    }
  }
}

}  // namespace

extern "C" int vargp_chol_inv(const float* K, float* L, float* X, int G, int S, int C,
                              void* stream) {
  return launch_on_clusters(chol_inv_kernel, G, C, stream, K, L, X, S);
}

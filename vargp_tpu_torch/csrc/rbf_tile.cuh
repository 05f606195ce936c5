// Fused ARD-RBF Gram tile on the CUDA cores in f32, used now by K1, the
// symmetric Gram (sym_gram.cu), and K5, the generic Gram on pre-scaled
// inputs (rbf_gram.cu); K2 and K4 run the tensor-core tile of rbf_mma.cuh:
//
//   out[h, o, i, j] = gamma2[h] * exp(-0.5 * max(na_i + nb_j - 2 <a_i, b_j>, 0))
//
// with the per-hyper-sample feature scaling applied while the tiles are
// staged in shared memory, so no (H, O, M, D) scaled copy of the inputs is
// ever written to device memory.  Two scaling conventions, both the ones
// the JAX package's Pallas kernels use:
//
//   scaled (K1, K_zz): rows a = z[o], cols b = z[o]; both sides scaled by
//                 s = exp(-log_ls) (H, D); na_i = |s a_i|^2, nb_j = |s b_j|^2.
//   PRESCALED (K5): rows a and cols b taken as they are (the caller scaled
//                 them); na_i = |a_i|^2, nb_j = |b_j|^2.  Both sides run the
//                 same code, so with a == b the Gram is bitwise symmetric.
//
// In the scaled case every output element is computed by the same arithmetic
// as its mirror (same k order, commutative products, norms computed by the
// same code), so the Gram is bitwise symmetric.
//
// Full f32 on the CUDA cores: K_zz is factorised downstream, and TF32's
// 10-bit mantissa would defeat the jitter.  What bounds it on an H100:
// the f32 FMAs (2*H*O*M*N*D operations against ~4*(H*O*M*N) output bytes),
// so the tile keeps a 4x4 register block per thread and an 8:1 FMA to
// shared-load ratio.  M and N are ragged (300 rows is not a tile
// multiple): loads outside the matrix read 0 and stores are masked.

#pragma once

#include <cuda_runtime.h>

namespace vargp {

constexpr int kTileM = 64;   // output rows per block
constexpr int kTileN = 64;   // output cols per block
constexpr int kTileK = 16;   // feature chunk staged per iteration
constexpr int kThreads = 256;
constexpr int kPad = 4;      // keeps rows 16-byte aligned for float4 reads

// Shared-memory staging of one tile's product.
struct TileSmem {
  alignas(16) float As[kTileK][kTileM + kPad];
  alignas(16) float Bs[kTileK][kTileN + kPad];
  float na[kTileM];
  float nb[kTileN];
};

// Inner products of rows [row0, row0 + kTileM) of A against rows
// [col0, col0 + kTileN) of Bm into acc (thread (ty, tx) = (tid >> 4,
// tid & 15) owns rows ty*4 .. ty*4+3 and cols tx*4 .. tx*4+3 of the tile),
// and the rows' and cols' squared norms into sm.na / sm.nb.  Ends with a
// barrier, so sm.na / sm.nb are readable by every thread.  Both sides are
// scaled by s (K1), or with PRESCALED taken as they are and s not read (K5).
template <bool PRESCALED>
__device__ __forceinline__ void rbf_tile_accumulate(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ s, int M, int N, int D, int row0, int col0,
    TileSmem& sm, float (&acc)[4][4]) {
  const int tid = threadIdx.x;

  // staging: thread loads 4 consecutive features of one row of each tile
  const int lr = tid >> 2;
  const int lk = (tid & 3) * 4;
  const int ar = row0 + lr;
  const int bc = col0 + lr;
  float na = 0.f, nb = 0.f;

  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kTileK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + lk + q;
      const bool kin = k < D;
      const float sk = (!PRESCALED && kin) ? s[k] : 0.f;
      const float av = (kin && ar < M) ? A[(size_t)ar * D + k] : 0.f;
      const float bv = (kin && bc < N) ? Bm[(size_t)bc * D + k] : 0.f;
      float ae, be;
      if (PRESCALED) {
        ae = av;
        be = bv;
        na = fmaf(ae, ae, na);
        nb = fmaf(be, be, nb);
      } else {
        ae = av * sk;
        be = bv * sk;
        na = fmaf(ae, ae, na);
        nb = fmaf(be, be, nb);
      }
      sm.As[lk + q][lr] = ae;
      sm.Bs[lk + q][lr] = be;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 ra = *reinterpret_cast<const float4*>(&sm.As[k][ty * 4]);
      const float4 rb = *reinterpret_cast<const float4*>(&sm.Bs[k][tx * 4]);
      const float av4[4] = {ra.x, ra.y, ra.z, ra.w};
      const float bv4[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av4[i], bv4[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the four staging lanes of a row hold partial norms: reduce in-warp
  na += __shfl_xor_sync(0xffffffffu, na, 1);
  na += __shfl_xor_sync(0xffffffffu, na, 2);
  nb += __shfl_xor_sync(0xffffffffu, nb, 1);
  nb += __shfl_xor_sync(0xffffffffu, nb, 2);
  if ((tid & 3) == 0) {
    sm.na[lr] = na;
    sm.nb[lr] = nb;
  }
  __syncthreads();
}

// The Gram value of element (i, j) of the thread's 4x4 block.
__device__ __forceinline__ float rbf_tile_value(const TileSmem& sm,
                                                const float (&acc)[4][4],
                                                float g2, int i, int j) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float d2 = fmaxf(sm.na[ty * 4 + i] + sm.nb[tx * 4 + j] - 2.f * acc[i][j], 0.f);
  return g2 * expf(-0.5f * d2);
}

}  // namespace vargp

// Fused ARD-RBF Gram tile shared by the symmetric Gram (sym_gram.cu) and
// the cross Gram (cross_gram.cu):
//
//   out[h, o, i, j] = gamma2[h] * exp(-0.5 * max(na_i + nb_j - 2 <a_i, b_j>, 0))
//
// with the per-hyper-sample feature scaling applied while the tiles are
// staged in shared memory, so no (H, O, M, D) scaled copy of the inputs is
// ever written to device memory.  Two scaling conventions, both the ones
// the JAX package's Pallas kernels use:
//
//   SYM  (K_zz):  rows a = z[o], cols b = z[o]; both sides scaled by
//                 s = exp(-log_ls) (H, D); na_i = |s a_i|^2, nb_j = |s b_j|^2.
//   !SYM (K_zx):  rows a = z[o] raw, cols b = x scaled by w = exp(-2 log_ls);
//                 na_i = <a_i, w a_i>, nb_j = <b_j, w b_j>.
//
// In the SYM case every output element is computed by the same arithmetic
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

template <bool SYM>
__global__ void __launch_bounds__(kThreads) rbf_tile_kernel(
    const float* __restrict__ a,       // (O, M, D)
    const float* __restrict__ b,       // (N, D); ignored when SYM
    const float* __restrict__ scale,   // (H, D): s (SYM) or w (!SYM)
    const float* __restrict__ gamma2,  // (H,)
    float* __restrict__ out,           // (H, O, M, N)
    int O, int M, int N, int D) {
  __shared__ __align__(16) float As[kTileK][kTileM + kPad];
  __shared__ __align__(16) float Bs[kTileK][kTileN + kPad];
  __shared__ float na_s[kTileM];
  __shared__ float nb_s[kTileN];

  const int ho = blockIdx.z;
  const int h = ho / O;
  const int o = ho - h * O;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x;

  const float* A = a + (size_t)o * M * D;
  const float* Bm = SYM ? A : b;
  const float* s = scale + (size_t)h * D;

  // staging: thread loads 4 consecutive features of one row of each tile
  const int lr = tid >> 2;
  const int lk = (tid & 3) * 4;
  const int ar = row0 + lr;
  const int bc = col0 + lr;
  float na = 0.f, nb = 0.f;

  // compute: thread owns a 4x4 output block
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kTileK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + lk + q;
      const bool kin = k < D;
      const float sk = kin ? s[k] : 0.f;
      const float av = (kin && ar < M) ? A[(size_t)ar * D + k] : 0.f;
      const float bv = (kin && bc < N) ? Bm[(size_t)bc * D + k] : 0.f;
      float ae, be;
      if (SYM) {
        ae = av * sk;
        be = bv * sk;
        na = fmaf(ae, ae, na);
        nb = fmaf(be, be, nb);
      } else {
        ae = av;
        be = bv * sk;
        na = fmaf(av, av * sk, na);
        nb = fmaf(bv, be, nb);
      }
      As[lk + q][lr] = ae;
      Bs[lk + q][lr] = be;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 ra = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 rb = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
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
    na_s[lr] = na;
    nb_s[lr] = nb;
  }
  __syncthreads();

  const float g2 = gamma2[h];
  float* O_ = out + (size_t)ho * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
    const float nai = na_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      const float d2 = fmaxf(nai + nb_s[tx * 4 + j] - 2.f * acc[i][j], 0.f);
      O_[(size_t)r * N + c] = g2 * expf(-0.5f * d2);
    }
  }
}

}  // namespace vargp

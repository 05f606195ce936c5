// K2: triangle-skip symmetric fused-scaling ARD-RBF Gram, K_zz of a long
// inducing chain (S >= 512 rows).
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d_tri (body
// _make_sym_gram_tri_kernel).  The TPU kernel walked the lower 128-row
// panels of one (h, o) block held in VMEM and transpose-copied each
// finished off-diagonal tile into the upper triangle.  Here the grid is
// the T(T+1)/2 lower 64x64 tile pairs (ti >= tj, T = ceil(S / 64)) of
// every (h, o): blockIdx.x is the pair, blockIdx.y is h * O + o.  A block
// computes its tile once with rbf_tile.cuh (the arithmetic of K1) and
// stores it at (ti, tj); an off-diagonal block also stores its transpose
// at (tj, ti), staged through shared memory (64 x 65 floats, the odd
// stride keeps the column reads free of bank conflicts) so that both
// stores coalesce.  Diagonal tiles are computed whole, as K1 computes
// them, so every element equals its mirror bit for bit and the output is
// bitwise symmetric, as the factorisation expects.
//
// What bounds it: the f32 FMAs of the S(S+1)/2 distinct entries, half of
// K1's whole square; the 120 MB output (S = 1000, H*O = 30) is the
// second limit.
//
// z (O, M, D), invs = exp(-log_ls) (H, D), gamma2 (H,) -> out (H, O, M, M).

#include "rbf_tile.cuh"

namespace {

using vargp::kThreads;
using vargp::kTileM;
using vargp::kTileN;
static_assert(kTileM == kTileN, "a mirrored tile must be square");

__global__ void __launch_bounds__(kThreads)
    sym_gram_tri_kernel(const float* __restrict__ z,
                        const float* __restrict__ invs,
                        const float* __restrict__ gamma2,
                        float* __restrict__ out, int O, int M, int D) {
  __shared__ vargp::TileSmem sm;
  __shared__ float tile[kTileM][kTileN + 1];

  // lower tile pair p -> (ti, tj), p = ti (ti + 1) / 2 + tj, tj <= ti
  const int p = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  while (ti * (ti + 1) / 2 > p) --ti;
  const int tj = p - ti * (ti + 1) / 2;

  const int ho = blockIdx.y;
  const int h = ho / O;
  const int o = ho - h * O;
  const int row0 = ti * kTileM;
  const int col0 = tj * kTileN;

  const float* A = z + (size_t)o * M * D;
  float acc[4][4];
  vargp::rbf_tile_accumulate<true>(A, A, invs + (size_t)h * D, M, M, D, row0,
                                   col0, sm, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float g2 = gamma2[h];
  float* O_ = out + (size_t)ho * M * M;
  const bool mirror = ti != tj;  // the same for every thread of the block
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      const float v = vargp::rbf_tile_value(sm, acc, g2, i, j);
      if (r < M && c < M) O_[(size_t)r * M + c] = v;
      if (mirror) tile[ty * 4 + i][tx * 4 + j] = v;
    }
  }
  if (!mirror) return;
  __syncthreads();
  // out[col0 + cc, row0 + rr] = tile[rr][cc]; rr runs fastest across the
  // threads, so a warp writes 32 consecutive floats of one output row
  for (int e = threadIdx.x; e < kTileM * kTileN; e += kThreads) {
    const int cc = e / kTileM;
    const int rr = e - cc * kTileM;
    const int gr = col0 + cc;
    const int gc = row0 + rr;
    if (gr < M && gc < M) O_[(size_t)gr * M + gc] = tile[rr][cc];
  }
}

}  // namespace

extern "C" int vargp_sym_gram_tri(const float* z, const float* invs,
                                  const float* gamma2, float* out, int H,
                                  int O, int M, int D, void* stream) {
  const int T = (M + kTileM - 1) / kTileM;
  const dim3 grid(T * (T + 1) / 2, H * O);
  sym_gram_tri_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, invs, gamma2, out, O, M, D);
  return static_cast<int>(cudaGetLastError());
}

// K5: generic RBF Gram on pre-scaled inputs, one Gram per batch element:
//
//   out[g, i, j] = gamma2[g] * exp(-0.5 * max(|sx_gi|^2 + |sy_gj|^2 - 2 <sx_gi, sy_gj>, 0))
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_gram_3d (body
// _make_gram_kernel, entered through rbf_gram_pallas).  The TPU kernel
// zero-padded M and N to 128 and D to a lane multiple and ran one
// 128x128 output block per grid step with whole feature rows in VMEM.
// Here both kernels run the tensor-core tile of rbf_mma.cuh (Tile128,
// 3xTF32, f32 accuracy) in its kPrescaled mode: no scale, the norms
// |a|^2 and |b|^2 from the staged values.  Ragged M and N are masked at
// load and store; nothing is padded in device memory.  Tile64 (K1's) was
// slower here (PERF.md, section 6).
//
//   rbf_gram_kernel (vargp_rbf_gram): sx against sy on the (column tile,
//     row tile, g) grid, as K4.
//   rbf_gram_sym_kernel (vargp_rbf_gram_sym): the self-Gram of sx (the
//     deep kernel's K_zz) on the mirrored pair grid (pair, g), as K2: each
//     distinct entry computed once and mirrored, the diagonal gamma2
//     exactly.
//
//   rbf_gram_small_kernel (vargp_rbf_gram_small): D <= 16 (the toy's two
//     inputs), one thread an output, d^2 = sum_d (a_d - b_d)^2 in f32.  The
//     tile's 3xTF32 product carries up to ~3 * 2^-22 of |a| |b| per term,
//     which a deep sum's f32 rounding hides and a 2-term one does not (at
//     D = 2 the tile's Gram lay 3.4x the f32 plain version's distance from
//     float64); the differences are exact for equal rows (d^2 = 0, the
//     value gamma2) and give a bitwise symmetric self-Gram ((a - b)^2 ==
//     (b - a)^2, the same order over d).
//
// Only the symmetric kernels give a bitwise symmetric Gram.  The cross
// kernel computes (i, j) and (j, i) as two products whose cross terms
// trade places, so equal values handed over as two tensors give a Gram
// that is symmetric only to rounding; the wrapper (ops/cuda/rbf_gram.py)
// takes the symmetric kernel when sx and sy are the same storage.
//
// What bounds it on an H100: at the deep kernel's D = 64, the bytes.  C's
// K_zx (30 x 300 x 512) writes 18.4 MB for 0.59 GFLOP: 0.0055 ms of
// output at 3.35 TB/s against 0.0036 ms of 3xTF32 products.  With 4
// chunks of 16 features, a block's life is mostly its ring's prologue and
// its epilogue, which stores a warp's 32 consecutive floats at a time.
//
// sx (G, M, D), sy (G, N, D), gamma2 (G,) -> out (G, M, N).

#include "rbf_mma.cuh"

namespace {

using rbf_mma::Mode;
using Tile = rbf_mma::Tile128;

__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    rbf_gram_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                    const float* __restrict__ gamma2, float* __restrict__ out, int M, int N,
                    int D, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * Tile::BM, col0 = blockIdx.x * Tile::BN;
  float acc[4][4][4];
  Tile::accumulate<Mode::kPrescaled>(sx + ((size_t)g * M + row0) * D, M - row0,
                                     sy + ((size_t)g * N + col0) * D, N - col0, nullptr, D, vec,
                                     smem, acc);
  Tile::tile_values(smem, acc, gamma2[g], false);
  Tile::store_tile(smem, out + ((size_t)g * M + row0) * N + col0, N, M - row0, N - col0, false);
}

__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    rbf_gram_sym_kernel(const float* __restrict__ sx, const float* __restrict__ gamma2,
                        float* __restrict__ out, int M, int D, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.y;
  Tile::sym_pair<Mode::kPrescaled>(sx + (size_t)g * M * D, nullptr, gamma2[g],
                                   out + (size_t)g * M * M, M, D, vec, smem);
}

__global__ void rbf_gram_small_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                                      const float* __restrict__ gamma2, float* __restrict__ out,
                                      int M, int N, int D) {
  const int g = blockIdx.z;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M || j >= N) return;
  const float* a = sx + ((size_t)g * M + i) * D;
  const float* b = sy + ((size_t)g * N + j) * D;
  float d2 = 0.f;
  for (int k = 0; k < D; ++k) {
    const float d = a[k] - b[k];
    d2 = fmaf(d, d, d2);
  }
  out[((size_t)g * M + i) * N + j] = gamma2[g] * expf(-0.5f * d2);
}

// devices where each kernel's shared memory is allowed
std::atomic<uint64_t> allowed{0}, allowed_sym{0};

}  // namespace

extern "C" int vargp_rbf_gram(const float* sx, const float* sy, const float* gamma2, float* out,
                              int G, int M, int N, int D, void* stream) {
  if (M == 0 || N == 0 || G == 0) return 0;
  const dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM, G);
  return Tile::launch(rbf_gram_kernel, allowed, grid, static_cast<cudaStream_t>(stream), sx, sy,
                      gamma2, out, M, N, D, rbf_mma::vec_rows(D, sx, sy, nullptr));
}

extern "C" int vargp_rbf_gram_sym(const float* sx, const float* gamma2, float* out, int G, int M,
                                  int D, void* stream) {
  if (M == 0 || G == 0) return 0;
  const int T = (M + Tile::BM - 1) / Tile::BM;
  const dim3 grid(T * (T + 1) / 2, G);
  return Tile::launch(rbf_gram_sym_kernel, allowed_sym, grid, static_cast<cudaStream_t>(stream),
                      sx, gamma2, out, M, D, rbf_mma::vec_rows(D, sx, sx, nullptr));
}

extern "C" int vargp_rbf_gram_small(const float* sx, const float* sy, const float* gamma2,
                                    float* out, int G, int M, int N, int D, void* stream) {
  if (M == 0 || N == 0 || G == 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((N + 31) / 32, (M + 7) / 8, G);
  rbf_gram_small_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(sx, sy, gamma2,
                                                                              out, M, N, D);
  return static_cast<int>(cudaGetLastError());
}

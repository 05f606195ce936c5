// K4: fused-scaling ARD-RBF cross Gram K_zx between the class-stacked
// inducing chain and a data batch shared by every class head.
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_cross_gram_4d (body
// _make_cross_gram_kernel, product _dot_nt_bf16x3).  The TPU kernel
// emulated a bf16x3 product; this one runs the tensor-core tile of
// rbf_mma.cuh in 3xTF32, f32 accuracy.  The output is written straight
// into the (H, O, M, B) layout the predictive marginal consumes, as on the
// TPU.  Grid: (column tile, row tile, h * O + o).
//
// The tile is K2's, Tile128: 128 x 128 outputs, two blocks an SM; a
// 64 x 128 tile (which pads A's 300 rows to 320, not 384) and K1's 64 x 64
// were slower at every shape the paths give K4 (PERF.md, section 6).
//
// z (O, M, D), x (B, D), invs2 = exp(-2 log_ls) (H, D), gamma2 (H,)
// -> out (H, O, M, B).

#include "rbf_mma.cuh"

namespace {

using rbf_mma::Mode;
using Tile = rbf_mma::Tile128;

__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    cross_gram_kernel(const float* __restrict__ z, const float* __restrict__ x,
                      const float* __restrict__ invs2, const float* __restrict__ gamma2,
                      float* __restrict__ out, int O, int M, int B, int D, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ho = blockIdx.z;
  const int h = ho / O;
  const int o = ho - h * O;
  const int row0 = blockIdx.y * Tile::BM, col0 = blockIdx.x * Tile::BN;
  float acc[4][4][4];
  Tile::accumulate<Mode::kCross>(z + ((size_t)o * M + row0) * D, M - row0, x + (size_t)col0 * D,
                                 B - col0, invs2 + (size_t)h * D, D, vec, smem, acc);
  Tile::tile_values(smem, acc, gamma2[h], false);
  Tile::store_tile(smem, out + ((size_t)ho * M + row0) * B + col0, B, M - row0, B - col0, false);
}

std::atomic<uint64_t> allowed{0};  // devices where the kernel's shared memory is allowed

}  // namespace

extern "C" int vargp_cross_gram(const float* z, const float* x,
                                const float* invs2, const float* gamma2,
                                float* out, int H, int O, int M, int B, int D,
                                void* stream) {
  if (M == 0 || B == 0 || H * O == 0) return 0;
  const dim3 grid((B + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM, H * O);
  return Tile::launch(cross_gram_kernel, allowed, grid, static_cast<cudaStream_t>(stream), z, x,
                      invs2, gamma2, out, O, M, B, D, rbf_mma::vec_rows(D, z, x, invs2));
}

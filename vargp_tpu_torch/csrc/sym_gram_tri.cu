// K2: triangle-skip symmetric fused-scaling ARD-RBF Gram, K_zz of a long
// inducing chain (S >= 512 rows).
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d_tri (body
// _make_sym_gram_tri_kernel).  The TPU kernel walked the lower 128-row
// panels of one (h, o) block held in VMEM and transpose-copied each
// finished off-diagonal tile into the upper triangle.  Here the grid is
// the T(T+1)/2 lower 128 x 128 tile pairs (ti >= tj, T = ceil(S / 128)) of
// every (h, o): blockIdx.x is the pair, blockIdx.y is h * O + o.  A block
// computes its tile once on the tensor-core tile of rbf_mma.cuh (Tile128,
// 3xTF32) and stores it at (ti, tj); an off-diagonal block also stores its
// transpose at (tj, ti), both through shared memory.  K1 (sym_gram.cu) is
// the same design on 64 x 64 tiles, and its output equals K2's.
//
// Symmetry: the 3-term product is not the same arithmetic for (i, j) and
// (j, i) (its two cross terms, small*big and big*small, trade places), so
// no entry is computed twice.  Each entry below the diagonal is computed
// once and written to both halves; a diagonal tile keeps its computed
// lower triangle (i >= j) and writes it to both halves too.  The output
// is bitwise symmetric, as the factorisation expects, and its diagonal is
// gamma2 exactly.
//
// What bounds it: the products of the S(S+1)/2 distinct entries, at the
// 3xTF32 rate (165 TFLOP/s); the 120 MB output (S = 1000, H*O = 30) is the
// second limit.  The diagonal tiles compute their upper triangle too
// (T of the T(T+1)/2 tiles).
//
// z (O, M, D), invs = exp(-log_ls) (H, D), gamma2 (H,) -> out (H, O, M, M).

#include "rbf_mma.cuh"

namespace {

using rbf_mma::Mode;
using Tile = rbf_mma::Tile128;

__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    sym_gram_tri_kernel(const float* __restrict__ z, const float* __restrict__ invs,
                        const float* __restrict__ gamma2, float* __restrict__ out, int O, int M,
                        int D, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ho = blockIdx.y;
  const int h = ho / O;
  const int o = ho - h * O;
  Tile::sym_pair<Mode::kSym>(z + (size_t)o * M * D, invs + (size_t)h * D, gamma2[h],
                             out + (size_t)ho * M * M, M, D, vec, smem);
}

std::atomic<uint64_t> allowed{0};  // devices where the kernel's shared memory is allowed

}  // namespace

extern "C" int vargp_sym_gram_tri(const float* z, const float* invs,
                                  const float* gamma2, float* out, int H,
                                  int O, int M, int D, void* stream) {
  if (M == 0 || H * O == 0) return 0;
  const int T = (M + Tile::BM - 1) / Tile::BM;
  const dim3 grid(T * (T + 1) / 2, H * O);
  return Tile::launch(sym_gram_tri_kernel, allowed, grid, static_cast<cudaStream_t>(stream), z,
                      invs, gamma2, out, O, M, D, rbf_mma::vec_rows(D, z, z, invs));
}

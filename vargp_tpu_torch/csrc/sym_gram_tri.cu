// K2: triangle-skip symmetric fused-scaling ARD-RBF Gram, K_zz of a long
// inducing chain (S >= 512 rows).
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d_tri (body
// _make_sym_gram_tri_kernel).  The TPU kernel walked the lower 128-row
// panels of one (h, o) block held in VMEM and transpose-copied each
// finished off-diagonal tile into the upper triangle.  Here the grid is
// the T(T+1)/2 lower 128 x 128 tile pairs (ti >= tj, T = ceil(S / 128)) of
// every (h, o): blockIdx.x is the pair, blockIdx.y is h * O + o.  A block
// computes its tile once on the tensor-core tile of rbf_mma.cuh (3xTF32)
// and stores it at (ti, tj); an off-diagonal block also stores its
// transpose at (tj, ti), both through shared memory.
//
// Symmetry: the 3-term product is not the same arithmetic for (i, j) and
// (j, i) (its two cross terms, small*big and big*small, trade places), so
// no entry is computed twice.  Each entry below the diagonal is computed
// once and written to both halves; a diagonal tile keeps its computed
// lower triangle (i >= j) and writes it to both halves too.  The output
// is bitwise symmetric, as the factorisation expects.
//
// What bounds it: the products of the S(S+1)/2 distinct entries, at the
// 3xTF32 rate (165 TFLOP/s); the 120 MB output (S = 1000, H*O = 30) is the
// second limit.  The diagonal tiles compute their upper triangle too
// (T of the T(T+1)/2 tiles).
//
// z (O, M, D), invs = exp(-log_ls) (H, D), gamma2 (H,) -> out (H, O, M, M).

#include "rbf_mma.cuh"

namespace {

using namespace rbf_mma;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sym_gram_tri_kernel(const float* __restrict__ z, const float* __restrict__ invs,
                        const float* __restrict__ gamma2, float* __restrict__ out, int O, int M,
                        int D, bool vec) {
  static_assert(BM == BN, "a mirrored tile must be square");
  extern __shared__ __align__(16) float smem[];
  // lower tile pair p -> (ti, tj), p = ti (ti + 1) / 2 + tj, tj <= ti
  const int p = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  while (ti * (ti + 1) / 2 > p) --ti;
  const int tj = p - ti * (ti + 1) / 2;

  const int ho = blockIdx.y;
  const int h = ho / O;
  const int o = ho - h * O;
  const int row0 = ti * BM, col0 = tj * BN;
  const float* A = z + (size_t)o * M * D;
  float acc[4][4][4];
  accumulate<true>(A + (size_t)row0 * D, M - row0, A + (size_t)col0 * D, M - col0,
                   invs + (size_t)h * D, D, vec, smem, acc);
  tile_values(smem, acc, gamma2[h], ti == tj);
  float* O_ = out + (size_t)ho * M * M;
  store_tile(smem, O_ + (size_t)row0 * M + col0, M, M - row0, M - col0, ti == tj);
  if (ti != tj) store_tile_transposed(smem, O_ + (size_t)col0 * M + row0, M, M - row0, M - col0);
}

std::atomic<uint64_t> allowed{0};  // devices where the kernel's shared memory is allowed

}  // namespace

extern "C" int vargp_sym_gram_tri(const float* z, const float* invs,
                                  const float* gamma2, float* out, int H,
                                  int O, int M, int D, void* stream) {
  if (M == 0 || H * O == 0) return 0;
  const int T = (M + BM - 1) / BM;
  const dim3 grid(T * (T + 1) / 2, H * O);
  return launch(sym_gram_tri_kernel, allowed, grid, static_cast<cudaStream_t>(stream), z, invs,
                gamma2, out, O, M, D, vec_rows(D, z, z, invs));
}

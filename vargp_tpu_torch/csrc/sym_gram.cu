// K1: symmetric fused-scaling ARD-RBF Gram, K_zz of an inducing chain of
// fewer than 512 rows (the JAX package's gate; K2 from 512 up).
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d (body
// _make_sym_gram_whole_kernel).  The TPU kernel ran one program per (h, o)
// with the whole class block in VMEM and computed the full square.  Here
// K1 is K2's design (sym_gram_tri.cu) on the tensor-core tile of
// rbf_mma.cuh (3xTF32): the grid is the lower tile pairs of every (h, o)
// (blockIdx.x the pair, blockIdx.y h * O + o), each distinct entry
// computed once and mirrored, the diagonal gamma2 exactly.  The tile is
// Tile64, 64 x 64 outputs, where K2's is 128 x 128: an entry's arithmetic
// does not depend on the tile, so K1's output equals K2's bit for bit and
// the values do not change at the gate.
//
// What bounds it: the products of the S(S+1)/2 distinct entries at the
// 3xTF32 rate (A, S = 300, D = 784: 2.1 GFLOP against 20 MB).  Below 512
// rows the grid is small and padded: at A, 64-row tiles give 15 pairs x 30
// (h, o) = 450 blocks for 528 slots (four blocks an SM) and compute 320
// rows of 300; 128-row tiles gave 180 blocks for 264 slots and 384 rows
// (PERF.md section 6).
//
// z (O, M, D), invs = exp(-log_ls) (H, D), gamma2 (H,) -> out (H, O, M, M).

#include "rbf_mma.cuh"

namespace {

using rbf_mma::Mode;
using Tile = rbf_mma::Tile64;

__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    sym_gram_kernel(const float* __restrict__ z, const float* __restrict__ invs,
                    const float* __restrict__ gamma2, float* __restrict__ out, int O, int M, int D,
                    bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ho = blockIdx.y;
  const int h = ho / O;
  const int o = ho - h * O;
  Tile::sym_pair<Mode::kSym>(z + (size_t)o * M * D, invs + (size_t)h * D, gamma2[h],
                             out + (size_t)ho * M * M, M, D, vec, smem);
}

std::atomic<uint64_t> allowed{0};  // devices where the kernel's shared memory is allowed

}  // namespace

extern "C" int vargp_sym_gram(const float* z, const float* invs, const float* gamma2, float* out,
                              int H, int O, int M, int D, void* stream) {
  if (M == 0 || H * O == 0) return 0;
  const int T = (M + Tile::BM - 1) / Tile::BM;
  const dim3 grid(T * (T + 1) / 2, H * O);
  return Tile::launch(sym_gram_kernel, allowed, grid, static_cast<cudaStream_t>(stream), z, invs,
                      gamma2, out, O, M, D, rbf_mma::vec_rows(D, z, z, invs));
}

// K7: batched dense lower Cholesky of (G, S, S) SPD matrices.
//
// Replaces vargp_tpu/ops/pallas/chol.py::cholesky_pallas (body
// _chol_kernel): a right-looking blocked factorisation in 128-column
// panels, one thread-block cluster of C blocks per matrix
// (chol_tile.cuh::cluster_chol; the wrapper picks C, the largest power of
// two <= min(8, SMs / G): 4 at G = 30, 8 at G <= 16, 1 at G >= 67).  Per
// panel one block runs the diagonal step (factor and inverse of the
// 128 x 128 block, chol_tile.cuh::diag_step), the cluster's blocks read
// the inverse from its shared memory and share the panel's 64-row tiles
// L21 = A21 D^-T and the trailing tiles A22 -= L21 L21^T, all products
// 3xTF32 on the tensor cores.  Only the lower triangle of K is read; a
// ragged last panel (300 = 2 x 128 + 44, 1000 = 7 x 128 + 104) is masked to
// the identity in shared memory.
//
// What bounds it, at A (30, 300, 300) and B (30, 1000, 1000):
//   operations: S^3/3 flops per matrix, three TF32 products each at
//     495 TFLOP/s (165 effective): 0.0016 ms at A, 0.061 ms at B;
//   bytes at 3.35 TB/s (the lower triangle read, the factor written):
//     0.0048 ms at A, 0.054 ms at B;
//   latency: S dependent column steps, here ceil(S/128) diagonal steps of
//     4 x 32 warp-register column steps each (~50 cycles a column step at
//     best: 0.008 ms at A, 0.025 ms at B), plus three cluster barriers a
//     panel.  The 3 and 8 diagonal steps take ~30 µs each as built, with
//     their loads and the blockwise inverse (ops/cuda/chol_probe.py), and
//     lie on the critical path whatever the width of the card: most of
//     A's time, a quarter of B's.
// What stays in L2: at A the 30 factors (10.8 MB) stay in the 50 MB L2;
// at B they do not (120 MB), so each panel's trailing update streams A22
// through device memory, while L21 (<= 0.45 MB a matrix) is re-read from
// L2.  The design answers: the cluster puts 120 of the 132 SMs on G = 30
// matrices (one block per matrix used 30); the tensor cores take the
// products; the diagonal step keeps its column steps in registers.

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

__global__ void __launch_bounds__(kThreads, 1)
    chol_kernel(const float* __restrict__ K, float* __restrict__ L, int S) {
  extern __shared__ __align__(16) float smem[];
  const size_t base =
      (size_t)(blockIdx.x / cooperative_groups::this_cluster().num_blocks()) * S * S;
  cluster_chol(K + base, L + base, nullptr, S, smem);
}

}  // namespace

extern "C" int vargp_chol(const float* K, float* L, int G, int S, int C, void* stream) {
  return launch_on_clusters(chol_kernel, G, C, stream, K, L, S);
}

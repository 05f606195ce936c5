// K3: batched lower Cholesky of G diagonal blocks of h x h (h <= 128),
// each read in place from a strided matrix.
//
// Replaces vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas_t (body
// _diag_chol_t_kernel).  The TPU kernel vectorised each column step over
// the whole batch in one program, on 128-blocks that its caller padded
// with an identity tail and sliced back.  On the H100 the batch is the
// grid: one 256-thread block per matrix (chol_tile.cuh::diag_chol_block).
// It reads the block's lower triangle in place (row stride ld, batch
// stride bstride: A's and B's diagonal blocks are views of the chain's
// Gram, 100 and 125 wide), puts the identity outside h x h in shared
// memory, factors the 128-block (chol_tile.cuh::diag_factor: four 32-column
// chunks, each factored by one warp in registers, the rows below solved
// one per thread, the rank-32 updates as 3xTF32 tensor-core tiles), and
// writes the h x h factor, strict upper triangle 0, into a contiguous
// (G, h, h) output.  The factor of blockdiag(A, I) is blockdiag(L, I), so
// no pad, copy or slice is left to the caller.  No clamp on the pivot: a
// non-positive pivot gives NaN where the plain column loop gives NaN.
//
// What bounds it: latency.  128 dependent column steps inside one warp
// (~50 cycles each at best: ~0.0034 ms) and 11 block barriers, with G = 30
// blocks on 132 SMs at the flagship shapes.  The bytes (the lower
// triangle read, the factor written: 2.96 MB at G = 30) take 0.0009 ms at
// 3.35 TB/s and the 21 MFLOP far less.  The design keeps the column steps
// in warp 0's registers, runs the next chunk's factor beside the rest of
// the update (ops/cuda/chol_probe.py --k3 times each phase), and reads the
// block in place.  Shared memory: one 128 x 132 block and 128 pivots'
// reciprocals, 68,096 bytes; registers allow two blocks an SM (128 a
// thread, no spill), so G = 200 (the analysis) runs in one wave.

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

constexpr size_t kSmemBytes = sizeof(float) * kDiagSmemFloats;

__global__ void __launch_bounds__(kThreads, kDiagMinBlocks)
    diag_chol_kernel(const float* __restrict__ in, float* __restrict__ out, long long bstride,
                     int ld, int h, bool vec) {
  extern __shared__ __align__(16) float smem[];
  diag_chol_block(in + blockIdx.x * bstride, ld, h, vec, out + (size_t)blockIdx.x * h * h, smem);
}

}  // namespace

// in: the first block's first entry; block g's entry (r, c) at
// in[g * bstride + r * ld + c].  out: (G, h, h) contiguous.
extern "C" int vargp_diag_chol(const float* in, float* out, int G, long long bstride, int ld,
                               int h, void* stream) {
  static bool attr_set = false;  // on the first card that launches it
  if (G < 1 || h < 1 || h > kN) return static_cast<int>(cudaErrorInvalidValue);
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        diag_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  // 16-byte cp.async only when every row of every block starts 16-byte aligned
  const bool vec = h % 4 == 0 && ld % 4 == 0 && bstride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0;
  diag_chol_kernel<<<G, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      in, out, bstride, ld, h, vec);
  return static_cast<int>(cudaGetLastError());
}

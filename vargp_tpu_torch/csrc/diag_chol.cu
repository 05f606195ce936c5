// K3: batched lower Cholesky of (G, 128, 128) SPD diagonal blocks.
//
// Replaces vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas_t (body
// _diag_chol_t_kernel).  The TPU kernel vectorised each column step over
// the whole batch in one program; on the H100 the batch is the grid: one
// thread block per matrix, the matrix held in shared memory (128 x 129
// floats, 66,048 bytes, padded by one column so that a warp reading a row
// hits 32 distinct banks).  That is above the 48 KB static limit, so the
// launcher raises the kernel's dynamic shared-memory cap first.
//
// Right-looking column loop: for column j, l = A[:, j] * rsqrt(A[j, j]) on
// rows >= j (0 above), then the trailing square is updated by -l l^T.  No
// clamp on the pivot: a non-positive pivot gives NaN (rsqrt of a negative
// number, or 0 * inf at a zero pivot) exactly as the TPU kernel does
// (chol_panel.py:176-177, :231), so a failed factorisation stays visible.
// The caller adds the jitter and the identity padding.
//
// What bounds it: latency.  128 dependent column steps, each ending in a
// block-wide barrier, and only G blocks (30 at the flagship shapes) on the
// 132 SMs; the 21 MFLOP and 3.9 MB it needs are far below the card's
// rates.  The full trailing square is updated (not only its lower half) so
// that every step is one branch-free sweep of the 16x16 thread grid.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 128;
constexpr int kLd = kN + 1;
constexpr int kT = 16;  // thread grid is kT x kT
constexpr size_t kSmemBytes = sizeof(float) * (kN * kLd + kN);

__global__ void __launch_bounds__(kT* kT)
    diag_chol_kernel(const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sA = smem;            // kN x kLd
  float* col = smem + kN * kLd;  // the scaled column j

  const size_t base = (size_t)blockIdx.x * kN * kN;
  const int tx = threadIdx.x % kT;
  const int ty = threadIdx.x / kT;
  const int t = threadIdx.x;

  for (int i = ty; i < kN; i += kT)
    for (int k = tx; k < kN; k += kT) sA[i * kLd + k] = in[base + i * kN + k];
  __syncthreads();

  for (int j = 0; j < kN; ++j) {
    if (t < kN) {
      const float r = rsqrtf(sA[j * kLd + j]);
      col[t] = (t >= j) ? sA[t * kLd + j] * r : 0.f;
    }
    __syncthreads();
    // trailing update of rows/cols > j; column j itself is written below,
    // and no thread of this sweep touches it
    for (int i = j + 1 + ty; i < kN; i += kT) {
      const float li = col[i];
      for (int k = j + 1 + tx; k < kN; k += kT)
        sA[i * kLd + k] = fmaf(-li, col[k], sA[i * kLd + k]);
    }
    if (t < kN) sA[t * kLd + j] = col[t];
    __syncthreads();
  }

  for (int i = ty; i < kN; i += kT)
    for (int k = tx; k < kN; k += kT)
      out[base + i * kN + k] = (k <= i) ? sA[i * kLd + k] : 0.f;
}

}  // namespace

extern "C" int vargp_diag_chol(const float* in, float* out, int G,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      diag_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  diag_chol_kernel<<<G, kT * kT, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}

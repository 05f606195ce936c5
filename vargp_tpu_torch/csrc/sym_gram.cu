// K1: symmetric fused-scaling ARD-RBF Gram, K_zz of the inducing chain.
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d (body
// _make_sym_gram_whole_kernel).  The TPU kernel ran one program per (h, o)
// with the whole class block in VMEM; here each (h, o) is a column of
// 64x64 output tiles (blockIdx.z), since a block's shared memory holds a
// tile, not a 300x784 class block.  The tile itself is rbf_tile.cuh.
//
// z (O, M, D), invs = exp(-log_ls) (H, D), gamma2 (H,) -> out (H, O, M, M).

#include "rbf_tile.cuh"

namespace {

// The symmetric Gram of z[o], both sides scaled by s.
__global__ void __launch_bounds__(vargp::kThreads) rbf_tile_kernel(
    const float* __restrict__ a,       // (O, M, D)
    const float* __restrict__ scale,   // (H, D): s
    const float* __restrict__ gamma2,  // (H,)
    float* __restrict__ out,           // (H, O, M, N)
    int O, int M, int N, int D) {
  __shared__ vargp::TileSmem sm;

  const int ho = blockIdx.z;
  const int h = ho / O;
  const int o = ho - h * O;
  const int row0 = blockIdx.y * vargp::kTileM;
  const int col0 = blockIdx.x * vargp::kTileN;

  const float* A = a + (size_t)o * M * D;
  float acc[4][4];
  vargp::rbf_tile_accumulate<false>(A, A, scale + (size_t)h * D, M, N, D, row0,
                                    col0, sm, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float g2 = gamma2[h];
  float* O_ = out + (size_t)ho * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      O_[(size_t)r * N + c] = vargp::rbf_tile_value(sm, acc, g2, i, j);
    }
  }
}

}  // namespace

extern "C" int vargp_sym_gram(const float* z, const float* invs,
                              const float* gamma2, float* out, int H, int O,
                              int M, int D, void* stream) {
  const dim3 grid((M + vargp::kTileN - 1) / vargp::kTileN,
                  (M + vargp::kTileM - 1) / vargp::kTileM, H * O);
  rbf_tile_kernel<<<grid, vargp::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      z, invs, gamma2, out, O, M, M, D);
  return static_cast<int>(cudaGetLastError());
}

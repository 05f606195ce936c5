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

extern "C" int vargp_sym_gram(const float* z, const float* invs,
                              const float* gamma2, float* out, int H, int O,
                              int M, int D, void* stream) {
  const dim3 grid((M + vargp::kTileN - 1) / vargp::kTileN,
                  (M + vargp::kTileM - 1) / vargp::kTileM, H * O);
  vargp::rbf_tile_kernel<true>
      <<<grid, vargp::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          z, nullptr, invs, gamma2, out, O, M, M, D);
  return static_cast<int>(cudaGetLastError());
}

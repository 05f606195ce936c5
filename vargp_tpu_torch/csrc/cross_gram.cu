// K4: fused-scaling ARD-RBF cross Gram K_zx between the class-stacked
// inducing chain and a data batch shared by every class head.
//
// Replaces vargp_tpu/ops/pallas/rbf_gram.py::_cross_gram_4d (body
// _make_cross_gram_kernel, product _dot_nt_bf16x3).  The TPU kernel
// emulated a bf16x3 product; this one is full f32, at least as accurate.
// The output is written straight into the (H, O, M, B) layout the
// predictive marginal consumes, as on the TPU.  The tile is rbf_tile.cuh.
//
// z (O, M, D), x (B, D), invs2 = exp(-2 log_ls) (H, D), gamma2 (H,)
// -> out (H, O, M, B).

#include "rbf_tile.cuh"

extern "C" int vargp_cross_gram(const float* z, const float* x,
                                const float* invs2, const float* gamma2,
                                float* out, int H, int O, int M, int B, int D,
                                void* stream) {
  const dim3 grid((B + vargp::kTileN - 1) / vargp::kTileN,
                  (M + vargp::kTileM - 1) / vargp::kTileM, H * O);
  vargp::rbf_tile_kernel<false>
      <<<grid, vargp::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          z, x, invs2, gamma2, out, O, M, B, D);
  return static_cast<int>(cudaGetLastError());
}

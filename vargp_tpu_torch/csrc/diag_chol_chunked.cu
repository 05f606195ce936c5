// K8: batched lower Cholesky of (G, 128, 128) SPD blocks, chunked design.
//
// Replaces vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas (bodies
// _diag_chol_kernel and _diag_chol_kernel_unrolled, which compute one
// function; one Hopper kernel stands for both).  It is the TPU's chunked
// design of K3's function, and on the H100 K3 is chunked itself: this
// launcher runs K3's kernel (diag_chol.cu, chol_tile.cuh::diag_factor) at
// h = 128 on contiguous blocks.  Only the lower triangle of the input is
// read.  What bounds it is K3's: latency.

extern "C" int vargp_diag_chol(const float* in, float* out, int G, long long bstride, int ld,
                               int h, void* stream);

extern "C" int vargp_diag_chol_chunked(const float* in, float* out, int G, void* stream) {
  return vargp_diag_chol(in, out, G, 128LL * 128, 128, 128, stream);
}

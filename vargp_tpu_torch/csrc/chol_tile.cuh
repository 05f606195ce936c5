// Device routines shared by the Cholesky kernels K8 (diag_chol_chunked.cu),
// K7 (chol.cu) and K6 (chol_inv.cu).  Every routine runs in one thread
// block of kThreads threads and works on f32 tiles in shared memory with a
// row stride of kLd = 129 floats, so a warp reading a row or a column of a
// tile hits 32 distinct banks.
//
//   chol_block:    lower Cholesky of a 128 x 128 block in place, in four
//                  32-column chunks: one warp factors the chunk's panel
//                  (its column steps exchange the pivot row's values by
//                  shuffles and need no block barrier), then the whole
//                  block applies the chunk's rank-32 update to the
//                  trailing lower triangle.  This is the chunked design of
//                  the TPU's diag_chol_pallas (chol_panel.py:311), with the
//                  batch as the grid instead of a vector axis.
//   tri_inv_block: the inverse of a lower-triangular 128 x 128 block by
//                  forward substitution, one thread per column.
//   stage_rows / stage_cols / mma_tile: a 64 x 64 output tile of a product
//                  whose operands are staged through shared memory in
//                  128-deep slices, a 4 x 4 register block per thread
//                  (plain f32 FMAs on the CUDA cores).
//   blocked_chol:  the right-looking blocked Cholesky of one S x S matrix
//                  in 128-column panels, worked in the output buffer in
//                  device memory (the whole matrix does not fit in shared
//                  memory once S > ~230): factor the diagonal block, solve
//                  the panel below it (a product with the block's inverse),
//                  update the trailing lower triangle by L21 L21^T.
//
// No pivot is clamped: a non-positive pivot gives NaN (rsqrt of a negative
// number, or 0 * inf at a zero pivot), as the TPU kernels do, so a failed
// factorisation stays visible downstream.

#pragma once

#include <cuda_runtime.h>

namespace chol_tile {

constexpr int kN = 128;       // diagonal block and panel width
constexpr int kLd = kN + 1;   // shared-memory row stride
constexpr int kTile = 64;     // output tile of the products
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBlockFloats = kN * kLd;
constexpr int kTileFloats = kTile * kLd;

// Lower Cholesky factor of the SPD block in sD (128 x 128, stride kLd) in
// place.  Reads and writes the lower triangle only; the caller zeroes the
// strict upper triangle.
__device__ inline void chol_block(float* sD) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int c0 = 0; c0 < kN; c0 += 32) {
    if (warp == 0) {
      for (int j = 0; j < 32; ++j) {
        const int jj = c0 + j;
        __syncwarp();  // the previous step's updates are in place
        const float piv = sD[jj * kLd + jj];
        __syncwarp();
        const float rs = rsqrtf(piv);
        for (int r = jj + lane; r < kN; r += 32) sD[r * kLd + jj] *= rs;
        __syncwarp();
        // rank-1 update of the chunk's later columns; l[c] for the chunk's
        // own rows comes from lane c - c0 by shuffle
        const float lown = (c0 + lane >= jj) ? sD[(c0 + lane) * kLd + jj] : 0.f;
        float lr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = c0 + lane + 32 * q;
          lr[q] = (r > jj && r < kN) ? sD[r * kLd + jj] : 0.f;
        }
        for (int c = jj + 1; c < c0 + 32; ++c) {
          const float lc = __shfl_sync(0xffffffffu, lown, c - c0);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = c0 + lane + 32 * q;
            if (r >= c && r < kN) sD[r * kLd + c] = fmaf(-lr[q], lc, sD[r * kLd + c]);
          }
        }
      }
    }
    __syncthreads();
    // rank-32 update of the trailing lower triangle
    const int t0 = c0 + 32, n = kN - t0;
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int r = t0 + idx / n, c = t0 + idx % n;
      if (c > r) continue;
      float acc = sD[r * kLd + c];
#pragma unroll 8
      for (int j = c0; j < t0; ++j) acc = fmaf(-sD[r * kLd + j], sD[c * kLd + j], acc);
      sD[r * kLd + c] = acc;
    }
    __syncthreads();
  }
}

// sX = inverse of the lower-triangular block in sL (both 128 x 128, stride
// kLd), upper triangle of sX zero.
__device__ inline void tri_inv_block(const float* sL, float* sX) {
  const int c = threadIdx.x;
  if (c < kN) {
    for (int i = 0; i < c; ++i) sX[i * kLd + c] = 0.f;
    for (int i = c; i < kN; ++i) {
      float s = (i == c) ? 1.f : 0.f;
      for (int m = c; m < i; ++m) s = fmaf(-sL[i * kLd + m], sX[m * kLd + c], s);
      sX[i * kLd + c] = s / sL[i * kLd + i];
    }
  }
  __syncthreads();
}

// sT[r, k] = g[(row0 + r) * ld + col0 + k] for r < 64, k < 128, zero where
// row0 + r >= nrows or k >= kvalid.
__device__ inline void stage_rows(float* sT, const float* g, int ld, int row0, int nrows,
                                  int col0, int kvalid) {
  for (int idx = threadIdx.x; idx < kTile * kN; idx += kThreads) {
    const int r = idx / kN, k = idx % kN;
    sT[r * kLd + k] = (row0 + r < nrows && k < kvalid) ? g[(size_t)(row0 + r) * ld + col0 + k] : 0.f;
  }
}

// sT[c, k] = g[(row0 + k) * ld + col0 + c] for c < 64, k < 128 (a
// transposed slice), zero where k >= kvalid.
__device__ inline void stage_cols(float* sT, const float* g, int ld, int row0, int kvalid,
                                  int col0) {
  for (int idx = threadIdx.x; idx < kTile * kN; idx += kThreads) {
    const int c = idx % kTile, k = idx / kTile;
    sT[c * kLd + k] = (k < kvalid) ? g[(size_t)(row0 + k) * ld + col0 + c] : 0.f;
  }
}

// acc[a][b] += sum_k sA[ty + 16a, k] * sB[tx + 16b, k] over k < 128.
__device__ inline void mma_tile(const float* sA, const float* sB, float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < kN; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sA[(ty + 16 * i) * kLd + k];
      b[i] = sB[(tx + 16 * i) * kLd + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ inline void zero_acc(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Shared memory of blocked_chol: the diagonal block, its inverse and two
// staged operand tiles.
constexpr size_t kBlockedSmemBytes = sizeof(float) * (2 * kBlockFloats + 2 * kTileFloats);

// Lower Cholesky factor of the S x S matrix K (lower triangle read) into L
// (S x S, strict upper triangle written 0).  When Dinv_out is not null the
// inverse of each diagonal block is written into its diagonal block (the
// rest of Dinv_out is left as it is).  smem holds kBlockedSmemBytes.
__device__ inline void blocked_chol(const float* __restrict__ K, float* L, float* Dinv_out,
                                    int S, float* smem) {
  float* sD = smem;
  float* sDinv = sD + kBlockFloats;
  float* sA = sDinv + kBlockFloats;
  float* sB = sA + kTileFloats;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (size_t idx = tid; idx < (size_t)S * S; idx += kThreads) {
    const int r = (int)(idx / S), c = (int)(idx % S);
    L[idx] = (c <= r) ? K[idx] : 0.f;
  }
  __syncthreads();

  for (int kc = 0; kc < S; kc += kN) {
    const int w = min(kN, S - kc);
    // the diagonal block, its ragged tail masked to the identity
    for (int idx = tid; idx < kN * kN; idx += kThreads) {
      const int r = idx / kN, c = idx % kN;
      float v;
      if (r < w && c < w)
        v = (c <= r) ? L[(size_t)(kc + r) * S + kc + c] : 0.f;
      else
        v = (r == c) ? 1.f : 0.f;
      sD[r * kLd + c] = v;
    }
    __syncthreads();
    chol_block(sD);
    tri_inv_block(sD, sDinv);
    for (int idx = tid; idx < w * w; idx += kThreads) {
      const int r = idx / w, c = idx % w;
      if (c > r) continue;
      L[(size_t)(kc + r) * S + kc + c] = sD[r * kLd + c];
      if (Dinv_out) Dinv_out[(size_t)(kc + r) * S + kc + c] = sDinv[r * kLd + c];
    }
    const int r0 = kc + w;
    if (r0 >= S) break;  // a ragged panel is always the last one

    // panel: L21 = A21 Dinv^T, 64 rows at a time (sDinv's rows are the
    // columns of Dinv^T, k-contiguous)
    for (int rt = r0; rt < S; rt += kTile) {
      __syncthreads();
      stage_rows(sA, L, S, rt, S, kc, kN);
      __syncthreads();
      for (int ct = 0; ct < kN; ct += kTile) {
        float acc[4][4];
        zero_acc(acc);
        mma_tile(sA, sDinv + ct * kLd, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rt + ty + 16 * i;
          if (r >= S) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) L[(size_t)r * S + kc + ct + tx + 16 * j] = acc[i][j];
        }
      }
    }
    __syncthreads();

    // trailing lower triangle: A22 -= L21 L21^T, on 64 x 64 tiles at or
    // below the diagonal
    for (int it = r0; it < S; it += kTile) {
      stage_rows(sA, L, S, it, S, kc, kN);
      for (int jt = r0; jt <= it; jt += kTile) {
        stage_rows(sB, L, S, jt, S, kc, kN);
        __syncthreads();
        float acc[4][4];
        zero_acc(acc);
        mma_tile(sA, sB, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = it + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = jt + tx + 16 * j;
            if (r < S && c <= r) L[(size_t)r * S + c] -= acc[i][j];
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
  __syncthreads();
}

}  // namespace chol_tile

// Device routines shared by the Cholesky kernels K3 (diag_chol.cu), K8
// (diag_chol_chunked.cu), K7 (chol.cu) and K6 (chol_inv.cu).  Every routine
// runs in one thread block of kThreads threads on f32 tiles in shared
// memory.
//
//   diag_factor:  the lower factor L of a 128 x 128 block in place (row
//                 stride kLdD = 132).  Per 32-column chunk, warp 0 factors
//                 the 32 x 32 block in its registers (a lane owns a row;
//                 pivots and the pivot column arrive by __shfl_sync, no
//                 shared-memory round trip per column, the next pivot
//                 shuffled ahead of the column's other shuffles), one
//                 thread per row below solves that row against it in
//                 registers (left-looking: L11's rows read as float4),
//                 and the rank-32 update of the trailing lower triangle
//                 runs as 3xTF32 tensor-core tiles, with a look-ahead: the
//                 next chunk's columns are updated first, on all 8 warps,
//                 and the next chunk's factor runs beside the rest.
//   diag_chol_block: K3's and K8's whole work on one matrix: the h x h
//                 block (h <= 128) read in place, its lower triangle only,
//                 with the identity outside it; diag_factor; the h x h
//                 factor written out.
//   diag_step:    K7's and K6's diagonal step: diag_factor, then the
//                 block's inverse (row stride kLdD).  The inverse is
//                 blockwise: four 32 x 32 chunk inverses at once (one warp
//                 each, a lane owns a column), then the six off-diagonal
//                 32-blocks in three rounds of products, nearest the
//                 diagonal first, on 16 x 16 tiles over all warps.  No step
//                 is longer than 32 dependent column steps.
//   warp_mma:     a warp's (16 MT) x (8 NT) output tile of A B^T on the
//                 tensor cores in 3xTF32: each f32 operand splits into
//                 big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big),
//                 and small*big + big*small + big*big accumulate in f32
//                 (mma.sync m16n8k8).  The dropped small*small term and the
//                 residues are ~2^-22 of each product, so a 128-deep sum
//                 keeps f32 accuracy; one TF32 product keeps ~3 decimal
//                 digits.  B is read K-major (B[n][k]) or N-major (B[k][n])
//                 from shared memory without a transposed copy.
//   cluster_chol: the right-looking blocked Cholesky of one S x S matrix
//                 (and, for K6, the diagonal blocks of its inverse) on one
//                 thread-block cluster of C blocks, worked in the output
//                 buffer in device memory (the first panel reads K in
//                 place).  Per 128-column panel: one block (rank panel % C)
//                 runs diag_step; the others copy the block's inverse out
//                 of its shared memory (distributed shared memory,
//                 cluster.map_shared_rank); the panel's 64-row tiles
//                 L21 = A21 D^-T and the trailing 64 x 128 tiles of
//                 A22 -= L21 L21^T (those that reach the lower triangle) go
//                 round-robin over the cluster's blocks, each tile's whole
//                 128-deep operands staged by cp.async while the previous
//                 tile multiplies, and its entries of A22 loaded one tile
//                 ahead.  Phases are separated by cluster barriers.
//
// Memory ordering across the cluster: a phase's results lie in device
// memory (L, and K6's X) and are read by other blocks of the cluster in
// the next phase.  Each writer runs __threadfence() before the cluster
// barrier (barrier.cluster.arrive.release / wait.acquire), and every read
// of such data goes through L2 (cp.async.cg, __ldcg): never through an L1
// line that another SM's write could leave stale.  Distributed shared
// memory needs only the barrier.
//
// No pivot is clamped: a non-positive pivot gives NaN (rsqrt of a negative
// number, or 0 * inf at a zero pivot), as the TPU kernels do, so a failed
// factorisation stays visible downstream.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chol_tile {

constexpr int kN = 128;       // diagonal block and panel width
constexpr int kThreads = 256; // 8 warps
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kLdD = kN + 4;        // diagonal block stride: 132 = 4 mod 32
constexpr int kDFloats = kN * kLdD; // one 128 x 128 block
constexpr int kLdK = 36;            // a K-major 32-deep slice: 36 = 4 mod 32 (K6)
constexpr int kLdN = 64 + 8;        // an N-major slice 64 wide: 72 = 8 mod 32

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += A B^T over k < K (a multiple of 8) for the warp's (16 MT) x
// (8 NT) tile: A(m, k) = pa[m * lda + k]; B(n, k) = pb[n * ldb + k]
// (K-major) or pb[k * ldb + n] (kBNMajor).  Thread (g = lane / 4, t =
// lane % 4) holds acc[mt][nt][e] = C(16 mt + g + 8 (e / 2), 8 nt + 2 t +
// e % 2).  lda and a K-major ldb are 4 mod 8, an N-major ldb 8 mod 32: no
// bank conflicts.
template <bool kBNMajor, int MT = 2, int NT = 4>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const float* pa, int lda,
                                         const float* pb, int ldb, int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int k = 0; k < K; k += 8) {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = pa + (16 * mt + g) * lda + k + t;
      split_tf32(p[0], ab[mt][0], as[mt][0]);
      split_tf32(p[8 * lda], ab[mt][1], as[mt][1]);
      split_tf32(p[4], ab[mt][2], as[mt][2]);
      split_tf32(p[8 * lda + 4], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (kBNMajor) {
        const float* q = pb + (k + t) * ldb + 8 * nt + g;
        split_tf32(q[0], bb[nt][0], bs[nt][0]);
        split_tf32(q[4 * ldb], bb[nt][1], bs[nt][1]);
      } else {
        const float* q = pb + (8 * nt + g) * ldb + k + t;
        split_tf32(q[0], bb[nt][0], bs[nt][0]);
        split_tf32(q[4], bb[nt][1], bs[nt][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[mt][nt], as[mt], bb[nt]);
        mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
        mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
      }
  }
}

// A warp's 16 x 16 tile: acc = A B^T as above, then f(r, c, v) for each of
// the thread's entries.
template <bool kBNMajor, typename F>
__device__ __forceinline__ void warp_mma16(const float* pa, int lda, const float* pb, int ldb,
                                           int K, F f) {
  float acc[1][2][4] = {};
  warp_mma<kBNMajor, 1, 2>(acc, pa, lda, pb, ldb, K);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) f(g + 8 * (e / 2), 8 * nt + 2 * t + e % 2, acc[0][nt][e]);
}

// Calls f(r, c, i) for each of the thread's 32 accumulators of a warp's
// 32 x 32 tile: (r, c) within the tile, i the index into acc[2][4][4]
// read flat.
template <typename F>
__device__ __forceinline__ void for_frag(F f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) f(16 * (i / 16) + g + 8 * ((i % 4) / 2), 8 * ((i / 4) % 4) + 2 * t + i % 2, i);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// dst[r * ldd + k] = g[r * ldg + k] for r < rows, k < width (a multiple of
// 4 when vec), zero in rows >= valid_rows.  16-byte cp.async when every row starts
// 16-byte aligned (vec), else synchronous L2 loads.  Both read through L2.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* g, int ldg, int rows,
                                      int valid_rows, int width, bool vec) {
  if (vec) {
    const int per_row = width / 4;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
      const int r = idx / per_row, k = 4 * (idx % per_row);
      const bool ok = r < valid_rows;
      cp_async16(dst + r * ldd + k, ok ? g + (size_t)r * ldg + k : g, ok);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
      const int r = idx / width, k = idx % width;
      dst[r * ldd + k] = r < valid_rows ? __ldcg(g + (size_t)r * ldg + k) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// the diagonal factor
// ---------------------------------------------------------------------------

// A probe that records nothing.  ops/cuda/chol_probe.py passes one that
// reads %globaltimer at each event: probe(e) is called by every thread
// that passes event e's point.
struct NoProbe {
  __device__ __forceinline__ void operator()(int) const {}
};
// Events: kEvLoaded, then per 32-column chunk k the ends of its (a), (b),
// (c) on the next chunk's columns, of the rest of (c) and of the join
// (kEvChunk + 5 k + phase), then kEvStored.
enum { kEvLoaded = 0, kEvChunk = 1, kEvA = 0, kEvB, kEvC, kEvRest, kEvJoin, kEvStored = 21 };
constexpr int kEvents = 22;
__host__ __device__ constexpr int ev(int k, int phase) { return kEvChunk + 5 * k + phase; }

// (a) Warp 0: the 32 x 32 diagonal block of the chunk at c0 in place; lane
// r holds row c0 + r.  Each column step's pivot comes by shuffle from its
// lane; the next pivot's one FMA and shuffle go ahead of the column's
// other shuffles (the same FMA that the column loop gives that lane).
// rinv[c0 + r] = 1 / L[c0 + r][c0 + r].
__device__ __forceinline__ void factor_chunk(float* sD, float* rinv, int c0) {
  const int lane = threadIdx.x % 32;
  float a[32];
  float4* row = reinterpret_cast<float4*>(sD + (c0 + lane) * kLdD + c0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = row[q];
    a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
  }
  float rs = rsqrtf(__shfl_sync(kFull, a[0], 0));
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[j] = (lane >= j) ? a[j] * rs : 0.f;
    if (j + 1 < 32) rs = rsqrtf(__shfl_sync(kFull, fmaf(-a[j], a[j], a[j + 1]), j + 1));
#pragma unroll
    for (int c = j + 1; c < 32; ++c) {
      const float lc = __shfl_sync(kFull, a[j], c);  // L[c][j]
      a[c] = fmaf(-a[j], lc, a[c]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) row[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  __syncwarp();
  rinv[c0 + lane] = 1.f / sD[(c0 + lane) * kLdD + c0 + lane];
}

// (b) One thread: row r's 32 entries of the chunk at c0, x L11^T = a, in
// registers.  Left-looking: x[c] = (a[c] - sum_{j<c} x[j] L11[c][j]) /
// L11[c][c], the sum in ascending j (the same FMAs, in the same order, as
// the right-looking substitution), L11's row c read as float4.
__device__ __forceinline__ void solve_row(float* sD, const float* rinv, int c0, int r) {
  float a[32];
  float4* row = reinterpret_cast<float4*>(sD + r * kLdD + c0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = row[q];
    a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
  }
  const float* L11 = sD + c0 * kLdD + c0;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    float s = a[c];
#pragma unroll
    for (int j = 0; j < c; j += 4) {
      const float4 l = *reinterpret_cast<const float4*>(L11 + c * kLdD + j);
      s = fmaf(-a[j], l.x, s);
      if (j + 1 < c) s = fmaf(-a[j + 1], l.y, s);
      if (j + 2 < c) s = fmaf(-a[j + 2], l.z, s);
      if (j + 3 < c) s = fmaf(-a[j + 3], l.w, s);
    }
    a[c] = s * rinv[c0 + c];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) row[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

// (c) One warp: the 16 x 16 tile (ti, tj) of the trailing block at t0 less
// the chunk's rank-32 product L21 L21^T, on its entries in the lower
// triangle.
__device__ __forceinline__ void update_tile(float* sD, int c0, int t0, int ti, int tj) {
  float* out = sD + (t0 + 16 * ti) * kLdD + t0 + 16 * tj;
  warp_mma16<false>(sD + (t0 + 16 * ti) * kLdD + c0, kLdD, sD + (t0 + 16 * tj) * kLdD + c0, kLdD,
                    32, [&](int r, int c, float v) {
                      if (16 * tj + c <= 16 * ti + r) out[r * kLdD + c] -= v;
                    });
}

// sD: a 128 x 128 block, stride kLdD, its lower triangle SPD (a ragged
// block is padded with the identity), strict upper triangle zero.  On
// return sD holds L (strict upper triangle zero) and rinv[c] = 1 / L[c][c].
// Ends with a block barrier.
//
// The look-ahead: chunk k's update is applied to chunk k + 1's 32 columns
// first; then warp 0 factors chunk k + 1 while warps 1-3 and 5-7 update
// the rest of the trailing triangle (warp 4 would share warp 0's
// scheduler), and one barrier joins them.
template <typename Probe = NoProbe>
__device__ inline void diag_factor(float* sD, float* rinv, Probe probe = {}) {
  const int tid = threadIdx.x, warp = tid / 32;
  // Chunk k's pass: the rows below chunk k - 1 solved and its update
  // applied, then chunk k's factor.  One call site of factor_chunk keeps
  // the unrolled column steps in the instruction cache once.
  for (int c0 = 0; c0 < kN; c0 += 32) {
    const int k = c0 / 32, p0 = c0 - 32, n = kN - c0, nb = n / 16;
    if (c0 > 0) {
      if (tid < n) solve_row(sD, rinv, p0, c0 + tid);
      __syncthreads();
      probe(ev(k - 1, kEvB));
      // this chunk's columns only: tiles (0, 0), then (ti, 0) and (ti, 1)
      for (int u = warp; u < 2 * nb - 1; u += kThreads / 32) {
        const int v = u == 0 ? 0 : u + 1;
        update_tile(sD, p0, c0, v / 2, v % 2);
      }
      __syncthreads();
      probe(ev(k - 1, kEvC));
    }
    if (warp == 0) {
      factor_chunk(sD, rinv, c0);
      if (c0 > 0) probe(ev(k, kEvA));
    } else if (c0 > 0 && warp != 4) {  // warp 4 would share warp 0's scheduler
      for (int u = warp - 1 - (warp > 4); u < (nb - 2) * (nb - 1) / 2; u += 6) {
        int ti = 0, tj = u;
        while (tj > ti) tj -= ++ti;
        update_tile(sD, p0, c0, ti + 2, tj + 2);
      }
      probe(ev(k - 1, kEvRest));
    }
    __syncthreads();
    probe(c0 > 0 ? ev(k - 1, kEvJoin) : ev(k, kEvA));
  }
}

// s (128 x 128, stride kLdD) = the lower triangle of the h x h block at g
// (row stride ldg), read through L2; zero above the diagonal; outside
// h x h the identity (diag = 1) or zero (diag = 0).  Warp w takes rows w,
// w + 8, ...; lane l columns 4 l .. 4 l + 3.  When every row of g starts
// 16-byte aligned and h is a multiple of 4 (vec), each 4-column chunk that
// reaches the lower triangle is one 16-byte cp.async (the entries above
// the diagonal that it brings are zeroed after the wait); else the loads
// of four rows are in flight before their stores.  Ends with a block
// barrier.
__device__ inline void load_square(float* s, const float* g, int ldg, int h, float diag,
                                   bool vec) {
  const int warp = threadIdx.x / 32, c = 4 * (threadIdx.x % 32);
  auto outside = [&](int r) {  // the chunk's entries where nothing is read
    return make_float4(r == c ? diag : 0.f, r == c + 1 ? diag : 0.f, r == c + 2 ? diag : 0.f,
                       r == c + 3 ? diag : 0.f);
  };
  if (vec) {
#pragma unroll 4
    for (int r = warp; r < kN; r += kThreads / 32) {
      float* d = s + r * kLdD + c;
      if (r < h && c <= r)
        cp_async16(d, g + (size_t)r * ldg + c, true);
      else
        *reinterpret_cast<float4*>(d) = outside(r);
    }
    cp_async_commit();  // wait_group counts committed groups only
    cp_async_wait<0>();
    for (int r = warp; r < h; r += kThreads / 32)
      for (int e = 1; e < 4; ++e)
        if (c <= r && r < c + e) s[r * kLdD + c + e] = 0.f;
  } else {
    for (int r0 = warp; r0 < kN; r0 += 4 * kThreads / 32) {
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i * kThreads / 32;
        const float* p = g + (size_t)r * ldg + c;
        v[i] = outside(r);
        if (r < h) {
          if (c <= r) v[i].x = __ldcg(p);
          if (c + 1 <= r) v[i].y = __ldcg(p + 1);
          if (c + 2 <= r) v[i].z = __ldcg(p + 2);
          if (c + 3 <= r) v[i].w = __ldcg(p + 3);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(s + (r0 + i * kThreads / 32) * kLdD + c) = v[i];
    }
  }
  __syncthreads();
}

// out (h x h, contiguous) = the leading h x h block of s (stride kLdD)
// with its strict upper triangle 0: warp w writes rows w, w + 8, ...; as
// float4 when h is a multiple of 4 (out 16-byte aligned).
__device__ inline void store_lower(float* out, const float* s, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (h % 4 == 0) {
    const int c = 4 * lane;
    if (c >= h) return;
    for (int r = warp; r < h; r += kThreads / 32) {
      float4 v = *reinterpret_cast<const float4*>(s + r * kLdD + c);
      if (c > r) v.x = 0.f;
      if (c + 1 > r) v.y = 0.f;
      if (c + 2 > r) v.z = 0.f;
      if (c + 3 > r) v.w = 0.f;
      *reinterpret_cast<float4*>(out + r * h + c) = v;
    }
  } else {
    for (int r = warp; r < h; r += kThreads / 32)
      for (int c = lane; c < h; c += 32) out[r * h + c] = c <= r ? s[r * kLdD + c] : 0.f;
  }
}

// Shared memory of diag_chol_block (floats): the block, then rinv; 68,096
// bytes, so three blocks fit on an SM.  Registers allow two
// (__launch_bounds__(kThreads, kDiagMinBlocks): at most 128 a thread; at
// three, 80 a thread, the factor spills).
constexpr int kDiagSmemFloats = kDFloats + kN;
constexpr int kDiagMinBlocks = 2;

// K3's and K8's work on one matrix: the lower Cholesky factor of the h x h
// block at g (h <= 128, row stride ldg, only its lower triangle read)
// into out (h x h, contiguous, strict upper triangle 0).  The identity
// outside h x h makes the factor blockdiag(L, I), whose leading block is
// the answer.  smem holds kDiagSmemFloats.
template <typename Probe = NoProbe>
__device__ inline void diag_chol_block(const float* g, int ldg, int h, bool vec, float* out,
                                       float* smem, Probe probe = {}) {
  float* sD = smem;
  float* rinv = smem + kDFloats;
  load_square(sD, g, ldg, h, 1.f, vec);
  probe(kEvLoaded);
  diag_factor(sD, rinv, probe);
  store_lower(out, sD, h);
  probe(kEvStored);
}

// ---------------------------------------------------------------------------
// the diagonal step
// ---------------------------------------------------------------------------

// One warp: sX's diagonal 32-block at c0 = the inverse of sD's (lower
// triangular, pivots' reciprocals in rinv) by forward substitution; lane c
// holds column c, the rows above its diagonal stay 0.
__device__ inline void invert_chunk(const float* sD, float* sX, const float* rinv, int c0) {
  const int lane = threadIdx.x % 32;
  const float* Lq = sD + c0 * kLdD + c0;
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = (i == lane) ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i >= lane) {
      x[i] *= rinv[c0 + i];
#pragma unroll
      for (int r = i + 1; r < 32; ++r) x[r] = fmaf(-Lq[r * kLdD + i], x[i], x[r]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) sX[(c0 + i) * kLdD + c0 + lane] = x[i];
}

// sD as diag_factor takes it.  On return sD holds L and sX (stride kLdD)
// holds L^-1, both with a zero strict upper triangle.  scratch: 3 x 32 x
// kLdN + 128 floats.
__device__ inline void diag_step(float* sD, float* sX, float* scratch) {
  const int tid = threadIdx.x, warp = tid / 32;
  float* rinv = scratch + 3 * 32 * kLdN;  // 1 / L[c][c]
  diag_factor(sD, rinv);

  // the inverse: the chunks' 32 x 32 inverses, one warp each (run during
  // the factor's chunks, they measured slower: they compete with warp 0),
  // while the other warps zero the strict upper 32-blocks
  if (warp < 4) {
    invert_chunk(sD, sX, rinv, 32 * warp);
  } else {
    for (int idx = tid - 128; idx < kN * kN; idx += kThreads - 128) {
      const int r = idx / kN, c = idx % kN;
      if (c / 32 > r / 32) sX[r * kLdD + c] = 0.f;
    }
  }
  __syncthreads();
  // the off-diagonal 32-blocks X[i][j] = -X[i][i] (L[i][j:i] X[j:i][j]),
  // nearest the diagonal first, on 16 x 16 units round-robin over the warps
  for (int d = 1; d < 4; ++d) {
    const int units = 4 * (4 - d);
    for (int u = warp; u < units; u += kThreads / 32) {
      const int j = u / 4, i = j + d, si = (u / 2) % 2, sj = u % 2;
      float* T = scratch + j * 32 * kLdN;
      warp_mma16<true>(sD + (32 * i + 16 * si) * kLdD + 32 * j, kLdD,
                       sX + 32 * j * kLdD + 32 * j + 16 * sj, kLdD, 32 * d,
                       [&](int r, int c, float v) { T[(16 * si + r) * kLdN + 16 * sj + c] = v; });
    }
    __syncthreads();
    for (int u = warp; u < units; u += kThreads / 32) {
      const int j = u / 4, i = j + d, si = (u / 2) % 2, sj = u % 2;
      const float* T = scratch + j * 32 * kLdN;
      float* out = sX + (32 * i + 16 * si) * kLdD + 32 * j + 16 * sj;
      warp_mma16<true>(sX + (32 * i + 16 * si) * kLdD + 32 * i, kLdD, T + 16 * sj, kLdN, 32,
                       [&](int r, int c, float v) { out[r * kLdD + c] = -v; });
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the blocked factorisation on one cluster
// ---------------------------------------------------------------------------

// Shared memory of cluster_chol (floats), one region in turn:
//   the diagonal step: sD [0, kDFloats), sDinv [kDFloats, 2 kDFloats),
//     scratch after them;
//   the panel: sDinv kept, two 64-row A tiles (whole 128 deep) after it;
//   the trailing update: two buffers of a 64-row A and a 128-row B tile
//     (whole 128 deep) over everything;
//   K6's stage 3 (chol_inv.cu): D_i^-1, P and a ring of operand slices.
constexpr int kRowTile = 64 * kLdD;             // a 64 x 128 tile
constexpr int kTrailFloats = 3 * kRowTile;      // A 64 rows + B 128 rows
constexpr int kSmemFloats = 2 * kTrailFloats;   // = 2 kDFloats + 2 kRowTile
static_assert(2 * kDFloats + 3 * 32 * kLdN + kN <= kSmemFloats, "the diagonal step fits");
constexpr size_t kClusterSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ void publish(cooperative_groups::cluster_group& cluster) {
  __threadfence();  // device-memory writes before the barrier's release
  cluster.sync();
}

// Lower Cholesky factor of the S x S matrix K (lower triangle read) into L
// (strict upper triangle written 0), by the calling cluster.  When X is
// not null it is zeroed and the inverse of each diagonal block is written
// into X's diagonal block.  smem holds kClusterSmemBytes.
__device__ inline void cluster_chol(const float* __restrict__ K, float* L, float* X, int S,
                                    float* smem) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* sD = smem;
  float* sDinv = sD + kDFloats;
  float* after = sDinv + kDFloats;  // scratch, or the panel's A tiles
  const bool vec = (S % 4) == 0;

  // The strict upper triangles are 0; every lower entry of L is written by
  // the panels (and of X by the diagonal steps and K6's stage 3).  Rank 0
  // runs the first diagonal step meanwhile, unless it is alone.
  for (int r = (C > 1 ? rank - 1 : 0); r >= 0 && r < S; r += (C > 1 ? C - 1 : 1)) {
    for (int c = r + 1 + tid; c < S; c += kThreads) {
      L[(size_t)r * S + c] = 0.f;
      if (X) X[(size_t)r * S + c] = 0.f;
    }
  }

  for (int kc = 0, panel = 0; kc < S; kc += kN, ++panel) {
    const int w = min(kN, S - kc), r0 = kc + w;
    const int owner = panel % C;
    // what the panel updates: K itself in the first panel, L after it
    const float* A = panel == 0 ? K : L;
    if (rank == owner) {
      load_square(sD, A + (size_t)kc * S + kc, S, w, 1.f, vec);  // ragged tail: identity
      diag_step(sD, sDinv, after);
      for (int r = warp; r < w; r += kThreads / 32) {
        for (int c = lane; c <= r; c += 32) {
          L[(size_t)(kc + r) * S + kc + c] = sD[r * kLdD + c];
          if (X) X[(size_t)(kc + r) * S + kc + c] = sDinv[r * kLdD + c];
        }
      }
    }
    publish(cluster);
    if (r0 >= S) break;  // a ragged panel is always the last one

    // the panel L21 = A21 D^-T: D^-1 from the owner's shared memory, then
    // 64-row tiles round-robin, the next tile loading while one multiplies;
    // a tile's rows are read and written by one block only
    if (rank != owner) {
      const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(sDinv, owner));
      float4* dst = reinterpret_cast<float4*>(sDinv);
      constexpr int n4 = kDFloats / 4;
      for (int i0 = tid; i0 < n4; i0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * kThreads < n4) v[u] = src[i0 + u * kThreads];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * kThreads < n4) dst[i0 + u * kThreads] = v[u];
      }
    }
    const int n = S - r0;
    const int n_row_tiles = (n + 63) / 64;
    {
      auto fetch = [&](int tile, int b) {
        const int rt = r0 + 64 * tile;
        stage(after + b * kRowTile, kLdD, A + (size_t)rt * S + kc, S, 64, S - rt, kN, vec);
        cp_async_commit();
      };
      if (rank < n_row_tiles) fetch(rank, 0);
      for (int tile = rank, b = 0; tile < n_row_tiles; tile += C, b ^= 1) {
        if (tile + C < n_row_tiles)
          fetch(tile + C, b ^ 1);
        else
          cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        float acc[2][4][4];
        zero_acc(acc);
        warp_mma<false>(acc, after + b * kRowTile + 32 * (warp / 4) * kLdD, kLdD,
                        sDinv + 32 * (warp % 4) * kLdD, kLdD, kN);
        const int rw = r0 + 64 * tile + 32 * (warp / 4), cw = kc + 32 * (warp % 4);
        const float* v = &acc[0][0][0];
        for_frag([&](int r, int c, int i) {
          if (i % 2 || rw + r >= S) return;
          float* p = L + (size_t)(rw + r) * S + cw + c;
          if (S % 2 == 0)
            *reinterpret_cast<float2*>(p) = make_float2(v[i], v[i + 1]);
          else
            p[0] = v[i], p[1] = v[i + 1];
        });
        __syncthreads();  // buffer b is free again
      }
    }
    publish(cluster);

    // the trailing lower triangle A22 -= L21 L21^T on 64 x 128 tiles
    // (it, jt) that reach the lower triangle (jt <= it + 63), round-robin,
    // the next tile's operands loading while one multiplies
    {
      const int n_col_tiles = (n + 127) / 128;
      auto row_count = [&](int ti) { return min(n_col_tiles, (64 * ti + 63) / 128 + 1); };
      auto coords = [&](int t, int& it, int& jt) {
        int ti = 0;
        while (t >= row_count(ti)) t -= row_count(ti++);
        it = r0 + 64 * ti;
        jt = r0 + 128 * t;
      };
      int n_tiles = 0;
      for (int ti = 0; ti < n_row_tiles; ++ti) n_tiles += row_count(ti);
      auto fetch = [&](int t, int b) {
        int it, jt;
        coords(t, it, jt);
        float* buf = smem + b * kTrailFloats;
        stage(buf, kLdD, L + (size_t)it * S + kc, S, 64, S - it, kN, vec);
        stage(buf + kRowTile, kLdD, L + (size_t)jt * S + kc, S, 128, S - jt, kN, vec);
        cp_async_commit();
      };
      // this thread's entries of A22 in tile t, (c, c + 1) pairs as float2
      // when S is even
      const bool pairs = (S % 2) == 0;
      auto entries = [&](int t, float (&dst)[32]) {
        int it, jt;
        coords(t, it, jt);
        const int rw = it + 32 * (warp / 4), cw = jt + 32 * (warp % 4);
        for_frag([&](int r, int c, int i) {
          if (i % 2) return;
          const int gr = rw + r, gc = cw + c;
          const float* p = A + (size_t)gr * S + gc;
          if (pairs && gr < S && gc + 1 <= gr) {
            const float2 u = __ldcg(reinterpret_cast<const float2*>(p));
            dst[i] = u.x, dst[i + 1] = u.y;
          } else {
            dst[i] = (gr < S && gc <= gr) ? __ldcg(p) : 0.f;
            dst[i + 1] = (gr < S && gc + 1 <= gr) ? __ldcg(p + 1) : 0.f;
          }
        });
      };
      float old[32], next[32];
      if (rank < n_tiles) {
        fetch(rank, 0);
        entries(rank, old);
      }
      for (int t = rank, b = 0; t < n_tiles; t += C, b ^= 1) {
        if (t + C < n_tiles) {  // the next tile's operands and entries load meanwhile
          fetch(t + C, b ^ 1);
          entries(t + C, next);
        } else {
          cp_async_commit();
        }
        cp_async_wait<1>();
        __syncthreads();
        const float* buf = smem + b * kTrailFloats;
        float acc[2][4][4];
        zero_acc(acc);
        warp_mma<false>(acc, buf + 32 * (warp / 4) * kLdD, kLdD,
                        buf + kRowTile + 32 * (warp % 4) * kLdD, kLdD, kN);
        int it, jt;
        coords(t, it, jt);
        const int rw = it + 32 * (warp / 4), cw = jt + 32 * (warp % 4);
        const float* v = &acc[0][0][0];
        for_frag([&](int r, int c, int i) {
          if (i % 2) return;
          const int gr = rw + r, gc = cw + c;
          float* p = L + (size_t)gr * S + gc;
          if (pairs && gr < S && gc + 1 <= gr) {
            *reinterpret_cast<float2*>(p) = make_float2(old[i] - v[i], old[i + 1] - v[i + 1]);
          } else {
            if (gr < S && gc <= gr) p[0] = old[i] - v[i];
            if (gr < S && gc + 1 <= gr) p[1] = old[i + 1] - v[i + 1];
          }
        });
#pragma unroll
        for (int i = 0; i < 32; ++i) old[i] = next[i];
        __syncthreads();  // buffer b is free again
      }
    }
    publish(cluster);
  }
}

}  // namespace chol_tile

namespace chol_tile {

// Launch `kernel` on G matrices with one cluster of C blocks each (grid
// G * C, kClusterSmemBytes of shared memory per block).  Returns a CUDA
// status; cudaErrorInvalidConfiguration when no cluster of that size fits
// on the card (no smaller launch is tried).
// The attribute and the occupancy of each cluster size are asked once per
// kernel (on the first card that launches it).
template <typename... Params, typename... Args>
inline int launch_on_clusters(void (*kernel)(Params...), int G, int C, void* stream,
                              Args... args) {
  static bool attr_set = false;
  static int fits[9] = {0};  // 0: not asked, 1: fits, -1: does not
  if (C < 1 || C > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kClusterSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kClusterSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fits[C] == 0) {
    int n_clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    fits[C] = n_clusters > 0 ? 1 : -1;
  }
  if (fits[C] < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chol_tile

// Fused RBF Gram tile on the tensor cores, shared by every Gram of the
// port: K1 (sym_gram.cu), K2 (sym_gram_tri.cu), K4 (cross_gram.cu) and K5
// (rbf_gram.cu):
//
//   out[., i, j] = gamma2 * exp(-0.5 * max(na_i + nb_j - 2 <a_i, b_j>, 0))
//
// Replaces, with those kernels, vargp_tpu/ops/pallas/rbf_gram.py's
// _sym_gram_4d (K1), _sym_gram_4d_tri (K2), _cross_gram_4d (K4) and
// _gram_3d (K5).  Three operand modes, the JAX package's conventions:
//
//   kSym       (K1, K2: K_zz): rows a = z[o], cols b = z[o], both scaled
//              by s = exp(-log_ls)[h]; na_i = |s a_i|^2, nb_j = |s b_j|^2.
//   kCross     (K4: K_zx): rows a = z[o] raw, cols b = x scaled by
//              w = exp(-2 log_ls)[h]; na_i = <a_i, w a_i>,
//              nb_j = <b_j, w b_j>.
//   kPrescaled (K5): a and b taken as they are (the caller scaled them), no
//              scale staged; na_i = |a_i|^2, nb_j = |b_j|^2.
//
// What bounds it on an H100: the product, 2 M N D operations per (h, o)
// against 4 M N output bytes (D = 784: ~390 operations a byte).  On the
// CUDA cores in f32 its ceiling is 67 TFLOP/s.  Here it runs on the tensor
// cores in 3xTF32 (165 TFLOP/s effective, f32 accuracy): each operand
// splits into big = v rounded to TF32 and small = (v - big) rounded to
// TF32 (cvt.rna's rounding), and small*big, big*small, big*big accumulate
// in that order (mma.sync m16n8k8).  The dropped small*small term is
// ~2^-22 of each product, so a 784-deep sum keeps f32 accuracy.
//
// The design (PERF.md section 6 records the alternatives measured):
//
//   Each warp computes a 64 x 32 sub-tile (4 x 4 mma tiles, 64 f32
//   accumulators a thread); Tile<kWM, kWN, kMinBlocks> lays kWM x kWN
//   warps over the block tile.  Two layouts ship:
//
//   Tile128 (K2, K4, K5): 128 x 128 outputs, 8 warps (2 x 4), two blocks
//   an SM (__launch_bounds__ holds a thread to 128 registers; ptxas
//   spills a few words): with one block of 8 warps an SM, two warps a
//   scheduler could not hide the fragment loads and the transform.
//
//   Tile64 (K1): 64 x 64 outputs, 2 warps (1 x 2), four blocks an SM (no
//   spill).  K1's chains are shorter than 512 rows, where the 128-row
//   tiles leave the card half idle and pad the most: at A (S = 300) 180
//   blocks for 264 slots, 384 rows computed for 300.  The 64-row tiles
//   give 450 blocks and compute 320 (PERF.md section 6 has both timed).
//
//   Staging: per 16-feature chunk, the tile's rows of a and of b and the
//   chunk's 16 scale values arrive raw through 16-byte cp.async
//   copies into a 2-slot ring (rows padded to BK + 4 floats: the
//   transform's reads are free of bank conflicts).  A thread's copies and
//   their row offsets are fixed for the tile (Stager).  Rows outside the
//   matrix and features >= D read 0.  When D is not a multiple of 4 (or a
//   pointer is not 16-byte aligned) every copy is a 4-byte cp.async.
//
//   Transform, once per staged element: scale (not in kPrescaled), add
//   into the row's norm in f32 (from the scaled value; for K4's z side
//   <z, w z>), split into big and small (two integer operations each, not
//   cvt.rna, which compiles to a longer sequence on sm_90), and store both
//   into a plane in fragment order: per 16-row group and 8-feature step,
//   lane (g, t) holds four values, an A fragment of m16n8k8 for a's
//   groups, the register pairs of two n8 tiles' B fragments for b's.  Each
//   fragment load is one conflict-free 16-byte load per plane, and the mma
//   loop converts and moves nothing.  The planes are double-buffered: chunk
//   c + 1 is transformed while chunk c multiplies, with one barrier per
//   chunk between them.
//
//   Accumulation: a chunk's products of a 16 x 8 tile go into a zeroed
//   tile that is then added to the f32 accumulator with a rounded add.
//   The tensor cores truncate as they add into their accumulator; over the
//   98 steps of D = 784 into a sum near |a_i|^2 (a diagonal entry of a
//   symmetric Gram, or z_i near x_j in K4) that biased d^2 by ~2e-5.
//
//   Epilogue: the values through shared memory (the ring reused, rows of
//   BN + 1 floats), then stored by rows, a warp 32 consecutive floats at a
//   time.
//
//   Symmetric Grams (K1, K2, K5's K_zz) run on the mirrored pair grid:
//   each lower tile pair (ti >= tj) is computed once; an off-diagonal one
//   is also stored transposed (column reads of the tile, conflict-free at
//   the odd stride), a diagonal one keeps its computed lower triangle and
//   writes it to both halves.  An entry's arithmetic does not depend on
//   the tile that computes it (the same chunks, k8 steps and rounded adds;
//   the lower entry i > j is always the one computed), so K1 and K2 agree
//   bit for bit.
//
// What holds it below the mma.sync rate: per 16-feature chunk a warp
// issues ~750 instructions for its 96 mma.sync (the transform's split,
// the staging, the rounded adds), and shared memory carries each chunk
// four times (the copy, the transform's read and write, the fragment
// loads).  wgmma on planes laid out for it is the next step.
//
// The kernels themselves are in sym_gram.cu (K1), sym_gram_tri.cu (K2),
// cross_gram.cu (K4) and rbf_gram.cu (K5).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "chol_tile.cuh"  // cp.async, the TF32 split and mma.sync

namespace rbf_mma {

using chol_tile::cp_async16;
using chol_tile::cp_async_commit;
using chol_tile::cp_async_wait;
using chol_tile::mma_tf32;

// The operands' scaling (the note at the top).
enum class Mode { kSym, kCross, kPrescaled };

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero: add half of the 13 dropped bits to the magnitude,
// then clear them), in two integer operations; on sm_90 cvt.rna compiles
// to a longer sequence.
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_rna(float v, uint32_t& big, uint32_t& small) {
  big = rna_tf32(v);
  small = rna_tf32(v - __uint_as_float(big));
}

// One lane's four values of a group into the planes at d: big at d, small
// at d + 128, each one 16-byte store.
__device__ __forceinline__ void store_group(float* d, const float (&v)[4]) {
  uint32_t big[4], small[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_rna(v[e], big[e], small[e]);
  *reinterpret_cast<uint4*>(d) = make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(d + 128) = make_uint4(small[0], small[1], small[2], small[3]);
}

// The lane's fragment registers of a group, as store_group left them.
__device__ __forceinline__ void load_group(const float* d, uint32_t (&big)[4], uint32_t (&small)[4]) {
  const uint4 b = *reinterpret_cast<const uint4*>(d);
  const uint4 s = *reinterpret_cast<const uint4*>(d + 128);
  big[0] = b.x, big[1] = b.y, big[2] = b.z, big[3] = b.w;
  small[0] = s.x, small[1] = s.y, small[2] = s.z, small[3] = s.w;
}

// Lower tile pair p of a symmetric Gram's grid -> (ti, tj), with
// p = ti (ti + 1) / 2 + tj and tj <= ti.
__device__ __forceinline__ void tile_pair(int p, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  while (ti * (ti + 1) / 2 > p) --ti;
  tj = p - ti * (ti + 1) / 2;
}

// 16-byte copies need D a multiple of 4 and every base 16-byte aligned (a
// null scale counts as aligned).
inline bool vec_rows(int D, const void* a, const void* b, const void* s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(s);
  return D % 4 == 0 && any % 16 == 0;
}

// The tile for one layout of warps: kWM x kWN warps, each a 64 x 32
// sub-tile (4 x 4 mma tiles), a block tile of 64 kWM x 32 kWN outputs, at
// least kMinBlocks blocks an SM (__launch_bounds__).
template <int kWM_, int kWN_, int kMinBlocks_>
struct Tile {
  static constexpr int kWM = kWM_, kWN = kWN_;  // warps down and across the block tile
  static constexpr int kMinBlocks = kMinBlocks_;  // blocks an SM, for __launch_bounds__
  static constexpr int kWarps = kWM * kWN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BM = 64 * kWM;                 // output rows (a) per block
  static constexpr int BN = 32 * kWN;                 // output cols (b) per block
  static constexpr int BK = 16;                       // features per staged chunk
  static constexpr int kStages = 2;                   // ring slots
  static constexpr int kRows = BM + BN;               // staged rows: a's, then b's
  static constexpr int kGroups = kRows / 16;
  static constexpr int kGroupsA = BM / 16;
  static constexpr int kPerWarp = kGroups / kWarps;   // groups a warp transforms
  static constexpr int kSteps = BK / 8;
  static constexpr int kLdR = BK + 4;                 // raw row stride, 4 mod 8
  static constexpr int kStage = kRows * kLdR + BK;    // raw rows, then the scale
  static constexpr int kPlane = kRows * BK * 2;       // big and small, fragment order
  static constexpr int kLdT = BN + 1;                 // epilogue tile stride
  static constexpr int kPipe = kStages * kStage + 2 * kPlane;
  static constexpr int kMain = kPipe > BM * kLdT ? kPipe : BM * kLdT;
  // the ring and planes (or the epilogue tile), then the rows' norms
  static constexpr size_t kSmemBytes = sizeof(float) * (kMain + kRows);
  static_assert(kGroups % kWarps == 0 && kGroupsA % kWarps == 0,
                "every warp transforms whole groups, each all a's or all b's");
  static_assert(BK % 8 == 0 && kStages >= 2, "chunks of whole k8 steps, a ring of 2+");

  // A thread's share of the staging, fixed for the tile: copy i moves the 4
  // features [k0 + kk, k0 + kk + 4) of staged row r0 + i * kRowsPerPass (a's
  // rows, then b's), one 16-byte cp.async (vec) or four 4-byte ones.  Rows
  // outside the matrix and features >= D are zero-filled.  The row offsets
  // and validity are worked out once, so a chunk's copy costs an add and a
  // compare.  Threads kk / 4 < kQ of row 0 also copy scale[k0 + kk ..],
  // unless scale is null (kPrescaled).
  struct Stager {
    static constexpr int kQ = BK / 4;  // copies per row
    static constexpr int kRowsPerPass = kThreads / kQ;
    static constexpr int kCopies = kRows / kRowsPerPass;
    static constexpr int kCopiesA = BM / kRowsPerPass;  // copies of a's rows
    static_assert(kThreads % kQ == 0 && BM % kRowsPerPass == 0 &&
                      BN % kRowsPerPass == 0, "every pass lies in a or in b");
    const float* a;
    const float* b;
    const float* scale;
    int off[kCopies];  // row * D + kk within a or b
    unsigned valid;    // bit i: copy i's row lies in the matrix
    int kk, dst0, D;
    bool vec;

    __device__ __forceinline__ Stager(const float* a_, int ra, const float* b_, int rb,
                                      const float* scale_, int D_, bool vec_)
        : a(a_), b(b_), scale(scale_), valid(0u), D(D_), vec(vec_) {
      const int r0 = threadIdx.x / kQ;
      kk = 4 * (threadIdx.x % kQ);
      dst0 = r0 * kLdR + kk;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int r = r0 + i * kRowsPerPass - (i < kCopiesA ? 0 : BM);
        off[i] = r * D + kk;
        if (r < (i < kCopiesA ? ra : rb)) valid |= 1u << i;
      }
    }

    __device__ __forceinline__ void issue(float* slot, int k0) const {
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const float* src = (i < kCopiesA ? a : b) + off[i] + k0;
        float* dst = slot + dst0 + i * kRowsPerPass * kLdR;
        const bool row = (valid >> i) & 1u;
        if (vec) {
          const bool ok = row && k0 + kk < D;  // D % 4 == 0: 4 features in or out
          cp_async16(dst, ok ? src : a, ok);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = row && k0 + kk + q < D;
            cp_async4(dst + q, ok ? src + q : a, ok);
          }
        }
      }
      if (scale != nullptr && threadIdx.x < kQ) {
        float* dst = slot + kRows * kLdR + kk;
        if (vec) {
          const bool ok = k0 + kk < D;
          cp_async16(dst, ok ? scale + k0 + kk : scale, ok);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = k0 + kk + q < D;
            cp_async4(dst + q, ok ? scale + k0 + kk + q : scale, ok);
          }
        }
      }
    }
  };

  // The transform of group q (16 staged rows), k8 step ks, by this lane
  // (g, t): raw slot -> plane pl; n_lo and n_hi take rows 16 q + g and
  // 16 q + g + 8.  The lane's four values (g, t), (g + 8, t), (g, t + 4),
  // (g + 8, t + 4) go in that order for a's groups (an A fragment), and as
  // (g, t), (g, t + 4), (g + 8, t), (g + 8, t + 4) for b's (side_b: the B
  // fragments of the group's two n8 tiles, each a register pair).
  template <Mode kMode>
  static __device__ __forceinline__ void transform(const float* raw, float* pl, int q,
                                                   bool side_b, int ks, int lane, float& n_lo,
                                                   float& n_hi) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = raw + (16 * q + g) * kLdR + 8 * ks + t;
    const float* sp = raw + kRows * kLdR + 8 * ks + t;
    const float x[4] = {p[0], p[8 * kLdR], p[4], p[8 * kLdR + 4]};
    const float s[4] = {sp[0], sp[0], sp[4], sp[4]};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& n = (e & 1) ? n_hi : n_lo;
      if (kMode == Mode::kCross) {  // K4 scales the x side only
        const float xw = x[e] * s[e];
        v[e] = side_b ? xw : x[e];
        n = fmaf(x[e], xw, n);
      } else {
        v[e] = kMode == Mode::kSym ? x[e] * s[e] : x[e];
        n = fmaf(v[e], v[e], n);
      }
    }
    if (side_b) {
      const float v1 = v[1];
      v[1] = v[2];
      v[2] = v1;
    }
    store_group(pl + (ks * kGroups + q) * 256 + 4 * lane, v);
  }

  // One warp's B operands of k8 step ks: the fragments of its 4 n8 tiles
  // (32 cols), big and small.
  static __device__ __forceinline__ void load_b(const float* pl, int ks, int wn, int lane,
                                                uint32_t (&bb)[4][2], uint32_t (&bs)[4][2]) {
#pragma unroll
    for (int gb = 0; gb < 2; ++gb) {
      uint32_t big[4], small[4];
      load_group(pl + (ks * kGroups + kGroupsA + 2 * wn + gb) * 256 + 4 * lane, big, small);
      bb[2 * gb][0] = big[0], bb[2 * gb][1] = big[1];
      bb[2 * gb + 1][0] = big[2], bb[2 * gb + 1][1] = big[3];
      bs[2 * gb][0] = small[0], bs[2 * gb][1] = small[1];
      bs[2 * gb + 1][0] = small[2], bs[2 * gb + 1][1] = small[3];
    }
  }

  // acc += the warp's 64 x 32 product over one chunk (its kSteps k8
  // steps), from the B fragments of every step.  Each 16 x 8 tile's products
  // (per step small*big, big*small, big*big) go into a zeroed f32 tile first,
  // which is then added to acc (round to nearest): the tensor cores truncate
  // as they add into their accumulator, and over D = 784 into a sum near
  // |a|^2 (a diagonal entry) that biases the sum by ~1e-5; a chunk's tile is
  // ~1/50 of it.
  static __device__ __forceinline__ void mma_chunk(const float* pl, int wm, int lane,
                                                   const uint32_t (&bb)[kSteps][4][2],
                                                   const uint32_t (&bs)[kSteps][4][2],
                                                   float (&acc)[4][4][4]) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float t[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t ab[4], as[4];
        load_group(pl + (ks * kGroups + 4 * wm + mt) * 256 + 4 * lane, ab, as);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(t[nt], as, bb[ks][nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(t[nt], ab, bs[ks][nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(t[nt], ab, bb[ks][nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[nt][e];
    }
  }

  // acc = <a_i, b_j> over the D features for the warp's 64 x 32 sub-tile
  // (thread (g, t) holds acc[mt][nt][e] = C(64 wm + 16 mt + g + 8 (e / 2),
  // 32 wn + 8 nt + 2 t + e % 2)), and the staged rows' norms into
  // smem[kMain + r] (a's rows r < BM, b's at BM + r).  a and b point at the
  // tile's first rows, ra and rb rows of each are valid; scale is null in
  // kPrescaled.  Ends with the copies drained and a barrier: the ring may be
  // reused.
  template <Mode kMode>
  static __device__ __forceinline__ void accumulate(const float* a, int ra, const float* b,
                                                    int rb, const float* scale, int D, bool vec,
                                                    float* smem, float (&acc)[4][4][4]) {
    float* ring = smem;
    float* planes = smem + kStages * kStage;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp / kWN, wn = warp % kWN;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    float nrm[kPerWarp][2];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) nrm[j][0] = nrm[j][1] = 0.f;

    const Stager st(a, ra, b, rb, scale, D, vec);
    const int nch = (D + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < nch) st.issue(ring + s * kStage, s * BK);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (nch > 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j)
          transform<kMode>(ring, planes, warp + kWarps * j, j >= kGroupsA / kWarps, ks, lane,
                          nrm[j][0], nrm[j][1]);
    }
    for (int c = 0; c < nch; ++c) {
      // chunk c + 1 has landed, chunk c's planes are whole, chunk c - 1's
      // products and raw slot are done with
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (c + kStages < nch) st.issue(ring + (c % kStages) * kStage, (c + kStages) * BK);
      cp_async_commit();
      const float* cur = planes + (c & 1) * kPlane;
      uint32_t bb[kSteps][4][2], bs[kSteps][4][2];
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) load_b(cur, ks, wn, lane, bb[ks], bs[ks]);
      if (c + 1 < nch) {
        float* nxt = planes + ((c + 1) & 1) * kPlane;
        const float* raw = ring + ((c + 1) % kStages) * kStage;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
          for (int j = 0; j < kPerWarp; ++j)
            transform<kMode>(raw, nxt, warp + kWarps * j, j >= kGroupsA / kWarps, ks, lane,
                            nrm[j][0], nrm[j][1]);
      }
      mma_chunk(cur, wm, lane, bb, bs, acc);
    }

    // the four t lanes of a row hold its partial norms
    float* norms = smem + kMain;
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float n = nrm[j][hi];
        n += __shfl_xor_sync(0xffffffffu, n, 1);
        n += __shfl_xor_sync(0xffffffffu, n, 2);
        if ((lane & 3) == 0) norms[16 * (warp + kWarps * j) + (lane >> 2) + 8 * hi] = n;
      }
    cp_async_wait<0>();
    __syncthreads();
  }

  // The Gram values of the block's tile into T = smem (BM x BN, stride
  // kLdT): g2 exp(-0.5 max(na + nb - 2 acc, 0)); on a diagonal tile of a
  // symmetric Gram (diag) the entries i == j take d^2 = 0, their exact value
  // (na_i + na_i - 2 <a_i, a_i> is rounding, ~1e-6 through the split sum).
  // Ends with a barrier.
  static __device__ __forceinline__ void tile_values(float* smem, const float (&acc)[4][4][4],
                                                     float g2, bool diag) {
    const float* norms = smem + kMain;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp / kWN, wn = warp % kWN, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 64 * wm + 16 * mt + g + 8 * (e >> 1);
          const int c = 32 * wn + 8 * nt + 2 * t + (e & 1);
          const float d2 = fmaxf(norms[r] + norms[BM + c] - 2.f * acc[mt][nt][e], 0.f);
          smem[r * kLdT + c] = g2 * expf(-0.5f * (diag && r == c ? 0.f : d2));
        }
    __syncthreads();
  }

  // out[r * ld + c] = T[r][c] for r < rows, c < cols; with lower_only (a
  // diagonal tile of a symmetric Gram) the entries above the diagonal take
  // their mirror T[c][r], so only the computed lower triangle is written, to
  // both halves.
  static __device__ __forceinline__ void store_tile(const float* T, float* out, size_t ld,
                                                    int rows, int cols, bool lower_only) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    rows = min(rows, BM);
    cols = min(cols, BN);
    for (int r = warp; r < rows; r += kWarps)
      for (int c = lane; c < cols; c += 32)
        out[r * ld + c] = (lower_only && c > r) ? T[c * kLdT + r] : T[r * kLdT + c];
  }

  // out[c * ld + r] = T[r][c]: the tile transposed, a warp 32 consecutive r
  // of one output row at a time (column reads of T, conflict-free at the odd
  // stride).
  static __device__ __forceinline__ void store_tile_transposed(const float* T, float* out,
                                                               size_t ld, int rows, int cols) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    rows = min(rows, BM);
    cols = min(cols, BN);
    for (int c = warp; c < cols; c += kWarps)
      for (int r = lane; r < rows; r += 32) out[c * ld + r] = T[r * kLdT + c];
  }

  // The values T = smem of tile pair (ti, tj) into the M x M Gram out: at
  // (ti, tj), a diagonal tile's lower triangle to both halves, and an
  // off-diagonal tile also transposed at (tj, ti).
  static __device__ __forceinline__ void store_pair(const float* T, float* out, int M, int ti,
                                                    int tj) {
    static_assert(BM == BN, "a mirrored tile must be square");
    const int row0 = ti * BM, col0 = tj * BN;
    store_tile(T, out + (size_t)row0 * M + col0, M, M - row0, M - col0, ti == tj);
    if (ti != tj) store_tile_transposed(T, out + (size_t)col0 * M + row0, M, M - row0, M - col0);
  }

  // One block of a symmetric Gram on the mirrored pair grid: tile pair
  // blockIdx.x of the M x M Gram of rows A (M x D), scaled by scale (null
  // in kPrescaled), computed once into out with gamma2 g2.
  template <Mode kMode>
  static __device__ __forceinline__ void sym_pair(const float* A, const float* scale, float g2,
                                                  float* out, int M, int D, bool vec, float* smem) {
    int ti, tj;
    tile_pair(blockIdx.x, ti, tj);
    const int row0 = ti * BM, col0 = tj * BN;
    float acc[4][4][4];
    accumulate<kMode>(A + (size_t)row0 * D, M - row0, A + (size_t)col0 * D, M - col0, scale, D,
                      vec, smem, acc);
    tile_values(smem, acc, g2, ti == tj);
    store_pair(smem, out, M, ti, tj);
  }

  // Launches kernel with kSmemBytes of dynamic shared memory, which above
  // 48 KB must first be allowed on the device.  That is a call to the driver,
  // and the steps that launch the Grams are paced by the host, so it is made
  // once per device for each kernel: allowed holds a bit per device (devices
  // past the 64th are allowed at every launch).  Returns the first CUDA error.
  template <typename... Params, typename... Args>
  static int launch(void (*kernel)(Params...), std::atomic<uint64_t>& allowed, dim3 grid,
                    cudaStream_t stream, Args... args) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(allowed.load(std::memory_order_acquire) & bit)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed.fetch_or(bit, std::memory_order_release);
    }
    kernel<<<grid, kThreads, kSmemBytes, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
};

// K2, K4 and K5: 128 x 128 outputs, 8 warps, two blocks an SM.
using Tile128 = Tile<2, 4, 2>;
// K1: 64 x 64 outputs, 2 warps, four blocks an SM (A's 300 rows pad to
// 320, not 384, and its grid is 450 blocks, not 180).
using Tile64 = Tile<1, 2, 4>;

}  // namespace rbf_mma

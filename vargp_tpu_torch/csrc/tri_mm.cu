// tri_mm (K9): out = tril(L) X for a batch of G lower-triangular L (S x S)
// and X (S x N), float32 in and out, row-major.
//
// Replaces no Pallas kernel: the JAX package leaves the predictive
// marginal's W = L^-1 K_zx to XLA's dot (vargp_tpu/gpmath/conditional.py:420),
// and the port left it to cuBLAS's dense f32 product, which also multiplies
// L^-1's zero upper triangle.  Caller: gpmath/conditional.py::
// whitened_marginal_diag_factored, once per predict call.
//
// What bounds it on an H100: the triangle's operations, S^2 N per matrix (the
// lower half of S x S, 2 per multiply-add), against L's lower half, X and the
// output in bytes.  At P-MNIST's predict shape (20 x 10 matrices, S = 1000,
// N = 512) that is 102.4 GFLOP and 1.2 GB: 0.62 ms at the 165 TFLOP/s of
// f32-accurate products on the tensor cores, 0.36 ms at 3.35 TB/s, so the
// operations bound it.
//
// How the design meets it:
//
//   The zeros are not multiplied.  A block computes a 128 x 128 output tile,
//   rows [r0, r0 + 128), over the k-chunks below min(r0 + 128, S) only, and
//   each of its two warpgroups (64 rows) stops at its own last row: about 11%
//   more than the triangle's work at S = 1000, where dense tiles do 100%
//   more.  L's strictly-upper part is never read: each 16-byte copy of a row
//   of L reads the entries up to the diagonal and zero-fills the rest
//   (cp.async's source size), so any L^-1 the factorisation's routes give
//   works, whatever lies above its diagonal.
//
//   f32 accuracy on the tensor cores: 3xTF32, the Grams' arithmetic
//   (rbf_mma.cuh's split_rna): each operand splits into big = tf32(v) and
//   small = tf32(v - big), and small*big, big*small, big*big accumulate in
//   f32.  The tensor cores truncate as they accumulate, so each 32-deep chunk
//   goes into a fresh tile (the first product's scale-d 0) that is then
//   added to the f32 result with a rounded add: the error against float64
//   stays below the dense f32 product's.
//
//   wgmma (m64n128k8, TF32).  A, L's rows, is K-major as it lies: each warp
//   loads its 16 rows' fragments from the staged chunk and splits them in
//   registers (the RS form: A from registers).  B, X's chunk, arrives N-major
//   (k rows of 128 columns); the split transposes it into big and small
//   planes of wgmma's K-major no-swizzle layout (8 x 16-byte core matrices),
//   double-buffered.  Chunk c + 1 is staged, split and its A fragments
//   fetched while chunk c's 12 products run asynchronously; after the wait
//   only the rounded adds and A's split stand between two batches.  The
//   copies run four chunks ahead through a 4-slot cp.async ring; one block
//   of 256 threads (~204 KB of shared memory) an SM.  The warpgroup index
//   goes through __shfl_sync so that ptxas can prove it uniform: the
//   descriptors then stay in uniform registers and the products are not
//   serialised.
//
//   The grid: row tiles have unequal work (tile i runs i + 1 times tile 0's
//   chunks).  Blocks take the longest row tiles first, every matrix's, each
//   (row tile, matrix) with its column tiles side by side, so the grid ends
//   on short blocks.
//
//   At the P-MNIST shape on an H100 80GB HBM3 (700 W): 1.72-1.74 ms, ~59
//   TFLOP/s on the S^2 N count; the same product on mma.sync with the
//   Grams' Tile128 (split planes in shared memory) took 2.13-2.16 ms, and
//   cuBLAS's dense f32 product 3.85-4.0 ms.

#include "rbf_mma.cuh"

namespace {

using rbf_mma::split_rna;

constexpr int kThreads = 256;                   // two warpgroups, 64 rows each
constexpr int BM = 128, BN = 128, BK = 32;      // output tile, chunk depth
constexpr int kSteps = BK / 8;                  // k8 steps a chunk
constexpr int kStages = 4;                      // cp.async ring slots
constexpr int kLdA = BK + 4;                    // L's staged rows: 36 = 4 mod 32
constexpr int kLdB = BN + 8;                    // X's staged rows: 136 = 8 mod 32
constexpr int kRaw = BM * kLdA + BK * kLdB;     // one staged chunk, floats
constexpr int kStepB = BN * 8;                  // a k8 step of a B plane, floats
constexpr int kPlane = kSteps * kStepB;         // one B plane (big or small)
constexpr int kPlanes = 2 * kPlane;             // big, then small
constexpr size_t kSmemBytes = sizeof(float) * (kStages * kRaw + 2 * kPlanes);
// descriptor strides in bytes: K-adjacent core matrices, then 8-row groups
constexpr uint32_t kLBO = 128, kSBO = 256;
static_assert(BN * BK / 4 == 4 * kThreads && BM * BK / 4 == 4 * kThreads,
              "each thread stages four 16-byte copies of L's and of X's chunk");

// 16 bytes into dst, the first `bytes` of them from src and the rest zero.
__device__ __forceinline__ void cp_async16_n(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

// A shared-memory matrix descriptor: K-major core matrices without swizzle.
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

// d (+)= a b for the warpgroup's 64 x 128 tile: a (64 x 8) from registers,
// b (8 x 128) from shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their other uses across these points (CUTLASS's
// warpgroup_fence_operand).
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kSteps][4]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[s][i])::"memory");
}

// A thread's share of a chunk's copies: four 16-byte copies of L's rows
// (row r0 + ra + 32 i, columns k0 + ka ..), only entries on or below the
// diagonal read; four of X's rows (row k0 + kb + 8 i, columns c0 + nb ..),
// rows >= S and columns >= N zero.  vec: S and N multiples of 4 and every
// base 16-byte aligned, else each entry is its own 4-byte copy.
struct Stager {
  const float* L;  // the matrix's L
  const float* X;  // the matrix's X
  int S, N, r0, c0;
  bool vec;

  __device__ __forceinline__ void issue(float* slot, int k0) const {
    const int ra = threadIdx.x / 8, ka = 4 * (threadIdx.x % 8);
    const int kb = threadIdx.x / 32, nb = 4 * (threadIdx.x % 32);
    float* sa = slot;
    float* sb = slot + BM * kLdA;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ra + 32 * i, c = k0 + ka;
      float* dst = sa + (ra + 32 * i) * kLdA + ka;
      const int n = r < S ? max(0, min(4, r + 1 - c)) : 0;  // entries on or below the diagonal
      const float* src = n > 0 ? L + (size_t)r * S + c : L;
      if (vec) {
        cp_async16_n(dst, src, 4 * n);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) rbf_mma::cp_async4(dst + q, q < n ? src + q : L, q < n);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kb + 8 * i, col = c0 + nb;
      float* dst = sb + (kb + 8 * i) * kLdB + nb;
      const int n = k < S ? max(0, min(4, N - col)) : 0;
      const float* src = n > 0 ? X + (size_t)k * N + col : X;
      if (vec) {
        cp_async16_n(dst, src, 4 * n);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) rbf_mma::cp_async4(dst + q, q < n ? src + q : X, q < n);
      }
    }
  }
};

// X's staged chunk split into the B planes: entry (k, n) of k8 step s at
// s * kStepB + (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4 (floats),
// big in the first plane, small in the second.  Thread (n, kg) splits
// column n's 4 entries 4 kg .. 4 kg + 3 of every step.
__device__ __forceinline__ void split_b(const float* raw, float* planes) {
  const float* sb = raw + BM * kLdA;
  const int n = threadIdx.x % BN, kg = threadIdx.x / BN;
  const int off = (n / 8) * 64 + kg * 32 + (n % 8) * 4;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float* q = sb + (8 * s + 4 * kg) * kLdB + n;
    const float v[4] = {q[0], q[kLdB], q[2 * kLdB], q[3 * kLdB]};
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_rna(v[e], big[e], small[e]);
    float* p = planes + s * kStepB + off;
    *reinterpret_cast<uint4*>(p) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(p + kPlane) = make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// The warp's A fragments of L's staged chunk, every step: rows row0 + g
// (+ 8), columns 8 s + t (+ 4), as wgmma's register operand lays them out.
__device__ __forceinline__ void fetch_a(const float* raw, int row0, float (&v)[kSteps][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float* p = raw + (row0 + g) * kLdA + 8 * s + t;
    v[s][0] = p[0], v[s][1] = p[8 * kLdA], v[s][2] = p[4], v[s][3] = p[8 * kLdA + 4];
  }
}

__device__ __forceinline__ void split_a(const float (&v)[kSteps][4], uint32_t (&big)[kSteps][4],
                                        uint32_t (&small)[kSteps][4]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_rna(v[s][e], big[s][e], small[s][e]);
}

// The warpgroup's products of one chunk into t, the first overwriting it;
// steps that begin below its last row only.  Returns whether any ran.
__device__ __forceinline__ bool issue_chunk(const float* planes, int k0, int last_row,
                                            const uint32_t (&big)[kSteps][4],
                                            const uint32_t (&small)[kSteps][4], float (&t)[64]) {
  const uint64_t db = desc(planes);
  constexpr uint64_t kStep16 = kStepB * 4 / 16, kPlane16 = kPlane * 4 / 16;  // in 16-byte units
  bool any = false;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (k0 + 8 * s > last_row) break;
    wgmma(t, small[s], db + s * kStep16, any ? 1 : 0);
    wgmma(t, big[s], db + s * kStep16 + kPlane16, 1);
    wgmma(t, big[s], db + s * kStep16, 1);
    any = true;
  }
  return any;
}

__global__ void __launch_bounds__(kThreads, 1)
    tri_mm_kernel(const float* __restrict__ L, const float* __restrict__ X,
                  float* __restrict__ out, int G, int S, int N, int n_rt, int n_ct, bool vec) {
  extern __shared__ __align__(128) float smem[];
  // block -> (row tile, matrix, column tile), the longest row tiles first
  const int per_rt = G * n_ct;
  const int rt = n_rt - 1 - static_cast<int>(blockIdx.x) / per_rt;
  const int rem = static_cast<int>(blockIdx.x) % per_rt;
  const int m = rem / n_ct;
  const int r0 = rt * BM, c0 = (rem % n_ct) * BN;

  float* raw = smem;                      // kStages staged chunks
  float* planes = smem + kStages * kRaw;  // two sets of B planes
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int first_row = r0 + 64 * wg;
  const int last_row = first_row < S ? min(first_row + 63, S - 1) : -1;  // -1: no rows
  const int row_a = 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // the warp's rows in the tile

  float acc[64], t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = t[i] = 0.f;
  uint32_t a_big[kSteps][4], a_small[kSteps][4];
  float va[kSteps][4];

  const Stager st{L + (size_t)m * S * S, X + (size_t)m * S * N, S, N, r0, c0, vec};
  const int nch = (min(r0 + BM, S) + BK - 1) / BK;  // the chunks on or below the diagonal
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nch) st.issue(raw + s * kRaw, s * BK);
    chol_tile::cp_async_commit();
  }
  chol_tile::cp_async_wait<kStages - 1>();
  __syncthreads();
  split_b(raw, planes);
  fetch_a(raw, row_a, va);
  split_a(va, a_big, a_small);
  fence_async_shared();
  __syncthreads();
  fence_regs(t);
  fence_regs(a_big);
  fence_regs(a_small);
  wgmma_fence();
  bool issued = issue_chunk(planes, 0, last_row, a_big, a_small, t);
  wgmma_commit();
  for (int c = 0; c < nch; ++c) {
    // chunk c's products run; chunk c + 1 has landed, and chunk c's slot is free
    chol_tile::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages < nch) st.issue(raw + (c % kStages) * kRaw, (c + kStages) * BK);
    chol_tile::cp_async_commit();
    float* next = planes + ((c + 1) & 1) * kPlanes;
    if (c + 1 < nch) {
      const float* slot = raw + ((c + 1) % kStages) * kRaw;
      split_b(slot, next);
      fetch_a(slot, row_a, va);
    }
    fence_async_shared();
    __syncthreads();  // chunk c + 1's planes are whole
    wgmma_wait();
    fence_regs(t);
    fence_regs(a_big);
    fence_regs(a_small);
    if (issued) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += t[i];
    }
    if (c + 1 < nch) {
      split_a(va, a_big, a_small);
      fence_regs(t);
      fence_regs(a_big);
      fence_regs(a_small);
      wgmma_fence();
      issued = issue_chunk(next, (c + 1) * BK, last_row, a_big, a_small, t);
      wgmma_commit();
    }
  }
  chol_tile::cp_async_wait<0>();
  wgmma_wait();
  fence_regs(t);
  fence_regs(acc);

  // warp w of the warpgroup holds rows first_row + 16 (w % 4) + g (+ 8) and
  // columns c0 + 8 j + 2 tq (+ 1) in acc[4 j ..]: one 8-byte store a pair when
  // every row is 16-byte aligned (vec)
  float* Om = out + (size_t)m * S * N;
  const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = first_row + 16 * w + g + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      float* o = Om + (size_t)r * N + col;
      if (vec) {
        if (col < N)
          *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        if (col < N) o[0] = acc[4 * j + 2 * h];
        if (col + 1 < N) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

std::atomic<uint64_t> allowed{0};  // devices where the kernel's shared memory is allowed

}  // namespace

// L (G, S, S), X (G, S, N), out (G, S, N), contiguous float32; the wrapper
// keeps G * ceil(S / 128) * ceil(N / 128) within the grid.  The shared-memory
// attribute is set once per device (rbf_mma's launch does the same).
extern "C" int vargp_tri_mm(const float* L, const float* X, float* out, int G, int S, int N,
                            void* stream) {
  if (G == 0 || S == 0 || N == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(tri_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const int n_rt = (S + BM - 1) / BM, n_ct = (N + BN - 1) / BN;
  const bool vec = S % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(L) | reinterpret_cast<uintptr_t>(X) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(G) * n_rt * n_ct);
  tri_mm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      L, X, out, G, S, N, n_rt, n_ct, vec);
  return static_cast<int>(cudaGetLastError());
}

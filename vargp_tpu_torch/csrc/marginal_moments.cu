// marginal_moments (K10): the predictive marginal's readers of W in one pass.
// For G matrices W (S x B, float32, row-major; S = T M rows in T task blocks
// of M), the whitened mean v (S), the tasks' scale factors w_t (M x M, lower
// triangular) and the prior variance kxx (one a hyper sample, G / H matrices
// each):
//
//   f_mean[b] = sum_s v[s] W[s, b]
//   diag1[b]  = sum_s W[s, b]^2
//   C_t       = w_t^T W_t                 (M x B; W_t the rows of task t)
//   diag2[b]  = sum_{t, m} C_t[m, b]^2
//   f_var[b]  = max((kxx - diag1[b]) + diag2[b], 0)
//
// Replaces no Pallas kernel: the JAX package leaves these readers to XLA
// (vargp_tpu/gpmath/conditional.py, whitened_marginal_diag_factored), and the
// port left them to a cuBLAS product (C_t), two squares, two reductions and
// the elementwise tail.  Caller: gpmath/conditional.py::
// whitened_marginal_diag_factored, once per predict call, after K9 formed W.
//
// What bounds it on an H100: W is read once (0.41 GB at P-MNIST's predict
// shape, 20 x 10 matrices, S = 1000, B = 512, T = 10, M = 100), and C's
// operations, which the triangle of w_t halves: C_t[m, b] sums w_t[k, m]
// W_t[k, b] over k >= m only.  That is T M (M + 1) B per matrix, 10.3 GFLOP
// at that shape: 0.15 ms at the 67 TFLOP/s of the f32 FMAs used here, 0.06
// ms at the card's 3xTF32 rate; the bytes take 0.13 ms at 3.35 TB/s, which
// bounds it.  C, W^2 and C^2 never reach device memory.
//
// How the design meets it:
//
//   A block takes one matrix and a strip of 64 columns, and walks the T task
//   blocks in order through two shared-memory slots.  One producer warp
//   fills a slot with task t + 1 while the computing warps work on task t:
//   the strip's rows of W_t as one tensor copy (TMA, columns past B
//   zero-filled), w_t's lower triangle as 16 x 16 tensor-copy tiles (tiles
//   past M zero-filled), v_t through the producer's registers.  The slot's
//   full barrier (an mbarrier the copies complete on) hands it over, its
//   empty barrier (one arrival a computing warp) hands it back.  The copy
//   engine moves the bytes, so the computing warps' shared-memory reads
//   share the load/store pipe with no copy instructions (on an H100 at
//   P-MNIST's predict shape the same products took 0.61 ms with cp.async
//   copies in that pipe, 0.45 ms with the tensor copies).  All S
//   rows of the strip pass through one block, so every sum is whole in it:
//   no atomics, and each output's order of sums is fixed (the same bits run
//   to run).
//
//   C_t in f32 FMAs on the CUDA cores, each lane a 4 x 8 tile (rows m,
//   columns 4 c .. 4 c + 3 and 32 + 4 c .. 32 + 4 c + 3 of the strip, so that
//   a warp's 16-byte loads of a W row are 128 contiguous bytes).  C's rows
//   fall in 16-row bands; band b needs rows k >= 16 b, M - 16 b of them, from
//   its panel: the tiles (b, b), (b, b + 1), ... of w_t, rows k >= 16 b and
//   the band's 16 columns, so that the zero upper triangle is not copied.  A
//   warp owns band p and, but for warp 0 when the count of bands is odd, a
//   second band q, chosen so that every warp has about M rows of work: with
//   n bands, odd, warp 0 takes band 0 alone and warp i the bands i and
//   n - i; even, warp i takes i and n - 1 - i.  From row 16 q on, both bands
//   share each W load: 64 FMAs per four 16-byte loads.  Each loop loads the
//   next row's operands before it multiplies the current one's.  A band's
//   first 16 rows are its diagonal tile: there the entries above the
//   diagonal are selected away to 0, so whatever lies above w_t's diagonal
//   never enters a sum.
//
//   diag1 and f_mean: each lane sums rows k = 4 i + r (mod 4 warps) of its
//   8 columns.  At the end the four row lanes of a column meet by shuffles,
//   the warps through shared memory in warp order, and the first 64 threads
//   write the strip's f_mean and f_var.

// CUtensorMap and cuTensorMapEncodeTiled's types; the function itself is looked up at run time
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBN = 64;      // columns a block
constexpr int kBand = 16;    // rows of C a band, and a tile's side
constexpr int kTile = kBand * kBand;
constexpr int kMaxM = 128;   // rows of a task block: 8 bands, 4 computing warps
constexpr int kMaxThreads = 32 * ((kMaxM / kBand + 1) / 2 + 1);
// a tensor copy's shared-memory alignment; the barriers take the first 128 bytes
constexpr int kAlign = 128;

__host__ __device__ constexpr int bands(int M) { return (M + kBand - 1) / kBand; }

// floats before band b's panel: a tile for each tile of the earlier bands
__host__ __device__ constexpr int panel_offset(int b, int n) {
  return kTile * (b * n - b * (b - 1) / 2);
}

// A slot: W_t's strip (M x 64), the panels, v_t; a multiple of 128 bytes
__host__ __device__ constexpr int slot_floats(int M) {
  return M * kBN + panel_offset(bands(M), bands(M)) + (M + 31) / 32 * 32;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrives on bar and adds `bytes` to the copies the phase waits for
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The box of `map` at (x, y) or (x, y, z) into dst, completing on bar
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map, int x, int y,
                                            int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

struct Args {
  const float* v;    // (G, S)
  const float* kxx;  // (G / per,)
  float* f_mean;     // (G, B)
  float* f_var;      // (G, B)
  int T, M, B, per, n_strips;
};

// Task t of matrix g into a slot, by the producer warp: v_t through the
// lanes' registers, then lane 0 arms the full barrier with the tensor
// copies' bytes and starts them: W's strip (map_W: B x G S, a 64 x M box)
// and each band's panel tiles (map_w: M x M x G T, 16 x 16 x 1 boxes).
__device__ __forceinline__ void stage(const CUtensorMap* map_W, const CUtensorMap* map_w,
                                      const Args& a, float* slot, uint64_t* full, int g, int t,
                                      int c0) {
  const int M = a.M, n = bands(M), lane = threadIdx.x & 31;
  float* panels = slot + M * kBN;
  float* vt = panels + panel_offset(n, n);
  const float* vs = a.v + ((size_t)g * a.T + t) * M;
  for (int k = lane; k < M; k += 32) vt[k] = vs[k];
  __syncwarp();
  if (lane == 0) {
    bar_expect(full, 4u * (M * kBN + panel_offset(n, n)));
    tensor_copy(slot, map_W, c0, (g * a.T + t) * M, full);
    for (int b = 0, i = 0; b < n; ++b)
      for (int kb = b; kb < n; ++kb, ++i)
        tensor_copy(panels + kTile * i, map_w, kBand * b, kBand * kb, g * a.T + t, full);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// entries m + i above row k set to 0
__device__ __forceinline__ float4 tril4(float4 a, int m, int k) {
  a.x = m > k ? 0.f : a.x;
  a.y = m + 1 > k ? 0.f : a.y;
  a.z = m + 2 > k ? 0.f : a.z;
  a.w = m + 3 > k ? 0.f : a.w;
  return a;
}

// acc[i][j] += a[i] x[j]
__device__ __forceinline__ void outer(float (&acc)[4][8], const float4& a, const float (&x)[8]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], x[j], acc[i][j]);
}

__device__ __forceinline__ void load_x(const float* row, int c, float (&x)[8]) {
  const float4 x0 = ld4(row + 4 * c), x1 = ld4(row + 32 + 4 * c);
  x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w;
  x[4] = x1.x, x[5] = x1.y, x[6] = x1.z, x[7] = x1.w;
}

// d2[j] += sum_i acc[i][j]^2, and acc zeroed
__device__ __forceinline__ void square_sum(float (&acc)[4][8], float (&d2)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = acc[0][j] * acc[0][j];
#pragma unroll
    for (int i = 1; i < 4; ++i) s = fmaf(acc[i][j], acc[i][j], s);
    d2[j] += s;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = 0.f;
  }
}

// Rows k .. k_end - 1 of band p's panel Pp alone (kTwo false) or of p's and
// q's (Pq), each panel's row k at k * 16 and the lane's first column of C
// mp, resp. mq; the next row's operands are loaded before the current row's
// products.  k advances to k_end.  kDiag: the rows lie in the last band's
// diagonal tile.
template <bool kTwo, bool kDiag>
__device__ __forceinline__ void rows(const float* sW, const float* Pp, const float* Pq, int& k,
                                     int k_end, int mp, int mq, int c, float (&ap)[4][8],
                                     float (&aq)[4][8]) {
  if (k >= k_end) return;
  float x[8];
  load_x(sW + k * kBN, c, x);
  float4 a = ld4(Pp + k * kBand), b;
  if (kTwo) b = ld4(Pq + k * kBand);
  if (kDiag) {
    if (kTwo) b = tril4(b, mq, k);
    else a = tril4(a, mp, k);
  }
  for (++k; k < k_end; ++k) {
    float xn[8];
    load_x(sW + k * kBN, c, xn);
    float4 an = ld4(Pp + k * kBand), bn;
    if (kTwo) bn = ld4(Pq + k * kBand);
    if (kDiag) {
      if (kTwo) bn = tril4(bn, mq, k);
      else an = tril4(an, mp, k);
    }
    outer(ap, a, x);
    if (kTwo) outer(aq, b, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = xn[j];
    a = an;
    if (kTwo) b = bn;
  }
  outer(ap, a, x);
  if (kTwo) outer(aq, b, x);
}

__global__ void __launch_bounds__(kMaxThreads)
    marginal_moments_kernel(const __grid_constant__ CUtensorMap map_W,
                            const __grid_constant__ CUtensorMap map_w, const Args a) {
  extern __shared__ __align__(kAlign) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // a slot's copies have landed
  uint64_t* empty = full + 2;                          // its products are done
  float* smem = reinterpret_cast<float*>(base + kAlign);
  const int g = static_cast<int>(blockIdx.x) / a.n_strips;
  const int c0 = (static_cast<int>(blockIdx.x) % a.n_strips) * kBN;
  const int M = a.M, n_bands = bands(M), n_warps = (n_bands + 1) / 2;
  const int lane = threadIdx.x & 31, r = lane >> 3, c = lane & 7;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int slot_len = slot_floats(M);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], n_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float fm[8], d1[8], d2[8], acc_p[4][8], acc_q[4][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    fm[j] = d1[j] = d2[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_p[i][j] = acc_q[i][j] = 0.f;
  }

  if (warp == n_warps) {  // the producer: task t into slot t % 2 once task t - 2 is done with it
    for (int t = 0; t < a.T; ++t) {
      if (t >= 2) bar_wait(&empty[t & 1], ((t >> 1) - 1) & 1);
      stage(&map_W, &map_w, a, smem + (t & 1) * slot_len, &full[t & 1], g, t, c0);
    }
  } else {
    // this warp's bands: p, and q > p unless q < 0
    const int p = warp, q = n_bands % 2 ? (warp ? n_bands - warp : -1) : n_bands - 1 - warp;
    const int mp = kBand * p + 4 * r, mq = kBand * q + 4 * r;
    for (int t = 0; t < a.T; ++t) {
      bar_wait(&full[t & 1], (t >> 1) & 1);
      const float* sW = smem + (t & 1) * slot_len;
      const float* panels = sW + M * kBN;
      const float* sv = panels + panel_offset(n_bands, n_bands);

      float x[8];
      for (int k = 4 * warp + r; k < M; k += 4 * n_warps) {
        load_x(sW + k * kBN, c, x);
        const float vk = sv[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          fm[j] = fmaf(vk, x[j], fm[j]);
          d1[j] = fmaf(x[j], x[j], d1[j]);
        }
      }

      // each panel's row k at k * 16, the lane's 4 columns at 4 r
      const float* Pp = panels + panel_offset(p, n_bands) + 4 * r - kTile * p;
      const float* Pq = q >= 0 ? panels + panel_offset(q, n_bands) + 4 * r - kTile * q : Pp;
      const int e1 = q >= 0 ? kBand * q : M;  // band p alone below row e1
      int k = kBand * p;
      rows<false, true>(sW, Pp, Pq, k, min(k + kBand, e1), mp, mq, c, acc_p, acc_q);
      rows<false, false>(sW, Pp, Pq, k, e1, mp, mq, c, acc_p, acc_q);
      if (q >= 0) {
        rows<true, true>(sW, Pp, Pq, k, min(k + kBand, M), mp, mq, c, acc_p, acc_q);
        rows<true, false>(sW, Pp, Pq, k, M, mp, mq, c, acc_p, acc_q);
        square_sum(acc_q, d2);
      }
      square_sum(acc_p, d2);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[t & 1]);
    }
  }
  __syncthreads();  // every slot read and every copy landed: slot 0 takes the sums

  // the four row lanes of each column, then the warps in order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int s = 8; s <= 16; s *= 2) {
      fm[j] += __shfl_xor_sync(0xffffffffu, fm[j], s);
      d1[j] += __shfl_xor_sync(0xffffffffu, d1[j], s);
      d2[j] += __shfl_xor_sync(0xffffffffu, d2[j], s);
    }
  }
  float* red = smem;  // (n_warps, 3, kBN)
  if (r == 0 && warp < n_warps) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? 4 * c + j : 32 + 4 * c + j - 4;
      red[(warp * 3 + 0) * kBN + col] = fm[j];
      red[(warp * 3 + 1) * kBN + col] = d1[j];
      red[(warp * 3 + 2) * kBN + col] = d2[j];
    }
  }
  __syncthreads();
  const float kxx = a.kxx[g / a.per];
  for (int col = threadIdx.x; col < kBN; col += blockDim.x) {
    if (c0 + col >= a.B) break;
    float sm = red[col], s1 = red[kBN + col], s2 = red[2 * kBN + col];
    for (int w = 1; w < n_warps; ++w) {
      sm += red[(w * 3 + 0) * kBN + col];
      s1 += red[(w * 3 + 1) * kBN + col];
      s2 += red[(w * 3 + 2) * kBN + col];
    }
    const float var = (kxx - s1) + s2;
    const size_t o = (size_t)g * a.B + c0 + col;
    a.f_mean[o] = sm;
    a.f_var[o] = var < 0.f ? 0.f : var;  // NaN stays NaN, as torch.clamp keeps it
  }
}

constexpr size_t kMaxSmemBytes = 2 * kAlign + sizeof(float) * 2 * slot_floats(kMaxM);
std::atomic<uint64_t> allowed{0};  // devices where the kernel's shared memory is allowed

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
std::atomic<EncodeTiled> encode_tiled{nullptr};  // cuTensorMapEncodeTiled, once looked up

// A float32 tensor map of `rank` dims (innermost first; strides in bytes of
// the outer dims), boxes of `box`, entries outside the dims read as zero.
cudaError_t encode(CUtensorMap* map, const float* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled.load(std::memory_order_acquire);
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
    encode_tiled.store(fn, std::memory_order_release);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, static_cast<cuuint32_t>(rank),
                        const_cast<float*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// W (G, S, ldW) and w (G, T, M, ldm), their first B, resp. M, columns read;
// v (G, S), kxx (G / per), f_mean and f_var (G, B); float32, S = T M,
// M <= 128.  The tensor copies need W's and w's bases 16-byte aligned and
// ldW, ldm multiples of 4 (the wrapper pads and copies where they are not);
// the wrapper keeps G * ceil(B / 64) within the grid.  The shared-memory
// attributes are set once per device.
extern "C" int vargp_marginal_moments(const float* W, const float* v, const float* w,
                                      const float* kxx, float* f_mean, float* f_var, int G, int T,
                                      int M, int B, int ldW, int ldm, int per, void* stream) {
  if (G == 0 || B == 0) return 0;
  if (M < 1 || M > kMaxM || T < 1 || per < 1 || B > ldW || M > ldm || ldW % 4 || ldm % 4 ||
      (reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(marginal_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(marginal_moments_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const cuuint64_t S = static_cast<cuuint64_t>(T) * M;
  CUtensorMap map_W, map_w;
  const cuuint64_t dims_W[2] = {static_cast<cuuint64_t>(B), G * S};
  const cuuint64_t strides_W[1] = {4ull * ldW};
  const cuuint32_t box_W[2] = {kBN, static_cast<cuuint32_t>(M)};
  e = encode(&map_W, W, 2, dims_W, strides_W, box_W);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cuuint64_t dims_w[3] = {static_cast<cuuint64_t>(M), static_cast<cuuint64_t>(M),
                                static_cast<cuuint64_t>(G) * T};
  const cuuint64_t strides_w[2] = {4ull * ldm, 4ull * ldm * M};
  const cuuint32_t box_w[3] = {kBand, kBand, 1};
  e = encode(&map_w, w, 3, dims_w, strides_w, box_w);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int n_warps = (bands(M) + 1) / 2, n_strips = (B + kBN - 1) / kBN;
  const Args a{v, kxx, f_mean, f_var, T, M, B, per, n_strips};
  // the alignment's slack and the barriers, then the two slots
  const size_t smem = 2 * kAlign + sizeof(float) * 2 * slot_floats(M);
  const dim3 grid(static_cast<unsigned>(G) * n_strips);
  // n_warps computing warps and the producer
  marginal_moments_kernel<<<grid, 32 * (n_warps + 1), smem, static_cast<cudaStream_t>(stream)>>>(
      map_W, map_w, a);
  return static_cast<int>(cudaGetLastError());
}

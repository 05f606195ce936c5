"""Where K7's and K3's time goes on the card: instrumented copies of their
kernels.

    python -m vargp_tpu_torch.ops.cuda.chol_probe [G S ...]
    python -m vargp_tpu_torch.ops.cuda.chol_probe --k3 [G ...]

Builds (with ``nvcc``, into a temporary directory) a copy of
``csrc/chol_tile.cuh::cluster_chol`` with ``%globaltimer`` read around
each phase and each cluster barrier, runs it on random SPD matrices, and
prints per block of the first cluster: the time in the diagonal step
(D), the panel (P) and the trailing update (T), the wait at the barrier
after each, and within P and T the waits for staged operands and the
time of the trailing tiles' products.  Then a microbenchmark of
``warp_mma`` (8 warps per SM on operands in shared memory, every SM
busy): cycles per 8-deep step per warp for the 3xTF32 product and for
the same three ``mma.sync`` without the split.  Default shapes: A (30,
300) and B (30, 1000).

``--k3``: K3 (``chol_tile.cuh::diag_chol_block``) on (G, 128, 128) with a
probe that reads ``%globaltimer`` at each of ``diag_factor``'s events:
the mean over blocks of the load, each chunk's (a) factor, (b) row solve
and (c) update (the update of the next chunk's columns, then the next
factor beside the rest of the update), and the write-out; and the
kernel's time without the probe by CUDA events (20 launches after a
warm-up).  Default G: 30 (A's and C's steps) and 200 (the analysis).
Needs a card and ``nvcc``; the kernel library is not touched.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

from vargp_tpu_torch.ops.cuda.build import CSRC, NVCC_FLAGS, find_nvcc

_HARNESS = r"""
#include "chol_tile.cuh"
#include <cstdio>
#include <cstdlib>
#include <vector>
using namespace chol_tile;
__device__ __forceinline__ unsigned long long gt() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
// prb: [0..2] work in D, P, T; [3..5] barrier wait after each;
// [6] operand waits in P and T; [7] products of the trailing tiles
__device__ void probe_publish(cooperative_groups::cluster_group& cluster, unsigned long long* prb,
                              int pi, unsigned long long& last) {
  const unsigned long long t0 = gt();
  publish(cluster);
  const unsigned long long t1 = gt();
  if (threadIdx.x == 0) prb[pi %% 3] += t0 - last, prb[3 + pi %% 3] += t1 - t0;
  last = t1;
}
namespace chol_tile {
%(body)s
}
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const float* K, float* L, int S, unsigned long long* out) {
  extern __shared__ __align__(16) float smem[];
  const int C = cooperative_groups::this_cluster().num_blocks();
  const size_t base = (size_t)(blockIdx.x / C) * S * S;
  unsigned long long prb[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const unsigned long long t0 = gt();
  cluster_chol_probe(prb, K + base, L + base, nullptr, S, smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) out[blockIdx.x * 9 + i] = prb[i];
    out[blockIdx.x * 9 + 8] = gt() - t0;
  }
}
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) mma_bench(float* out, long long* cyc, int reps) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < 192 * kLdD; i += kThreads) sm[i] = (i %% 97) * 0.01f;
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const float* pa = sm + 32 * (warp / 4) * kLdD;
  const float* pb = sm + (64 + 32 * (warp %% 4)) * kLdD;
  const int lane = threadIdx.x %% 32, g = lane / 4, t = lane %% 4;
  float acc[2][4][4] = {};
  const long long c0 = clock64();
  for (int r = 0; r < reps; ++r) {
    if (kSplit) {
      warp_mma<false>(acc, pa, kLdD, pb, kLdD, kN);
    } else {  // the same loads and three mma.sync, no split
      for (int k = 0; k < kN; k += 8) {
        uint32_t a[2][4], b[4][2];
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = pa + (16 * mt + g) * kLdD + k + t;
          a[mt][0] = __float_as_uint(p[0]), a[mt][1] = __float_as_uint(p[8 * kLdD]);
          a[mt][2] = __float_as_uint(p[4]), a[mt][3] = __float_as_uint(p[8 * kLdD + 4]);
        }
        for (int nt = 0; nt < 4; ++nt) {
          const float* q = pb + (8 * nt + g) * kLdD + k + t;
          b[nt][0] = __float_as_uint(q[0]), b[nt][1] = __float_as_uint(q[4]);
        }
        for (int mt = 0; mt < 2; ++mt)
          for (int nt = 0; nt < 4; ++nt)
            for (int u = 0; u < 3; ++u) mma_tf32(acc[mt][nt], a[mt], b[nt]);
      }
    }
  }
  __syncthreads();
  const long long c1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += (&acc[0][0][0])[i];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
  if (blockIdx.x == 0 && threadIdx.x == 0) *cyc = c1 - c0;
}
template <bool kSplit>
void bench(const char* name, int n_sm) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, n_sm * kThreads * 4);
  cudaMalloc(&cyc, 8);
  const int smem = 192 * kLdD * 4, reps = 50;
  cudaFuncSetAttribute(mma_bench<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mma_bench<kSplit><<<n_sm, kThreads, smem>>>(out, cyc, 1);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  mma_bench<kSplit><<<n_sm, kThreads, smem>>>(out, cyc, reps);
  cudaEventRecord(b);
  const cudaError_t e = cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  const double flops = (double)n_sm * 8 * reps * 32 * 32 * kN * 2;
  printf("warp_mma %%s: %%s, %%.1f cycles per 8-deep step per warp, %%.2f TFLOP/s of f32 product "
         "on %%d SMs\n", name, cudaGetErrorString(e), c / (reps * kN / 8.0), flops / ms / 1e9, n_sm);
}
int main(int argc, char** argv) {
  for (int a = 1; a + 1 < argc; a += 2) {
    const int G = atoi(argv[a]), S = atoi(argv[a + 1]);
    int n_sm;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
    int C = 1;
    while (2 * C <= 8 && 2 * C <= n_sm / G) C *= 2;
    std::vector<float> h((size_t)G * S * S);
    srand(1);
    for (int g = 0; g < G; ++g)
      for (int r = 0; r < S; ++r)
        for (int c = 0; c <= r; ++c) {  // diagonally dominant: SPD
          const float v = r == c ? 1.f : (rand() / (float)RAND_MAX - 0.5f) / S;
          h[((size_t)g * S + r) * S + c] = h[((size_t)g * S + c) * S + r] = v;
        }
    float *K, *L;
    unsigned long long* out;
    cudaMalloc(&K, h.size() * 4);
    cudaMalloc(&L, h.size() * 4);
    cudaMalloc(&out, G * C * 9 * 8);
    cudaMemcpy(K, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    std::vector<unsigned long long> o(G * C * 9);
    int st = 0;
    for (int it = 0; it < 3; ++it) {  // the last of three runs
      cudaMemset(out, 0, o.size() * 8);
      st = launch_on_clusters(probe_kernel, G, C, nullptr, (const float*)K, L, S, out);
      cudaDeviceSynchronize();
    }
    cudaMemcpy(o.data(), out, o.size() * 8, cudaMemcpyDeviceToHost);
    printf("(G, S) = (%%d, %%d), cluster %%d, launch status %%d, us per block of the first cluster:\n",
           G, S, C, st);
    for (int b = 0; b < C; ++b) {
      const unsigned long long* q = &o[b * 9];
      printf("  block %%d: total %%.1f | work D %%.1f P %%.1f T %%.1f | barrier wait after D %%.1f "
             "P %%.1f T %%.1f | operand waits %%.1f | trailing products %%.1f\n", b, q[8] / 1e3,
             q[0] / 1e3, q[1] / 1e3, q[2] / 1e3, q[3] / 1e3, q[4] / 1e3, q[5] / 1e3, q[6] / 1e3,
             q[7] / 1e3);
    }
    cudaFree(K), cudaFree(L), cudaFree(out);
  }
  int n_sm;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  bench<true>("3xTF32 (split in the loop)", n_sm);
  bench<false>("3 mma.sync, no split", n_sm);
  return 0;
}
"""

_K3_HARNESS = r"""
#include "chol_tile.cuh"
#include <cstdio>
#include <cstdlib>
#include <vector>
using namespace chol_tile;
__device__ __forceinline__ unsigned long long gt() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
constexpr int kSlots = kEvents + 1;  // slot 0: the start, slot e + 1: event e
// lane 0 of each warp that passes event e records the time in [e + 1][warp]
struct Rec {
  unsigned long long* t;
  __device__ void operator()(int e) const {
    if (threadIdx.x %% 32 == 0) t[(e + 1) * 8 + threadIdx.x / 32] = gt();
  }
};
template <bool kProbe>
__global__ void __launch_bounds__(kThreads, kDiagMinBlocks)
    k3(const float* in, float* out, unsigned long long* rec) {
  extern __shared__ __align__(16) float smem[];
  const float* g = in + (size_t)blockIdx.x * kN * kN;
  float* o = out + (size_t)blockIdx.x * kN * kN;
  if (kProbe) {
    Rec r{rec + (size_t)blockIdx.x * kSlots * 8};
    if (threadIdx.x %% 32 == 0) r.t[threadIdx.x / 32] = gt();
    diag_chol_block(g, kN, kN, true, o, smem, r);
  } else {
    diag_chol_block(g, kN, kN, true, o, smem);
  }
}
void run(int G, const float* in, float* out, unsigned long long* rec) {
  const int smem = kDiagSmemFloats * 4;
  cudaFuncSetAttribute(k3<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(k3<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  std::vector<unsigned long long> h((size_t)G * kSlots * 8);
  double mean[kSlots] = {0};
  for (int it = 0; it < 3; ++it) {  // the last of three runs
    cudaMemset(rec, 0, h.size() * 8);
    k3<true><<<G, kThreads, smem>>>(in, out, rec);
    cudaDeviceSynchronize();
  }
  cudaMemcpy(h.data(), rec, h.size() * 8, cudaMemcpyDeviceToHost);
  for (int b = 0; b < G; ++b) {
    const unsigned long long* q = &h[(size_t)b * kSlots * 8];
    unsigned long long t0 = q[0];
    for (int w = 1; w < 8; ++w) t0 = q[w] < t0 ? q[w] : t0;
    for (int s = 1; s < kSlots; ++s) {  // an event's time: the latest warp that recorded it
      unsigned long long m = 0;
      for (int w = 0; w < 8; ++w) m = q[s * 8 + w] > m ? q[s * 8 + w] : m;
      if (m) mean[s] += (m - t0) / 1e3 / G;
    }
  }
  auto T = [&](int e) { return mean[e + 1]; };
  k3<false><<<G, kThreads, smem>>>(in, out, rec);
  cudaEvent_t a, b;
  cudaEventCreate(&a), cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) k3<false><<<G, kThreads, smem>>>(in, out, rec);
  cudaEventRecord(b);
  const cudaError_t e = cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("K3, G = %%d: %%s; %%.5f ms per launch by events (no probe); us since the block's start, "
         "mean over blocks (the probe's own run):\n", G, cudaGetErrorString(e), ms / 20);
  printf("  load %%.2f\n", T(kEvLoaded));
  double prev = T(kEvLoaded), sa = T(ev(0, kEvA)) - prev, sb = 0, sc = 0, sr = 0;
  printf("  chunk 0: (a) %%.2f", sa);
  prev = T(ev(0, kEvA));
  for (int k = 0; k < 3; ++k) {
    const double b_ = T(ev(k, kEvB)) - prev, c_ = T(ev(k, kEvC)) - T(ev(k, kEvB));
    const double a_ = T(ev(k + 1, kEvA)) - T(ev(k, kEvC));
    const double r_ = T(ev(k, kEvRest)) - T(ev(k, kEvC)), j_ = T(ev(k, kEvJoin)) - T(ev(k, kEvC));
    sb += b_, sc += c_, sa += a_, sr += r_;
    printf(" (b) %%.2f (c, next chunk's columns) %%.2f\n  chunk %%d: (a) %%.2f beside the rest of "
           "chunk %%d's (c) %%.2f, joined after %%.2f", b_, c_, k + 1, a_, k, r_, j_);
    prev = T(ev(k, kEvJoin));
  }
  printf("\n  write-out %%.2f; total %%.2f | sums: (a) %%.2f (b) %%.2f (c) %%.2f, off the critical "
         "path %%.2f\n", T(kEvStored) - prev, T(kEvStored), sa, sb, sc, sr);
}
int main(int argc, char** argv) {
  for (int i = 1; i < argc; ++i) {
    const int G = atoi(argv[i]);
    std::vector<float> h((size_t)G * kN * kN);
    srand(1);
    for (int g = 0; g < G; ++g)
      for (int r = 0; r < kN; ++r)
        for (int c = 0; c <= r; ++c) {  // diagonally dominant: SPD
          const float v = r == c ? 1.f : (rand() / (float)RAND_MAX - 0.5f) / kN;
          h[((size_t)g * kN + r) * kN + c] = h[((size_t)g * kN + c) * kN + r] = v;
        }
    float *in, *out;
    unsigned long long* rec;
    cudaMalloc(&in, h.size() * 4);
    cudaMalloc(&out, h.size() * 4);
    cudaMalloc(&rec, (size_t)G * kSlots * 8 * 8);
    cudaMemcpy(in, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    run(G, in, out, rec);
    cudaFree(in), cudaFree(out), cudaFree(rec);
  }
  return 0;
}
"""


def _instrumented_body() -> str:
    """cluster_chol, renamed, with timers spliced in at fixed anchors."""
    src = (CSRC / "chol_tile.cuh").read_text()
    i = src.index("__device__ inline void cluster_chol(")
    body = src[i:src.index("\n}\n", i) + 3]
    edits = [
        ("cluster_chol(", "cluster_chol_probe(unsigned long long* prb, "),
        ("  const bool vec = (S % 4) == 0;\n",
         "  const bool vec = (S % 4) == 0;\n  int pi = 0;\n  unsigned long long last = gt();\n"),
        ("publish(cluster);", "probe_publish(cluster, prb, pi++, last);"),
        ("        cp_async_wait<1>();\n        __syncthreads();",
         "        { const unsigned long long tw = gt(); cp_async_wait<1>(); __syncthreads();"
         " if (threadIdx.x == 0) prb[6] += gt() - tw; }"),
        ("        warp_mma<false>(acc, buf + 32 * (warp / 4) * kLdD, kLdD,\n"
         "                        buf + kRowTile + 32 * (warp % 4) * kLdD, kLdD, kN);",
         "        const unsigned long long tm = gt();\n"
         "        warp_mma<false>(acc, buf + 32 * (warp / 4) * kLdD, kLdD,\n"
         "                        buf + kRowTile + 32 * (warp % 4) * kLdD, kLdD, kN);\n"
         "        __syncwarp();\n        if (threadIdx.x == 0) prb[7] += gt() - tm;"),
    ]
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"chol_probe: cluster_chol no longer contains {old!r}")
        body = body.replace(old, new)
    return body


def main(argv: list[str]) -> None:
    k3 = argv[:1] == ["--k3"]
    if k3:
        shapes = argv[1:] or ["30", "200"]
        source = _K3_HARNESS % {}
    else:
        shapes = argv or ["30", "300", "30", "1000"]
        source = _HARNESS % {"body": _instrumented_body()}
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "chol_probe.cu"
        cu.write_text(source)
        exe = Path(tmp) / "chol_probe"
        flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([find_nvcc(), *flags, "-I", str(CSRC), "-o", str(exe), str(cu)], check=True)
        subprocess.run([str(exe), *shapes], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])

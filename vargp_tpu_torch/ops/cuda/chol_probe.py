"""Where K7's time goes on the card: an instrumented copy of its kernel.

    python -m vargp_tpu_torch.ops.cuda.chol_probe [G S ...]

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
300) and B (30, 1000).  Needs a card and ``nvcc``; the kernel library is
not touched.
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
    shapes = argv or ["30", "300", "30", "1000"]
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "chol_probe.cu"
        cu.write_text(_HARNESS % {"body": _instrumented_body()})
        exe = Path(tmp) / "chol_probe"
        flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([find_nvcc(), *flags, "-I", str(CSRC), "-o", str(exe), str(cu)], check=True)
        subprocess.run([str(exe), *shapes], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])

"""The tensor-core Gram tile (``csrc/rbf_mma.cuh``) as K2 and K4 ship it,
on the card.

    python -m vargp_tpu_torch.ops.cuda.gram_probe

Prints ptxas's registers, spills and shared memory for K2's and K4's
kernels (``sym_gram_tri.cu``, ``cross_gram.cu``), the instruction mix of
each kernel's main loop in the SASS of the kernel library
(``cuobjdump -sass``: from the barrier before the first ``HMMA`` to the
branch after the last), then for each shape of ``SHAPES`` (K2 at B; K4 at
A, at B and at the evaluation's H = 20) the kernel through its wrapper:
CUDA events around 20 back-to-back launches after a warm-up, the effective
TFLOP/s (2 M N D operations per (h, o); K2's distinct entries only) and
the max abs error against the plain version.  The last line is one JSON
object.  Needs a card and ``nvcc``.
"""

import collections
import json
import math
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from vargp_tpu_torch.ops.cuda import build

SOURCES = {"sym_gram_tri_kernel": "sym_gram_tri.cu", "cross_gram_kernel": "cross_gram.cu"}
# label: (kernel, H, O, S, B, D); B is K4's batch
SHAPES = {
    "K2 at B": ("sym", 3, 10, 1000, 0, 784),
    "K4 at A": ("cross", 3, 10, 300, 512, 784),
    "K4 at B": ("cross", 3, 10, 1000, 512, 784),
    "K4 at eval": ("cross", 20, 10, 300, 512, 784),
}


def ptxas_report() -> list[str]:
    """ptxas's lines for K2's and K4's kernels: registers, spills, shared memory."""
    keep = ("Compiling entry function", "registers", "spill")
    log = build.resource_usage(list(SOURCES.values()))
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]


def loop_mix(so: Path) -> dict:
    """{kernel: (instructions, opcode counts)} of each kernel's main loop in
    the SASS of the library ``so``: from the last barrier before the first
    HMMA to the first branch after the last one."""
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = chunk.partition("\n")
        kernel = next((k for k in SOURCES if k in name), None)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", body)
        if kernel is None or "HMMA" not in ops:
            continue
        first = ops.index("HMMA")
        last = len(ops) - 1 - ops[::-1].index("HMMA")
        start = max((j for j in range(first) if ops[j] == "BAR"), default=0)
        end = next((j for j in range(last, len(ops)) if ops[j] == "BRA"), len(ops) - 1)
        loop = ops[start:end + 1]
        out[kernel] = (len(loop), dict(collections.Counter(loop).most_common(12)))
    return out


def inputs(H, O, S, B, D, seed=0):
    """z, x ~ N(0, 1/D), lengthscales near 1 (as chip_smoke.gram_inputs)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    z = t(rng.standard_normal((O, S, D)) / math.sqrt(D))
    x = t(rng.standard_normal((max(B, 1), D)) / math.sqrt(D))
    log_ls = rng.standard_normal((H, D)) * 0.1
    return z, x, t(np.exp(-log_ls)), t(np.exp(-2.0 * log_ls)), t(np.exp(rng.standard_normal(H) * 0.2))


def events_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print("ptxas:")
    for ln in ptxas_report():
        print(f"  {ln}")
    build.library()
    mix = loop_mix(build.library_path())
    for name, (n, ops) in mix.items():
        print(f"  {name} main loop: {n} instructions, {ops.get('HMMA', 0)} HMMA; {ops}")
    results = {"loop_mix": {k: {"instructions": n, "ops": ops} for k, (n, ops) in mix.items()}}
    for label, (kind, H, O, S, B, D) in SHAPES.items():
        z, x, s, w, g2 = inputs(H, O, S, B, D)
        if kind == "sym":
            ref, fn = sym_gram_plain(z, s, g2), lambda: sym_gram_tri(z, s, g2)
            flops = 1.0 * H * O * S * (S + 1) * D
        else:
            ref, fn = cross_gram_plain(z, x, w, g2), lambda: cross_gram(z, x, w, g2)
            flops = 2.0 * H * O * S * B * D
        err = float((fn() - ref).abs().max())
        ms = events_ms(fn)
        results[label] = dict(ms=ms, tflops=flops / ms / 1e9, max_abs_err=err)
        print(f"  {label}: {ms:.5f} ms, {flops / ms / 1e9:.2f} TFLOP/s effective, "
              f"max abs err {err:.3e}")
        del z, x, ref
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"gram_probe": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The tensor-core Gram tile (``csrc/rbf_mma.cuh``) as the four Grams ship
it, on the card.

    python -m vargp_tpu_torch.ops.cuda.gram_probe

Prints ptxas's registers, spills and shared memory for the tile's kernels
(``sym_gram.cu``, K1 on Tile64; ``sym_gram_tri.cu``; ``cross_gram.cu``;
``rbf_gram.cu``, K5's cross and symmetric kernels), the instruction mix of
each kernel's main loop in the SASS of the kernel library
(``cuobjdump -sass``: from the barrier before the first ``HMMA`` to the
branch after the last), then for each shape of ``SHAPES`` (K1 at A and at
the evaluation's H = 20; K2 at B; K4 at A, at B and at the evaluation's;
K5's K_zz and K_zx at C and at the evaluation's) the kernel through its
wrapper: CUDA events around 20 back-to-back launches after a warm-up, the
effective TFLOP/s (2 M N D operations per Gram; a symmetric Gram's
distinct entries only) and the max abs error against the plain version.
The last line is one JSON object.  Needs a card and ``nvcc``.
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

SOURCES = {"sym_gram_kernel": "sym_gram.cu", "sym_gram_tri_kernel": "sym_gram_tri.cu",
           "cross_gram_kernel": "cross_gram.cu", "rbf_gram_kernel": "rbf_gram.cu",
           "rbf_gram_sym_kernel": "rbf_gram.cu"}
# label: (wrapper, H, O, S, B, D); B is K4's batch, or K5's (0: its K_zz)
SHAPES = {
    "K1 at A": ("sym_gram", 3, 10, 300, 0, 784),
    "K1 at eval": ("sym_gram", 20, 10, 300, 0, 784),
    "K2 at B": ("sym_gram_tri", 3, 10, 1000, 0, 784),
    "K4 at A": ("cross_gram", 3, 10, 300, 512, 784),
    "K4 at B": ("cross_gram", 3, 10, 1000, 512, 784),
    "K4 at eval": ("cross_gram", 20, 10, 300, 512, 784),
    "K5 K_zz at C": ("rbf_gram", 3, 10, 300, 0, 64),
    "K5 K_zx at C": ("rbf_gram", 3, 10, 300, 512, 64),
    "K5 K_zz at eval": ("rbf_gram", 20, 10, 300, 0, 64),
    "K5 K_zx at eval": ("rbf_gram", 20, 10, 300, 512, 64),
}


def ptxas_report() -> list[str]:
    """ptxas's lines for the tile's kernels: registers, spills, shared memory."""
    keep = ("Compiling entry function", "registers", "spill")
    log = build.resource_usage(sorted(set(SOURCES.values())))
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


def case(kind, H, O, S, B, D):
    """(kernel call, plain call, operations) of wrapper ``kind`` at one shape
    of SHAPES; K5 takes H * O Grams of z and x (z against itself when B is
    0), pre-scaled by 1/sqrt(2) (squared distances near 1)."""
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

    if kind == "rbf_gram":
        z, x, *_, g2 = inputs(1, H * O, S, B, D)
        z, x = z * 0.5 ** 0.5, x.expand(H * O, *x.shape) * 0.5 ** 0.5
        g2 = g2.repeat(H * O)
        y = z if B == 0 else x.contiguous()
        flops = H * O * (1.0 * S * (S + 1) if B == 0 else 2.0 * S * B) * D
        return (lambda: rbf_gram(z, y, g2)), (lambda: rbf_gram_plain(z, y, g2)), flops
    z, x, s, w, g2 = inputs(H, O, S, B, D)
    if kind == "cross_gram":
        return (lambda: cross_gram(z, x, w, g2)), (lambda: cross_gram_plain(z, x, w, g2)), \
            2.0 * H * O * S * B * D
    kernel = sym_gram if kind == "sym_gram" else sym_gram_tri
    return (lambda: kernel(z, s, g2)), (lambda: sym_gram_plain(z, s, g2)), \
        1.0 * H * O * S * (S + 1) * D


def main() -> int:
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
        fn, plain, flops = case(kind, H, O, S, B, D)
        ref = plain()
        err = float((fn() - ref).abs().max())
        ms = events_ms(fn)
        results[label] = dict(ms=ms, tflops=flops / ms / 1e9, max_abs_err=err)
        print(f"  {label}: {ms:.5f} ms, {flops / ms / 1e9:.2f} TFLOP/s effective, "
              f"max abs err {err:.3e}")
        del fn, plain, ref
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"gram_probe": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

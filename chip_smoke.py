#!/usr/bin/env python3
"""Drive vargp_tpu_torch's forward, training, chain-analysis and protocol
paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero, printing no
result) on a failure:

1. the card: ``torch.cuda.is_available()``, its name and power limit;
2. the build: every kernel of the paths compiled from ``vargp_tpu_torch/csrc``
   with one ``nvcc`` call;
3. each kernel (K1 sym-Gram, K2 triangle-skip sym-Gram, K3 diagonal-block
   Cholesky, K4 cross-Gram, K5 generic Gram on pre-scaled inputs, K6 fused
   Cholesky and triangular inverse, K7 batched Cholesky, K8 chunked
   diagonal-block Cholesky) held against its plain PyTorch version on the
   card, at the shapes of the paths and at a ragged shape, each launch
   counted (K1 at A's, the evaluation's (H = 20) and P-MNIST's S = 500;
   K2 also at one (h, o) of 1000 rows; K4 at A's, B's and the
   evaluation's, at a second ragged shape and at one (h, o); K5 at C's
   K_zz and K_zx and the evaluation's (G = 200), a ragged self-Gram and
   cross Gram, both also from a base that is not 16-byte aligned, and a
   self-Gram handed over as two tensors, which must take the cross
   launch; K3 also on
   blocks 1, 33, 100, 125 and 128 wide read in place from matrices with
   row strides 300, 1000 and 875, at G = 200, and on the first diagonal
   blocks of A's, B's and the analysis's Grams as the paths hand them
   over: (30, 100, 100), (30, 125, 125), (200, 100, 100); K6 and K7 also at one
   panel, a one-row last panel and each cluster size their wrapper picks:
   1, 4 and 8 blocks per matrix); K1 at A, K2 and K4 at B and K5's two
   Grams at C also against a float64 Gram, within twice the f32 plain
   version's error, beside a 1xTF32 control that must fail that limit;
   K1, K2 and K5's self-Grams must be bitwise symmetric with gamma2
   exactly on the diagonal, and K1 and K2 bitwise equal on the same
   inputs at S = 300 and S = 1000; K3, K6, K7 and K8 must give NaN on a
   non-positive pivot where their plain versions do (K3 also in a
   100-wide block), and K6's L^-1 L must be the identity;
4. the forward path: ``loss`` and ``predict`` of the flagship VAR-GP model
   (A, Split-MNIST task 4: a 5-task chain, M=60, 10 classes, D=784, B=512,
   3 hyper samples, 10 function samples; random weights from a numpy seed)
   on the card, with every kernel's launch counter read around it, and the
   same path on the CPU (plain versions) as the reference; then the same
   for C, the deep-kernel (DKL) model at A's shapes (phi = 784-256-256-64,
   so K5 takes both Grams);
5. the training path, one ``elbo_step`` each at A (padded chain, S=300,
   Yogi at lr 3e-3, beta 10), at B (Permuted-MNIST's final task: a
   10-task chain, M=100, S=1000, lr 3.7e-3, beta 1.64) and at C (A's
   settings under DKL), with the launch counters read around each step;
   every parameter's ELBO gradient, phi's included, on the card against
   the CPU's on the same inputs and noise; then the factorisation's other
   routes, each step with its launches counted and card against CPU:
   ``solve_via_inverse=False`` (K7 once per step, no K3; also ``loss`` +
   ``predict``) at A, B and C, ``VARGP_TPU_CHOLINV=pallas`` (K6 once per
   step, no K3; also against the default route on the card) at A, B and
   C, and ``VARGP_TPU_AR_FORM=materialized`` at A and B;
6. training: a ``train_block`` of 20 Yogi steps at A and at C (finite loss
   at every step; the first 3 steps' ELBO pieces against the same 3 steps
   on the CPU, with the block's own permutations and noise) and of 5 steps
   at B;
7. the chain-reload analysis: a 5-task chain of C's shapes with random
   weights saved with ``save_chain`` and loaded with ``load_chain``
   (bitwise), then its 5 x 5 accuracy and entropy matrices over the
   synthetic Split-MNIST test splits (10,000 rows, made by numpy) at the
   notebooks' budgets (n_f=50, n_var_samples=20), with one cell's first
   batch replayed on the CPU from the same draws;
8. the protocol: ``vargp_run.split_mnist``, the drivers' entry point,
   for two tasks of Split-MNIST's chain padded to 5 tasks (A's step),
   20 epochs each with an evaluation every 10, on the synthetic surrogate
   (``PROTOCOL``), the launches counted around the run: every logged
   scalar finite, the evaluations at epochs 10 and 20, task 0's
   validation accuracy at epoch 20 at least 0.98, the checkpoints
   reloaded bitwise and their 2 x 2 matrices, and the last evaluated
   split replayed on the CPU from its own draws (the first batch's
   probabilities, the split's correct count); it prints ``train_task``'s
   steps per second, the ms per evaluated split and the phase's wall
   time beside the card's name and power limit;
9. timings: each kernel, its plain version and one PyTorch yardstick call
   the port never makes, in device time per call (``torch.profiler``; when
   a trace comes back with no device event, CUDA events with the host
   queued ahead of the card), and
   the kernel also with CUDA events around back-to-back calls (K3, K8,
   K6 and K7 at A's and B's shapes; the Grams at the shapes of
   GRAM_SHAPES: K1 at A's, the evaluation's and P-MNIST's S = 500, K2 at
   B's, K4 at A's, B's and the evaluation's, K5's K_zz and K_zx at C's and
   the evaluation's, each with both bounds, 3xTF32 and f32, and the
   effective TFLOP/s; all also cold: a 256 MB buffer
   written between calls, CUDA events around each; K3 also at the
   diagonal blocks of A's, B's and the analysis's factorisations and at
   G = 200, each beside ``torch.linalg.cholesky`` on the same view; K6
   beside the default blocked factorisation, K7 beside
   ``torch.linalg.cholesky``, all four at one panel);
   ``loss`` and ``predict`` end to end; the
   forward, forward + backward and whole step of training at A, B and C,
   and the step under the solve and fused routes (CUDA events); the
   default step's kernel launches and device-busy time under
   ``torch.profiler``.

The line before the last two is one JSON object ``{"kernels": [...]}``; then
the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Nothing under ``results/`` is read.
"""

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(n_tasks=5, M=60, O=10, D=784, B=512, H=3, n_f=10)
PMNIST_LAST = dict(n_tasks=10, M=100, O=10, D=784, B=512, H=3, n_f=10)
# the two training configurations, from vargp_tpu/experiments/vargp_run.py:
# A split_mnist (padded 5-task chain), B permuted_mnist's final task (an
# unpadded 10-task chain); n_rows is the train block's dataset, one epoch
# C is split_mnist --dkl=True: A's chain and settings under the deep kernel.
# launches: each counter's launches in one train step (rbf_gram_sym: K5's
# symmetric kernel, counted also under rbf_gram).
TRAIN = {
    "A": dict(shape=FLAGSHIP, lr=3e-3, beta=10.0, padded=True, n_rows=10000, dkl=False,
              launches={"sym_gram": 1, "sym_gram_tri": 0, "diag_chol": 3, "cross_gram": 1,
                        "rbf_gram": 0, "rbf_gram_sym": 0}),
    "B": dict(shape=PMNIST_LAST, lr=3.7e-3, beta=1.64, padded=False, n_rows=2500, dkl=False,
              launches={"sym_gram": 0, "sym_gram_tri": 1, "diag_chol": 8, "cross_gram": 1,
                        "rbf_gram": 0, "rbf_gram_sym": 0}),
    "C": dict(shape=FLAGSHIP, lr=3e-3, beta=10.0, padded=True, n_rows=10000, dkl=True,
              launches={"sym_gram": 0, "sym_gram_tri": 0, "diag_chol": 3, "cross_gram": 0,
                        "rbf_gram": 2, "rbf_gram_sym": 1}),
}
# the chain-reload analysis at the notebooks' budgets
ANALYSIS = dict(n_f=50, n_var_samples=20, batch_size=512, seed=5, replay_cell=(1, 0))
# the protocol: vargp_run.split_mnist's first two tasks at full width (the
# chain padded to the protocol's 5 tasks: A's step), 20 epochs each with
# an evaluation every 10, on the synthetic surrogate.  Task 0's
# validation accuracy at epoch 20 must reach min_val_acc (the JAX
# package's minted run, results/smnist_r4, had 1.000 there); one
# evaluated split is replayed on the CPU, its correct count within
# count_tol of its rows.
PROTOCOL = dict(n_tasks=2, pad_tasks_to=5, epochs=20, eval_interval=10, seed=SEED,
                eval_epochs=[10, 20], min_val_acc=0.98, count_tol=1e-3)

# H100 SXM rates for the bound (NVIDIA data sheet): f32 on the CUDA cores
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The Grams (K1, K2, K4, K5), K6 and K7 multiply on the tensor cores in
# 3xTF32: three TF32 products (495 TFLOP/s dense) per f32 product
PEAK_TF32X3_FLOPS = 495e12 / 3
# The deep kernel's features: phi = 784-256-256-64
DKL_FEATURES = 64
# The Grams at the shapes the paths give them, (H, O, S, B, D): K1 at A's
# step, at the evaluation's predict (H = 20 hyper samples, A's 300-row
# chain) and at P-MNIST's task 5 (S = 500, the last chain below K2's 512
# rows); K2 at B's step; K4 at A's and B's steps and the evaluation's
# (batches of 512); K5 on the deep kernel's features at C's step and the
# evaluation's, G = H * O Grams, K_zz (the self-Gram, B = 0) and K_zx.
GRAM_SHAPES = {
    "sym_gram": {
        "A": (FLAGSHIP["H"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"], 0, FLAGSHIP["D"]),
        "eval": (ANALYSIS["n_var_samples"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"], 0,
                 FLAGSHIP["D"]),
        "P-MNIST task 5": (PMNIST_LAST["H"], PMNIST_LAST["O"], 5 * PMNIST_LAST["M"], 0,
                           PMNIST_LAST["D"]),
    },
    "sym_gram_tri": {"B": (PMNIST_LAST["H"], PMNIST_LAST["O"],
                           PMNIST_LAST["n_tasks"] * PMNIST_LAST["M"], 0, PMNIST_LAST["D"])},
    "cross_gram": {
        "A": (FLAGSHIP["H"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"], FLAGSHIP["B"],
              FLAGSHIP["D"]),
        "B": (PMNIST_LAST["H"], PMNIST_LAST["O"], PMNIST_LAST["n_tasks"] * PMNIST_LAST["M"],
              PMNIST_LAST["B"], PMNIST_LAST["D"]),
        "eval": (ANALYSIS["n_var_samples"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"],
                 ANALYSIS["batch_size"], FLAGSHIP["D"]),
    },
    "rbf_gram": {
        "C K_zz": (FLAGSHIP["H"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"], 0,
                   DKL_FEATURES),
        "C K_zx": (FLAGSHIP["H"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"], FLAGSHIP["B"],
                   DKL_FEATURES),
        "eval K_zz": (ANALYSIS["n_var_samples"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"],
                      0, DKL_FEATURES),
        "eval K_zx": (ANALYSIS["n_var_samples"], FLAGSHIP["O"], FLAGSHIP["n_tasks"] * FLAGSHIP["M"],
                      ANALYSIS["batch_size"], DKL_FEATURES),
    },
}

# Tolerances, each against the plain version on the same card and inputs.
# Grams: values lie in [0, gamma2]; the kernel and the plain einsum sum the
# D=784 products in different orders, so d2 differs by a few f32 ulps of
# the squared norms (~1e-5 relative), which moves K by about that much.
TOL_GRAM = 1e-4
# K1 at A, K2 and K4 at B and K5's two Grams at C against a float64 Gram
# on the card: within twice the f32 plain version's max error against the
# same float64 Gram (as tests/test_torch_gram_mma.py holds the emulated
# tile).  Both carry the f32 rounding of na + nb - 2 <a, b>; a 3xTF32
# product adds less than that, a product that dropped its two cross terms
# (1xTF32) adds far more, and the check holds such a control to failing
# the same limit.  The symmetric Grams are held off their diagonal, where
# they write gamma2 exactly (d^2 = 0) and the plain version's d^2 is
# rounding; there they must equal gamma2.
F64_RATIO = 2.0
# Cholesky of a well-conditioned block (eigenvalues >= 0.5): right-looking
# column order in both, FMA rounding only in the kernel.
TOL_CHOL = 1e-4
# End to end, card against CPU: K3/K1/K4 rounding passes through the
# factorisation, the Newton-Schulz inverse and sums over 10 x 60 KL terms.
TOL_E2E_REL = 1e-3
TOL_PROBS = 1e-4
# Gradients, card against CPU: the same rounding through the backward's
# products; each leaf against its largest magnitude.
TOL_GRAD_REL = 1e-3
# Under DKL the last bias of phi shifts every feature alike and the RBF
# kernel sees only feature differences: its gradient is exactly 0 and both
# devices return rounding noise there.  It is held to 0, within
# TOL_GRAD_REL of phi's largest bias gradient.
SHIFT_LEAF = ".phi.biases[2]"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after warm-up; inputs stay warm in L2 as on the main path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn`` per call with the host kept ahead of the card: the
    stream sleeps for at least twice the host's time to queue ``reps`` calls
    while the host queues them between two CUDA events, so the span holds
    the card's work back to back and none of the host's time between
    launches.  A note is printed when the host still fell behind (the start
    event had run before the last call was queued)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(host_s * 4e9, 2e9)) + 1_000_000)  # cycles: >= 2x host_s below 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        print("  (the host fell behind the card: the events include time between launches)")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3, one_kernel: bool = False) -> float:
    """Mean device time of ``fn`` per call: the summed durations of the
    kernels it launches, traced by ``torch.profiler`` over ``reps`` calls
    after warm-up.  Unlike ``time_ms`` it leaves out the host's time between
    launches, which a kernel of a few microseconds cannot hide.  The trace
    can miss launches (seen for the kernel library's launches: K6 at B
    traced at half its CUDA-event time), so for ``fn`` that launches one
    kernel (``one_kernel``) the mean is taken over the traced launches and
    their count is printed when some are missing.  The trace can also come
    back with no device event at all; after three such traces the time is
    taken by ``queued_ms`` instead, and a note says so."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a trace that came back without device events is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels and one_kernel:
            if len(kernels) < reps:
                print(f"  (the profiler traced {len(kernels)} of {reps} launches)")
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / len(kernels)
        if kernels:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
        print(f"  (the profiler traced no device time, trace {attempt + 1} of 3)")
    print("  (timed with CUDA events instead, the host queued ahead of the card)")
    return queued_ms(fn, reps)


def cold_ms(fn, reps: int = 10, flush_bytes: int = 256 << 20) -> float:
    """Mean time of one call of ``fn`` that finds the 50 MB L2 cold: a
    256 MB buffer is written before each call, and CUDA events bracket the
    call alone (the host queues them while the write runs, so they time
    the kernel and not the host)."""
    buf = torch.empty(flush_bytes // 4, device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        buf.fill_(float(i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 as the kernels' split rounds it (to nearest, ties
    away from zero: half of the 13 dropped bits added, then cleared)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def sym_gram_1xtf32(z, invs, gamma2):
    """K2's function with the product in one TF32 term (big*big: the two
    cross terms of the 3-term product dropped), norms in f32: the control
    the float64 check must catch."""
    sz = z[None] * invs[:, None, None, :]
    nn = torch.sum(sz * sz, dim=-1)
    xy = torch.einsum("homd,hond->homn", tf32(sz), tf32(sz))
    d2 = torch.clamp(nn[..., :, None] - 2.0 * xy + nn[..., None, :], min=0.0)
    return gamma2[:, None, None, None] * torch.exp(-0.5 * d2)


def rbf_gram_1xtf32(sx, sy, gamma2):
    """K5's function with the product in one TF32 term, as sym_gram_1xtf32."""
    xx, yy = torch.sum(sx * sx, dim=-1), torch.sum(sy * sy, dim=-1)
    xy = torch.einsum("gmd,gnd->gmn", tf32(sx), tf32(sy))
    d2 = torch.clamp(xx[..., :, None] - 2.0 * xy + yy[..., None, :], min=0.0)
    return gamma2[:, None, None] * torch.exp(-0.5 * d2)


def cross_gram_1xtf32(z, x, invs2, gamma2):
    """K4's function with the product in one TF32 term, as sym_gram_1xtf32."""
    xs = x[None] * invs2[:, None, :]
    cross = torch.einsum("oid,hbd->hoib", tf32(z), tf32(xs))
    zz = torch.einsum("oid,hd->hoi", z * z, invs2)
    xx = torch.einsum("bd,hd->hb", x * x, invs2)
    d2 = torch.clamp(zz[..., None] + xx[:, None, None, :] - 2.0 * cross, min=0.0)
    return gamma2[:, None, None, None] * torch.exp(-0.5 * d2)


def check_f64(name: str, got, plain, control, args, keep=None) -> dict:
    """The kernel's output ``got``, the f32 plain version and the 1xTF32
    ``control`` on ``args``, each against the plain version in float64 on
    the same inputs (over the entries ``keep`` selects, all by default):
    raise unless the kernel lies within F64_RATIO times the plain version's
    error and the control does not.  Returns the three errors."""
    ref = plain(*(a.double() for a in args))
    sel = (lambda t: t) if keep is None else (lambda t: t[..., keep])
    ref = sel(ref)
    errs = {"kernel": max_abs_err(sel(got), ref), "plain_f32": max_abs_err(sel(plain(*args)), ref),
            "control_1xtf32": max_abs_err(sel(control(*args)), ref)}
    limit = F64_RATIO * errs["plain_f32"]
    print(f"  {name} against float64: max abs err kernel {errs['kernel']:.3e}, f32 plain "
          f"{errs['plain_f32']:.3e}, 1xTF32 control {errs['control_1xtf32']:.3e} (limit {limit:.3e})")
    if not errs["kernel"] <= limit:
        raise AssertionError(f"{name}: {errs['kernel']} from float64, above {F64_RATIO}x the f32 "
                             f"plain version's {errs['plain_f32']}")
    if not errs["control_1xtf32"] > limit:
        raise AssertionError(f"{name}: the 1xTF32 control passed the float64 limit {limit}: the "
                             f"check cannot tell a 3xTF32 product from a 1xTF32 one")
    return errs


def check(name: str, err: float, tol: float, scale: float = 1.0) -> None:
    """Raise unless the max abs error ``err`` is within ``tol``; ``scale``
    is the largest reference value, for the relative figure printed."""
    print(f"  {name}: max abs err {err:.3e}, relative to the largest value "
          f"{err / scale:.3e} (tol {tol:.0e} abs)")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} above tolerance {tol}")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def gram_inputs(rng, O, M, D, H, B, device):
    """z, x ~ N(0, 1/D) and lengthscales near 1: squared distances near 2,
    so the Gram values spread over (0, gamma2) instead of underflowing."""
    f32 = np.float32
    t = lambda a: torch.tensor(a.astype(f32), device=device)
    z = t(rng.standard_normal((O, M, D)) / math.sqrt(D))
    x = t(rng.standard_normal((B, D)) / math.sqrt(D))
    log_ls = rng.standard_normal((H, D)) * 0.1
    invs = t(np.exp(-log_ls))
    invs2 = t(np.exp(-2.0 * log_ls))
    gamma2 = t(np.exp(rng.standard_normal(H) * 0.2))
    return z, x, invs, invs2, gamma2


def dkl_features(rng, G, S, B, F, device):
    """K5's inputs: G Grams' chain features (G, S, F) and batch features
    (G, B, F) ~ N(0, 1/(2F)), so squared distances lie near 1 and Gram
    values are O(1), and gamma2 (G,) near 1."""
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)
    sz = t(rng.standard_normal((G, S, F)) / math.sqrt(2 * F))
    sx = t(rng.standard_normal((G, B, F)) / math.sqrt(2 * F))
    return sz, sx, t(np.exp(rng.standard_normal(G) * 0.2))


def spd_blocks(rng, G, device, S=128):
    """(G, S, S) SPD matrices with eigenvalues >= 0.5, entries O(1)."""
    A = rng.standard_normal((G, S, S)).astype(np.float32)
    K = A @ A.transpose(0, 2, 1) / np.float32(S) + np.float32(0.5) * np.eye(S, dtype=np.float32)
    return torch.tensor(K, device=device)


def flagship_model(device, seed=SEED, shape=FLAGSHIP, dkl=False):
    """The flagship configuration (or ``shape``'s) with random weights from
    ``seed``.  Inputs are N(0, 0.01) and the lengthscales start near the
    median pairwise distance (sqrt(2 * 784 * 0.01) ~ 4), so every Gram
    entry is O(1) rather than exp(-30).  Under ``dkl`` the feature map is
    torch.nn.Linear's init from uniform draws, and the 64 lengthscales
    start near the median distance of the chain's features (the experiment
    scripts' ``ls_init='median'``)."""
    from vargp_tpu_torch.gpmath import vec2tril
    from vargp_tpu_torch.kernels import RBFParams, default_prior, init_mlp, mlp_apply
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.utils.convert import noise_for_loss, noise_for_predict

    f = shape
    O, M, D, B, H, n_f = f["O"], f["M"], f["D"], f["B"], f["H"], f["n_f"]
    cfg = V.VARGPConfig(M=M, out_size=O, in_size=D, n_f=n_f, n_var_samples=H, dkl=dkl)
    P = V._theta_size(cfg)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = lambda a: torch.tensor(np.asarray(a, f32), device=device)
    n_tri = M * (M + 1) // 2
    prev = tuple(
        V.TaskPosterior(
            z=t(rng.standard_normal((O, M, D)) * 0.1),
            u_mean=t(rng.standard_normal((O, M, 1)) * 0.3),
            u_tril=vec2tril(t(rng.standard_normal((O, n_tri)) * 0.1)),
        )
        for _ in range(f["n_tasks"] - 1)
    )
    rows, cols = np.tril_indices(M)
    u_tril_vec = np.where(rows == cols, 1.0, 0.0) + 0.05 * rng.standard_normal((O, n_tri))
    phi = None
    if dkl:
        dims = [D, 256, 256, P]
        draws = []
        for a, b in zip(dims, dims[1:]):
            draws += [rng.random((a, b)), rng.random(b)]
        phi = init_mlp([t(u) for u in draws], D)
        # the median feature distance of the chain's first 512 rows, taken
        # on the CPU so that every device starts from the same value
        cpu_phi = init_mlp([torch.tensor(u, dtype=torch.float32) for u in draws], D)
        zs = torch.cat([p.z.cpu() for p in prev], dim=-2).reshape(-1, D)[:512]
        feats = mlp_apply(cpu_phi, zs).double()
        d2 = torch.sum((feats[:, None] - feats[None]) ** 2, dim=-1)
        log_ls = float(torch.log(torch.sqrt(torch.median(d2[d2 > 0]))))
    else:
        log_ls = np.log(4.0)
    log_mean = np.concatenate(
        [log_ls + 0.05 * rng.standard_normal(P), [np.log(0.5)]]
    )
    params = V.VARGPParams(
        z=t(rng.standard_normal((O, M, D)) * 0.1),
        u_mean=t(0.5 * rng.standard_normal((O, M, 1))),
        u_tril_vec=t(u_tril_vec),
        kernel=RBFParams(log_mean=t(log_mean), log_logvar=t(np.full(P + 1, -2.0))),
        phi=phi,
    )
    prior = default_prior(P, device=device)
    x = t(rng.standard_normal((B, D)) * 0.1)
    y = torch.tensor(rng.integers(0, O, B), device=device)
    c = (f["n_tasks"] - 1) * M
    hyper_eps = rng.standard_normal((H, P + 1))
    prefix_eps = rng.standard_normal((H, H, O, c))
    lik_eps = rng.standard_normal((H, n_f, O, B))
    pred_lik_eps = rng.standard_normal((H, n_f, O, B))
    noise = noise_for_loss(hyper_eps, prefix_eps, lik_eps, device=device)
    pnoise = noise_for_predict(hyper_eps, pred_lik_eps, device=device)
    return cfg, params, prev, prior, x, y, noise, pnoise


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_symmetric(label, K, ref, gamma2):
    """A symmetric Gram's own checks: bitwise symmetric and gamma2 exactly
    on the diagonal (K[g.., i, i] = gamma2[g]); prints the error against
    the plain version ``ref`` on and off the diagonal.  Returns the
    diagonal's mask."""
    if not torch.equal(K, K.transpose(-1, -2)):
        raise AssertionError(f"{label}: not exactly symmetric")
    diag = K.diagonal(dim1=-2, dim2=-1)
    if not torch.equal(diag, gamma2.reshape(*gamma2.shape, *[1] * (diag.dim() - 1)).expand_as(diag)):
        raise AssertionError(f"{label}: the diagonal is not gamma2 exactly")
    eye = torch.eye(K.shape[-1], dtype=torch.bool, device=K.device)
    print(f"  {label}: bitwise symmetric, gamma2 on the diagonal; max abs err there "
          f"{max_abs_err(diag, ref.diagonal(dim1=-2, dim2=-1)):.3e} (d^2 = 0 written, the plain "
          f"version's d^2 is rounding), off it {max_abs_err(K[..., ~eye], ref[..., ~eye]):.3e}")
    return eye


def check_kernels(dev):
    """K1 and K4 against their plain versions on the card, each launch
    counted: K1 at each shape of GRAM_SHAPES (A's, the evaluation's,
    P-MNIST's S = 500) and a ragged one (D = 33: the 4-byte copies), each
    bitwise symmetric with gamma2 on its diagonal, and at A equal to K2 bit
    for bit on the same inputs and against float64 (check_f64) off the
    diagonal; K4 at each shape of GRAM_SHAPES (A's, B's, the
    evaluation's), two ragged ones (77 rows, part of one row tile, and
    333, the third tile partial) and one (h, o) with a ragged last column
    tile, at B's shape also against float64.  Returns the largest error
    per kernel and K1's and K4's errors against float64."""
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

    rng = np.random.default_rng(SEED + 1)
    errs = {"sym_gram": 0.0, "cross_gram": 0.0}
    f64 = {}
    k1_cases = {label: (O, S, D, H) for label, (H, O, S, _, D) in GRAM_SHAPES["sym_gram"].items()}
    k1_cases["ragged"] = (2, 77, 33, 2)
    for label, (O, M, D, H) in k1_cases.items():
        z, _, invs, _, gamma2 = gram_inputs(rng, O, M, D, H, 1, dev)
        before = sym_gram.launches
        K = sym_gram(z, invs, gamma2)
        torch.cuda.synchronize()
        if sym_gram.launches != before + 1:
            raise AssertionError("K1's launch counter did not count its launch")
        ref = sym_gram_plain(z, invs, gamma2)
        e = max_abs_err(K, ref)
        check(f"K1 sym_gram {label} {tuple(K.shape)}", e, TOL_GRAM * float(gamma2.max()),
              float(ref.abs().max()))
        eye = check_symmetric(f"K1 {label}", K, ref, gamma2)
        errs["sym_gram"] = max(errs["sym_gram"], e)
        if label == "A":
            if not torch.equal(K, sym_gram_tri(z, invs, gamma2)):
                raise AssertionError("K1 and K2 differ on the same inputs at S = 300")
            print(f"  K1 and K2 (forced) on A's inputs {tuple(K.shape)}: bitwise equal")
            f64["sym_gram"] = check_f64("K1 sym_gram A, off the diagonal", K, sym_gram_plain,
                                        sym_gram_1xtf32, (z, invs, gamma2), keep=~eye)
        del K, ref
    k4_cases = {label: (O, S, D, H, B) for label, (H, O, S, B, D) in GRAM_SHAPES["cross_gram"].items()}
    k4_cases.update({"ragged": (2, 77, 33, 2, 45), "ragged, 3 row tiles": (2, 333, 33, 2, 45),
                     "H*O = 1": (1, 1000, 784, 1, 200)})
    for label, (O, M, D, H, B) in k4_cases.items():
        z, x, _, invs2, gamma2 = gram_inputs(rng, O, M, D, H, B, dev)
        before = cross_gram.launches
        Kx = cross_gram(z, x, invs2, gamma2)
        torch.cuda.synchronize()
        if cross_gram.launches != before + 1:
            raise AssertionError("K4's launch counter did not count its launch")
        ref = cross_gram_plain(z, x, invs2, gamma2)
        e = max_abs_err(Kx, ref)
        check(f"K4 cross_gram {label} {tuple(Kx.shape)}", e, TOL_GRAM * float(gamma2.max()),
              float(ref.abs().max()))
        errs["cross_gram"] = max(errs["cross_gram"], e)
        if label == "B":
            f64["cross_gram"] = check_f64(f"K4 cross_gram {label}", Kx, cross_gram_plain,
                                          cross_gram_1xtf32, (z, x, invs2, gamma2))
        del Kx, ref
    return errs, f64


# K3's blocks as the default route hands them over: A's and C's 100-wide
# and B's 125-wide diagonal blocks are views of the chain's Gram (row
# strides 300 and 1000, then the trailing matrices' 200, 875, 750, ...).
# Each (row stride, offset on the diagonal): rows of 300 and 1000 floats
# at offsets 0 and 128 start on 16 bytes (the cp.async path when h is a
# multiple of 4); rows of 875 floats do not (the L2-load path).
K3_VIEWS = {300: 0, 1000: 128, 875: 125}
K3_WIDTHS = (1, 33, 100, 125, 128)


def junk_above(K):
    """K with 7 above the diagonal: the kernels read only the lower triangle."""
    return K + torch.triu(torch.full_like(K, 7.0), 1)


def compare_k3(cases: dict) -> float:
    """K3 against its plain version on each input of ``cases`` (label:
    blocks), each launch counted; returns the largest error."""
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol, diag_chol_plain

    err = 0.0
    for label, A in cases.items():
        before = diag_chol.launches
        L = diag_chol(A)
        torch.cuda.synchronize()
        if diag_chol.launches != before + 1:
            raise AssertionError("K3's launch counter did not count its launch")
        ref = diag_chol_plain(A)
        e = max_abs_err(L, ref)
        check(f"K3 diag_chol {label} {tuple(A.shape)}", e, TOL_CHOL, float(ref.abs().max()))
        err = max(err, e)
    return err


def check_k3(dev):
    """K3 against its plain version on the card: (30, 128, 128), (5, 128,
    128) and (200, 128, 128) contiguous; each width of K3_WIDTHS as a view
    of a (4, ld, ld) matrix for each row stride ld of K3_VIEWS; NaN where
    the plain version has NaN from a non-positive pivot at h = 128 and at
    h = 100, identity blocks exact.  Returns the largest error and the
    (30, 128, 128) and (200, 128, 128) inputs for timing."""
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol, diag_chol_plain

    rng = np.random.default_rng(SEED + 6)
    cases = {f"G = {G}, contiguous": spd_blocks(rng, G, dev) for G in (30, 5, 200)}
    for ld, off in K3_VIEWS.items():
        big = junk_above(spd_blocks(rng, 4, dev, ld))
        for h in K3_WIDTHS:
            cases[f"h = {h}, row stride {ld}"] = big[:, off:off + h, off:off + h]
    err = compare_k3(cases)
    check_nan_pivot("K3 diag_chol", diag_chol, diag_chol_plain, 128, 5)
    check_nan_pivot("K3 diag_chol", diag_chol, diag_chol_plain, 100, 50)
    # the timing inputs beside the paths' blocks (main): the flagship block
    # and G = 200 whole blocks
    flag = {"(30, 128, 128)": cases["G = 30, contiguous"],
            "(200, 128, 128)": cases["G = 200, contiguous"]}
    return err, flag


def check_k2(dev):
    """K2 against its plain version on the card at B's shape (S = 1000: the
    last 128-row tile holds 104 rows), a ragged one (D = 33: the 4-byte
    copies) and one (h, o) at S = 1000: within tolerance, bitwise
    symmetric, gamma2 exactly on the diagonal, one launch per call; at B's
    shape also equal to K1 bit for bit on the same inputs and against
    float64 off the diagonal (check_f64).  Returns the largest error and
    the errors against float64."""
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

    f = PMNIST_LAST
    rng = np.random.default_rng(SEED + 2)
    err = 0.0
    for label, (O, M, D, H) in (
        ("B", (f["O"], f["n_tasks"] * f["M"], f["D"], f["H"])),
        ("ragged", (3, 520, 33, 2)),
        ("H*O = 1", (1, 1000, 784, 1)),
    ):
        z, _, invs, _, gamma2 = gram_inputs(rng, O, M, D, H, 1, dev)
        before = sym_gram_tri.launches
        K = sym_gram_tri(z, invs, gamma2)
        torch.cuda.synchronize()
        if sym_gram_tri.launches != before + 1:
            raise AssertionError("K2's launch counter did not count its launch")
        ref = sym_gram_plain(z, invs, gamma2)
        e = max_abs_err(K, ref)
        check(f"K2 sym_gram_tri {label} {tuple(K.shape)}", e, TOL_GRAM * float(gamma2.max()),
              float(ref.abs().max()))
        eye = check_symmetric(f"K2 {label}", K, ref, gamma2)
        err = max(err, e)
        if label == "B":
            if not torch.equal(K, sym_gram(z, invs, gamma2)):
                raise AssertionError("K1 and K2 differ on the same inputs at S = 1000")
            print(f"  K1 (forced) and K2 on B's inputs {tuple(K.shape)}: bitwise equal")
            f64 = check_f64(f"K2 sym_gram_tri {label}, off the diagonal", K, sym_gram_plain,
                            sym_gram_1xtf32, (z, invs, gamma2), keep=~eye)
    return err, f64


def check_k5(dev):
    """K5 against its plain version on the card, each launch counted and
    its kernel told by the counters: C's K_zz (sx is sy: the symmetric
    launch; G = H*O = 30, 300 rows of 64 features) and K_zx (against 512
    rows), the evaluation's pair (G = 200), a ragged cross Gram (37 x 70)
    and a ragged self-Gram (37 rows), each also from a base that is not 16
    bytes aligned (the 4-byte copies).  Every self-Gram is bitwise
    symmetric with gamma2 on its diagonal; the same values handed over as
    two tensors take the cross launch.  At C both Grams also against
    float64 (check_f64, K_zz off the diagonal).  Returns the largest error
    and the errors against float64."""
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain

    rng = np.random.default_rng(SEED + 4)

    def unaligned(t):
        """t's values in a tensor whose base lies 4 bytes past a 16-byte boundary."""
        out = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
        return out.copy_(t)

    cases = {}
    for label, (H, O, S, B, F) in GRAM_SHAPES["rbf_gram"].items():
        if B == 0:  # K_zz and K_zx of one G from one draw of features
            sz, sx, g2 = dkl_features(rng, H * O, S, ANALYSIS["batch_size"], F, dev)
            where = label.split()[0]
            cases[f"{where} K_zz"], cases[f"{where} K_zx"] = (sz, sz, g2), (sz, sx, g2)
    rz, rx, rg = dkl_features(rng, 3, 37, 70, DKL_FEATURES, dev)
    uz = unaligned(rz)
    cases.update({"ragged cross": (rz, rx, rg), "ragged self": (rz, rz, rg),
                  "ragged cross, unaligned": (uz, rx, rg), "ragged self, unaligned": (uz, uz, rg),
                  "ragged self as two tensors": (rz, rz.clone(), rg)})
    err, f64 = 0.0, {}
    for label, (a, b, g) in cases.items():
        sym = a is b
        before, before_sym = rbf_gram.launches, rbf_gram.sym_launches
        K = rbf_gram(a, b, g)
        torch.cuda.synchronize()
        if (rbf_gram.launches, rbf_gram.sym_launches) != (before + 1, before_sym + int(sym)):
            raise AssertionError(f"K5 {label}: the wrong launch (symmetric expected: {sym})")
        ref = rbf_gram_plain(a, b, g)
        e = max_abs_err(K, ref)
        check(f"K5 rbf_gram {label} {tuple(K.shape)} ({'symmetric' if sym else 'cross'} launch)",
              e, TOL_GRAM * float(g.max()), float(ref.abs().max()))
        eye = check_symmetric(f"K5 {label}", K, ref, g) if sym else None
        if label == "ragged self as two tensors":
            print(f"  K5 {label}: max |K - K^T| {max_abs_err(K, K.transpose(-1, -2))!r} "
                  f"(the cross kernel: symmetric to rounding only)")
        err = max(err, e)
        if label.startswith("C "):
            f64[label[2:]] = check_f64(
                f"K5 rbf_gram {label}{', off the diagonal' if sym else ''}", K, rbf_gram_plain,
                rbf_gram_1xtf32, (a, b, g), keep=None if eye is None else ~eye)
        del K, ref
    return err, f64


def check_nan_pivot(label, fn, plain, S, bad, G=2):
    """A non-positive pivot must give NaN in the same places as the plain
    version, and an identity matrix's factor must come back exact."""
    A = torch.eye(S, device="cuda").repeat(G, 1, 1)
    A[1, bad, bad] = -1.0
    outs, refs = fn(A), plain(A)
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    for o, r in zip(outs, refs):
        if not (torch.isnan(o[1, bad, bad]) and torch.equal(torch.isnan(o), torch.isnan(r))):
            raise AssertionError(f"{label} does not give NaN where the plain version does")
        if not torch.equal(o[0], torch.eye(S, device="cuda")):
            raise AssertionError(f"{label} changed the factor of an identity matrix")
        fin = ~torch.isnan(o)
        check(f"{label} non-positive pivot at {bad} (finite part)", max_abs_err(o[fin], r[fin]),
              TOL_CHOL)
    print(f"  {label} {tuple(A.shape)} non-positive pivot at {bad}: NaN where the plain version "
          f"has NaN")


def check_chol_kernels(dev):
    """K8, K7 and K6 against their plain versions on the card: K8 at
    (30, 128, 128) and (200, 128, 128); K7 and K6 at A's and B's shapes, at
    (6, 128, 128), at a ragged S = 200, at one panel (30, 128, 128), at a
    one-row last panel (30, 129, 129), and at the cluster sizes the wrapper
    can pick besides A's 4: (200, 300, 300) gives 1, (1, 1000, 1000) gives
    8; K6's L^-1 L - I; NaN from a non-positive pivot at each cluster size.
    Only the lower triangle is read, so the inputs carry junk above the
    diagonal.  Returns the largest errors, the inputs for timing and the
    cluster size of each shape."""
    from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain, cluster_size
    from vargp_tpu_torch.ops.cuda.chol_inv import chol_inv, chol_inv_plain
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol_chunked, diag_chol_plain

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED + 5)
    errs = {"diag_chol_chunked": 0.0, "cholesky": 0.0, "chol_inv": 0.0}
    flag, clusters = {}, {}
    for G in (30, 200):
        K = spd_blocks(rng, G, dev)
        before = diag_chol_chunked.launches
        L = diag_chol_chunked(junk_above(K))
        torch.cuda.synchronize()
        if diag_chol_chunked.launches != before + 1:
            raise AssertionError("K8's launch counter did not count its launch")
        ref = diag_chol_plain(K)
        e = max_abs_err(L, ref)
        check(f"K8 diag_chol_chunked {tuple(K.shape)}", e, TOL_CHOL, float(ref.abs().max()))
        errs["diag_chol_chunked"] = max(errs["diag_chol_chunked"], e)
        flag.setdefault("K8", K)
    A, B = FLAGSHIP, PMNIST_LAST
    shapes = {"A": (A["H"] * A["O"], A["n_tasks"] * A["M"]), "B": (B["H"] * B["O"], B["n_tasks"] * B["M"]),
              "six blocks": (6, 128), "ragged": (30, 200), "one panel": (30, 128),
              "one-row last panel": (30, 129), "analysis": (200, 300), "one matrix": (1, 1000)}
    for label, (G, S) in shapes.items():
        K = spd_blocks(rng, G, dev, S)
        b7, b6 = cholesky.launches, chol_inv.launches
        L = cholesky(junk_above(K))
        L6, X = chol_inv(junk_above(K))
        torch.cuda.synchronize()
        if (cholesky.launches, chol_inv.launches) != (b7 + 1, b6 + 1):
            raise AssertionError("K7's or K6's launch counter did not count its launch")
        clusters[label] = cluster_size(G, n_sm)
        print(f"  K7/K6 at {label} {tuple(K.shape)}: cluster of {clusters[label]} blocks per matrix")
        ref = cholesky_plain(K)
        e = max_abs_err(L, ref)
        check(f"K7 cholesky {label} {tuple(K.shape)}", e, TOL_CHOL, float(ref.abs().max()))
        errs["cholesky"] = max(errs["cholesky"], e)
        refL, refX = chol_inv_plain(K)
        e6 = max(max_abs_err(L6, refL), max_abs_err(X, refX))
        check(f"K6 chol_inv {label} {tuple(K.shape)} (L and L^-1)", e6, TOL_CHOL,
              float(refX.abs().max()))
        errs["chol_inv"] = max(errs["chol_inv"], e6)
        check(f"K6 chol_inv {label}: L^-1 L - I", max_abs_err(X @ L6, torch.eye(S, device=dev)),
              TOL_CHOL)
        if label in ("A", "B", "one panel", "analysis"):
            flag[label] = K
    check_nan_pivot("K8 diag_chol_chunked", diag_chol_chunked, diag_chol_plain, 128, 5)
    for G, S, bad in ((2, 300, 150), (30, 300, 150), (200, 300, 150), (2, 1000, 700), (2, 129, 128)):
        print(f"  (cluster of {cluster_size(G, n_sm)} at G = {G})")
        check_nan_pivot("K7 cholesky", cholesky, cholesky_plain, S, bad, G)
        check_nan_pivot("K6 chol_inv", chol_inv, chol_inv_plain, S, bad, G)
    return errs, flag, clusters


# wrapper name -> its module under vargp_tpu_torch.ops.cuda
KERNELS = {"sym_gram": "sym_gram", "sym_gram_tri": "sym_gram_tri", "diag_chol": "diag_chol",
           "cross_gram": "cross_gram", "rbf_gram": "rbf_gram", "chol_inv": "chol_inv",
           "cholesky": "chol", "diag_chol_chunked": "diag_chol"}


def wrappers() -> dict:
    import importlib

    return {n: getattr(importlib.import_module(f"vargp_tpu_torch.ops.cuda.{m}"), n)
            for n, m in KERNELS.items()}


# The routes through the chain's factorisation: the default (K3 plus
# products), solve_via_inverse=False (K7 alone, then triangular solves),
# VARGP_TPU_CHOLINV=pallas (K6 in place of the blocked forward) and
# VARGP_TPU_AR_FORM=materialized (the default factorisation, the
# materialised posterior).  Each is (config override, environment).
ROUTES = {
    "default": ({}, {}),
    "solve": ({"solve_via_inverse": False}, {}),
    "fused": ({}, {"VARGP_TPU_CHOLINV": "pallas"}),
    "materialized": ({}, {"VARGP_TPU_AR_FORM": "materialized"}),
}


@contextlib.contextmanager
def route_env(route: str):
    """The route's environment knobs set for the block, restored after."""
    env = ROUTES[route][1]
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counters() -> dict:
    """Every launch counter: counter name -> (wrapper, attribute); each
    wrapper's ``launches``, and K5's symmetric kernel's as rbf_gram_sym."""
    return {**{n: (w, "launches") for n, w in wrappers().items()},
            "rbf_gram_sym": (wrappers()["rbf_gram"], "sym_launches")}


def expected_launches(name: str, route: str = "default") -> dict:
    """Every counter's launches in one train step of configuration ``name``
    under ``route``: the factorisation's kernels change, the Grams' stay."""
    want = {k: 0 for k in counters()}
    want.update(TRAIN[name]["launches"])
    if route == "solve":
        want.update(diag_chol=0, cholesky=1)
    elif route == "fused":
        want.update(diag_chol=0, chol_inv=1)
    return want


def reset_counts():
    for w, attr in counters().values():
        setattr(w, attr, 0)


def read_counts():
    return {n: getattr(w, attr) for n, (w, attr) in counters().items()}


def run_slice(device, name="A", route="default"):
    """loss and predict of configuration ``name`` of TRAIN (the flagship
    model at A, its deep kernel at C) on ``device`` under ``route``."""
    from vargp_tpu_torch.models import vargp as V

    spec = TRAIN[name]
    cfg, params, prev, prior, x, y, noise, pnoise = flagship_model(
        device, shape=spec["shape"], dkl=spec["dkl"])
    cfg = dataclasses.replace(cfg, **ROUTES[route][0])
    out = V.loss(params, prev, prior, x, y, noise, cfg, device=device)
    probs = V.predict(params, prev, x, pnoise, cfg, device=device)
    return [float(v) for v in out], probs


def check_forward(name, dev, route="default"):
    """loss + predict of configuration ``name`` under ``route`` on the card,
    with the launches counted (each call builds one posterior: twice the
    step's forward launches), against the same on the CPU.  Returns the
    launches."""
    dkl = TRAIN[name]["dkl"]
    print(f"forward path (loss + predict, {name}{', deep kernel' if dkl else ''}, route {route}):")
    with route_env(route):
        reset_counts()
        pieces, probs = run_slice(dev, name, route)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"  launches: {launches}")
        want = {k: 2 * v for k, v in expected_launches(name, route).items()}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} on the forward path, expected {want}")
        check_outputs("card", pieces, probs, TRAIN[name]["shape"])
        cpu_pieces, cpu_probs = run_slice(torch.device("cpu"), name, route)
    check_outputs("cpu", cpu_pieces, cpu_probs, TRAIN[name]["shape"])
    for n, g, c in zip(("kl_hypers", "kl_u", "nll"), pieces, cpu_pieces):
        rel = abs(g - c) / max(abs(c), 1e-30)
        print(f"  {name} {n}: card {g!r} cpu {c!r} rel err {rel:.3e} (tol {TOL_E2E_REL:.0e})")
        if not rel <= TOL_E2E_REL:
            raise AssertionError(f"{name} {n}: card and CPU differ by {rel} (relative)")
    check(f"{name} predict probabilities, card vs CPU", max_abs_err(probs.cpu(), cpu_probs),
          TOL_PROBS, float(cpu_probs.max()))
    return launches


def analysis_chain(device):
    """A 5-task chain of C's shapes, each task's parameters drawn as
    ``flagship_model`` draws C's, from seeds of their own."""
    chain = []
    for k in range(FLAGSHIP["n_tasks"]):
        cfg, params, *_ = flagship_model(device, seed=SEED + 100 + k, dkl=True)
        chain.append(params)
    return cfg, chain


def check_analysis(dev):
    """The chain round trip through ``save_chain`` / ``load_chain``
    (bitwise), the analysis matrices on the card with the launches
    counted, and one cell's first batch replayed on the CPU."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train.optim import tree_leaves
    from vargp_tpu_torch.utils.checkpoint import load_chain, save_chain
    from vargp_tpu_torch.utils.convert import params_from_numpy

    cfg, chain = analysis_chain(dev)
    T = len(chain)
    with tempfile.TemporaryDirectory() as d:
        for k, p in enumerate(chain):
            save_chain(d, k, p)
        loaded = load_chain(d, T, A.params_template(cfg))
    for k, (p, q) in enumerate(zip(chain, loaded)):
        for n, a, b in zip(leaf_names(p), tree_leaves(p), tree_leaves(q)):
            if not np.array_equal(a.cpu().numpy(), b):
                raise AssertionError(f"task {k} leaf {n} changed in the save/load round trip")
    print(f"  save_chain / load_chain of {T} tasks ({len(tree_leaves(chain[0]))} leaves each): bitwise")
    chain = [params_from_numpy(q, device=dev)[0] for q in loaded]

    t0 = time.perf_counter()
    test_full = data.load_mnist(None, train=False)  # no IDX files: the surrogate
    test_sets = [data.filter_by_class(test_full, [2 * t, 2 * t + 1]) for t in range(T)]
    t_data = time.perf_counter() - t0
    a = ANALYSIS
    reset_counts()
    t0 = time.perf_counter()
    acc, ent = A.accuracy_entropy_matrices(chain, cfg, test_sets, seed=a["seed"], n_f=a["n_f"],
                                           n_var_samples=a["n_var_samples"],
                                           batch_size=a["batch_size"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_batches = sum(-(-len(ts) // a["batch_size"]) for ts in test_sets) * T
    print(f"  test splits: {[len(ts) for ts in test_sets]} rows, made in {t_data:.3f} s")
    print(f"  accuracy matrix: {np.round(acc, 4).tolist()}")
    print(f"  entropy matrix: {np.round(ent, 4).tolist()}")
    print(f"  analysis wall time {wall:.3f} s for {n_batches} predict calls at H={a['n_var_samples']}, "
          f"n_f={a['n_f']}; launches {launches}")
    if acc.shape != (T, T) or not (np.isfinite(acc).all() and np.isfinite(ent).all()):
        raise AssertionError("analysis: matrices of the wrong shape or not finite")
    if acc.min() < 0 or acc.max() > 1 or ent.min() < 0 or ent.max() > 1 + 1e-6:
        raise AssertionError("analysis: accuracy or normalised entropy outside [0, 1]")
    want = {k: 0 for k in counters()}
    want.update(rbf_gram=2 * n_batches, rbf_gram_sym=n_batches, diag_chol=3 * n_batches)
    if launches != want:
        raise AssertionError(f"analysis: launches {launches}, expected {want}")

    # one cell's first batch again, card and CPU, from the cell's own draws
    t, s = a["replay_cell"]
    cfg_eval = V.eval_budget_cfg(cfg, n_f=a["n_f"], n_var_samples=a["n_var_samples"])
    draws = A.eval_draws(torch.Generator(device=dev).manual_seed(a["seed"]), cfg_eval, T * T,
                         a["batch_size"])
    noise = next(itertools.islice(draws, t * T + s, None))
    x = next(data.eval_batches(test_sets[s], a["batch_size"])).x
    cpu_chain = [params_from_numpy(q, device="cpu")[0] for q in loaded]
    probs = {}
    for where, ch, nz in (("card", chain, noise),
                          ("cpu", cpu_chain, {k: v.cpu() for k, v in noise.items()})):
        device = torch.device("cuda" if where == "card" else "cpu")
        prev, mask = V.pad_chain(tuple(V.freeze_task(p) for p in ch[:t]), cfg, T, device=device)
        with torch.no_grad():
            probs[where] = V.predict(ch[t], prev, torch.from_numpy(x).to(device), nz, cfg_eval,
                                     chain_mask=mask, device=device).cpu()
    check(f"analysis cell {(t, s)} first batch, card vs CPU", max_abs_err(probs["card"], probs["cpu"]),
          TOL_PROBS, float(probs["cpu"].max()))
    return dict(acc=acc, ent=ent, wall_s=wall, launches=launches, predicts=n_batches)


@contextlib.contextmanager
def recorded_protocol(dev):
    """Wrap ``train_task``, ``train_block`` and the evaluation function of
    the drivers' path so that each call is recorded (and each evaluated
    split timed between two synchronisations); the functions themselves
    run unchanged."""
    from vargp_tpu_torch.experiments import vargp_run
    from vargp_tpu_torch.train import loop as TL

    rec = {"infos": [], "steps": 0, "split_ms": [], "batches": 0, "last_split": None}
    orig = (vargp_run.train_task, TL.train_block, TL.make_device_eval_fn)

    def train_task(*a, **kw):
        params, info = orig[0](*a, **kw)
        rec["infos"].append(info)
        return params, info

    def train_block(*a, **kw):
        out = orig[1](*a, **kw)
        rec["steps"] += out[2].numel()
        return out

    def make_device_eval_fn(*a, **kw):
        fn = orig[2](*a, **kw)

        def eval_acc(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["split_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["batches"] += args[3].shape[0]
            rec["last_split"] = (args, out)
            return out

        return eval_acc

    vargp_run.train_task, TL.train_block, TL.make_device_eval_fn = (
        train_task, train_block, make_device_eval_fn)
    try:
        yield rec
    finally:
        vargp_run.train_task, TL.train_block, TL.make_device_eval_fn = orig


def to_cpu(tree):
    """A tree of tensors (NamedTuples, tuples, dicts) with every tensor on
    the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        subs = [to_cpu(v) for v in tree]
        return type(tree)(*subs) if hasattr(tree, "_fields") else tuple(subs)
    return tree


def check_protocol(dev, smi):
    """The protocol through the drivers' entry point: ``split_mnist``'s
    first two tasks on the card (the launches counted around the run), the
    evaluation cadence, task 0's validation accuracy, the checkpoints
    reloaded bitwise and their 2 x 2 matrices, and the last evaluated
    split replayed on the CPU from its own draws."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.experiments import vargp_run
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train import loop as TL
    from vargp_tpu_torch.train.optim import tree_leaves
    from vargp_tpu_torch.utils.checkpoint import load_chain

    pr = PROTOCOL
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, recorded_protocol(dev) as rec:
        reset_counts()
        t0 = time.perf_counter()
        chain, summaries = vargp_run.split_mnist(
            n_tasks=pr["n_tasks"], pad_tasks_to=pr["pad_tasks_to"], epochs=pr["epochs"],
            eval_interval=pr["eval_interval"], seed=pr["seed"], log_dir=d, device=dev)
        torch.cuda.synchronize()
        run_wall = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        cfg = V.VARGPConfig(M=FLAGSHIP["M"], out_size=FLAGSHIP["O"], in_size=FLAGSHIP["D"])
        loaded = load_chain(d, pr["n_tasks"], A.params_template(cfg))
    T = pr["n_tasks"]
    sps = [info["steps_per_sec"] for info in rec["infos"]]
    print(f"  split_mnist, {T} tasks of a {pr['pad_tasks_to']}-task chain, {pr['epochs']} epochs: "
          f"{run_wall:.3f} s, {rec['steps']} train steps, {len(rec['split_ms'])} evaluated splits "
          f"({rec['batches']} batches); launches {launches}")
    print(f"  train_task steps_per_sec per task {sps}; ms per evaluated split (a build_posterior "
          f"and its batches) mean {np.mean(rec['split_ms']):.3f}, min {min(rec['split_ms']):.3f}, "
          f"max {max(rec['split_ms']):.3f}; {smi}")
    if not all(math.isfinite(r["value"]) for r in rows):
        raise AssertionError("protocol: a logged scalar is not finite")
    for t in range(T):
        evals = [(r["step"], r["value"]) for r in rows if r["tag"] == f"task{t}/val/acc"]
        print(f"  task {t}: validation accuracy at its evaluations {evals}; best {summaries[t]}")
        if [e for e, _ in evals] != pr["eval_epochs"]:
            raise AssertionError(f"protocol task {t}: evaluations at epochs {evals}, "
                                 f"expected {pr['eval_epochs']}")
    val0 = dict((r["step"], r["value"]) for r in rows if r["tag"] == "task0/val/acc")[pr["epochs"]]
    if not val0 >= pr["min_val_acc"]:
        raise AssertionError(f"protocol: task 0 validation accuracy {val0} at epoch {pr['epochs']},"
                             f" expected >= {pr['min_val_acc']}")
    # every step and every evaluated split builds one posterior (K1, K3 x 3)
    # and every step and evaluated batch one K_zx (K4)
    want = {k: 0 for k in counters()}
    n_post = rec["steps"] + len(rec["split_ms"])
    want.update(sym_gram=n_post, diag_chol=3 * n_post, cross_gram=rec["steps"] + rec["batches"])
    if launches != want:
        raise AssertionError(f"protocol: launches {launches}, expected {want}")

    for k, (p, q) in enumerate(zip(chain, loaded)):
        for n, a, b in zip(leaf_names(p), tree_leaves(p), tree_leaves(q)):
            if not np.array_equal(a.cpu().numpy(), b):
                raise AssertionError(f"protocol: task {k} checkpoint leaf {n} is not bitwise")
    test_full = data.load_mnist(None, train=False)
    test_sets = [data.filter_by_class(test_full, [2 * t, 2 * t + 1]) for t in range(T)]
    acc, ent = A.accuracy_entropy_matrices(chain, cfg, test_sets, seed=pr["seed"], device=dev)
    print(f"  checkpoints reloaded bitwise; accuracy matrix {acc.tolist()}, entropy {ent.tolist()}")
    if acc.shape != (T, T) or not (np.isfinite(acc).all() and np.isfinite(ent).all()):
        raise AssertionError("protocol: analysis matrices of the wrong shape or not finite")

    # the last evaluated split (task 1's test split at its last evaluation)
    # again on the CPU, from the same parameters, chain, stacks and draws
    args, (count, total) = rec["last_split"]
    params, prev, mask, xs, ys, ws, draws = args
    hp = TL.TrainHyperparams()
    cpu_args = to_cpu((params, prev, mask, xs, ys, ws, draws))
    cpu_count, _ = TL.make_device_eval_fn(cfg, hp)(*cpu_args, device="cpu")
    with torch.no_grad():
        card_b0 = next(TL.eval_predictions(params, prev, mask, xs, draws, cfg, hp, device=dev))
        cpu_b0 = next(TL.eval_predictions(*cpu_args[:4], cpu_args[6], cfg, hp, device="cpu"))
    check("protocol: the last evaluated split's first batch, card vs CPU",
          max_abs_err(card_b0.cpu(), cpu_b0), TOL_PROBS, float(cpu_b0.max()))
    n_rows = float(total)
    diff = abs(float(count) - float(cpu_count))
    print(f"  that split's correct count: card {float(count)} CPU {float(cpu_count)} of "
          f"{n_rows:.0f} rows (tol {pr['count_tol']:.0e} of the rows)")
    if not diff <= pr["count_tol"] * n_rows:
        raise AssertionError(f"protocol: correct counts differ by {diff} of {n_rows} rows")
    wall = time.perf_counter() - t_phase
    print(f"  protocol phase wall time {wall:.3f} s; {smi}")
    return dict(launches=launches, steps=rec["steps"], steps_per_sec=sps,
                split_ms=float(np.mean(rec["split_ms"])), wall_s=wall, acc=acc)


def check_outputs(where, pieces, probs, shape=FLAGSHIP):
    B, O = shape["B"], shape["O"]
    if not all(math.isfinite(v) for v in pieces):
        raise AssertionError(f"{where}: non-finite loss pieces {pieces}")
    if tuple(probs.shape) != (B, O) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"{where}: predict gave {tuple(probs.shape)} or non-finite values")
    row = probs.sum(dim=1)
    if float(torch.max(torch.abs(row - 1.0))) > 1e-4:
        raise AssertionError(f"{where}: predictive rows do not sum to 1")


def train_inputs(name, device, route="default"):
    """Configuration ``name`` of TRAIN on ``device``: the model (its config
    set for ``route``), its step's noise (drawn from the numpy seed, the
    same on every device), the padded chain's mask, the train block's
    dataset and the optimizer."""
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train import loop as TL

    spec = TRAIN[name]
    cfg, params, prev, prior, x, y, noise, _ = flagship_model(device, shape=spec["shape"],
                                                              dkl=spec["dkl"])
    cfg = dataclasses.replace(cfg, **ROUTES[route][0])
    mask = None
    if spec["padded"]:  # every slot of the padded chain holds a real task
        prev, mask = V.pad_chain(prev, cfg, len(prev) + 1, device=device)
    rng = np.random.default_rng(SEED + 3)
    data = (rng.standard_normal((spec["n_rows"], cfg.in_size)) * 0.1).astype(np.float32)
    targets = rng.integers(0, cfg.out_size, spec["n_rows"])
    dx, dy, dw = TL.pad_dataset_to_device(data, targets, x.shape[0], device=device)
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=spec["lr"]))
    return dict(cfg=cfg, params=params, prev=prev, prior=prior, x=x, y=y, noise=noise,
                w=torch.ones(x.shape[0], device=device), mask=mask, data=(dx, dy, dw),
                n_train=spec["n_rows"], beta=spec["beta"], opt=opt, device=device)


def elbo_grads(t):
    """The ELBO pieces (tensors on the device) and every parameter leaf's
    gradient of the ELBO."""
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(t["params"])]
    pieces = V.loss(tree_unflatten(t["params"], leaves), t["prev"], t["prior"], t["x"], t["y"],
                    t["noise"], t["cfg"], weights=t["w"], chain_mask=t["mask"],
                    device=t["device"])
    total = t["beta"] * pieces[0] + pieces[1] + t["n_train"] / float(t["x"].shape[0]) * pieces[2]
    return [v.detach() for v in pieces], torch.autograd.grad(total, leaves)


def step(t):
    from vargp_tpu_torch.train import loop as TL

    return TL.elbo_step(t["params"], t["opt"].init(t["params"]), t["prev"], t["prior"], t["x"],
                        t["y"], t["w"], t["noise"], cfg=t["cfg"], opt=t["opt"], beta=t["beta"],
                        n_train=t["n_train"], chain_mask=t["mask"], device=t["device"])


def compare_grads(label, names, pieces, grads, ref_pieces, ref_grads):
    """The ELBO pieces within TOL_E2E_REL relative and every gradient leaf
    within TOL_GRAD_REL of its largest magnitude, against the reference;
    phi's last bias (exactly 0) against phi's largest bias gradient."""
    for n, g, r in zip(("kl_hypers", "kl_u", "nll"), pieces, ref_pieces):
        g, r = float(g), float(r)
        rel = abs(g - r) / max(abs(r), 1e-30)
        print(f"  {label} {n}: {g!r} against {r!r}, rel err {rel:.3e} (tol {TOL_E2E_REL:.0e})")
        if not rel <= TOL_E2E_REL:
            raise AssertionError(f"{label} {n}: differs by {rel} (relative)")
    bias_scale = max((float(r.abs().max()) for n, r in zip(names, ref_grads)
                      if n.startswith(".phi.biases") and n != SHIFT_LEAF), default=0.0)
    for leaf, g, r in zip(names, grads, ref_grads):
        g, r = g.cpu(), r.cpu()
        if leaf == SHIFT_LEAF:  # exactly 0: both against 0
            rel = max(float(g.abs().max()), float(r.abs().max())) / max(bias_scale, 1e-30)
            print(f"  {label} d ELBO / d {leaf}: largest magnitude on either side / phi's "
                  f"largest bias gradient {rel:.3e} (the exact value is 0; tol {TOL_GRAD_REL:.0e})")
        else:
            scale = float(r.abs().max())
            rel = max_abs_err(g, r) / max(scale, 1e-30)
            print(f"  {label} d ELBO / d {leaf}: max abs err / largest magnitude {rel:.3e} "
                  f"(largest {scale:.3e}, tol {TOL_GRAD_REL:.0e})")
        if not (rel <= TOL_GRAD_REL and bool(torch.isfinite(g).all())):
            raise AssertionError(f"{label}: gradient of {leaf} differs by {rel}")


def check_train_step(name, dev, route="default"):
    """One ELBO step on the card under ``route`` with its launches counted;
    the ELBO pieces and every gradient against the CPU's under the same
    route.  Returns the step's launches and the card's pieces and
    gradients."""
    with route_env(route):
        t, c = train_inputs(name, dev, route), train_inputs(name, torch.device("cpu"), route)
        reset_counts()
        _, _, loss, _ = step(t)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"  {name}, route {route}: one elbo_step, launches {launches}, loss {float(loss)!r}")
        want = expected_launches(name, route)
        if launches != want:
            raise AssertionError(f"{name} ({route}): launches {launches}, expected {want}")
        if not math.isfinite(float(loss)):
            raise AssertionError(f"{name} ({route}): non-finite loss")
        pieces, grads = elbo_grads(t)
        cpu_pieces, cpu_grads = elbo_grads(c)
    compare_grads(f"{name} ({route}) card vs CPU", leaf_names(t["params"]), pieces, grads,
                  cpu_pieces, cpu_grads)
    return launches, (pieces, grads, leaf_names(t["params"]))


def leaf_names(tree):
    """The key paths of a parameter tree's leaves, in the JAX package's
    order (``.z``, ..., ``.phi.biases[2]``)."""
    from vargp_tpu_torch.utils.checkpoint import flatten_with_paths

    return [k for k, _ in flatten_with_paths(tree)]


def check_training(dev):
    """Train blocks on the card: 20 steps at A and at C, each checked
    against the CPU on its first 3, and 5 steps at B.  Returns each
    block's launches."""
    from vargp_tpu_torch.train import loop as TL

    out = {}
    for name, seed in (("A", 11), ("B", 12), ("C", 13)):
        t = train_inputs(name, dev)
        dx, dy, dw = t["data"]
        B = t["x"].shape[0]
        reset_counts()
        _, _, losses, pieces = TL.train_block(
            t["params"], t["opt"].init(t["params"]), t["prev"], t["prior"], t["mask"],
            t["n_train"], dx, dy, dw, torch.Generator(device=dev).manual_seed(seed),
            cfg=t["cfg"], opt=t["opt"], beta=t["beta"], batch_size=B, n_epochs=1, device=dev)
        torch.cuda.synchronize()
        out[name] = read_counts()
        losses = losses.cpu()
        print(f"  {name}: train block of {losses.numel()} steps, launches {out[name]}, "
              f"losses {[round(float(v), 4) for v in losses]}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{name}: a non-finite loss in the train block")
        if name == "B":
            continue
        # the block's first 3 steps again on the CPU: the same permutation
        # and noise, drawn again on the card from the same seed
        c = train_inputs(name, torch.device("cpu"))
        cx, cy, cw = c["data"]
        draws = itertools.islice(
            TL.block_draws(torch.Generator(device=dev).manual_seed(seed), dx.shape[0], B, 1,
                           t["cfg"], len(t["prev"])), 3)
        params, state = c["params"], c["opt"].init(c["params"])
        for k, (idx, noise) in enumerate(draws):
            idx = idx.cpu()
            noise = {key: v.cpu() for key, v in noise.items()}
            params, state, _, aux = TL.elbo_step(
                params, state, c["prev"], c["prior"], cx[idx], cy[idx], cw[idx], noise,
                cfg=c["cfg"], opt=c["opt"], beta=c["beta"], n_train=c["n_train"],
                chain_mask=c["mask"], device="cpu")
            for n, g, r in zip(("kl_hypers", "kl_u", "nll"), pieces[k].tolist(), aux):
                rel = abs(g - float(r)) / max(abs(float(r)), 1e-30)
                print(f"  {name} step {k} {n}: card {g!r} cpu {float(r)!r} rel err {rel:.3e}")
                if not rel <= TOL_E2E_REL:
                    raise AssertionError(f"{name} step {k} {n}: card and CPU differ by {rel}")
    return out


def time_k3(blocks: dict) -> dict:
    """K3 at each shape of ``blocks`` (views as the paths give them): device
    time per launch, CUDA events around back-to-back calls, cold, the bound,
    and torch.linalg.cholesky on the same view by device time and events."""
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol

    out = {}
    for label, A in blocks.items():
        G, h = A.shape[0], A.shape[-1]
        b_ms, b_by = bound(G * h ** 3 / 3.0, 4.0 * G * (h * (h + 1) / 2 + h * h))
        fn, lib = (lambda: diag_chol(A)), (lambda: torch.linalg.cholesky(A))
        out[label] = {"ms": device_ms(fn, one_kernel=True), "event_ms": time_ms(fn), "cold_ms": cold_ms(fn),
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(lib),
                      "library_event_ms": time_ms(lib), "row_stride": A.stride(-2)}
        print(f"  diag_chol (K3) at {label}: " + "  ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}" for k, v in out[label].items()))
    return out


def kernel_times(fn, plain, library, flops, nbytes, peak=PEAK_F32_FLOPS, one_kernel=True,
                 **info) -> dict:
    """One kernel's numbers at one shape: ``info`` (its shape, say), then
    its device time per call (``device_ms``, per traced launch when ``fn``
    launches one kernel), CUDA events around back-to-back calls, cold, the
    plain version's and the library call's device times, the bound at
    ``peak`` (and, where ``peak`` is another, at the f32 rate), the work and
    the effective TFLOP/s."""
    ms = device_ms(fn, one_kernel=one_kernel)
    t = dict(info, ms=ms, event_ms=time_ms(fn), cold_ms=cold_ms(fn),
             plain_ms=device_ms(plain, reps=5, warmup=1), library_ms=device_ms(library))
    t["bound_ms"], t["bound_by"] = bound(flops, nbytes, peak)
    if peak != PEAK_F32_FLOPS:
        t["bound_f32_ms"], t["bound_f32_by"] = bound(flops, nbytes)
    t.update(gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / ms / 1e9)
    return t


def fmt_times(t: dict) -> str:
    return "  ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}" for k, v in t.items())


def gram_case(n, H, O, S, B, D, rng, dev) -> dict:
    """Gram kernel ``n`` (sym_gram K1, sym_gram_tri K2, cross_gram K4 or
    rbf_gram K5) at one shape of GRAM_SHAPES, as kernel_times takes it: the
    kernel, its plain version and the yardstick (``cdist`` + ``exp`` on
    inputs scaled beforehand), the operations (a symmetric Gram's S(S+1)/2
    distinct entries) and bytes (inputs read once, the output written
    once), at the 3xTF32 rate the kernels multiply at.  K5 takes G = H * O
    Grams of features (K_zz when B = 0, its input read once)."""
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

    if n == "rbf_gram":
        G = H * O
        sz, sx, g2 = dkl_features(rng, G, S, max(B, 1), D, dev)
        g3 = g2[:, None, None]
        other, N = (sz, S) if B == 0 else (sx, B)
        inputs = G * S * D if B == 0 else G * (S + B) * D
        return dict(
            shape=[G, S, N, D], fn=lambda: rbf_gram(sz, other, g2),
            plain=lambda: rbf_gram_plain(sz, other, g2),
            library=lambda: g3 * torch.exp(-0.5 * torch.cdist(sz, other).square()),
            flops=1.0 * G * S * (S + 1) * D if B == 0 else 2.0 * G * S * B * D,
            nbytes=4.0 * (inputs + G + G * S * N), peak=PEAK_TF32X3_FLOPS)
    z, x, invs, invs2, gamma2 = gram_inputs(rng, O, S, D, H, max(B, 1), dev)
    g4 = gamma2[:, None, None, None]
    if n in ("sym_gram", "sym_gram_tri"):
        kernel = sym_gram if n == "sym_gram" else sym_gram_tri
        sz = (z[None] * invs[:, None, None, :]).reshape(H * O, S, D)
        return dict(
            shape=[H, O, S, D], fn=lambda: kernel(z, invs, gamma2),
            plain=lambda: sym_gram_plain(z, invs, gamma2),
            library=lambda: g4 * torch.exp(-0.5 * torch.cdist(sz, sz).square().view(H, O, S, S)),
            flops=1.0 * H * O * S * (S + 1) * D,
            nbytes=4.0 * (O * S * D + 2 * H * D + H + H * O * S * S), peak=PEAK_TF32X3_FLOPS)
    zw = (z[None] * invs2.sqrt()[:, None, None, :]).reshape(H * O, S, D)
    xw = (x[None] * invs2.sqrt()[:, None, :])[:, None].expand(H, O, B, D).reshape(H * O, B, D)
    return dict(
        shape=[H, O, S, B, D], fn=lambda: cross_gram(z, x, invs2, gamma2),
        plain=lambda: cross_gram_plain(z, x, invs2, gamma2),
        library=lambda: g4 * torch.exp(-0.5 * torch.cdist(zw, xw).square().view(H, O, S, B)),
        flops=2.0 * H * O * S * B * D,
        nbytes=4.0 * (O * S * D + B * D + H * D + H + H * O * S * B), peak=PEAK_TF32X3_FLOPS)


def gram_cases(dev) -> dict:
    """{kernel: {shape label: gram_case}} over GRAM_SHAPES."""
    rng = np.random.default_rng(SEED + 7)
    return {n: {label: gram_case(n, *shape, rng, dev) for label, shape in shapes.items()}
            for n, shapes in GRAM_SHAPES.items()}


def traced_step(fn, reps: int = 5):
    """Kernel launches and device-busy ms per call of ``fn`` under
    torch.profiler (as scripts/profile_torch_train.py counts them), after a
    warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels) / reps, sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps


def time_training(dev):
    """ms per forward, forward + backward and whole step, at A, B and C;
    and the whole step under the solve and fused routes."""
    from vargp_tpu_torch.models import vargp as V

    out = {}
    for name in TRAIN:
        t = train_inputs(name, dev)
        reps = 5 if name == "B" else 10

        def fwd():
            with torch.no_grad():
                return V.loss(t["params"], t["prev"], t["prior"], t["x"], t["y"], t["noise"],
                              t["cfg"], weights=t["w"], chain_mask=t["mask"], device=dev)

        launches, busy = traced_step(lambda: step(t))
        out[name] = {
            "forward_ms": time_ms(fwd, reps=reps),
            "forward_backward_ms": time_ms(lambda: elbo_grads(t), reps=reps),
            "step_ms": time_ms(lambda: step(t), reps=reps),
            "step_launches_traced": launches, "step_device_busy_ms": busy,
        }
        for route in ("solve", "fused"):
            with route_env(route):
                tr = train_inputs(name, dev, route)
                out[name][f"step_ms_{route}"] = time_ms(lambda: step(tr), reps=reps)
        print(f"  train {name}: " + "  ".join(f"{k} {v:.4f}" for k, v in out[name].items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    import vargp_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol, diag_chol_plain

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(build.sources())} sources, one nvcc call")

    dev = torch.device("cuda")
    print("kernels against their plain versions on the card:")
    errs, f64 = check_kernels(dev)
    errs["diag_chol"], flag_k3 = check_k3(dev)
    errs["sym_gram_tri"], f64["sym_gram_tri"] = check_k2(dev)
    errs["rbf_gram"], f64["rbf_gram"] = check_k5(dev)
    errs_chol, flag_chol, clusters = check_chol_kernels(dev)
    errs.update(errs_chol)
    # K3's timing shapes: the first diagonal block of A's (and C's) and of
    # B's chain Gram and of the analysis's (C's chain at H = 20), as views
    flag_k3 = {"(30, 128, 128)": flag_k3["(30, 128, 128)"],
               "A (30, 100, 100) of (30, 300, 300)": flag_chol["A"][:, :100, :100],
               "B (30, 125, 125) of (30, 1000, 1000)": flag_chol["B"][:, :125, :125],
               "analysis (200, 100, 100) of (200, 300, 300)": flag_chol["analysis"][:, :100, :100],
               "(200, 128, 128)": flag_k3["(200, 128, 128)"]}
    # K3 against its plain version on the paths' own blocks too, at their
    # row strides (junk above the diagonal: only the lower triangle is read)
    errs["diag_chol"] = max(errs["diag_chol"], compare_k3({
        f"{label}, junk above": junk_above(flag_chol[key])[:, :h, :h]
        for label, key, h in (("A's first block", "A", 100), ("B's first block", "B", 125),
                              ("the analysis's first block", "analysis", 100))}))

    forward_launches = {name: check_forward(name, dev) for name in ("A", "C")}
    solve_forward_launches = {name: check_forward(name, dev, "solve") for name in ("A", "B")}

    print("training path (one elbo_step each at A, B and C; gradients, card vs CPU):")
    step_out = {name: check_train_step(name, dev) for name in TRAIN}
    step_launches = {name: v[0] for name, v in step_out.items()}
    print("the factorisation's other routes (one elbo_step each; gradients, card vs CPU):")
    route_launches = {}
    for route, names in (("solve", "ABC"), ("fused", "ABC"), ("materialized", "AB")):
        route_launches[route] = {}
        for name in names:
            route_launches[route][name], card = check_train_step(name, dev, route)
            if route == "fused":  # the same function as the default route, on the card
                compare_grads(f"{name} fused vs default route, card", card[2], card[0], card[1],
                              *step_out[name][1][:2])
    print("training (train blocks on the card):")
    block_launches = check_training(dev)

    print("chain-reload analysis (C's shapes, synthetic Split-MNIST test splits):")
    analysis = check_analysis(dev)

    print("the protocol (split_mnist's first two tasks at A's width, synthetic Split-MNIST):")
    protocol = check_protocol(dev, smi)

    print("timings (ms per call):")
    spd = flag_k3["(30, 128, 128)"]
    G = spd.shape[0]
    grams = gram_cases(dev)
    # Each entry's cases are the shapes it is timed at (kernel_times'
    # arguments); the row holds the first case's numbers, the others nested
    # as at_<label>.
    entries = [
        dict(
            name="sym_gram", route="cuda", source="vargp_tpu_torch/csrc/sym_gram.cu",
            replaces="vargp_tpu/ops/pallas/rbf_gram.py:305", cases=grams["sym_gram"],
        ),
        dict(
            name="sym_gram_tri", route="cuda", source="vargp_tpu_torch/csrc/sym_gram_tri.cu",
            replaces="vargp_tpu/ops/pallas/rbf_gram.py:258", cases=grams["sym_gram_tri"],
        ),
        dict(
            name="diag_chol", route="cuda", source="vargp_tpu_torch/csrc/diag_chol.cu",
            replaces="vargp_tpu/ops/pallas/chol_panel.py:255",
            cases={"(30, 128, 128)": dict(
                fn=lambda: diag_chol(spd), plain=lambda: diag_chol_plain(spd),
                library=lambda: torch.linalg.cholesky(spd),
                # the lower triangle is read, the whole factor written
                flops=G * 128.0 ** 3 / 3.0, nbytes=4.0 * G * (128 * 129 / 2 + 128 * 128))},
        ),
        dict(
            name="cross_gram", route="cuda", source="vargp_tpu_torch/csrc/cross_gram.cu",
            replaces="vargp_tpu/ops/pallas/rbf_gram.py:420", cases=grams["cross_gram"],
        ),
        dict(  # its row holds C's K_zz (the symmetric launch)
            name="rbf_gram", route="cuda", source="vargp_tpu_torch/csrc/rbf_gram.cu",
            replaces="vargp_tpu/ops/pallas/rbf_gram.py:47", cases=grams["rbf_gram"],
        ),
    ]
    # K8, K7 and K6: the lower triangle read once, each factor written
    # whole; K7 S^3/3 FMAs' worth of operations, K6 twice that (the
    # factor and the inverse)
    from vargp_tpu_torch.ops import dispatch
    from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain
    from vargp_tpu_torch.ops.cuda.chol_inv import chol_inv, chol_inv_plain
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol_chunked

    def chol_work(K, n_out, n_factor):
        G, S = K.shape[0], K.shape[-1]
        return dict(flops=n_factor * G * S ** 3 / 3.0,
                    nbytes=4.0 * G * (S * (S + 1) / 2 + n_out * S * S))

    def cholinv_library(K):
        L = torch.linalg.cholesky(K)
        return torch.linalg.solve_triangular(L, torch.eye(K.shape[-1], device=K.device), upper=False)

    k8in = flag_chol["K8"]
    entries.append(dict(
        name="diag_chol_chunked", route="cuda", source="vargp_tpu_torch/csrc/diag_chol_chunked.cu",
        replaces="vargp_tpu/ops/pallas/chol_panel.py:311", path=None,
        cases={"(30, 128, 128)": dict(
            fn=lambda: diag_chol_chunked(k8in), plain=lambda: diag_chol_plain(k8in),
            library=lambda: torch.linalg.cholesky(k8in), **chol_work(k8in, 1, 1))},
    ))
    for n, path, src, rpl, fn, plain, lib, n_out, n_f in (
        ("cholesky", "solve", "chol.cu", "chol.py:82", cholesky, cholesky_plain,
         torch.linalg.cholesky, 1, 1),
        ("chol_inv", "fused", "chol_inv.cu", "chol_inv.py:117", chol_inv, chol_inv_plain,
         cholinv_library, 2, 2),
    ):
        entries.append(dict(
            name=n, route="cuda", source=f"vargp_tpu_torch/csrc/{src}",
            replaces=f"vargp_tpu/ops/pallas/{rpl}", path=path,
            cases={cfg_name: dict(
                cluster=clusters[cfg_name], peak=PEAK_TF32X3_FLOPS,
                fn=functools.partial(fn, flag_chol[cfg_name]),
                plain=functools.partial(plain, flag_chol[cfg_name]),
                library=functools.partial(lib, flag_chol[cfg_name]),
                **chol_work(flag_chol[cfg_name], n_out, n_f)) for cfg_name in ("A", "B")},
        ))
    kernels = []
    # ms, plain_ms, library_ms: device time per call (device_ms); event_ms:
    # CUDA events around back-to-back calls, the wrapper's host time included.
    # A kernel's launches are counted on the path that runs it: the default
    # route's steps, or the route that the kernel serves (K7 solve, K6
    # fused); K8 is reached by no path.
    for e in entries:
        n = e["name"]
        times = {}
        for label, case in e["cases"].items():
            times[label] = kernel_times(**case)
            print(f"  {n} at {label}: {fmt_times(times[label])}")
        first, *rest = times
        t = times[first]
        path = e.get("path", "default")
        steps = step_launches if path == "default" else route_launches.get(path, {})
        per_step = {k: v[n] for k, v in steps.items()}
        print(f"  {n}: launches per train step {per_step}, "
              f"per forward (loss + predict) { {k: v[n] for k, v in forward_launches.items()} }, "
              f"per train block { {k: v[n] for k, v in block_launches.items()} }, "
              f"in the analysis {analysis['launches'][n]}, in the protocol "
              f"{protocol['launches'][n]}")
        kernels.append({
            "name": n, "route": e["route"], "source": e["source"], "replaces": e["replaces"],
            # launches: the counted train steps (A, B, C) of the kernel's path
            "launches": sum(per_step.values()), "launches_per_step": per_step, "path": path,
            "protocol_launches": protocol["launches"][n],
            "max_abs_err": errs[n], **t, **{f"at_{lb}": times[lb] for lb in rest},
        })
        if n in f64:  # the Grams against float64
            kernels[-1]["f64"] = f64[n]
        if n == "rbf_gram":  # K5's symmetric launches (K_zz), among its launches
            kernels[-1]["sym_launches_per_step"] = {k: v["rbf_gram_sym"] for k, v in steps.items()}
        if n in ("diag_chol", "diag_chol_chunked"):  # K3 and K8 against the library by events too
            lib_event_ms = time_ms(e["cases"][first]["library"])
            kernels[-1]["library_event_ms"] = lib_event_ms
            print(f"  {n} at {first}: against torch.linalg.cholesky (device {t['library_ms']:.5f}, "
                  f"events {lib_event_ms:.5f}): "
                  f"{'faster' if t['ms'] < t['library_ms'] else 'SLOWER'} by device time, "
                  f"{'faster' if t['event_ms'] < lib_event_ms else 'SLOWER'} by events")
        if n == "diag_chol":  # K3 at the shapes the paths give it
            kernels[-1]["at_shapes"] = time_k3(flag_k3)
    # K6 beside the route it would replace, K7 beside torch.linalg.cholesky
    for cfg_name in ("A", "B"):
        K = flag_chol[cfg_name]
        blocked = device_ms(lambda: dispatch.chol_and_inv(K))
        k6 = [k for k in kernels if k["name"] == "chol_inv"][0]
        k7 = [k for k in kernels if k["name"] == "cholesky"][0]
        k6, k7 = (k if cfg_name == "A" else k["at_B"] for k in (k6, k7))
        print(f"  chol_and_inv's default route (K3 plus products) at {cfg_name} {tuple(K.shape)}: "
              f"device {blocked:.4f}  events {time_ms(lambda: dispatch.chol_and_inv(K)):.4f}; "
              f"K6 {k6['ms']:.4f} ({'faster' if k6['ms'] < blocked else 'SLOWER'}); "
              f"K7 {k7['ms']:.4f} against torch.linalg.cholesky {k7['library_ms']:.4f} "
              f"({'faster' if k7['ms'] < k7['library_ms'] else 'SLOWER'})")
    # one panel: K7's and K6's time is the diagonal step alone, beside K8's
    K = flag_chol["one panel"]
    one = {n: device_ms(f, one_kernel=True) for n, f in (
        ("K7", lambda: cholesky(K)), ("K6", lambda: chol_inv(K)), ("K8", lambda: diag_chol_chunked(K)),
        ("K3", lambda: diag_chol(K)))}
    print(f"  one panel {tuple(K.shape)}, device time: " + "  ".join(f"{n} {v:.4f}" for n, v in one.items())
          + f"; CUDA events: K7 {time_ms(lambda: cholesky(K)):.4f}  K6 {time_ms(lambda: chol_inv(K)):.4f}  "
          f"K8 {time_ms(lambda: diag_chol_chunked(K)):.4f}  K3 {time_ms(lambda: diag_chol(K)):.4f}; "
          f"CUDA events, the host queued ahead: K7 {queued_ms(lambda: cholesky(K)):.4f}  "
          f"K6 {queued_ms(lambda: chol_inv(K)):.4f}  K8 {queued_ms(lambda: diag_chol_chunked(K)):.4f}  "
          f"K3 {queued_ms(lambda: diag_chol(K)):.4f}")

    from vargp_tpu_torch.models import vargp as V

    for name in ("A", "C"):
        cfg, params, prev, prior, xx, yy, noise, pnoise = flagship_model(dev, dkl=TRAIN[name]["dkl"])
        for label, fn in (
            ("loss", lambda: V.loss(params, prev, prior, xx, yy, noise, cfg)),
            ("predict", lambda: V.predict(params, prev, xx, pnoise, cfg)),
        ):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 10
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            print(f"  {name} {label} end to end: {(time.perf_counter() - t0) / reps * 1e3:.4f} ms "
                  f"(host clock, synchronised)")
    time_training(dev)
    print(f"  launches per step under each route: default {step_launches}, "
          f"{ {r: v for r, v in route_launches.items()} }; "
          f"per loss + predict under the solve route {solve_forward_launches}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

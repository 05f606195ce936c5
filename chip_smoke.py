#!/usr/bin/env python3
"""Drive vargp_tpu_torch's forward, training, chain-analysis and protocol
paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero, printing no
result) on a failure:

1. the card: ``torch.cuda.is_available()``, its name and power limit;
2. the build: every kernel of the paths compiled from ``vargp_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together, and one link;
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
   100-wide block), and K6's L^-1 L must be the identity; K9 (tri_mm, the
   marginal's triangular product W = L^-1 K_zx) at TRI_MM_SHAPES on the
   marginal's own operands, against the dense f32 product and float64
   (within twice the dense product's error; a 1xTF32 control must fail
   that limit), and with NaN filled above L's diagonal, finite and bitwise
   its product with tril(L); K10 (marginal_moments, W's readers: f_mean,
   diag(W^T W), diag(C^T C) in one pass) at MOMENTS_SHAPES on the
   marginal's own operands, one launch a call, against the dense f32 chain
   and float64 (f_mean and f_var within twice the chain's error; a chain
   with C in 1xTF32 must fail that limit on f_var), and with NaN filled
   above w's diagonals, finite and bitwise its result on tril(w);
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
   batch replayed on the CPU from the same draws; a cell's noise is
   shared by its batches, so ``predict`` builds one posterior a cell and
   reuses it for the cell's other batches (``utils.tracing.POSTERIOR``'s
   builds and reuses printed and checked);
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
9. the global continual SVGP: K5 on raw 784-pixel rows at the global
   path's shapes (S-MNIST's joint self-Gram of [z; prev.z] (30, 120, 784)
   and K_zx against a batch (30, 60 x 512), the analysis's pair at
   G = 200, P-MNIST's joint (30, 200, 784)) and on the toy's two inputs
   (its joint (12, 60, 2) and K_zx (12, 40 x 512): the small kernel), each
   against its plain version and against float64 (``check_f64``), the
   self-Grams with rows shared by z and prev.z; K7 at (30, 60, 60),
   (30, 100, 100) and (12, 40, 40) against its plain version; one global
   ``elbo_step`` at task 1 of s_mnist_global (M = 60) and at p_mnist_global
   (M = 100), each with a previous task, its launches counted (K5 twice,
   one symmetric; K7 three times) and its four ELBO pieces and every
   gradient against the CPU's; then ``global_run.split_mnist``'s first two
   tasks, 20 epochs each with an evaluation every 10 (``GLOBAL_PROTOCOL``),
   its launches counted, task 0's validation accuracy at epoch 20, the last
   evaluated split replayed on the CPU, and the chain reload:
   ``analyze_smnist_global`` on its checkpoints on the card and on the CPU
   with the card's draws;
10. the VAR-GP Retrain ablation and the Gaussian-likelihood regression:
   K5's small kernel (up to 16 features) at their shapes (SMALL_GRAMS:
   Retrain's chain K_zz (12, 40, 2), K_zx against the batch, K(z_all, z~)
   and K(z~, z~), task 0's K_zx; the regression's step and final-RMSE
   Grams at D = 1), each against its plain version and float64, the rows
   of K(z_all, z~) that a task's first step shares with z~ bitwise equal
   to K(z~, z~); one Retrain ``elbo_step`` at task 0 and at task 1's
   first step (K5 twice / four times, K7 once / three times), its pieces
   and every gradient against the CPU's, again after 5 steps; K7 at
   (12, 40, 40), (12, 20, 20), (3, 24, 24), (16, 24, 24) and on the
   first step's conditional covariance (symmetrised, the jitter added),
   NaN on a non-positive pivot at each shape; ``retrain_run.toy``'s two
   tasks at 30 epochs (RETRAIN_PROTOCOL): the launches, finite values,
   the ELBO falling, the checkpoints bitwise, the last evaluation replayed
   on the CPU; the minted ``results/toy_retrain_full/ckpt1.npz`` (the one
   file under ``results/`` read) predicted on the toy's 4 classes on the
   card and on the CPU with the card's draws; ``regression(epochs=300,
   M=16)``: RMSE below 0.3, the launches, its first steps' losses on the
   CPU with the card's draws;
11. timings: each kernel, its plain version and one PyTorch yardstick call
   the port never makes, in device time per call (``torch.profiler``; when
   a trace comes back with no device event, CUDA events with the host
   queued ahead of the card), and
   the kernel also with CUDA events around back-to-back calls (K3, K8,
   K6 and K7 at A's and B's shapes; the Grams at the shapes of
   GRAM_SHAPES: K1 at A's, the evaluation's and P-MNIST's S = 500, K2 at
   B's, K4 at A's, B's and the evaluation's, K5's K_zz and K_zx at C's and
   the evaluation's, each with both bounds, 3xTF32 and f32, and the
   effective TFLOP/s; K9 at TRI_MM_SHAPES beside the dense
   ``torch.matmul``, which is also its plain version; K10 at
   MOMENTS_SHAPES beside the dense chain, its plain version; all also cold: a 256 MB buffer
   written between calls, CUDA events around each; K3 also at the
   diagonal blocks of A's, B's and the analysis's factorisations and at
   G = 200, each beside ``torch.linalg.cholesky`` on the same view; K6
   beside the default blocked factorisation, K7 beside
   ``torch.linalg.cholesky``, all four at one panel);
   ``loss`` and ``predict`` end to end (``predict`` reusing its
   posterior, and with the posterior built each call); the
   forward, forward + backward and whole step of training at A, B and C,
   and the step under the solve and fused routes (CUDA events); the
   default step's kernel launches and device-busy time under
   ``torch.profiler``; K5 and K7 also at the global shapes of phase 9
   (nested as at_<label>), and the global step's forward, forward +
   backward, whole step, launches, device-busy time and idle share; K5
   and K7 at the shapes of phase 10 too, and the same for the Retrain
   step (task 0 and 1) and the regression's step;
12. the exported predictor (``utils.export``): ``predict`` at the
   evaluation's shapes on A's 5-task chain (M = 60, S = 300, D = 784,
   B = 512, H = 20, n_f = 50; ``EXPORT``) exported under the default route
   and under ``VARGP_TPU_CHOLINV=pallas``, its graph's ``vargp_torch::``
   nodes counted (one per launch: K1, K3 three times and K4; K6 in K3's
   place), the ``.pt2`` loaded in a fresh ``python3`` on the card, its
   launches per call counted there, its probabilities bitwise equal to
   eager ``predict``'s on the same noise (else within 1e-6, the reason
   printed), both timed per call with CUDA events;
13. per-op device profiles (``utils.profiling.profile_fn``) of one
   training step at A, B, D (the global step) and E (Retrain's task-1
   step): the top 15 ops by device ms per step, the most launched ops,
   and each of the port's kernels traced against the launches its wrapper
   counted, the short ones named;
14. the FLOP audit (``utils.flops.audit``) of one training step at A and
   at B: GFLOP by bucket (f32 products, the ``vargp_torch::`` operators by
   their cost functions), movement MB, the speed of light on the H100,
   ``achieved`` against the step's device-busy time and its CUDA-event
   time, the card's name and power limit beside them.  The bounds of
   phase 11 come from the same cost functions and peaks (``build.cost``:
   operations, bytes and precision class; ``utils.flops.bound_s``);
15. multi-GPU (``vargp_tpu_torch.parallel``, SHARDED): the kernels built
   once here, then ranks spawned on card 0 over gloo (the machine has one
   card; NCCL refuses two ranks on one device), two for the 1 x 2 and
   2 x 1 ("data" x "model") meshes and four for 2 x 2: on each, A's step
   and a 5-step train block held to the single-device step and block on
   the same draws (loss and pieces 1e-5 relative, every leaf after
   ``unshard_to_host`` 1e-4 relative and a thousandth of a step per step
   absolute, 3e-6 and 1.5e-5, Yogi's moments 1e-4 of each leaf's largest
   magnitude), each rank's launches counted
   (K1 1, K3 3, K4 1 a step) at its shard's shapes, its ms per step by
   CUDA events and its time in collectives from a profile, labelled as
   ranks sharing one card; then ``split_mnist``'s first two tasks
   (PROTOCOL) on the 1 x 2 mesh through the driver, each task's
   accuracies within 0.02 of phase 8's, rank 0's checkpoints reloaded
   into the single-device template.  A rank that fails or outlives its
   timeout fails the script.  ``python3 chip_smoke.py --phases=sharded``
   runs phases 8 and 15 alone and prints no result line;
   ``--phases=tri_mm`` runs K9's checks and times alone, the same way;
   ``--phases=marginal_moments`` K10's, after a profile of the dense chain
   it replaces at P-MNIST's predict shape.

The line before the last two is one JSON object ``{"kernels": [...]}``; then
the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Under ``results/`` only
``toy_retrain_full/ckpt1.npz`` is read.
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
from torch.utils._python_dispatch import TorchDispatchMode

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

# The global continual SVGP (vargp_tpu_torch/experiments/global_run.py):
# one elbo_step at task 1 of s_mnist_global (M = 60 a class, the previous
# task's 60 rows: z starts as their copy, perturbed here by a step's worth
# of training) and at a task of p_mnist_global (M = 100, the previous 100);
# raw 784-pixel rows of the synthetic MNIST surrogate.  A step launches K5
# twice (the joint self-Gram of [z; prev.z], symmetric, and K_zx against
# the batch) and K7 three times.  The protocol phase runs
# s_mnist_global's first two tasks, 20 epochs each, an evaluation every
# 10; task 0's validation accuracy at epoch 20 must reach min_val_acc (the
# JAX package's minted run, results/smnist_global, had 1.0 there).
GLOBAL_STEP = {
    "S-MNIST global": dict(M=60, O=10, D=784, B=512, H=3, n_f=10, lr=3e-3, beta=10.0,
                           n_train=11000),
    "P-MNIST global": dict(M=100, O=10, D=784, B=512, H=3, n_f=10, lr=3.7e-3, beta=1.64,
                           n_train=50000),
}
GLOBAL_LAUNCHES = {"rbf_gram": 2, "rbf_gram_sym": 1, "cholesky": 3}
GLOBAL_PROTOCOL = dict(n_tasks=2, epochs=20, eval_interval=10, seed=SEED, eval_epochs=[10, 20],
                       min_val_acc=0.95, count_tol=1e-3)
# K5 on raw pixels and on the toy's two inputs, (G, S, N, D): N = 0 is a
# self-Gram (the joint [z; prev.z] of a step with a previous task, the
# analysis's K_zz), else a cross Gram against N rows; K7 at the global
# path's factor shapes (G, S).
GLOBAL_GRAMS = {
    "S-MNIST global joint K_zz": (30, 120, 0, 784),
    "S-MNIST global K_zx": (30, 60, 512, 784),
    "analysis global K_zz": (200, 60, 0, 784),
    "analysis global K_zx": (200, 60, 512, 784),
    "P-MNIST global joint K_zz": (30, 200, 0, 784),
    "toy global joint K_zz": (12, 60, 0, 2),
    "toy global K_zx": (12, 40, 512, 2),
}
GLOBAL_CHOL = {"S-MNIST global": (30, 60), "P-MNIST global": (30, 100), "toy global": (12, 40)}

# One elbo_step of toy_retrain at full width (tasks of 2 classes, O = 4,
# D = 2, M = 20 a task, B = 512: a task's 100 rows padded; H = 3, n_f = 10;
# Yogi at lr 1e-2, beta 1): at task 0 (K5 twice, one symmetric; K7 once)
# and at task 1's first step, the previous task trainable again and frozen
# (z_all[:20] = z~: K5 four times, two symmetric; K7 three times), then
# after `steps` steps.  The protocol phase runs toy_retrain's two tasks at
# 30 epochs, an evaluation every 10: the JAX reference's task-0 accuracy
# there is 0.37 (results/toy_retrain_full; it passes 0.9 only after
# 980-1500 epochs over seeds 0-2), so the phase holds the ELBO to falling
# (a task's last 5 steps below elbo_drop of its first 5; the port on the
# CPU falls 20-60x over seeds 0-2) and the last evaluation to the CPU's
# (accuracies within one row of 200).  The regression runs
# regression(epochs=300, M=16) (RMSE below 0.3, as the JAX package's test
# asks) and its first steps again on the CPU.
RETRAIN_STEP = dict(M=20, O=4, D=2, B=512, H=3, n_f=10, lr=1e-2, beta=1.0, steps=5)
RETRAIN_LAUNCHES = {"task 0": {"rbf_gram": 2, "cholesky": 1},
                    "task 1": {"rbf_gram": 4, "cholesky": 3}}
RETRAIN_PROTOCOL = dict(n_tasks=2, epochs=30, eval_interval=10, seed=SEED,
                        eval_epochs=[10, 20, 30], elbo_drop=0.5, count_tol=0.005)
REGRESSION = dict(epochs=300, M=16, seed=SEED, max_rmse=0.3, replay_steps=3)
# K5's small kernel at the Retrain and regression paths' shapes, (G, S, N,
# D, shared): N = 0 a self-Gram; `shared` rows of a cross Gram's S repeat
# its N (K(z_all, z~) at a task's first step).  Retrain at task 1: the
# chain's K_zz (12, 40, 2), K_zx against the batch, K(z_all, z~) and
# K(z~, z~); at task 0 K_zz is K(z~, z~)'s shape and K_zx (12, 20 x 512);
# the regression's step (H = 3, M = 24, N = 256, D = 1) and its final RMSE
# (H = 16).  K7 at their factors' shapes (G, S).
SMALL_GRAMS = {
    "retrain K_zz": (12, 40, 0, 2, 0),
    "retrain K_zx": (12, 40, 512, 2, 0),
    "retrain K(z_all, z~)": (12, 40, 20, 2, 20),
    "retrain K(z~, z~)": (12, 20, 0, 2, 0),
    "retrain task 0 K_zx": (12, 20, 512, 2, 0),
    "regression K_zz": (3, 24, 0, 1, 0),
    "regression K_zx": (3, 24, 256, 1, 0),
    "regression RMSE K_zz": (16, 24, 0, 1, 0),
    "regression RMSE K_zx": (16, 24, 256, 1, 0),
}
SMALL_CHOL = {"retrain chain": (12, 40), "retrain frozen": (12, 20), "regression": (3, 24),
              "regression RMSE": (16, 24)}

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

# K9 (tri_mm, W = L^-1 K_zx of the predictive marginal) at (H, O, S, N):
# the P-MNIST and S-MNIST cells' predict calls (H = 20), P-MNIST's
# evaluation (H = 3), and a ragged S that is no multiple of 4 (the 4-byte
# copies) beside N = 200 (a partial column tile)
TRI_MM_SHAPES = {
    "P-MNIST predict": (ANALYSIS["n_var_samples"], PMNIST_LAST["O"],
                        PMNIST_LAST["n_tasks"] * PMNIST_LAST["M"], ANALYSIS["batch_size"]),
    "S-MNIST predict": (ANALYSIS["n_var_samples"], FLAGSHIP["O"],
                        FLAGSHIP["n_tasks"] * FLAGSHIP["M"], ANALYSIS["batch_size"]),
    "P-MNIST evaluation": (PMNIST_LAST["H"], PMNIST_LAST["O"],
                           PMNIST_LAST["n_tasks"] * PMNIST_LAST["M"], PMNIST_LAST["B"]),
    "ragged": (2, 3, 250, 200),
}

# K10 (marginal_moments, W's readers: f_mean, diag(W^T W), diag(C^T C)) at
# (H, O, T, M, B): the P-MNIST and S-MNIST cells' predict calls (H = 20),
# P-MNIST's evaluation (H = 3), and a ragged batch (B = 301, a partial strip
# and W's 4-byte copies) beside M = 50 (no multiple of 4: w's 4-byte copies)
MOMENTS_SHAPES = {
    "P-MNIST predict": (ANALYSIS["n_var_samples"], PMNIST_LAST["O"], PMNIST_LAST["n_tasks"],
                        PMNIST_LAST["M"], ANALYSIS["batch_size"]),
    "S-MNIST predict": (ANALYSIS["n_var_samples"], FLAGSHIP["O"], FLAGSHIP["n_tasks"],
                        FLAGSHIP["M"], ANALYSIS["batch_size"]),
    "P-MNIST evaluation": (PMNIST_LAST["H"], PMNIST_LAST["O"], PMNIST_LAST["n_tasks"],
                           PMNIST_LAST["M"], PMNIST_LAST["B"]),
    "ragged": (2, 3, 5, 50, 301),
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


def bound(flops: float, nbytes: float, precision: str = "f32"):
    """The least ms for this work on the H100 and what sets it, at the
    H100 peaks of ``utils.flops`` (``bound_s``): operations at
    ``precision``'s rate, bytes at the memory rate."""
    from vargp_tpu_torch.utils.flops import bound_s

    t, by = bound_s(flops, nbytes, precision)
    return t * 1e3, by


def work(cost) -> dict:
    """kernel_times' ``flops``, ``nbytes`` and ``precision`` from an
    operator's cost (``build.cost``): what the FLOP audit bills it by."""
    return dict(flops=float(cost.flops), nbytes=float(cost.bytes), precision=cost.precision)


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
        K, n = launched(sym_gram, z, invs, gamma2)
        if n != {"vargp_sym_gram": 1}:
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
        Kx, n = launched(cross_gram, z, x, invs2, gamma2)
        if n != {"vargp_cross_gram": 1}:
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
        L, n = launched(diag_chol, A)
        if n != {"vargp_diag_chol": 1}:
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
        K, n = launched(sym_gram_tri, z, invs, gamma2)
        if n != {"vargp_sym_gram_tri": 1}:
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
        K, n = launched(rbf_gram, a, b, g)
        if n != {k5_symbol(a, b): 1}:
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


def tri_mm_inputs(rng, H, O, S, N, dev):
    """K9's operands as the predictive marginal makes them: L^-1 of the
    chain's RBF Gram (K1, the jitter, the default blocked factorisation)
    and K_zx against N rows (K4), from gram_inputs at D = 784."""
    from vargp_tpu_torch.gpmath import add_jitter
    from vargp_tpu_torch.ops import dispatch
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram

    z, x, invs, invs2, gamma2 = gram_inputs(rng, O, S, FLAGSHIP["D"], H, N, dev)
    _, L_inv = dispatch.chol_and_inv(add_jitter(sym_gram(z, invs, gamma2)))
    return L_inv.contiguous(), cross_gram(z, x, invs2, gamma2)


def check_tri_mm(dev) -> tuple:
    """K9 at each TRI_MM_SHAPES shape on the marginal's own operands: one
    launch a call; against the dense f32 product (its plain version) and
    against float64, within F64_RATIO times the dense product's error
    (a 1xTF32 control must fail that limit); with NaN filled into L's
    strictly-upper triangle, finite and bitwise equal to its product with
    tril(L).  Returns the largest error against the plain version, the
    float64 errors and each shape's timing case (kernel_times' arguments)."""
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda.tri_mm import tri_mm, tri_mm_plain

    def tril_mm(L, X):  # the triangular product in any precision
        return torch.matmul(torch.tril(L), X)

    def tril_mm_1xtf32(L, X):
        return torch.matmul(tf32(torch.tril(L)), tf32(X))

    rng = np.random.default_rng(SEED + 9)
    err, f64, cases = 0.0, {}, {}
    for label, (H, O, S, N) in TRI_MM_SHAPES.items():
        L, X = tri_mm_inputs(rng, H, O, S, N, dev)
        got, n = launched(tri_mm, L, X)
        if n != {"vargp_tri_mm": 1}:
            raise AssertionError(f"tri_mm at {label}: launches {n}, expected one")
        plain = tri_mm_plain(L, X)
        e = max_abs_err(got, plain)
        scale = float(plain.abs().max())  # the limit is relative to W's largest entry
        check(f"tri_mm (K9) at {label} {(H, O, S, N)}, against the dense f32 product", e,
              TOL_GRAM * scale, scale)
        err = max(err, e)
        f64[label] = check_f64(f"tri_mm (K9) at {label}", got, tril_mm, tril_mm_1xtf32, (L, X))
        upper = torch.ones(S, S, dtype=torch.bool, device=dev).triu(1)
        poisoned = L.masked_fill(upper, float("nan"))
        tril_got, nan_got = tri_mm(torch.tril(L), X), tri_mm(poisoned, X)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(nan_got).all()) and torch.equal(nan_got, tril_got)
                and torch.equal(got, tril_got)):
            raise AssertionError(f"tri_mm at {label}: with NaN above L's diagonal the product is "
                                 "not finite or not bitwise its product with tril(L)")
        print(f"  tri_mm (K9) at {label}: NaN above the diagonal: finite, bitwise the tril(L) "
              "product")
        cases[label] = dict(
            shape=[H, O, S, N], fn=functools.partial(tri_mm, L, X),
            plain=functools.partial(tri_mm_plain, L, X),
            library=functools.partial(torch.matmul, L, X),
            **work(build.cost("tri_mm", L.shape, X.shape)))
    return err, f64, cases


def moments_inputs(rng, H, O, T, M, B, dev):
    """K10's operands as the predictive marginal makes them: W = L^-1 K_zx
    by K9 from tri_mm_inputs' way (K1, the jitter, the blocked
    factorisation, K4 at D = 784), the factored posterior's v and w from a
    random u_mean and a u_tril unpacked from its vector (w lower
    triangular), and Kxx = gamma2 (H, 1, 1)."""
    from vargp_tpu_torch.gpmath import add_jitter, ar_joint_posterior_factored, vec2tril
    from vargp_tpu_torch.ops import dispatch
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram
    from vargp_tpu_torch.ops.cuda.tri_mm import tri_mm

    S = T * M
    z, x, invs, invs2, gamma2 = gram_inputs(rng, O, S, FLAGSHIP["D"], H, B, dev)
    L, L_inv = dispatch.chol_and_inv(add_jitter(sym_gram(z, invs, gamma2)))
    t = lambda a: torch.tensor(a.astype(np.float32), device=dev)  # noqa: E731
    u_means = [t(rng.standard_normal((O, M, 1)) * 0.5) for _ in range(T)]
    u_trils = [vec2tril(t(rng.standard_normal((O, M * (M + 1) // 2)) * 0.1), M) for _ in range(T)]
    post = ar_joint_posterior_factored(L, L_inv, u_means, u_trils)
    W = tri_mm(L_inv.contiguous(), cross_gram(z, x, invs2, gamma2))
    return W, post.v.contiguous(), post.w.contiguous(), gamma2[:, None, None].contiguous()


def check_marginal_moments(dev) -> tuple:
    """K10 at each MOMENTS_SHAPES shape on the marginal's own operands: one
    launch a call; against its plain version (the dense chain the marginal
    took before it) and against float64, f_mean and f_var each within
    F64_RATIO times the f32 chain's error (a chain whose C_t = w_t^T W_t is
    1xTF32 must fail that limit on f_var); with NaN filled into w's strictly
    upper triangles, finite and bitwise its result on tril(w).  Returns the
    largest error against the plain version (relative to the largest
    f_var), the float64 errors and each shape's timing case."""
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda.marginal_moments import marginal_moments, marginal_moments_plain

    def chain_1xtf32(W, v, w, kxx):  # the chain with its task products in one TF32 term
        T, M = w.shape[-3], w.shape[-1]
        C = torch.matmul(tf32(w.transpose(-1, -2)), tf32(W.reshape(*W.shape[:-2], T, M, -1)))
        return (torch.einsum("...mi,...mb->...b", v, W),
                torch.clamp(kxx - torch.sum(W * W, dim=-2) + torch.sum(C * C, dim=(-3, -2)),
                            min=0.0))

    rng = np.random.default_rng(SEED + 10)
    err, f64, cases = 0.0, {}, {}
    for label, (H, O, T, M, B) in MOMENTS_SHAPES.items():
        args = moments_inputs(rng, H, O, T, M, B, dev)
        got, n = launched(marginal_moments, *args)
        if n != {"vargp_marginal_moments": 1}:
            raise AssertionError(f"marginal_moments at {label}: launches {n}, expected one")
        plain = marginal_moments_plain(*args)
        scale = float(plain[1].abs().max())
        e = max(max_abs_err(a, b) for a, b in zip(got, plain))
        check(f"marginal_moments (K10) at {label} {(H, O, T, M, B)}, against the f32 chain", e,
              TOL_GRAM * scale, scale)
        err = max(err, e / scale)
        ref = marginal_moments_plain(*(a.double() for a in args))
        control = chain_1xtf32(*args)
        f64[label] = {}
        for i, name in enumerate(("f_mean", "f_var")):
            errs = {"kernel": max_abs_err(got[i], ref[i]), "plain_f32": max_abs_err(plain[i], ref[i]),
                    "control_1xtf32": max_abs_err(control[i], ref[i])}
            limit = F64_RATIO * errs["plain_f32"]
            print(f"  marginal_moments (K10) at {label}, {name} against float64: max abs err kernel "
                  f"{errs['kernel']:.3e}, f32 chain {errs['plain_f32']:.3e}, 1xTF32 C control "
                  f"{errs['control_1xtf32']:.3e} (limit {limit:.3e})")
            if not errs["kernel"] <= limit:
                raise AssertionError(f"marginal_moments at {label}: {name} {errs['kernel']} from "
                                     f"float64, above {F64_RATIO}x the f32 chain's "
                                     f"{errs['plain_f32']}")
            if name == "f_var" and not errs["control_1xtf32"] > limit:
                raise AssertionError(f"marginal_moments at {label}: the 1xTF32 control passed the "
                                     f"float64 limit {limit}: the check cannot tell C in f32 "
                                     "from C in TF32")
            f64[label][name] = errs
        W, v, w, kxx = args
        upper = torch.ones(M, M, dtype=torch.bool, device=dev).triu(1)
        tril_got = marginal_moments(W, v, torch.tril(w), kxx)
        nan_got = marginal_moments(W, v, w.masked_fill(upper, float("nan")), kxx)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(a).all()) and torch.equal(a, b) and torch.equal(b, c)
                   for a, b, c in zip(nan_got, tril_got, got)):
            raise AssertionError(f"marginal_moments at {label}: with NaN above w's diagonal the "
                                 "result is not finite or not bitwise its result on tril(w)")
        print(f"  marginal_moments (K10) at {label}: NaN above w's diagonal: finite, bitwise the "
              "tril(w) result")
        plain_fn = functools.partial(marginal_moments_plain, *args)
        # one_kernel off: where W or w goes in padded, the copies' launches are the call's too;
        # the chain's CUDA-event time beside K10's event_ms, where the host sets both paces
        cases[label] = dict(
            shape=[H, O, T, M, B], fn=functools.partial(marginal_moments, *args),
            plain=plain_fn, plain_event_ms=time_ms(plain_fn), one_kernel=False,  # library too
            **work(build.cost("marginal_moments", *(a.shape for a in args))))
    return err, f64, cases


def profile_moments_chain(dev) -> dict:
    """``utils.profiling.profile_fn`` on the dense chain that K10 replaces
    (the marginal after W, as the parent tree ran it) at P-MNIST's predict
    shape: its device events by name, each one's ms per call, and the sum."""
    from vargp_tpu_torch.ops.cuda.marginal_moments import marginal_moments_plain
    from vargp_tpu_torch.utils.profiling import profile_fn

    args = moments_inputs(np.random.default_rng(SEED + 12), *MOMENTS_SHAPES["P-MNIST predict"], dev)
    prof = profile_fn(marginal_moments_plain, *args, iters=10, top=20)
    print(f"  the dense chain at P-MNIST predict {MOMENTS_SHAPES['P-MNIST predict']}: "
          f"{prof['events_per_call']:.2f} events, {prof['busy_ms']:.4f} device ms a call")
    for k, v in prof["top"].items():
        print(f"    {v:.5f} ms  {prof['launches_per_call'].get(k, 0):.1f}x  {k}")
    return prof


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
        L, n = launched(diag_chol_chunked, junk_above(K))
        if n != {"vargp_diag_chol_chunked": 1}:
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
        L, n7 = launched(cholesky, junk_above(K))
        (L6, X), n6 = launched(chol_inv, junk_above(K))
        if (n7, n6) != ({"vargp_chol": 1}, {"vargp_chol_inv": 1}):
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


# each launch counter and the launcher symbols it sums in
# vargp_tpu_torch.utils.tracing.LAUNCHES: rbf_gram every K5 launch,
# rbf_gram_sym those of its symmetric kernel (above SMALL_D features; the
# small kernel serves self- and cross Grams alike)
COUNTERS = {
    "sym_gram": ("vargp_sym_gram",), "sym_gram_tri": ("vargp_sym_gram_tri",),
    "diag_chol": ("vargp_diag_chol",), "cross_gram": ("vargp_cross_gram",),
    "rbf_gram": ("vargp_rbf_gram", "vargp_rbf_gram_sym", "vargp_rbf_gram_small"),
    "rbf_gram_sym": ("vargp_rbf_gram_sym",), "chol_inv": ("vargp_chol_inv",),
    "cholesky": ("vargp_chol",), "diag_chol_chunked": ("vargp_diag_chol_chunked",),
    "tri_mm": ("vargp_tri_mm",), "marginal_moments": ("vargp_marginal_moments",),
}


def launched(fn, *args):
    """``fn(*args)`` with the card synchronised after it, and the launches it
    made: (its result, {launcher symbol: launches})."""
    from vargp_tpu_torch.utils import tracing

    before = tracing.LAUNCHES.copy()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(tracing.LAUNCHES - before)


def k5_symbol(a, b) -> str:
    """The launcher K5 takes for rbf_gram(a, b): the small kernel up to
    SMALL_D features, else the symmetric kernel for one tensor and the
    cross kernel for two."""
    from vargp_tpu_torch.ops.cuda.rbf_gram import SMALL_D

    if a.shape[-1] <= SMALL_D:
        return "vargp_rbf_gram_small"
    return "vargp_rbf_gram_sym" if a is b else "vargp_rbf_gram"


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
    """Every launch counter: counter name -> the launcher symbols it sums."""
    return COUNTERS


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
    from vargp_tpu_torch.utils import tracing

    tracing.LAUNCHES.clear()


def read_counts():
    from vargp_tpu_torch.utils import tracing

    return {n: sum(tracing.LAUNCHES[k] for k in keys) for n, keys in COUNTERS.items()}


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
        # the marginal of loss and of predict takes K9 for W = L^-1 K_zx (the
        # flagship's parameters record no gradient) wherever the posterior
        # keeps L^-1 factored; the solve route's materialised one does not
        # and W's readers take K10 (marginal_moments) there too
        want["tri_mm"] = want["marginal_moments"] = 0 if route == "solve" else 2
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
    from vargp_tpu_torch.utils import tracing
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
    tracing.POSTERIOR.clear()
    t0 = time.perf_counter()
    acc, ent = A.accuracy_entropy_matrices(chain, cfg, test_sets, seed=a["seed"], n_f=a["n_f"],
                                           n_var_samples=a["n_var_samples"],
                                           batch_size=a["batch_size"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    posteriors = dict(tracing.POSTERIOR)
    n_batches = sum(-(-len(ts) // a["batch_size"]) for ts in test_sets) * T
    n_cells = T * len(test_sets)
    print(f"  test splits: {[len(ts) for ts in test_sets]} rows, made in {t_data:.3f} s")
    print(f"  accuracy matrix: {np.round(acc, 4).tolist()}")
    print(f"  entropy matrix: {np.round(ent, 4).tolist()}")
    print(f"  analysis wall time {wall:.3f} s for {n_batches} predict calls at H={a['n_var_samples']}, "
          f"n_f={a['n_f']}; launches {launches}")
    print(f"  predict's chain posteriors: {posteriors.get('build', 0)} built, "
          f"{posteriors.get('reuse', 0)} reused ({n_cells} cells, one noise draw a cell)")
    if posteriors != {"build": n_cells, "reuse": n_batches - n_cells}:
        raise AssertionError(f"analysis: posteriors {posteriors}, expected {n_cells} builds and "
                             f"{n_batches - n_cells} reuses")
    if acc.shape != (T, T) or not (np.isfinite(acc).all() and np.isfinite(ent).all()):
        raise AssertionError("analysis: matrices of the wrong shape or not finite")
    if acc.min() < 0 or acc.max() > 1 or ent.min() < 0 or ent.max() > 1 + 1e-6:
        raise AssertionError("analysis: accuracy or normalised entropy outside [0, 1]")
    want = {k: 0 for k in counters()}
    # each cell's posterior builds K_zz (K5, symmetric) and its factor (K3
    # three times) once; each batch launches K_zx (K5)
    want.update(rbf_gram=n_batches + n_cells, rbf_gram_sym=n_cells, diag_chol=3 * n_cells,
                tri_mm=n_batches,  # and each batch's W = L^-1 K_zx (K9)
                marginal_moments=n_batches)  # and W's readers (K10)
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
    # and every step and evaluated batch one K_zx (K4); every evaluated batch
    # (no gradient) W = L^-1 K_zx by K9 and W's readers by K10
    want = {k: 0 for k in counters()}
    n_post = rec["steps"] + len(rec["split_ms"])
    want.update(sym_gram=n_post, diag_chol=3 * n_post, cross_gram=rec["steps"] + rec["batches"],
                tri_mm=rec["batches"], marginal_moments=rec["batches"])
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
                split_ms=float(np.mean(rec["split_ms"])), wall_s=wall, acc=acc,
                summaries=summaries)


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
            TL.GeneratorDraws(torch.Generator(device=dev).manual_seed(seed)).block(
                dx.shape[0], B, 1, t["cfg"], len(t["prev"])), 3)
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
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol

    out = {}
    for label, A in blocks.items():
        b_ms, b_by = bound(*build.cost("diag_chol", A.shape))
        fn, lib = (lambda: diag_chol(A)), (lambda: torch.linalg.cholesky(A))
        out[label] = {"ms": device_ms(fn, one_kernel=True), "event_ms": time_ms(fn), "cold_ms": cold_ms(fn),
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(lib),
                      "library_event_ms": time_ms(lib), "row_stride": A.stride(-2)}
        print(f"  diag_chol (K3) at {label}: " + "  ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}" for k, v in out[label].items()))
    return out


def kernel_times(fn, plain, flops, nbytes, library=None, precision="f32", one_kernel=True,
                 **info) -> dict:
    """One kernel's numbers at one shape: ``info`` (its shape, say), then
    its device time per call (``device_ms``, per traced launch when ``fn``
    launches one kernel), CUDA events around back-to-back calls, cold, the
    plain version's and the library call's device times (the plain
    version's where the library call is the plain version, ``library``
    None), the bound at ``precision``'s peak (and, where that is another,
    at the f32 rate), the work and the effective TFLOP/s."""
    ms = device_ms(fn, one_kernel=one_kernel)
    plain_ms = device_ms(plain, reps=5, warmup=1)
    t = dict(info, ms=ms, event_ms=time_ms(fn), cold_ms=cold_ms(fn), plain_ms=plain_ms,
             library_ms=plain_ms if library is None else device_ms(library))
    t["bound_ms"], t["bound_by"] = bound(flops, nbytes, precision)
    if precision != "f32":
        t["bound_f32_ms"], t["bound_f32_by"] = bound(flops, nbytes)
    t.update(gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / ms / 1e9)
    return t


def fmt_times(t: dict) -> str:
    return "  ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}" for k, v in t.items())


def gram_case(n, H, O, S, B, D, rng, dev) -> dict:
    """Gram kernel ``n`` (sym_gram K1, sym_gram_tri K2, cross_gram K4 or
    rbf_gram K5) at one shape of GRAM_SHAPES, as kernel_times takes it: the
    kernel, its plain version and the yardstick (``cdist`` + ``exp`` on
    inputs scaled beforehand), the operations and bytes of the wrapper's
    cost function (a symmetric Gram's mirrored pairs once; inputs read
    once, the output written once), at the 3xTF32 rate the kernels multiply
    at.  K5 takes G = H * O Grams of features (K_zz when B = 0: the
    symmetric mode)."""
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
    from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

    if n == "rbf_gram":
        G = H * O
        sz, sx, g2 = dkl_features(rng, G, S, max(B, 1), D, dev)
        g3 = g2[:, None, None]
        other, N = (sz, S) if B == 0 else (sx, B)
        return dict(
            shape=[G, S, N, D], fn=lambda: rbf_gram(sz, other, g2),
            plain=lambda: rbf_gram_plain(sz, other, g2),
            library=lambda: g3 * torch.exp(-0.5 * torch.cdist(sz, other).square()),
            **work(build.cost("rbf_gram_sym", sz.shape, g2.shape) if B == 0
                   else build.cost("rbf_gram", sz.shape, other.shape, g2.shape)))
    z, x, invs, invs2, gamma2 = gram_inputs(rng, O, S, D, H, max(B, 1), dev)
    g4 = gamma2[:, None, None, None]
    if n in ("sym_gram", "sym_gram_tri"):
        kernel = sym_gram if n == "sym_gram" else sym_gram_tri
        sz = (z[None] * invs[:, None, None, :]).reshape(H * O, S, D)
        return dict(
            shape=[H, O, S, D], fn=lambda: kernel(z, invs, gamma2),
            plain=lambda: sym_gram_plain(z, invs, gamma2),
            library=lambda: g4 * torch.exp(-0.5 * torch.cdist(sz, sz).square().view(H, O, S, S)),
            **work(build.cost(n, z.shape, invs.shape, gamma2.shape)))
    zw = (z[None] * invs2.sqrt()[:, None, None, :]).reshape(H * O, S, D)
    xw = (x[None] * invs2.sqrt()[:, None, :])[:, None].expand(H, O, B, D).reshape(H * O, B, D)
    return dict(
        shape=[H, O, S, B, D], fn=lambda: cross_gram(z, x, invs2, gamma2),
        plain=lambda: cross_gram_plain(z, x, invs2, gamma2),
        library=lambda: g4 * torch.exp(-0.5 * torch.cdist(zw, xw).square().view(H, O, S, B)),
        **work(build.cost("cross_gram", z.shape, x.shape, invs2.shape, gamma2.shape)))


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


# ---------------------------------------------------------------------------
# the global continual SVGP
# ---------------------------------------------------------------------------


def pixel_rows(rng, n: int, D: int = 784) -> np.ndarray:
    """n rows of the synthetic MNIST surrogate's test split (every run of
    it makes the same rows from its numpy seed), drawn by ``rng``; the
    toy's rows for D = 2."""
    from vargp_tpu_torch import data

    ds = data.load_mnist(None, train=False) if D == 784 else data.make_toy_dataset(seed=0)
    return ds.data[rng.integers(0, len(ds), n)]


def global_gram_inputs(rng, G, S, N, D, device):
    """K5's inputs at a global shape: G sets of S rows (and N more) of
    pixels or toy points, each set scaled by its own lengthscales, near
    half the rows' median distance (so the Gram spreads over (0, gamma2))
    and varying by 20% across the features, and gamma2 (G,) near 7 (the
    minted S-MNIST global run's).  A self-Gram's rows repeat their first
    half (z and the previous task's rows, equal at a task's start)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    rows = pixel_rows(rng, G * (S + N), D).reshape(G, S + N, D)
    if N == 0:
        rows[:, S // 2:S] = rows[:, :S - S // 2]
    d = np.sqrt(np.median(np.sum((rows[0, :32, None] - rows[0, None, :32]) ** 2, axis=-1)))
    ls = 0.5 * d * np.exp(0.2 * rng.standard_normal((G, 1, D)))
    scaled = rows / ls
    gamma2 = t(np.exp(np.log(7.0) + 0.2 * rng.standard_normal(G)))
    sz = t(scaled[:, :S])
    return sz, (sz if N == 0 else t(scaled[:, S:])), gamma2


def check_k5_global(dev):
    """K5 at the global path's shapes (GLOBAL_GRAMS) against its plain
    version and against float64 (check_f64, self-Grams off the diagonal),
    each launch counted and its kernel told by the counters; every
    self-Gram bitwise symmetric with gamma2 on its diagonal.  Returns the
    largest error, the float64 errors and the inputs for timing."""
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain

    rng = np.random.default_rng(SEED + 8)
    err, f64, inputs = 0.0, {}, {}
    for label, (G, S, N, D) in GLOBAL_GRAMS.items():
        a, b, g = global_gram_inputs(rng, G, S, N, D, dev)
        inputs[label] = (a, b, g)
        sym = a is b
        K, n = launched(rbf_gram, a, b, g)
        if n != {k5_symbol(a, b): 1}:
            raise AssertionError(f"K5 {label}: the wrong launch (symmetric expected: {sym})")
        ref = rbf_gram_plain(a, b, g)
        e = max_abs_err(K, ref)
        check(f"K5 rbf_gram {label} {tuple(K.shape)} (D = {D}, "
              f"{'symmetric' if sym else 'cross'} launch)", e, TOL_GRAM * float(g.max()),
              float(ref.abs().max()))
        eye = check_symmetric(f"K5 {label}", K, ref, g) if sym else None
        err = max(err, e)
        f64[label] = check_f64(f"K5 rbf_gram {label}{', off the diagonal' if sym else ''}", K,
                               rbf_gram_plain, rbf_gram_1xtf32, (a, b, g),
                               keep=None if eye is None else ~eye)
        del K, ref
    return err, f64, inputs


def check_k7_global(dev):
    """K7 at the global path's factor shapes (GLOBAL_CHOL) against its
    plain version, junk above the diagonal (only the lower triangle is
    read), each launch counted.  Returns the largest error and the inputs
    for timing."""
    from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain

    rng = np.random.default_rng(SEED + 9)
    err, inputs = 0.0, {}
    for label, (G, S) in GLOBAL_CHOL.items():
        K = spd_blocks(rng, G, dev, S)
        L, n = launched(cholesky, junk_above(K))
        if n != {"vargp_chol": 1}:
            raise AssertionError("K7's launch counter did not count its launch")
        ref = cholesky_plain(K)
        e = max_abs_err(L, ref)
        check(f"K7 cholesky {label} {tuple(K.shape)}", e, TOL_CHOL, float(ref.abs().max()))
        err = max(err, e)
        inputs[label] = K
    return err, inputs


def global_inputs(name, device, seed=SEED):
    """The global model at GLOBAL_STEP[name] on ``device`` with a previous
    task, from a numpy seed: prev.z the surrogate's rows, z their copy
    moved by N(0, 0.01) per pixel, lengthscales near half the rows' median
    distance, random variational parameters; the step's batch and noise."""
    from vargp_tpu_torch.gpmath import tril_size, vec2tril
    from vargp_tpu_torch.kernels import RBFParams, RBFPrior
    from vargp_tpu_torch.models import global_svgp as G
    from vargp_tpu_torch.train import loop as TL

    f = GLOBAL_STEP[name]
    O, M, D, B, H, n_f = f["O"], f["M"], f["D"], f["B"], f["H"], f["n_f"]
    cfg = G.GlobalSVGPConfig(M=M, out_size=O, in_size=D, n_f=n_f, n_var_samples=H)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    prev_z = pixel_rows(rng, O * M).reshape(O, M, D)
    rows = pixel_rows(rng, 64)
    d = np.sqrt(np.median(np.sum((rows[:, None] - rows[None]) ** 2, axis=-1)))
    log_ls = np.log(0.5 * d) + 0.05 * rng.standard_normal(D)
    n_tri = tril_size(M)
    prev = G.GlobalPrev(
        z=t(prev_z), u_mean=t(rng.standard_normal((O, M, 1)) * 0.5),
        u_tril=vec2tril(t(rng.standard_normal((O, n_tri)) * 0.1)))
    mean = np.concatenate([log_ls, [np.log(2.0)]])
    params = G.GlobalSVGPParams(
        z=t(prev_z + 0.01 * rng.standard_normal(prev_z.shape)),
        u_mean=t(rng.standard_normal((O, M, 1)) * 0.5),
        u_tril_vec=t(np.eye(M)[np.tril_indices(M)] + 0.1 * rng.standard_normal((O, n_tri))),
        kernel=RBFParams(t(mean), t(np.full(D + 1, -2.0))))
    prior = RBFPrior(t(mean + 0.1 * rng.standard_normal(D + 1)), t(np.full(D + 1, -1.0)))
    x = t(pixel_rows(rng, B))
    y = torch.tensor(rng.integers(0, O, B), device=device)
    noise = {"hyper_eps": t(rng.standard_normal((H, D + 1))),
             "lik_eps": t(rng.standard_normal((H, n_f, O, B))),
             "reg_eps": t(rng.standard_normal((H, H, O, M)))}
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=f["lr"]))
    return dict(cfg=cfg, params=params, prev=prev, prior=prior, x=x, y=y, noise=noise,
                w=torch.ones(B, device=device), n_train=f["n_train"], beta=f["beta"], opt=opt,
                device=device)


def global_grads(t):
    """The global ELBO's four pieces and every parameter leaf's gradient."""
    from vargp_tpu_torch.models import global_svgp as G
    from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(t["params"])]
    pieces = G.loss(tree_unflatten(t["params"], leaves), t["prev"], t["prior"], t["x"], t["y"],
                    t["noise"], t["cfg"], weights=t["w"], device=t["device"])
    klh, klu, upr, nll = pieces
    total = t["beta"] * klh + klu - upr + t["n_train"] / float(t["x"].shape[0]) * nll
    return [v.detach() for v in pieces], torch.autograd.grad(total, leaves)


def global_step(t):
    from vargp_tpu_torch.train import loop as TL
    from vargp_tpu_torch.train import loop_global as TLG

    return TL.gradient_step(
        t["params"], t["opt"].init(t["params"]),
        lambda p: TLG.elbo(p, t["prev"], t["prior"], t["x"], t["y"], t["w"], t["noise"],
                           cfg=t["cfg"], beta=t["beta"], n_train=t["n_train"],
                           device=t["device"]),
        t["opt"])


def check_global_step(name, dev):
    """One global elbo_step on the card with its launches counted; the four
    ELBO pieces and every gradient against the CPU's on the same inputs
    and noise.  Returns the step's launches."""
    t, c = global_inputs(name, dev), global_inputs(name, torch.device("cpu"))
    reset_counts()
    _, _, loss, _ = global_step(t)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  {name}: one elbo_step, launches {launches}, loss {float(loss)!r}")
    want = {k: 0 for k in counters()}
    want.update(GLOBAL_LAUNCHES)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    pieces, grads = global_grads(t)
    cpu_pieces, cpu_grads = global_grads(c)
    names = leaf_names(t["params"])
    for n, g, r in zip(("kl_hypers", "kl_u", "u_prev_reg", "nll"), pieces, cpu_pieces):
        g, r = float(g), float(r)
        rel = abs(g - r) / max(abs(r), 1e-30)
        print(f"  {name} {n}: card {g!r} cpu {r!r}, rel err {rel:.3e} (tol {TOL_E2E_REL:.0e})")
        if not (rel <= TOL_E2E_REL and math.isfinite(g)):
            raise AssertionError(f"{name} {n}: card and CPU differ by {rel} (relative)")
    for leaf, g, r in zip(names, grads, cpu_grads):
        scale = float(r.abs().max())
        rel = max_abs_err(g.cpu(), r) / max(scale, 1e-30)
        print(f"  {name} d ELBO / d {leaf}: max abs err / largest magnitude {rel:.3e} "
              f"(largest {scale:.3e}, tol {TOL_GRAD_REL:.0e})")
        if not (rel <= TOL_GRAD_REL and bool(torch.isfinite(g).all())):
            raise AssertionError(f"{name}: gradient of {leaf} differs by {rel}")
    return launches


@contextlib.contextmanager
def recorded_global(dev):
    """Wrap the global drivers' ``train_task``, train block, evaluation
    function and the analysis's draws so that each call is recorded (each
    evaluated split timed between two synchronisations); the functions
    run unchanged."""
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.experiments import global_run
    from vargp_tpu_torch.train import loop_global as TLG

    rec = {"infos": [], "steps": 0, "split_ms": [], "batches": 0, "last_split": None,
           "draws": []}
    orig = (global_run.train_task, TLG.step_block, TLG.make_device_eval_fn_global, A.eval_draws)

    def train_task(*a, **kw):
        params, info = orig[0](*a, **kw)
        rec["infos"].append(info)
        return params, info

    def train_block(*a, **kw):
        out = orig[1](*a, **kw)
        rec["steps"] += out[2].numel()
        return out

    def make_eval_fn(*a, **kw):
        fn = orig[2](*a, **kw)

        def eval_acc(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["split_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["batches"] += args[2].shape[0]
            rec["last_split"] = (args, out)
            return out

        return eval_acc

    def eval_draws(*a, **kw):
        for d in orig[3](*a, **kw):
            rec["draws"].append(d)
            yield d

    global_run.train_task, TLG.step_block, TLG.make_device_eval_fn_global = (
        train_task, train_block, make_eval_fn)
    A.eval_draws = eval_draws
    try:
        yield rec
    finally:
        (global_run.train_task, TLG.step_block, TLG.make_device_eval_fn_global,
         A.eval_draws) = orig


def check_global_protocol(dev, smi):
    """s_mnist_global's first two tasks through the drivers' entry point on
    the card (the launches counted around the run): the evaluation
    cadence, task 0's validation accuracy, every logged scalar finite, the
    last evaluated split replayed on the CPU from its own draws; then the
    chain reload: ``analyze_smnist_global`` on the saved checkpoints on the
    card, and again on the CPU with the card's draws."""
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.experiments import global_run
    from vargp_tpu_torch.models import global_svgp as G
    from vargp_tpu_torch.train import loop as TL
    from vargp_tpu_torch.train import loop_global as TLG

    pr = GLOBAL_PROTOCOL
    T = pr["n_tasks"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        with recorded_global(dev) as rec:
            reset_counts()
            t0 = time.perf_counter()
            params, summaries = global_run.split_mnist(
                n_tasks=T, epochs=pr["epochs"], eval_interval=pr["eval_interval"],
                seed=pr["seed"], log_dir=d, device=dev)
            torch.cuda.synchronize()
            run_wall = time.perf_counter() - t0
            launches = read_counts()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        sps = [info["steps_per_sec"] for info in rec["infos"]]
        print(f"  s_mnist_global, {T} tasks, {pr['epochs']} epochs: {run_wall:.3f} s, "
              f"{rec['steps']} train steps, {len(rec['split_ms'])} evaluated splits "
              f"({rec['batches']} batches); launches {launches}")
        print(f"  train_task steps_per_sec per task {sps}; ms per evaluated split (a predict "
              f"per batch) mean {np.mean(rec['split_ms']):.3f}, min {min(rec['split_ms']):.3f}, "
              f"max {max(rec['split_ms']):.3f}; {smi}")
        if not all(math.isfinite(r["value"]) for r in rows):
            raise AssertionError("global protocol: a logged scalar is not finite")
        for t in range(T):
            evals = [(r["step"], r["value"]) for r in rows if r["tag"] == f"task{t}/val/acc"]
            reg = [r["value"] for r in rows if r["tag"] == f"task{t}/loss/u_prev_reg"]
            print(f"  task {t}: validation accuracy at its evaluations {evals}; u_prev_reg {reg}; "
                  f"best {summaries[t]}")
            if [e for e, _ in evals] != pr["eval_epochs"]:
                raise AssertionError(f"global protocol task {t}: evaluations at epochs {evals}")
            if (t == 0) != all(v == 0.0 for v in reg):
                raise AssertionError(f"global protocol task {t}: u_prev_reg {reg}")
        val0 = dict((r["step"], r["value"]) for r in rows
                    if r["tag"] == "task0/val/acc")[pr["epochs"]]
        if not val0 >= pr["min_val_acc"]:
            raise AssertionError(f"global protocol: task 0 validation accuracy {val0} at epoch "
                                 f"{pr['epochs']}, expected >= {pr['min_val_acc']}")
        # a step: K5 twice (one symmetric), K7 once at task 0 and three times
        # after; an evaluated batch: K5 twice (one symmetric), K7 once
        steps0 = rec["infos"][0]["steps"]
        steps1 = rec["steps"] - steps0
        want = {k: 0 for k in counters()}
        want.update(rbf_gram=2 * (rec["steps"] + rec["batches"]),
                    rbf_gram_sym=rec["steps"] + rec["batches"],
                    cholesky=steps0 + 3 * steps1 + rec["batches"])
        if launches != want:
            raise AssertionError(f"global protocol: launches {launches}, expected {want}")

        # the last evaluated split (task 1's test split) again on the CPU
        args, (count, total) = rec["last_split"]
        cfg = G.GlobalSVGPConfig(M=FLAGSHIP["M"], out_size=FLAGSHIP["O"], in_size=FLAGSHIP["D"])
        hp = TL.TrainHyperparams()
        cpu_args = to_cpu(args)
        cpu_count, _ = TLG.make_device_eval_fn_global(cfg, hp)(*cpu_args, device="cpu")
        p, prev, xs, ys, ws, draws = args
        with torch.no_grad():
            b0 = {k: v[0] for k, v in draws.items()}
            card_b0 = G.predict(p, prev, xs[0], b0, cfg, device=dev).cpu()
            cpu_b0 = G.predict(*to_cpu((p, prev, xs[0], b0)), cfg, device="cpu")
        check("global protocol: the last evaluated split's first batch, card vs CPU",
              max_abs_err(card_b0, cpu_b0), TOL_PROBS, float(cpu_b0.max()))
        diff = abs(float(count) - float(cpu_count))
        print(f"  that split's correct count: card {float(count)} CPU {float(cpu_count)} of "
              f"{float(total):.0f} rows (tol {pr['count_tol']:.0e} of the rows)")
        if not diff <= pr["count_tol"] * float(total):
            raise AssertionError(f"global protocol: correct counts differ by {diff}")

        # the chain reload: the analysis on the card, then on the CPU with
        # the card's draws
        with recorded_global(dev) as rec_a:
            reset_counts()
            t0 = time.perf_counter()
            card = A.analyze_smnist_global(d, n_tasks=T, device=dev)
            torch.cuda.synchronize()
            a_wall = time.perf_counter() - t0
            a_launches = read_counts()
        replay = iter([{k: v.cpu() for k, v in dr.items()} for dr in rec_a["draws"]])
        orig = A.eval_draws
        A.eval_draws = lambda *a, **kw: iter([next(replay)])
        try:
            cpu = A.analyze_smnist_global(d, n_tasks=T, device="cpu",
                                          out_json=os.path.join(d, "analysis_cpu.json"))
        finally:
            A.eval_draws = orig
    acc, cacc = np.asarray(card["acc_matrix"]), np.asarray(cpu["acc_matrix"])
    ent, cent = np.asarray(card["ent_matrix"]), np.asarray(cpu["ent_matrix"])
    print(f"  analyze_smnist_global on the card: {a_wall:.3f} s, launches {a_launches}; accuracy "
          f"matrix {acc.tolist()}, entropy {np.round(ent, 5).tolist()}; the CPU's with the same "
          f"draws: max |dacc| {np.abs(acc - cacc).max()!r}, max |dent| {np.abs(ent - cent).max()!r}")
    if acc.shape != (T, T) or not (np.isfinite(acc).all() and np.isfinite(ent).all()):
        raise AssertionError("global reload: matrices of the wrong shape or not finite")
    if not (np.abs(acc - cacc).max() <= pr["count_tol"] and np.abs(ent - cent).max() <= TOL_PROBS):
        raise AssertionError("global reload: the card's matrices differ from the CPU's")
    wall = time.perf_counter() - t_phase
    print(f"  global protocol phase wall time {wall:.3f} s; {smi}")
    return dict(launches=launches, steps=rec["steps"], steps_per_sec=sps,
                split_ms=float(np.mean(rec["split_ms"])), wall_s=wall, acc=acc,
                analysis_launches=a_launches, analysis_wall_s=a_wall)


def global_kernel_cases(k5_inputs, k7_inputs) -> tuple[dict, dict]:
    """kernel_times cases for K5 at GLOBAL_GRAMS and K7 at GLOBAL_CHOL: the
    kernel, its plain version, the library call (``cdist`` + ``exp``;
    ``torch.linalg.cholesky``), the operations and bytes (inputs read once,
    outputs written once; a self-Gram's mirrored pairs once, K7's S^3/3
    multiply-adds' worth: the wrappers' cost functions) at the 3xTF32
    rate."""
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain

    k5 = {}
    for label, (a, b, g) in k5_inputs.items():
        G, S, D = a.shape
        N = b.shape[1]
        g3 = g[:, None, None]
        k5[label] = dict(
            shape=[G, S, N, D], fn=functools.partial(rbf_gram, a, b, g),
            plain=functools.partial(rbf_gram_plain, a, b, g),
            library=lambda a=a, b=b, g3=g3: g3 * torch.exp(-0.5 * torch.cdist(a, b).square()),
            **work(build.cost("rbf_gram_sym", a.shape, g.shape) if a is b
                   else build.cost("rbf_gram", a.shape, b.shape, g.shape)))
    k7 = {}
    for label, K in k7_inputs.items():
        G, S = K.shape[0], K.shape[-1]
        k7[label] = dict(
            shape=[G, S, S], fn=functools.partial(cholesky, K),
            plain=functools.partial(cholesky_plain, K),
            library=functools.partial(torch.linalg.cholesky, K),
            **work(build.cost("cholesky", K.shape)))
    return k5, k7


def time_global_training(dev):
    """The global step at GLOBAL_STEP's configurations: ms per forward,
    forward + backward and whole step (CUDA events around back-to-back
    calls), the step's launches and device-busy ms under torch.profiler,
    and its idle share (1 - busy / step ms)."""
    from vargp_tpu_torch.models import global_svgp as G

    out = {}
    for name in GLOBAL_STEP:
        t = global_inputs(name, dev)

        def fwd():
            with torch.no_grad():
                return G.loss(t["params"], t["prev"], t["prior"], t["x"], t["y"], t["noise"],
                              t["cfg"], weights=t["w"], device=dev)

        launches, busy = traced_step(lambda: global_step(t))
        step_ms = time_ms(lambda: global_step(t), reps=10)
        out[name] = {"forward_ms": time_ms(fwd, reps=10),
                     "forward_backward_ms": time_ms(lambda: global_grads(t), reps=10),
                     "step_ms": step_ms, "step_launches_traced": launches,
                     "step_device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms}
        print(f"  global step {name}: " + "  ".join(f"{k} {v:.4f}" for k, v in out[name].items()))
    return out


# ---------------------------------------------------------------------------
# the VAR-GP Retrain ablation and the Gaussian-likelihood regression
# ---------------------------------------------------------------------------


def small_gram_inputs(rng, G, S, N, D, device, shared=0):
    """K5's inputs at the Retrain toy's (D = 2: rows of the 4-cluster toy)
    and the regression's (D = 1: its x in [-3, 3]) shapes: G sets of S
    rows (and N more), each set scaled by its own lengthscales near 0.5
    (the toy's initial exp(log 0.5)) varying by 20% across sets and
    features, and gamma2 (G,) near 1.  With ``shared`` the first
    ``shared`` rows of the S repeat the N rows (z_all[:c] = z~ at a task's
    first step)."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.experiments.regression import _make_data

    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    pool = data.make_toy_dataset(seed=0).data if D == 2 else _make_data(
        np.random.default_rng(SEED))[0]
    rows = pool[rng.integers(0, len(pool), G * (S + N))].reshape(G, S + N, D)
    if shared:
        rows[:, :shared] = rows[:, S:S + shared]
    scaled = rows / (0.5 * np.exp(0.2 * rng.standard_normal((G, 1, D))))
    gamma2 = t(np.exp(0.2 * rng.standard_normal(G)))
    sz = t(scaled[:, :S])
    return sz, (sz if N == 0 else t(scaled[:, S:])), gamma2


def check_k5_small(dev):
    """K5's small kernel at the Retrain and regression shapes
    (SMALL_GRAMS) against its plain version and against float64
    (check_f64, self-Grams off the diagonal), each launch counted; every
    self-Gram bitwise symmetric with gamma2 on its diagonal; and the
    shared entries bitwise equal: K(z~, z~) and the rows of K(z_all, z~)
    that z_all shares with z~, as a task's first step hands them over.
    Returns the largest error, the float64 errors and the inputs."""
    from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain

    rng = np.random.default_rng(SEED + 10)
    err, f64, inputs = 0.0, {}, {}
    for label, (G, S, N, D, shared) in SMALL_GRAMS.items():
        a, b, g = small_gram_inputs(rng, G, S, N, D, dev, shared)
        inputs[label] = (a, b, g)
        sym = a is b
        K, n = launched(rbf_gram, a, b, g)
        if n != {k5_symbol(a, b): 1}:
            raise AssertionError(f"K5 {label}: the wrong launch (symmetric expected: {sym})")
        ref = rbf_gram_plain(a, b, g)
        e = max_abs_err(K, ref)
        check(f"K5 rbf_gram {label} {tuple(K.shape)} (D = {D}, "
              f"{'symmetric' if sym else 'cross'} launch)", e, TOL_GRAM * float(g.max()),
              float(ref.abs().max()))
        eye = check_symmetric(f"K5 {label}", K, ref, g) if sym else None
        err = max(err, e)
        f64[label] = check_f64(f"K5 rbf_gram {label}{', off the diagonal' if sym else ''}", K,
                               rbf_gram_plain, rbf_gram_1xtf32, (a, b, g),
                               keep=None if eye is None else ~eye)
        if shared:
            Ktt = rbf_gram(b, b, g)
            if not torch.equal(K[:, :shared], Ktt):
                raise AssertionError(f"K5 {label}: the rows shared with z~ differ from K(z~, z~) "
                                     f"by {max_abs_err(K[:, :shared], Ktt)}")
            print(f"  K5 {label}: its first {shared} rows (z_all[:c] = z~) bitwise equal to "
                  f"K(z~, z~) {tuple(Ktt.shape)} (the symmetric launch)")
        del K, ref
    return err, f64, inputs


def retrain_inputs(device, task=1, seed=SEED):
    """A toy_retrain step at full width on ``device``, from a numpy seed:
    task 1 (``task=1``) at its first step, the previous task's raw
    parameters (20 toy rows of classes 0-1 a class, random u_mean,
    u_tril_vec near the identity's) trainable again and frozen into the
    snapshot, so the conditional covariance cancels to the jitter; or task
    0 alone.  The kernel near the toy's init, the prior the previous
    kernel's; a batch of the task's 100 rows padded to 512 zero-weight
    rows; the step's noise."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.gpmath import tril_size
    from vargp_tpu_torch.kernels import RBFParams
    from vargp_tpu_torch.models import vargp_retrain as R
    from vargp_tpu_torch.train import loop as TL

    f = RETRAIN_STEP
    O, M, D, B, H, n_f = f["O"], f["M"], f["D"], f["B"], f["H"], f["n_f"]
    cfg = R.RetrainConfig(M=M, out_size=O, in_size=D, n_f=n_f, n_var_samples=H)
    rng = np.random.default_rng(seed + task)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    toy = data.make_toy_dataset(seed=0)
    rows = lambda ds: t(ds.data[rng.integers(0, len(ds), (O, M))])
    eye_vec = np.eye(M)[np.tril_indices(M)]
    chain, prior_from = (), None
    if task:
        chain = (R.TaskRaw(z=rows(data.filter_by_class(toy, [0, 1])),
                           u_mean=t(0.5 * rng.standard_normal((O, M, 1))),
                           u_tril_vec=t(eye_vec + 0.3 * rng.standard_normal((O, tril_size(M))))),)
        prior_from = RBFParams(t(np.log(0.5) + 0.1 * rng.standard_normal(D + 1)),
                               t(np.full(D + 1, -2.5)))
    train = data.filter_by_class(toy, [2 * task, 2 * task + 1])
    params, prior, frozen = R.init_params(t(rng.standard_normal(D + 1)),
                                          t(rng.standard_normal((O, M, 1))), rows(train), cfg,
                                          prev_chain=chain, kernel_prior_from=prior_from)
    x, y, w = TL.pad_dataset_to_device(train.data, train.targets, B, device=device)
    S, c = M * (task + 1), M * task
    noise = {"hyper_eps": t(rng.standard_normal((H, D + 1))),
             "lik_eps": t(rng.standard_normal((H, n_f, O, B)))}
    if task:
        noise["u_eps"] = t(rng.standard_normal((H, H, O, S)))
        noise["ut_eps"] = t(rng.standard_normal((H, H, H, O, c)))
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=f["lr"]))
    return dict(cfg=cfg, params=params, frozen=frozen, prior=prior, x=x, y=y, w=w, noise=noise,
                n_train=float(len(train)), beta=f["beta"], opt=opt, device=device)


def retrain_grads(t):
    """The Retrain ELBO's three pieces and every parameter leaf's gradient."""
    from vargp_tpu_torch.models import vargp_retrain as R
    from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(t["params"])]
    pieces = R.loss(tree_unflatten(t["params"], leaves), t["frozen"], t["prior"], t["x"], t["y"],
                    t["noise"], t["cfg"], weights=t["w"], device=t["device"])
    klh, klu, nll = pieces
    total = t["beta"] * klh + klu + t["n_train"] / float(t["w"].sum()) * nll
    return [v.detach() for v in pieces], torch.autograd.grad(total, leaves)


def retrain_step(t, opt_state=None):
    from vargp_tpu_torch.experiments import retrain_run as RR
    from vargp_tpu_torch.train import loop as TL

    state = t["opt"].init(t["params"]) if opt_state is None else opt_state
    return TL.gradient_step(
        t["params"], state,
        lambda p: RR.elbo(p, t["frozen"], t["prior"], t["x"], t["y"], t["w"], t["noise"],
                          cfg=t["cfg"], beta=t["beta"], n_train=t["n_train"],
                          device=t["device"]),
        t["opt"])


def compare_retrain(label, t, c):
    """The three ELBO pieces and every gradient of ``t`` (the card) against
    ``c`` (the CPU) on the same parameters and noise, to the global step's
    limits."""
    pieces, grads = retrain_grads(t)
    cpu_pieces, cpu_grads = retrain_grads(c)
    for n, g, r in zip(("kl_hypers", "kl_u", "nll"), pieces, cpu_pieces):
        g, r = float(g), float(r)
        rel = abs(g - r) / max(abs(r), 1e-30)
        print(f"  {label} {n}: card {g!r} cpu {r!r}, rel err {rel:.3e} (tol {TOL_E2E_REL:.0e})")
        if not (rel <= TOL_E2E_REL and math.isfinite(g)):
            raise AssertionError(f"{label} {n}: card and CPU differ by {rel} (relative)")
    worst = 0.0
    for leaf, g, r in zip(leaf_names(t["params"]), grads, cpu_grads):
        scale = float(r.abs().max())
        rel = max_abs_err(g.cpu(), r) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not (rel <= TOL_GRAD_REL and bool(torch.isfinite(g).all())):
            raise AssertionError(f"{label}: gradient of {leaf} differs by {rel} of its scale")
    print(f"  {label}: every gradient leaf card vs CPU within {worst:.3e} of its largest "
          f"magnitude (tol {TOL_GRAD_REL:.0e})")


def check_retrain_step(dev):
    """One Retrain elbo_step on the card at task 0 and at task 1's first
    step, its launches counted (K5 twice, one symmetric, and K7 once at
    task 0; K5 four times, two symmetric, and K7 three times at task 1),
    the pieces and gradients against the CPU's; then the same comparison
    after 5 steps on the card, at the card's parameters.  Returns the
    launches per step."""
    from vargp_tpu_torch import gpmath
    from vargp_tpu_torch.kernels import gram, sample_hypers
    from vargp_tpu_torch.models import vargp_retrain as R

    out = {}
    for task, label in ((0, "task 0"), (1, "task 1")):
        t, c = retrain_inputs(dev, task), retrain_inputs(torch.device("cpu"), task)
        reset_counts()
        params, state, loss, _ = retrain_step(t)
        torch.cuda.synchronize()
        out[label] = read_counts()
        want = {k: 0 for k in counters()}
        want.update(RETRAIN_LAUNCHES[label])
        print(f"  retrain {label}: one elbo_step, launches {out[label]}, loss {float(loss)!r}")
        if out[label] != want:
            raise AssertionError(f"retrain {label}: launches {out[label]}, expected {want}")
        compare_retrain(f"retrain {label}, step 0", t, c)
        if not task:
            continue
        for _ in range(RETRAIN_STEP["steps"] - 1):
            params, state, loss, _ = retrain_step(dict(t, params=params), state)
        t = dict(t, params=params)
        c = dict(c, params=to_cpu(params))
        compare_retrain(f"retrain {label}, after {RETRAIN_STEP['steps']} steps", t, c)
        # the conditional covariance at the first step, as the model hands it to K7
        t0 = retrain_inputs(dev, task)
        with torch.no_grad():
            theta = sample_hypers(t0["params"].kernel, t0["noise"]["hyper_eps"])
            z_all, L, _ = R._chain(theta, t0["params"].tasks, t0["cfg"].jitter)
            z_t = t0["frozen"][0].z
            W = gpmath.tri_solve(L, gram(theta, z_all, z_t))
            cov = gram(theta, z_t) - torch.einsum("...mb,...mc->...bc", W, W)
            out["cond_cov"] = gpmath.add_jitter(0.5 * (cov + cov.transpose(-1, -2)),
                                               t0["cfg"].jitter).reshape(-1, *cov.shape[-2:])
    return out


@contextlib.contextmanager
def recorded_retrain():
    """Wrap the Retrain driver's ``train_task``, train block and evaluation
    so that each call is recorded; the functions run unchanged."""
    from vargp_tpu_torch.experiments import retrain_run as RR

    rec = {"params": [], "infos": [], "losses": [], "evals": [], "last_eval": None}
    orig = (RR.train_task, RR.step_block, RR.accuracy)

    def train_task(*a, **kw):
        params, info = orig[0](*a, **kw)
        rec["params"].append(params)
        rec["infos"].append(info)
        return params, info

    def train_block(*a, **kw):
        out = orig[1](*a, **kw)
        rec["losses"].append(out[2])
        return out

    def accuracy(*a, **kw):
        out = orig[2](*a, **kw)
        rec["evals"].append(out)
        rec["last_eval"] = (a, kw, out)
        return out

    RR.train_task, RR.step_block, RR.accuracy = train_task, train_block, accuracy
    try:
        yield rec
    finally:
        RR.train_task, RR.step_block, RR.accuracy = orig


def check_retrain_protocol(dev, smi):
    """toy_retrain's two tasks through the drivers' entry point on the card
    (RETRAIN_PROTOCOL), the launches counted around the run: every logged
    accuracy and every step's ELBO finite, the evaluations at their epochs,
    the ELBO falling within each task, the checkpoints reloaded bitwise,
    and the last evaluation replayed on the CPU with its own draws."""
    from vargp_tpu_torch.experiments import retrain_run as RR
    from vargp_tpu_torch.models import vargp_retrain as R
    from vargp_tpu_torch.train.optim import tree_leaves
    from vargp_tpu_torch.utils.checkpoint import load_pytree

    pr = RETRAIN_PROTOCOL
    T = pr["n_tasks"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, recorded_retrain() as rec:
        reset_counts()
        t0 = time.perf_counter()
        params, summaries = RR.toy(epochs=pr["epochs"], eval_interval=pr["eval_interval"],
                                   n_tasks=T, seed=pr["seed"], log_dir=d, device=dev)
        torch.cuda.synchronize()
        run_wall = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        cfg = R.RetrainConfig(M=RETRAIN_STEP["M"], out_size=4, in_size=2)
        loaded = [load_pytree(os.path.join(d, f"ckpt{t}.npz"), R.params_template(cfg, t + 1))
                  for t in range(T)]
    steps = [info["steps"] for info in rec["infos"]]
    sps = [info["steps_per_sec"] for info in rec["infos"]]
    n_eval = len(rec["evals"])
    print(f"  toy_retrain, {T} tasks, {pr['epochs']} epochs: {run_wall:.3f} s, steps {steps}, "
          f"{n_eval} evaluations (one 512-row batch each); launches {launches}")
    print(f"  steps_per_sec per task {sps}; final accuracies {summaries}; {smi}")
    losses = torch.cat(rec["losses"]).cpu()
    if not (all(math.isfinite(r["value"]) for r in rows) and bool(torch.isfinite(losses).all())):
        raise AssertionError("retrain protocol: a logged accuracy or a step's ELBO is not finite")
    start = 0
    for t in range(T):
        evals = [(r["step"], r["value"]) for r in rows if r["tag"] == f"task{t}/test/acc"]
        task_losses = losses[start:start + steps[t]]
        start += steps[t]
        first, last = float(task_losses[:5].mean()), float(task_losses[-5:].mean())
        print(f"  task {t}: test accuracy at its evaluations {evals}; ELBO over its first 5 "
              f"steps {first!r}, its last 5 {last!r}")
        if [e for e, _ in evals] != pr["eval_epochs"]:
            raise AssertionError(f"retrain protocol task {t}: evaluations at {evals}")
        if not last < pr["elbo_drop"] * first:
            raise AssertionError(f"retrain protocol task {t}: the ELBO fell from {first} to "
                                 f"{last}, expected below {pr['elbo_drop']} of it")
    # a step: K5 2 (1 symmetric), K7 1 at task 0; K5 4 (2 symmetric), K7 3
    # after; an evaluation (one batch): K5 2 (1 symmetric), K7 1
    want = {k: 0 for k in counters()}
    want.update(rbf_gram=2 * steps[0] + 4 * sum(steps[1:]) + 2 * n_eval,
                cholesky=steps[0] + 3 * sum(steps[1:]) + n_eval)
    if launches != want:
        raise AssertionError(f"retrain protocol: launches {launches}, expected {want}")
    for t, (p, q) in enumerate(zip(rec["params"], loaded)):
        for n, a, b in zip(leaf_names(p), tree_leaves(p), tree_leaves(q)):
            if not np.array_equal(a.cpu().numpy(), b):
                raise AssertionError(f"retrain protocol: task {t} checkpoint leaf {n} not bitwise")
    # the last evaluation (task 1's final accuracy) again on the CPU
    (p, ds, noise, cfg_e, bs), kw, acc = rec["last_eval"]
    cpu_acc = RR.accuracy(to_cpu(p), ds, to_cpu(noise), cfg_e, bs, device="cpu")
    x0 = torch.from_numpy(np.ascontiguousarray(ds.data[:bs]))
    x0 = torch.cat([x0, x0.new_zeros((bs - len(x0), x0.shape[1]))]) if len(x0) < bs else x0
    with torch.no_grad():
        card_b0 = R.predict(p, x0.to(dev), noise, cfg_e, device=dev).cpu()
        cpu_b0 = R.predict(to_cpu(p), x0, to_cpu(noise), cfg_e, device="cpu")
    check("retrain protocol: the last evaluation's batch, card vs CPU",
          max_abs_err(card_b0, cpu_b0), TOL_PROBS, float(cpu_b0.max()))
    print(f"  that evaluation's accuracy: card {acc!r} CPU {cpu_acc!r} of {len(ds)} rows")
    if not abs(acc - cpu_acc) <= pr["count_tol"]:
        raise AssertionError(f"retrain protocol: accuracies {acc} and {cpu_acc} differ")
    print(f"  retrain protocol phase wall time {time.perf_counter() - t_phase:.3f} s; {smi}")
    return dict(launches=launches, steps=steps, steps_per_sec=sps, wall_s=run_wall)


def check_minted_retrain(dev):
    """``results/toy_retrain_full/ckpt1.npz`` (the JAX package's minted
    Retrain chain, both tasks) reloaded through the port's template on the
    card: its predictions on the toy's 4 classes (200 rows, one 512-row
    batch) at the model's budgets, from a generator's draws, against the
    CPU's on the same draws; accuracy and mean entropy printed."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.models import vargp_retrain as R
    from vargp_tpu_torch.train.metrics import compute_acc_ent
    from vargp_tpu_torch.utils.checkpoint import load_pytree
    from vargp_tpu_torch.utils.convert import params_from_numpy

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                        "toy_retrain_full", "ckpt1.npz")
    cfg = R.RetrainConfig(M=RETRAIN_STEP["M"], out_size=4, in_size=2)
    tree = load_pytree(path, R.params_template(cfg, 2))
    card, cpu = (params_from_numpy(tree, device=d)[0] for d in (dev, "cpu"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = {"hyper_eps": torch.randn((3, 3), generator=gen, device=dev),
             "lik_eps": torch.randn((3, 10, 4, 512), generator=gen, device=dev)}
    toy = data.make_toy_dataset(seed=0)
    x = torch.zeros((512, 2))
    x[:len(toy)] = torch.from_numpy(toy.data)
    reset_counts()
    with torch.no_grad():
        probs = R.predict(card, x.to(dev), noise, cfg, device=dev)
        torch.cuda.synchronize()
        launches = read_counts()
        ref = R.predict(cpu, x, to_cpu(noise), cfg, device="cpu")
    check("minted toy_retrain_full ckpt1 on the toy's 4 classes, card vs CPU",
          max_abs_err(probs.cpu(), ref), TOL_PROBS, float(ref.max()))
    acc, ent = compute_acc_ent(toy, lambda xb: probs[:len(xb)], 512)
    cpu_acc, cpu_ent = compute_acc_ent(toy, lambda xb: ref[:len(xb)], 512)
    print(f"  its accuracy {acc!r} (CPU {cpu_acc!r}), mean entropy {ent!r} nats (CPU {cpu_ent!r});"
          f" launches {launches}")
    if not (acc == cpu_acc and abs(ent - cpu_ent) <= TOL_PROBS and acc > 0.5):
        raise AssertionError(f"minted retrain chain: accuracy {acc} / {cpu_acc}, entropy "
                             f"{ent} / {cpu_ent}")
    return dict(acc=acc, ent=ent, launches=launches)


class RecordedRegressionDraws:
    """The regression driver's draw source over ``gen``, every draw kept
    (``init`` once, then ``hypers``) so that a CPU run can replay them."""

    def __init__(self, gen=None, replay=None):
        from vargp_tpu_torch.experiments.regression import RegressionDraws

        self.src = None if gen is None else RegressionDraws(gen)
        self.replay = None if replay is None else iter(replay)
        self.kept = []

    def _next(self, make):
        out = make() if self.replay is None else next(self.replay)
        self.kept.append(out)
        return out

    def init(self):
        return self._next(lambda: self.src.init())

    def hypers(self, n):
        return self._next(lambda: self.src.hypers(n))


def check_regression(dev, smi):
    """``regression`` on the card at REGRESSION's settings through the
    drivers' entry point, the launches counted (a step: K5 2, one
    symmetric, K7 1; the final RMSE the same at H = 16): RMSE below
    max_rmse; then its first steps again on the CPU with the card's draws,
    the step losses card vs CPU."""
    from vargp_tpu_torch.experiments import regression as RG
    from vargp_tpu_torch.utils.prng import task_generator

    pr = REGRESSION
    losses = {"card": [], "cpu": []}
    orig = RG.gradient_step

    def run(where, draws, epochs):
        def step(*a, **kw):
            out = orig(*a, **kw)
            losses[where].append(out[2])
            return out

        RG.gradient_step = step
        try:
            with tempfile.TemporaryDirectory() as d:
                return RG.regression(epochs=epochs, M=pr["M"], seed=pr["seed"], log_dir=d,
                                     device=dev if where == "card" else "cpu", draws=draws)
        finally:
            RG.gradient_step = orig

    rec = RecordedRegressionDraws(task_generator(np.random.SeedSequence(pr["seed"]), 0, dev))
    reset_counts()
    t0 = time.perf_counter()
    _, rmse = run("card", rec, pr["epochs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"  regression (epochs {pr['epochs']}, M {pr['M']}): train RMSE {rmse!r} (noise sigma "
          f"0.1; limit {pr['max_rmse']}), {wall:.3f} s, launches {launches}; {smi}")
    n = pr["epochs"] + 1
    want = {k: 0 for k in counters()}
    want.update(rbf_gram=2 * n, cholesky=n)
    if launches != want:
        raise AssertionError(f"regression: launches {launches}, expected {want}")
    if not rmse < pr["max_rmse"]:
        raise AssertionError(f"regression: RMSE {rmse} not below {pr['max_rmse']}")
    k = pr["replay_steps"]
    run("cpu", RecordedRegressionDraws(replay=[d.cpu() for d in rec.kept[:k + 2]]), k)
    for i, (g, r) in enumerate(zip(losses["card"][:k], losses["cpu"])):
        g, r = float(g), float(r)
        rel = abs(g - r) / max(abs(r), 1e-30)
        print(f"  regression step {i}: loss card {g!r} cpu {r!r}, rel err {rel:.3e} "
              f"(tol {TOL_E2E_REL:.0e})")
        if not rel <= TOL_E2E_REL:
            raise AssertionError(f"regression step {i}: card and CPU differ by {rel}")
    return dict(rmse=rmse, launches=launches, wall_s=wall,
                steps_per_sec=pr["epochs"] / wall)


def time_retrain_training(dev):
    """The Retrain step at task 1 (and task 0) and the regression's step:
    ms per forward, forward + backward and whole step (CUDA events around
    back-to-back calls), the step's launches and device-busy ms under
    torch.profiler, and its idle share (1 - busy / step ms)."""
    from vargp_tpu_torch.experiments import regression as RG
    from vargp_tpu_torch.models import vargp_retrain as R
    from vargp_tpu_torch.train.optim import Yogi

    out = {}
    for task in (1, 0):
        t = retrain_inputs(dev, task)

        def fwd():
            with torch.no_grad():
                return R.loss(t["params"], t["frozen"], t["prior"], t["x"], t["y"], t["noise"],
                              t["cfg"], weights=t["w"], device=dev)

        launches, busy = traced_step(lambda: retrain_step(t))
        step_ms = time_ms(lambda: retrain_step(t), reps=10)
        out[f"retrain task {task}"] = {
            "forward_ms": time_ms(fwd, reps=10),
            "forward_backward_ms": time_ms(lambda: retrain_grads(t), reps=10),
            "step_ms": step_ms, "step_launches_traced": launches, "step_device_busy_ms": busy,
            "idle_share": 1.0 - busy / step_ms}
    rng = np.random.default_rng(SEED)
    x_np, y_np = RG._make_data(rng)
    idx = rng.permutation(len(x_np))[:24]
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    params = RG.RegressionParams(
        kernel=RG.init_rbf(torch.zeros(2, device=dev)), lik=RG.init_gaussian(1, device=dev),
        u_mean=torch.zeros((1, 24, 1), device=dev), u_tril_vec=torch.full((1, 300), 0.5, device=dev),
        z=torch.from_numpy(x_np[idx]).to(dev)[None])
    prior = RG.default_prior(1, device=dev)
    opt = Yogi(1e-2)
    state = opt.init(params)
    hyper = torch.randn((3, 2), generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def reg_step():
        return RG.gradient_step(params, state, lambda p: RG.elbo(p, prior, x, y, hyper), opt)

    launches, busy = traced_step(reg_step)
    step_ms = time_ms(reg_step, reps=10)
    out["regression"] = {"step_ms": step_ms, "step_launches_traced": launches,
                         "step_device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms}
    for name, row in out.items():
        print(f"  {name} step: " + "  ".join(f"{k} {v:.4f}" for k, v in row.items()))
    return out


def check_k7_small(dev, cond_cov):
    """K7 at the Retrain and regression factor shapes (SMALL_CHOL) and on
    the conditional covariance of a Retrain task's first step, symmetrised
    and jittered as the model hands it over (rounding around 0 plus 1e-4
    on the diagonal), against its plain version, each launch counted; NaN
    from a non-positive pivot at each shape, as check_nan_pivot runs it.
    Returns the largest error and the inputs for timing."""
    from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain

    rng = np.random.default_rng(SEED + 11)
    err, inputs = 0.0, {}
    cases = {label: spd_blocks(rng, G, dev, S) for label, (G, S) in SMALL_CHOL.items()}
    cases["retrain cond_cov step 0"] = cond_cov
    for label, K in cases.items():
        L, n = launched(cholesky, junk_above(K))
        if n != {"vargp_chol": 1}:
            raise AssertionError("K7's launch counter did not count its launch")
        ref = cholesky_plain(K)
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError(f"K7 {label}: the plain factor is not finite")
        e = max_abs_err(L, ref)
        check(f"K7 cholesky {label} {tuple(K.shape)}", e, TOL_CHOL, float(ref.abs().max()))
        err = max(err, e)
        inputs[label] = K
    for G, S in SMALL_CHOL.values():
        check_nan_pivot("K7 cholesky", cholesky, cholesky_plain, S, S // 2, G)
    return err, inputs


# ---------------------------------------------------------------------------
# the kernels as operators: the exported predictor, per-op profiles, the
# FLOP audit
# ---------------------------------------------------------------------------

# predict exported at the evaluation's shapes on A's 5-task chain (M = 60,
# S = 300, D = 784, B = 512, H = 20 hyper samples, n_f = 50), loaded in a
# fresh process: its probabilities bitwise equal to eager predict's on the
# same noise, or within `tol` with the reason printed; its launches per
# call under each route
EXPORT = dict(batch_size=512, n_f=50, n_var_samples=20, reps=10, tol=1e-6, seed=SEED + 11,
              launches={"default": {"sym_gram": 1, "diag_chol": 3, "cross_gram": 1, "tri_mm": 1,
                                    "marginal_moments": 1},
                        "fused": {"sym_gram": 1, "chol_inv": 1, "cross_gram": 1, "tri_mm": 1,
                                  "marginal_moments": 1}})
# each launch counter's kernels in a trace, by their __global__ names (K8's
# launcher runs K3's kernel; rbf_gram_sym is a part of rbf_gram's count)
KERNEL_SYMBOLS = {
    "sym_gram": r"\bsym_gram_kernel\b", "sym_gram_tri": r"\bsym_gram_tri_kernel\b",
    "diag_chol": r"\bdiag_chol_kernel\b", "cross_gram": r"\bcross_gram_kernel\b",
    "rbf_gram": r"\brbf_gram(_sym|_small)?_kernel\b", "chol_inv": r"\bchol_inv_kernel\b",
    "cholesky": r"\bchol_kernel\b", "tri_mm": r"\btri_mm_kernel\b",
    "marginal_moments": r"\bmarginal_moments_kernel\b",
}
PROFILE = dict(iters=10, top=15)

# run in a fresh python3: load the exported predictor, count its launches
# on one call, time it, save its probabilities
_LOADED_PREDICT = r"""
import json, sys, time
import torch
import chip_smoke as s
from vargp_tpu_torch.utils.export import load_predictor

path, inputs, out, reps = sys.argv[1:5]
t0 = time.perf_counter()
pred = load_predictor(path)
load_s = time.perf_counter() - t0
d = torch.load(inputs)
x, noise = d["x"].cuda(), {k: v.cuda() for k, v in d["noise"].items()}
s.reset_counts()
probs = pred(x, noise)
torch.cuda.synchronize()
counts = s.read_counts()
nodes = [str(n.target) for n in pred.program.graph.nodes
         if n.op == "call_function" and str(n.target).startswith("vargp_torch.")]
ms = s.time_ms(lambda: pred(x, noise), reps=int(reps))
torch.save(probs.cpu(), out)
print(json.dumps({"launches": counts, "nodes": nodes, "ms": ms, "load_s": load_s}))
"""


def check_export(dev, route: str = "default") -> dict:
    """``utils.export`` on the card under ``route``: predict at EXPORT's
    shapes exported (the route's knobs set while it traces), its graph's
    ``vargp_torch::`` nodes counted, the .pt2 loaded in a fresh process and
    called without the knobs, its launches per call counted there against
    EXPORT's, its probabilities against eager predict's on the same noise
    (bitwise, else within EXPORT["tol"] with the reason printed), both
    timed per call with CUDA events."""
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.utils import export as E

    cfg, params, prev, _, x, _, _, _ = flagship_model(dev)
    B, n_f, n_var = EXPORT["batch_size"], EXPORT["n_f"], EXPORT["n_var_samples"]
    cfg_eval = V.eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var)
    rng = np.random.default_rng(EXPORT["seed"])
    noise = {k: torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
             for k, shape in E.noise_shapes(cfg_eval, B).items()}
    want = {k: 0 for k in counters()}
    want.update(EXPORT["launches"][route])
    with tempfile.TemporaryDirectory(prefix="vargp_export_") as tmp:
        return _check_export(dev, route, tmp, want, cfg, cfg_eval, params, prev, x, noise)


def _check_export(dev, route, tmp, want, cfg, cfg_eval, params, prev, x, noise) -> dict:
    """check_export's body, its files in the directory ``tmp``."""
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.utils import export as E

    B, n_f, n_var = EXPORT["batch_size"], EXPORT["n_f"], EXPORT["n_var_samples"]
    path = os.path.join(tmp, "predictor.pt2")
    with route_env(route):
        t0 = time.perf_counter()
        E.export_predictor(params, prev, cfg, B, path, n_f=n_f, n_var_samples=n_var, device=dev)
        export_s = time.perf_counter() - t0

        def eager():  # the posterior built each call, as the loaded program builds it
            V.clear_posterior_cache()
            with torch.no_grad():
                return V.predict(params, prev, x, noise, cfg_eval, device=dev)

        reset_counts()
        ref = eager()
        torch.cuda.synchronize()
        eager_launches = read_counts()
        eager_ms = time_ms(eager, reps=EXPORT["reps"])
    if eager_launches != want:
        raise AssertionError(f"export {route}: eager predict launched {eager_launches}, expected {want}")
    torch.save({"x": x.cpu(), "noise": {k: v.cpu() for k, v in noise.items()}},
               os.path.join(tmp, "inputs.pt"))
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-c", _LOADED_PREDICT, path, os.path.join(tmp, "inputs.pt"),
         os.path.join(tmp, "probs.pt"), str(EXPORT["reps"])],
        cwd=here, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here, *filter(None, [os.environ.get("PYTHONPATH")])])), capture_output=True, text=True,
        timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"export {route}: the fresh process failed:\n{res.stdout}{res.stderr}")
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    if loaded["launches"] != want:
        raise AssertionError(f"export {route}: the loaded predictor launched {loaded['launches']}, "
                             f"expected {want}")
    n_nodes = len(loaded["nodes"])
    if n_nodes != sum(want.values()):
        raise AssertionError(f"export {route}: {n_nodes} vargp_torch nodes {loaded['nodes']}, "
                             f"expected {sum(want.values())}: the graph lost a kernel")
    got = torch.load(os.path.join(tmp, "probs.pt")).to(dev)
    bitwise = torch.equal(got, ref)
    err = max_abs_err(got, ref)
    print(f"  export {route}: {export_s:.2f} s to export, {loaded['load_s']:.2f} s to load in a "
          f"fresh process; {n_nodes} vargp_torch nodes {sorted(set(loaded['nodes']))}; launches "
          f"per call {dict((k, v) for k, v in loaded['launches'].items() if v)} (eager the same); "
          f"probabilities {tuple(got.shape)} "
          + ("bitwise equal to eager predict's" if bitwise else f"max abs diff {err:.3e}"))
    if not bitwise:
        inproc = E.load_predictor(path, device=dev)(x, noise)
        same = torch.equal(inproc, got)
        print(f"  export {route}: not bitwise equal: the loaded graph in this process gives "
              + ("the fresh process's values bit for bit, so the difference is the graph's: "
                 "it runs ATen's decompositions of the eager calls (matmul and einsum as bmm "
                 "with their reshapes), which may take another cuBLAS kernel and order of sums"
                 if same else f"{max_abs_err(inproc, ref):.3e} from eager: the run itself "
                 "is not deterministic"))
        if err > EXPORT["tol"]:
            raise AssertionError(f"export {route}: {err:.3e} from eager predict > {EXPORT['tol']}")
    print(f"  export {route}: predict per call (CUDA events) eager {eager_ms:.4f} ms, "
          f"loaded {loaded['ms']:.4f} ms")
    return dict(launches=loaded["launches"], nodes=n_nodes, bitwise=bitwise, max_abs_diff=err,
                eager_ms=eager_ms, loaded_ms=loaded["ms"], export_s=export_s,
                load_s=loaded["load_s"])


def traced_kernels(launches: dict) -> dict:
    """Each launch counter's traced kernel events per call: the events whose
    names match its KERNEL_SYMBOLS pattern."""
    import re

    return {n: sum(v for k, v in launches.items() if re.search(pat, k))
            for n, pat in KERNEL_SYMBOLS.items()}


def profile_cases(dev) -> dict:
    """One training step of each profiled configuration, as a callable: A
    and B (``elbo_step``), D (the global step, task 1 of s_mnist_global)
    and E (Retrain's task-1 first step)."""
    a, b = train_inputs("A", dev), train_inputs("B", dev)
    d = global_inputs("S-MNIST global", dev)
    e = retrain_inputs(dev, task=1)
    return {"A": lambda: step(a), "B": lambda: step(b), "D": lambda: global_step(d),
            "E": lambda: retrain_step(e)}


def check_profiles(dev, smi) -> dict:
    """``utils.profiling.profile_fn`` on one step of each profile_cases
    configuration: the top ops by device ms per step, the kernel events
    traced per step, and each of the port's kernels traced against the
    launches its wrapper counted over the same calls (a warm-up and
    PROFILE["iters"]); a kernel traced fewer times than launched is named."""
    from vargp_tpu_torch.utils.profiling import profile_fn

    out = {}
    for name, fn in profile_cases(dev).items():
        reset_counts()
        prof = profile_fn(fn, iters=PROFILE["iters"], top=PROFILE["top"], device=dev)
        calls = PROFILE["iters"] + 1
        counted = {n: v / calls for n, v in read_counts().items()}
        counted["diag_chol"] += counted.pop("diag_chol_chunked")  # one kernel
        counted.pop("rbf_gram_sym")
        traced = traced_kernels(prof["launches_per_call"])
        short = {n: (traced[n], counted[n]) for n in traced if traced[n] < counted[n]}
        ours = sum(counted.values())
        print(f"  profile {name}: {prof['events_per_call']:.1f} kernel events traced per step, "
              f"{prof['busy_ms']:.4f} ms of device work per step; the port's kernels traced "
              f"{sum(traced.values()):.1f} per step against {ours:.1f} launches counted"
              + (f"; SHORT in the trace (traced, counted): {short}" if short else
                 ": every launch traced"))
        for op, ms in prof["top"].items():
            print(f"    {ms:9.5f} ms  {prof['launches_per_call'].get(op, 0):6.1f}x  {op[:110]}")
        by_count = sorted(prof["launches_per_call"].items(), key=lambda kv: -kv[1])[:10]
        print(f"    most launched: " + "; ".join(f"{v:.0f}x {k[:60]}" for k, v in by_count))
        out[name] = dict(events_per_call=prof["events_per_call"], busy_ms=prof["busy_ms"],
                         top=prof["top"], traced=traced, counted=counted, short=short)
    print(f"  ({smi})")
    return out


def check_audit(dev, smi, profiles) -> dict:
    """``utils.flops.audit`` of one training step at A and B on the card:
    GFLOP by bucket (products by precision class, the vargp_torch
    operators by their cost functions), movement MB, the speed of light,
    and ``achieved`` against the step's device-busy time (the profile
    phase's) and its CUDA-event time; the forward alone beside it."""
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.utils.flops import achieved, audit

    out = {}
    for name in ("A", "B"):
        t = train_inputs(name, dev)

        def fwd():
            with torch.no_grad():
                return V.loss(t["params"], t["prev"], t["prior"], t["x"], t["y"], t["noise"],
                              t["cfg"], weights=t["w"], chain_mask=t["mask"], device=dev)

        summary, _, moves, ops = audit(lambda: step(t))
        fwd_summary = audit(fwd)[0]
        if summary["gflop_f32"] <= fwd_summary["gflop_f32"]:
            raise AssertionError(f"audit {name}: the step's products ({summary['gflop_f32']}) "
                                 f"are no more than the forward's: the backward was not seen")
        event_ms = time_ms(lambda: step(t), reps=5 if name == "B" else 10)
        busy_ms = profiles[name]["busy_ms"]
        out[name] = dict(summary=summary, forward=fwd_summary, ops=ops, moves=dict(moves),
                         event_ms=event_ms, busy_ms=busy_ms,
                         vs_busy=achieved(summary, busy_ms / 1e3),
                         vs_events=achieved(summary, event_ms / 1e3))
        print(f"  audit {name}: " + "  ".join(f"{k} {v:.5f}" for k, v in summary.items())
              + f"; forward alone gflop_f32 {fwd_summary['gflop_f32']:.5f}")
        print(f"    operators: " + "; ".join(f"{k} {v['calls']}x {v['flops'] / 1e9:.4f} GFLOP "
                                              f"{v['bytes'] / 1e6:.2f} MB" for k, v in ops.items()))
        print(f"    movement bytes by op: " + ", ".join(f"{k} {v / 1e6:.2f} MB"
                                                        for k, v in moves.items()))
        print(f"    achieved against the device-busy {busy_ms:.4f} ms: {out[name]['vs_busy']}; "
              f"against the step by CUDA events {event_ms:.4f} ms: {out[name]['vs_events']}")
    print(f"  ({smi})")
    return out


# ---------------------------------------------------------------------------
# multi-GPU: the ("data", "model") mesh on ranks that share the one card
# ---------------------------------------------------------------------------

# A's step and a short train block on meshes of ranks spawned here, every
# rank on card 0 (the machine has one; NCCL refuses two ranks on one
# device, so the ranks talk over gloo), held to the single-device step on
# the same draws: the loss and pieces within tol_loss relative, Yogi's
# moments within moments_of_largest of each leaf's largest magnitude
# (tests/test_torch_parallel.py's limits), every leaf within rtol and a
# thousandth of a step of lr 3e-3 per step taken (atol after the step,
# block_atol after the block).  Yogi's update, lr m / (sqrt(v) + eps),
# turns the gradients' f32 noise (the sharded sums add in another order)
# into parameter noise where a gradient is near 0: on the card one step
# at 2 x 1 moved a leaf 1.84e-6 off, and 5 steps at 1 x 2 5.1e-6, beyond
# the 1e-6 that the CPU tests' tiny case holds.  Each
# rank's launches per step are counted at its shard's shapes (K1 on its
# O / mp classes, K3 3x, K4 on its B / dp rows).  Then split_mnist's first
# two tasks (PROTOCOL) on the 1 x 2 mesh, each task's accuracies within
# protocol_tol of check_protocol's single-device run.  The times are of
# ranks that share one card: no number here is a scale-out speed.
SHARDED = dict(spawns={2: [("1 x 2", 2), ("2 x 1", 1)], 4: [("2 x 2", 2)]},
               block_steps=5, timed_steps=10, profiled_steps=3, rank_timeout=480,
               tol_loss=1e-5, rtol=1e-4, atol=3e-6, block_atol=1.5e-5, moments_of_largest=1e-4,
               protocol_tol=0.02,
               launches={"sym_gram": 1, "diag_chol": 3, "cross_gram": 1})


class _KernelShapes(TorchDispatchMode):
    """Each ``vargp_torch::`` operator call's tensor shapes, in order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name.startswith("vargp_torch::"):
            self.calls.append((func._schema.name.split("::")[1],
                               [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


def _sharded_step_run(label, model_parallel, dev):
    """On this rank: A's step on the mesh (launches, shapes, collectives),
    its time by CUDA events, the collectives' share from a CPU profile,
    and a block of SHARDED["block_steps"] steps."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from vargp_tpu_torch import parallel
    from vargp_tpu_torch.train import loop as TL

    sh = SHARDED
    n = dist.get_world_size()
    mesh = parallel.make_mesh(n, model_parallel, devices=[dev] * n)
    t = train_inputs("A", dev)
    cfg, O = t["cfg"], t["cfg"].out_size
    p = parallel.shard_params(t["params"], mesh, O)
    prev = parallel.shard_params(t["prev"], mesh, O)
    x, y, w = parallel.shard_batch(t["x"], t["y"], t["w"], mesh)
    update = parallel.make_sharded_update_fn(cfg, t["opt"], t["beta"], t["n_train"], mesh)

    def one():
        return update(p, t["opt"].init(p), prev, t["prior"], x, y, w, t["noise"],
                      chain_mask=t["mask"])

    reset_counts()
    mesh.log.clear()
    with _KernelShapes() as shapes:
        p1, s1, loss, pieces = one()
    torch.cuda.synchronize()
    out = dict(label=label, rank=mesh.rank, coords=mesh.coords, shape=mesh.shape,
               backend=dist.get_backend(), launches=read_counts(), calls=shapes.calls,
               collectives=list(mesh.log), loss=float(loss), pieces=[float(v) for v in pieces],
               params=parallel.unshard_to_host(p1, mesh, O),
               opt=parallel.unshard_to_host(s1, mesh, O))
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    dist.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(sh["timed_steps"]):
        one()
    end.record()
    torch.cuda.synchronize()
    out["host_ms"] = (time.perf_counter() - t0) * 1e3 / sh["timed_steps"]
    out["ms"] = start.elapsed_time(end) / sh["timed_steps"]
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(sh["profiled_steps"]):
            one()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    coll = [e for e in prof.key_averages() if e.key.startswith(("gloo:", "nccl:"))]
    out["collective_ms"] = sum(e.cpu_time_total for e in coll) / 1e3 / sh["profiled_steps"]
    out["collective_calls"] = sum(e.count for e in coll) / sh["profiled_steps"]
    out["profiled_ms"] = wall * 1e3 / sh["profiled_steps"]

    dx, dy, dw = t["data"]
    B = t["x"].shape[0]
    draws = itertools.islice(TL.GeneratorDraws(torch.Generator(device=dev).manual_seed(SEED + 21))
                             .block(dx.shape[0], B, 1, cfg, len(prev)), sh["block_steps"])
    run = parallel.make_sharded_device_train_fn(cfg, t["opt"], t["beta"], B, 1, mesh)
    pb, _, losses, bpieces = run(p, t["opt"].init(p), prev, t["prior"], t["mask"], t["n_train"],
                                 dx, dy, dw, None, draws=draws)
    out["block"] = dict(losses=losses.cpu(), pieces=bpieces.cpu(),
                        params=parallel.unshard_to_host(pb, mesh, O))
    return out


def sharded_rank(meshes, protocol_dir, dev):
    """A spawned rank's share of the sharded phases on ``dev``: each
    mesh's step, then (with ``protocol_dir``) split_mnist's first two
    tasks over the job's ranks, rank 0 writing its run to
    ``protocol_dir``."""
    import vargp_tpu_torch  # noqa: F401  (sets the TF32 flags)

    import torch.distributed as dist

    out = {"steps": [_sharded_step_run(label, mp, dev) for label, mp in meshes]}
    # whether this backend gathers tensors on the card (the port's gather
    # is an all_reduce of a zero-padded buffer on every backend)
    try:
        got = torch.empty(dist.get_world_size(), device=dev)
        dist.all_gather_into_tensor(got, torch.full((1,), float(dist.get_rank()), device=dev))
        out["all_gather"] = f"works: {got.tolist()}"
    except Exception as exc:  # a probe: its answer is printed, nothing depends on it
        out["all_gather"] = f"raises {type(exc).__name__}: {exc}"[:300]
    if protocol_dir is not None:

        from vargp_tpu_torch.experiments import vargp_run

        pr = PROTOCOL
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, summaries = vargp_run.split_mnist(
            n_tasks=pr["n_tasks"], pad_tasks_to=pr["pad_tasks_to"], epochs=pr["epochs"],
            eval_interval=pr["eval_interval"], seed=pr["seed"], log_dir=protocol_dir,
            n_devices=dist.get_world_size(), model_parallel=2, device=dev.type)
        torch.cuda.synchronize()
        out["protocol"] = dict(summaries=summaries, wall_s=time.perf_counter() - t0,
                               launches=read_counts())
    return out


def _excess(got, want, rtol, atol, of_largest=None) -> float:
    """The largest (|got - want| - rtol |want|) / atol over the leaves of
    two trees, atol taken as ``of_largest`` of each leaf's largest
    magnitude when given: at most 1 passes."""
    from vargp_tpu_torch.train.optim import tree_leaves

    got, want = tree_leaves(got), [np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                                   for v in tree_leaves(want)]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} leaves against {len(want)}")
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, dtype=np.float64), b.astype(np.float64)
        tol = of_largest * float(np.abs(b).max()) if of_largest is not None else atol
        worst = max(worst, float(np.max(np.abs(a - b) - rtol * np.abs(b))) / max(tol, 1e-30))
    return worst


def check_sharded(dev, smi, protocol) -> dict:
    """The sharded phases (SHARDED): one spawn of 2 ranks (the 1 x 2 and
    2 x 1 meshes, then the protocol on 1 x 2) and one of 4 (2 x 2), every
    rank on card 0 over gloo; each rank's step against the single-device
    step and block on the same draws, its launches and shapes; the
    protocol's accuracies against ``protocol``'s and its checkpoints
    reloaded.  Returns each mesh's launches per rank and step."""
    from vargp_tpu_torch import parallel
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train import loop as TL
    from vargp_tpu_torch.train.optim import tree_leaves
    from vargp_tpu_torch.utils.checkpoint import load_chain

    sh = SHARDED
    t_phase = time.perf_counter()
    t = train_inputs("A", dev)
    p_ref, s_ref, loss_ref, pieces_ref = step(t)
    dx, dy, dw = t["data"]
    B = t["x"].shape[0]
    draws = itertools.islice(TL.GeneratorDraws(torch.Generator(device=dev).manual_seed(SEED + 21))
                             .block(dx.shape[0], B, 1, t["cfg"], len(t["prev"])),
                             sh["block_steps"])
    pb_ref, _, losses_ref, _ = TL.train_block(
        t["params"], t["opt"].init(t["params"]), t["prev"], t["prior"], t["mask"], t["n_train"],
        dx, dy, dw, None, cfg=t["cfg"], opt=t["opt"], beta=t["beta"], batch_size=B, n_epochs=1,
        device=dev, draws=draws)
    loss_ref = float(loss_ref)
    losses_ref = losses_ref.cpu()
    O = t["cfg"].out_size
    print(f"  single-device reference at A on the card: loss {loss_ref!r}, block losses "
          f"{losses_ref.tolist()}")

    results, launches = {}, {}
    rank_dev = torch.device(dev.type, 0) if dev.type == "cuda" else dev  # every rank on card 0
    with tempfile.TemporaryDirectory() as d:
        proto_dir = os.path.join(d, "protocol")
        for n, meshes in sh["spawns"].items():
            t0 = time.perf_counter()
            ranks = parallel.spawn_ranks(sharded_rank, [rank_dev] * n,
                                         (meshes, proto_dir if n == 2 else None, rank_dev),
                                         timeout=sh["rank_timeout"], store_dir=d)
            print(f"  {n} ranks on {rank_dev}: {time.perf_counter() - t0:.3f} s, spawn to join; "
                  f"{ranks[0]['steps'][0]['backend']} all_gather_into_tensor on the device "
                  f"{ranks[0]['all_gather']}")
            results[n] = ranks
        cfg = V.VARGPConfig(M=FLAGSHIP["M"], out_size=FLAGSHIP["O"], in_size=FLAGSHIP["D"])
        loaded = load_chain(proto_dir, PROTOCOL["n_tasks"], A.params_template(cfg))

    for n, ranks in results.items():
        for k, (label, mp) in enumerate(sh["spawns"][n]):
            dp = n // mp
            per_rank = {}
            for r in ranks:
                st = r["steps"][k]
                want = {c: 0 for c in counters()}
                want.update(sh["launches"])
                if st["launches"] != want:
                    raise AssertionError(f"{label} rank {st['rank']}: launches {st['launches']}, "
                                         f"expected {want}")
                H = t["cfg"].n_var_samples
                for name, shapes in st["calls"]:
                    # the Grams' z (O / mp, S, D) and K4's x (B / dp, D); the
                    # factor's batch of H x O / mp blocks
                    local = (shapes[0][0] == O // mp if name in ("sym_gram", "cross_gram")
                             else math.prod(shapes[0][:-2]) == H * O // mp)
                    if not local or (name == "cross_gram" and shapes[1][0] != B // dp):
                        raise AssertionError(f"{label} rank {st['rank']}: {name} at {shapes}, "
                                             f"not on the shard ({O // mp} classes, {B // dp} rows)")
                rel = abs(st["loss"] - loss_ref) / abs(loss_ref)
                prel = max(abs(a - float(b)) / max(abs(float(b)), 1e-30)
                           for a, b in zip(st["pieces"], pieces_ref))
                e_p = _excess(st["params"], p_ref, sh["rtol"], sh["atol"])
                e_o = _excess(st["opt"], s_ref, 0, 0, sh["moments_of_largest"])
                b = st["block"]
                brel = float(torch.max(torch.abs(b["losses"] - losses_ref) / torch.abs(losses_ref)))
                e_b = _excess(b["params"], pb_ref, sh["rtol"], sh["block_atol"])
                shapes = sorted({(name, tuple(s[0])) for name, s in st["calls"]})
                print(f"  {label} rank {st['rank']} at {st['coords']} ({st['backend']}): loss "
                      f"{st['loss']!r} (rel {rel:.3e}), pieces rel {prel:.3e}; params at "
                      f"{e_p:.3f} of their limit, moments {e_o:.3f}; block of "
                      f"{b['losses'].numel()} steps: losses rel {brel:.3e}, params {e_b:.3f} of "
                      f"their limit; launches {st['launches']}; operator inputs {shapes}; "
                      f"collectives per step {len(st['collectives'])}: "
                      f"{[(c[0], c[2]) for c in st['collectives']]}")
                print(f"  {label} rank {st['rank']}: ms per sharded step by CUDA events "
                      f"{st['ms']:.4f} (host clock {st['host_ms']:.4f}); profiled "
                      f"{st['profiled_ms']:.4f} ms a step, of it in collectives "
                      f"{st['collective_ms']:.4f} ms ({st['collective_calls']:.0f} calls, "
                      f"{st['collective_ms'] / st['profiled_ms']:.1%}); ranks sharing one card "
                      f"over gloo, not a scale-out speed; {smi}")
                if not (rel <= sh["tol_loss"] and prel <= sh["tol_loss"] and brel <= sh["tol_loss"]
                        and max(e_p, e_o, e_b) <= 1.0):
                    raise AssertionError(f"{label} rank {st['rank']}: the sharded step or block "
                                         "differs from the single-device one beyond its limits")
                per_rank[st["rank"]] = st["launches"]
            launches[label] = per_rank

    pr = results[2][0]["protocol"]
    print(f"  split_mnist's first {PROTOCOL['n_tasks']} tasks on the 1 x 2 mesh (2 ranks on card "
          f"0, gloo): {pr['wall_s']:.3f} s, rank 0's launches {pr['launches']}; single device "
          f"{protocol['wall_s']:.3f} s (the whole phase); {smi}")
    for tk, (a, b) in enumerate(zip(protocol["summaries"], pr["summaries"])):
        diff = {k: abs(a[k] - b[k]) for k in a}
        print(f"  task {tk}: single device {a}, sharded {b}")
        if set(a) != set(b) or not all(v < sh["protocol_tol"] for v in diff.values()):
            raise AssertionError(f"sharded protocol task {tk}: {b} against {a}")
    for tk, p in enumerate(loaded):
        if not all(np.isfinite(v).all() for v in tree_leaves(p)):
            raise AssertionError(f"sharded protocol: checkpoint {tk} not finite")
    print(f"  rank 0's {len(loaded)} checkpoints reloaded into the single-device template; "
          f"the sharded phases {time.perf_counter() - t_phase:.3f} s")
    return dict(launches=launches, protocol_launches=pr["launches"])



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
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(build.sources())} sources, one nvcc "
          "each in parallel, one link")

    dev = torch.device("cuda")
    if sys.argv[1:] == ["--phases=sharded"]:  # the multi-GPU phases alone, no result line
        protocol = check_protocol(dev, smi)
        check_sharded(dev, smi, protocol)
        print(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--phases=tri_mm"]:  # K9's checks and times alone, no result line
        _, f64_k9, cases = check_tri_mm(dev)
        times = {label: kernel_times(**case) for label, case in cases.items()}
        for label, t in times.items():
            print(f"  tri_mm at {label}: {fmt_times(t)}")
        print(json.dumps({"tri_mm": times, "f64": f64_k9}))
        print(smi)
        print(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--phases=marginal_moments"]:  # K10's checks and times alone, no result line
        chain = profile_moments_chain(dev)
        _, f64_k10, cases = check_marginal_moments(dev)
        times = {label: kernel_times(**case) for label, case in cases.items()}
        for label, t in times.items():
            print(f"  marginal_moments at {label}: {fmt_times(t)}")
        print(json.dumps({"marginal_moments": times, "f64": f64_k10,
                          "chain": {k: chain[k] for k in ("top", "events_per_call", "busy_ms")}}))
        print(smi)
        print(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    print("kernels against their plain versions on the card:")
    errs, f64 = check_kernels(dev)
    errs["diag_chol"], flag_k3 = check_k3(dev)
    errs["sym_gram_tri"], f64["sym_gram_tri"] = check_k2(dev)
    errs["rbf_gram"], f64["rbf_gram"] = check_k5(dev)
    errs_chol, flag_chol, clusters = check_chol_kernels(dev)
    errs.update(errs_chol)
    print("K9, the marginal's triangular product W = L^-1 K_zx:")
    errs["tri_mm"], f64["tri_mm"], tri_mm_cases = check_tri_mm(dev)
    print("K10, the marginal's readers of W (f_mean, diag(W^T W), diag(C^T C)):")
    errs["marginal_moments"], f64["marginal_moments"], moments_cases = check_marginal_moments(dev)
    print("the global SVGP's kernel shapes (K5 on raw pixels and on the toy's 2 inputs, K7):")
    e5, f64_global, k5_global = check_k5_global(dev)
    errs["rbf_gram"] = max(errs["rbf_gram"], e5)
    f64["rbf_gram"].update(f64_global)
    e7, k7_global = check_k7_global(dev)
    errs["cholesky"] = max(errs["cholesky"], e7)
    print("the Retrain ablation's and the regression's kernel shapes (K5's small kernel at "
          "D = 2 and 1):")
    e5, f64_small, k5_small = check_k5_small(dev)
    errs["rbf_gram"] = max(errs["rbf_gram"], e5)
    f64["rbf_gram"].update(f64_small)
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
    print("the global SVGP's training step (one elbo_step each; gradients, card vs CPU):")
    global_launches = {name: check_global_step(name, dev) for name in GLOBAL_STEP}
    print("the Retrain ablation's training step (task 0, task 1's first step and after 5 steps; "
          "gradients, card vs CPU), and K7 at its and the regression's shapes:")
    retrain_launches = check_retrain_step(dev)
    e7, k7_small = check_k7_small(dev, retrain_launches.pop("cond_cov"))
    errs["cholesky"] = max(errs["cholesky"], e7)
    print("training (train blocks on the card):")
    block_launches = check_training(dev)

    print("chain-reload analysis (C's shapes, synthetic Split-MNIST test splits):")
    analysis = check_analysis(dev)

    print("the protocol (split_mnist's first two tasks at A's width, synthetic Split-MNIST):")
    protocol = check_protocol(dev, smi)

    print("the global protocol (s_mnist_global's first two tasks, synthetic Split-MNIST), "
          "and its chain reload:")
    global_protocol = check_global_protocol(dev, smi)

    print("the Retrain protocol (toy_retrain's two tasks, 30 epochs each):")
    retrain_protocol = check_retrain_protocol(dev, smi)
    print("the minted Retrain chain (results/toy_retrain_full/ckpt1.npz) reloaded:")
    minted_retrain = check_minted_retrain(dev)
    print("the regression (the Gaussian likelihood, regression(epochs=300, M=16)):")
    regression = check_regression(dev, smi)
    regression_per_step = {n: v // (REGRESSION["epochs"] + 1)
                           for n, v in regression["launches"].items()}

    print("the exported predictor (A's chain at the evaluation's budget), loaded in a fresh "
          "process, under the default and the fused route:")
    exported = {route: check_export(dev, route) for route in ("default", "fused")}
    print("per-op device profiles of one training step at A, B, D (global) and E (Retrain):")
    profiles = check_profiles(dev, smi)
    print("the FLOP audit of one training step at A and B:")
    check_audit(dev, smi, profiles)
    print("multi-GPU: A's step and a train block on 1 x 2, 2 x 1 and 2 x 2 meshes of ranks that "
          "share card 0 (gloo), against the single-device step; the protocol on 1 x 2:")
    sharded = check_sharded(dev, smi, protocol)

    print("timings (ms per call):")
    spd = flag_k3["(30, 128, 128)"]
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
                **work(build.cost("diag_chol", spd.shape)))},
        ),
        dict(
            name="cross_gram", route="cuda", source="vargp_tpu_torch/csrc/cross_gram.cu",
            replaces="vargp_tpu/ops/pallas/rbf_gram.py:420", cases=grams["cross_gram"],
        ),
        dict(  # its row holds C's K_zz (the symmetric launch)
            name="rbf_gram", route="cuda", source="vargp_tpu_torch/csrc/rbf_gram.cu",
            replaces="vargp_tpu/ops/pallas/rbf_gram.py:47", cases=grams["rbf_gram"],
        ),
        dict(  # no train step runs it (the step records gradients): 0 launches a step
            name="tri_mm", route="cuda", source="vargp_tpu_torch/csrc/tri_mm.cu",
            replaces="none (XLA's dot, vargp_tpu/gpmath/conditional.py:420)", cases=tri_mm_cases,
        ),
        dict(  # nor this one: 0 launches a step
            name="marginal_moments", route="cuda",
            source="vargp_tpu_torch/csrc/marginal_moments.cu",
            replaces="none (XLA's products and reductions, vargp_tpu/gpmath/conditional.py:402)",
            cases=moments_cases,
        ),
    ]
    # K8, K7 and K6 (their wrappers' cost functions): the lower triangle
    # read once, each factor written whole; K7 S^3/3 FMAs' worth of
    # operations, K6 twice that (the factor and the inverse)
    from vargp_tpu_torch.ops import dispatch
    from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain
    from vargp_tpu_torch.ops.cuda.chol_inv import chol_inv, chol_inv_plain
    from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol_chunked

    def cholinv_library(K):
        L = torch.linalg.cholesky(K)
        return torch.linalg.solve_triangular(L, torch.eye(K.shape[-1], device=K.device), upper=False)

    k8in = flag_chol["K8"]
    entries.append(dict(
        name="diag_chol_chunked", route="cuda", source="vargp_tpu_torch/csrc/diag_chol_chunked.cu",
        replaces="vargp_tpu/ops/pallas/chol_panel.py:311", path=None,
        cases={"(30, 128, 128)": dict(
            fn=lambda: diag_chol_chunked(k8in), plain=lambda: diag_chol_plain(k8in),
            library=lambda: torch.linalg.cholesky(k8in), **work(build.cost("diag_chol_chunked", k8in.shape)))},
    ))
    k5_cases, k7_cases = global_kernel_cases(k5_global, k7_global)
    k5_small_cases, k7_small_cases = global_kernel_cases(k5_small, k7_small)
    k5_cases.update(k5_small_cases)
    k7_cases.update(k7_small_cases)
    next(e for e in entries if e["name"] == "rbf_gram")["cases"].update(k5_cases)
    for n, path, src, rpl, fn, plain, lib in (
        ("cholesky", "solve", "chol.cu", "chol.py:82", cholesky, cholesky_plain,
         torch.linalg.cholesky),
        ("chol_inv", "fused", "chol_inv.cu", "chol_inv.py:117", chol_inv, chol_inv_plain,
         cholinv_library),
    ):
        entries.append(dict(
            name=n, route="cuda", source=f"vargp_tpu_torch/csrc/{src}",
            replaces=f"vargp_tpu/ops/pallas/{rpl}", path=path,
            cases={cfg_name: dict(
                cluster=clusters[cfg_name],
                fn=functools.partial(fn, flag_chol[cfg_name]),
                plain=functools.partial(plain, flag_chol[cfg_name]),
                library=functools.partial(lib, flag_chol[cfg_name]),
                **work(build.cost(n, flag_chol[cfg_name].shape))) for cfg_name in ("A", "B")},
        ))
    next(e for e in entries if e["name"] == "cholesky")["cases"].update(k7_cases)
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
        global_step_launches = {k: v[n] for k, v in global_launches.items()}
        print(f"  {n}: launches per global step {global_step_launches}, in the global protocol "
              f"{global_protocol['launches'][n]}, in its chain reload "
              f"{global_protocol['analysis_launches'][n]}")
        retrain_step_launches = {k: v[n] for k, v in retrain_launches.items()}
        print(f"  {n}: launches per Retrain step {retrain_step_launches}, in the Retrain protocol "
              f"{retrain_protocol['launches'][n]}, in the minted chain's reload "
              f"{minted_retrain['launches'][n]}; per regression step {regression_per_step[n]}, "
              f"in the regression run {regression['launches'][n]}")
        kernels.append({
            "name": n, "route": e["route"], "source": e["source"], "replaces": e["replaces"],
            # launches: the counted train steps of the kernel's paths (A, B,
            # C on its route; the global SVGP's two; Retrain's task 0 and 1
            # and a regression step), the exported predictor's call
            # under each route and every rank's sharded step at A
            "launches": sum(per_step.values()) + sum(global_step_launches.values())
            + sum(retrain_step_launches.values()) + regression_per_step[n]
            + sum(v["launches"][n] for v in exported.values())
            + sum(v[n] for per_rank in sharded["launches"].values() for v in per_rank.values()),
            "launches_per_step": per_step, "path": path,
            "sharded_launches_per_step": {label: {r: v[n] for r, v in per_rank.items()}
                                          for label, per_rank in sharded["launches"].items()},
            "sharded_protocol_launches": sharded["protocol_launches"][n],
            "protocol_launches": protocol["launches"][n],
            "global_launches_per_step": global_step_launches,
            "global_protocol_launches": global_protocol["launches"][n],
            "global_reload_launches": global_protocol["analysis_launches"][n],
            "retrain_launches_per_step": retrain_step_launches,
            "retrain_protocol_launches": retrain_protocol["launches"][n],
            "regression_launches_per_step": regression_per_step[n],
            "regression_launches": regression["launches"][n],
            "export_launches_per_call": {r: v["launches"][n] for r, v in exported.items()},
            "traced_per_step": {k: v["traced"].get(n) for k, v in profiles.items()},
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
            ("predict, posterior built each call",
             lambda: (V.clear_posterior_cache(), V.predict(params, prev, xx, pnoise, cfg))),
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
    time_global_training(dev)
    time_retrain_training(dev)
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

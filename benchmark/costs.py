"""The benchmark's frozen counts of operations and bytes.

Two yardsticks, both worked out from shapes alone and kept here so that a
change to the program cannot change them:

- ``operator_cost``: the work of one call of each ``vargp_torch::``
  operator (a hand-written kernel of ``vargp_tpu_torch``) at its input
  shapes: the operations the mathematics needs and the bytes of its
  inputs read once and its outputs written once.  A frozen copy of the
  cost functions the port registered with its operators when this
  benchmark was written (``ops/cuda/*.py``).  ``bound_s`` turns a cost
  into the least time the card could take.
- ``train_step_flops`` / ``predict_call_flops``: the model FLOPs of one
  ELBO training step and of one ``predict`` call, term by term from the
  ELBO's and the predictive's mathematics (``posterior_terms``,
  ``call_terms``, ``model_terms``).  Each product counts 2mnk, a symmetric
  Gram its distinct pairs, a Cholesky factor n^3/3, a triangular solve
  n^2 k; elementwise work (the softmax's Monte Carlo terms among it) and
  recomputation count nothing; a training step counts its forward three
  times (the backward twice the forward).  The chain posterior depends on
  the chain and the hyper draw alone, not on the batch: a ``predict``
  call counts it at the share of calls that draw anew.

The peak is 165 TFLOP/s, NVIDIA's 495 TF32 TFLOP/s of one H100 SXM over
three passes: the rate of f32-accurate products on the tensor cores, the
fastest f32-accurate arithmetic the card has; memory 3.35 TB/s (HBM3).
"""

import math

PEAK_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def _sym_gram(z, invs, gamma2):
    """K1, K2: each distinct (i, j) pair's D-long product once."""
    (O, M, D), (H, _) = z, invs
    return H * O * M * M * D, F32 * (O * M * D + H * D + H + H * O * M * M)


def _cross_gram(z, x, invs2, gamma2):
    """K4: every (i, b) pair's D-long product."""
    (O, M, D), (B, _), (H, _) = z, x, invs2
    return 2 * H * O * M * B * D, F32 * (O * M * D + B * D + H * D + H + H * O * M * B)


def _rbf_gram(sx, sy, gamma2):
    """K5's cross mode."""
    (G, M, D), (_, N, _) = sx, sy
    return 2 * G * M * N * D, F32 * (G * M * D + G * N * D + G + G * M * N)


def _rbf_gram_sym(sx, gamma2):
    """K5's symmetric mode: each mirrored pair once."""
    G, M, D = sx
    return G * M * M * D, F32 * (G * M * D + G + G * M * M)


def _factor(A, n_out=1, n_factor=1):
    """Factoring (..., h, h) blocks: h^3/3 each (``n_factor`` times that
    for a factor and its inverse), the lower triangle read once and
    ``n_out`` h x h outputs written."""
    h, G = A[-1], math.prod(A[:-2])
    return n_factor * G * h ** 3 // 3, F32 * G * (h * (h + 1) // 2 + n_out * h * h)


OPERATORS = {
    "vargp_torch::sym_gram": _sym_gram,
    "vargp_torch::sym_gram_tri": _sym_gram,
    "vargp_torch::cross_gram": _cross_gram,
    "vargp_torch::rbf_gram": _rbf_gram,
    "vargp_torch::rbf_gram_sym": _rbf_gram_sym,
    "vargp_torch::diag_chol": _factor,
    "vargp_torch::diag_chol_chunked": _factor,
    "vargp_torch::cholesky": _factor,
    "vargp_torch::chol_inv": lambda K: _factor(K, n_out=2, n_factor=2),
}


def operator_cost(name: str, shapes) -> tuple[int, int] | None:
    """(operations, bytes) of one call of operator ``name`` at its input
    ``shapes`` (lists of ints, as the profiler records them), or None for
    an operator this table does not know."""
    fn = OPERATORS.get(name)
    if fn is None:
        return None
    return fn(*[tuple(s) for s in shapes[:_arity(fn)]])


def _arity(fn) -> int:
    code = fn.__code__
    return code.co_argcount - len(fn.__defaults__ or ())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call can take: the larger of its operations at the
    peak and its bytes at the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _sizes(cfg: dict, H: int) -> tuple:
    O, M, D = (cfg["model"][k] for k in ("out_size", "M", "in_size"))
    T = cfg["task"] + 1
    return H * O, T, M, T * M, D


def posterior_terms(cfg: dict, H: int) -> dict:
    """The chain posterior's model FLOPs, term by term, at a chain of
    ``cfg``'s tasks (T = task + 1 blocks of M rows a class, S = T M) and H
    hyper samples: what depends on the chain and the draw, not the rows."""
    G, T, M, S, D = _sizes(cfg, H)
    return {
        "K_zz, a symmetric Gram (S^2 D a matrix)": G * S * S * D,
        "chol(K_zz) (S^3 / 3)": G * S ** 3 // 3,
        "each task's whitened mean, L_tt^-1 m_t (T M^2)": G * T * M * M,
        "each task's whitened scale, L_tt^-1 U_t (T M^3)": G * T * M ** 3,
    }


def call_terms(cfg: dict, H: int, B: int) -> dict:
    """The marginal's model FLOPs on B rows, term by term, given the chain
    posterior."""
    G, T, M, S, D = _sizes(cfg, H)
    return {
        "K_zx, a cross Gram (2 S B D)": 2 * G * S * B * D,
        "L^-1 K_zx, a triangular solve (S^2 B)": G * S * S * B,
        "f_mean = v^T W (2 S B)": 2 * G * S * B,
        "C_t = w_t^T W_t (2 T M^2 B)": 2 * G * T * M * M * B,
    }


def model_terms(cfg: dict, H: int, B: int) -> dict:
    """A training forward's model FLOPs, term by term: the chain
    posterior, the marginal on B rows and the KL's terms."""
    G, _, M, S, _ = _sizes(cfg, H)
    c = S - M
    n_v = cfg["model"]["n_var_samples"]
    return dict(posterior_terms(cfg, H), **call_terms(cfg, H, B), **{
        "prefix sample, w_t eps_t (2 n_v (T-1) M^2)": 2 * n_v * G * c * M,
        "prior mean L21 w (2 n_v M c)": 2 * n_v * G * M * c,
        "KL trace, L22^-1 U (M^3)": G * M ** 3,
        "KL mean, L22^-1 (mu_p - mu_q) (n_v M^2)": n_v * G * M * M,
    })


def train_step_flops(cfg: dict, batch_size: int) -> int:
    """One ELBO step: the forward with its KL at the configuration's hyper
    samples, three times (forward and a backward of twice its products)."""
    return 3 * sum(model_terms(cfg, cfg["model"]["n_var_samples"], batch_size).values())


def predict_call_flops(cfg: dict, n_var_samples: int, batch_size: int,
                       builds_per_call: float) -> float:
    """One ``predict`` call at the evaluation's hyper samples: the marginal
    on its batch, and the chain posterior at ``builds_per_call``, the share
    of calls that need a new one (1: every call draws anew).  The
    softmax's Monte Carlo terms are elementwise and count nothing."""
    return (sum(call_terms(cfg, n_var_samples, batch_size).values())
            + builds_per_call * sum(posterior_terms(cfg, n_var_samples).values()))

"""The port's ``predict`` under the deep kernel (DKL) on the CPU: against
the benchmark's plain float64 reference (``benchmark/reference/vargp_dkl.py``,
which imports nothing of either package), and the deep kernel's
``features`` spans and ``tracing.FEATURES`` counter.

The case: 3 classes, M = 4, a chain of three tasks (S = 12), D = 12, phi at
the published widths 12 -> 256 -> 256 -> 64, B = 5 rows, H = 3 hyper
samples, n_f = 4; weights random from a seed, phi at ``torch.nn.Linear``'s
initialisation, the lengthscales at the median distance of the chain's
features.  The port runs in float64 on its plain (CPU) operators, so both
sides compute the same float64 quantities by different routes (the port's
blocked factor and its inverse, the factored whitened posterior; the
reference's ``torch.linalg.cholesky`` and triangular solves).  Their
probabilities agree to ``ATOL`` = 1e-10 absolute: the gap is float64
rounding amplified by the Gram's conditioning (jitter 1e-4), and the
largest seen on four seeds is 8.3e-16; phi's first weights scaled by 1.01
move a probability by 9e-4 or more.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import vargp as R
from benchmark.reference import vargp_dkl as RD
from vargp_tpu_torch.kernels import MLPParams, RBFParams
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.utils import tracing

O, M, D, B, H, N_F, T = 3, 4, 12, 5, 3, 4, 3
WIDTHS = [D, 256, 256, 64]
P = WIDTHS[-1]
JITTER = 1e-4
ATOL = 1e-10
F64 = torch.float64


@pytest.fixture(autouse=True)
def _fresh():
    V.clear_posterior_cache()
    tracing.clear()
    yield
    V.clear_posterior_cache()
    tracing.clear()


def _case(seed: int, n_prev: int = T - 1):
    """The raw problem (the reference's leaves) and its noise, in float64:
    (current, chain, phi, x, x2, noise)."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, dtype=F64)

    phi = []
    for a, b in zip(WIDTHS, WIDTHS[1:]):
        bound = 1.0 / math.sqrt(a)
        phi += [(2 * torch.rand((a, b), generator=g, dtype=F64) - 1) * bound,
                (2 * torch.rand((b,), generator=g, dtype=F64) - 1) * bound]
    n_tri = M * (M + 1) // 2
    chain = [{"z": normal(O, M, D, scale=0.3), "u_mean": normal(O, M, 1, scale=0.3),
              "u_tril_vec": normal(O, n_tri, scale=0.1)} for _ in range(n_prev)]
    z = normal(O, M, D, scale=0.3)
    feats = RD.features(R.F64, phi, torch.cat([z] + [t["z"] for t in chain], 1).reshape(-1, D))
    d2 = torch.cdist(feats, feats) ** 2
    log_ls = 0.5 * math.log(float(torch.quantile(d2[d2 > 0], 0.5)))
    rows, cols = torch.tril_indices(M, M)
    current = {"z": z, "u_mean": normal(O, M, 1, scale=0.5),
               "u_tril_vec": (rows == cols).to(F64) + normal(O, n_tri, scale=0.05),
               "log_mean": torch.cat([log_ls + normal(P, scale=0.05),
                                      torch.tensor([math.log(0.5)], dtype=F64)]),
               "log_logvar": torch.full((P + 1,), -2.0, dtype=F64)}
    noise = {"hyper_eps": normal(H, P + 1), "lik_eps": normal(H, N_F, O, B)}
    return current, chain, phi, normal(B, D, scale=0.3), normal(B, D, scale=0.3), noise


def _port(current, chain, phi):
    params = V.VARGPParams(
        z=current["z"], u_mean=current["u_mean"], u_tril_vec=current["u_tril_vec"],
        kernel=RBFParams(current["log_mean"], current["log_logvar"]),
        phi=MLPParams(weights=tuple(phi[0::2]), biases=tuple(phi[1::2])))
    prev = tuple(V.freeze_task(V.VARGPParams(z=t["z"], u_mean=t["u_mean"],
                                             u_tril_vec=t["u_tril_vec"], kernel=None))
                 for t in chain)
    cfg = V.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H, dkl=True,
                        jitter=JITTER)
    return params, prev, cfg


def _reference(current, chain, phi, x, noise):
    chain = [{"z": t["z"], "u_mean": t["u_mean"], "u_tril": R.unpack_tril(t["u_tril_vec"], M)}
             for t in chain]
    return RD.predict(R.F64, current, chain, phi, x, noise, JITTER, hyper_block=2)


@pytest.mark.parametrize("case", ["build", "reuse", "padded"])
def test_predict_matches_the_float64_reference(case):
    """A call that builds the chain posterior; a second call on new rows
    that reuses it; a chain padded to three tasks with its one dummy task
    masked, against the reference on the real two-task chain."""
    current, chain, phi, x, x2, noise = _case(11, n_prev=1 if case == "padded" else T - 1)
    params, prev, cfg = _port(current, chain, phi)
    mask = None
    if case == "padded":
        prev, mask = V.pad_chain(prev, cfg, T, device="cpu")
        prev = tuple(V.TaskPosterior(*(t.to(F64) for t in p)) for p in prev)
        mask = mask.to(F64)
    before = dict(tracing.POSTERIOR)
    got = V.predict(params, prev, x, noise, cfg, chain_mask=mask, device="cpu")
    if case == "reuse":
        got = V.predict(params, prev, x2, noise, cfg, chain_mask=mask, device="cpu")
        x = x2
    counted = {k: tracing.POSTERIOR[k] - before.get(k, 0) for k in ("build", "reuse")}
    assert counted == {"build": 1, "reuse": int(case == "reuse")}
    want = _reference(current, chain, phi, x, noise)
    assert got.dtype == F64 and got.shape == (B, O)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def _tree(spans) -> list:
    by_id = {s.id: s.name for s in spans}
    return [(s.name, by_id.get(s.parent)) for s in sorted(spans, key=lambda s: s.start)]


def test_features_spans_nest_in_the_posterior_and_the_marginal():
    current, chain, phi, x, x2, noise = _case(12)
    params, prev, cfg = _port(current, chain, phi)
    V.predict(params, prev, x, noise, cfg, device="cpu")
    assert tracing.spans() == []  # tracing off: no span
    V.clear_posterior_cache()
    with profile(activities=[ProfilerActivity.CPU]):
        V.predict(params, prev, x, noise, cfg, device="cpu")
        V.predict(params, prev, x2, noise, cfg, device="cpu")
    marginal = [("marginal", "predict"), ("features", "marginal"), ("features", "marginal"),
                ("likelihood", "predict")]
    assert _tree(tracing.spans()) == (
        [("predict", None), ("posterior", "predict"), ("features", "posterior")] + marginal
        + [("predict", None)] + marginal)


def test_features_counts_the_rows_through_phi():
    """A reused call sends its B rows and the chain's O S inducing rows
    through phi; a call that builds the posterior sends the chain's again."""
    current, chain, phi, x, x2, noise = _case(13)
    params, prev, cfg = _port(current, chain, phi)
    S = T * M
    before = dict(tracing.FEATURES)

    def counted():
        return {k: tracing.FEATURES[k] - before.get(k, 0) for k in ("chain", "batch")}

    V.predict(params, prev, x, noise, cfg, device="cpu")
    assert counted() == {"chain": 2 * O * S, "batch": B}
    V.predict(params, prev, x2, noise, cfg, device="cpu")
    assert counted() == {"chain": 3 * O * S, "batch": 2 * B}

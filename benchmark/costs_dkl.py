"""The model FLOPs of one ``predict`` call under the deep kernel (DKL).

``costs.py``'s rules (a product 2mnk, a symmetric Gram its distinct pairs,
a factor n^3/3, a triangular solve n^2 k; elementwise work, the ReLUs and
the biases among it, and recomputation count nothing), on two changes:

- the Grams K_zz and K_zx see phi's P features, not the D pixels;
- phi itself: each of its products, 2 rows (D h + h h + h P) for widths
  D, h, h, P.  phi over the chain's inducing rows (every class's, O S
  rows) counts once with the posterior, once a pass; phi over the batch
  (B rows, which every class shares) once a call.  The program applies
  phi to the chain again in every call's marginal: recomputation, which
  counts nothing.
"""

from benchmark import costs


def phi_flops(dims: list, rows: int) -> int:
    """phi's products on ``rows`` rows, widths ``dims`` (input first)."""
    return 2 * rows * sum(a * b for a, b in zip(dims, dims[1:]))


def _feature_cfg(cfg: dict) -> dict:
    """``cfg`` with the Grams' width set to phi's output."""
    return dict(cfg, model=dict(cfg["model"], in_size=cfg["phi_widths"][-1]))


def posterior_terms(cfg: dict, H: int) -> dict:
    """The chain posterior's model FLOPs, term by term: phi over the chain,
    then ``costs.posterior_terms`` on the features."""
    m = cfg["model"]
    rows = m["out_size"] * (cfg["task"] + 1) * m["M"]
    return {"phi over the chain's inducing rows (O S rows)": phi_flops(cfg["phi_widths"], rows),
            **costs.posterior_terms(_feature_cfg(cfg), H)}


def call_terms(cfg: dict, H: int, B: int) -> dict:
    """The marginal's model FLOPs on B rows, term by term: phi over the
    batch, then ``costs.call_terms`` on the features."""
    return {"phi over the batch (B rows)": phi_flops(cfg["phi_widths"], B),
            **costs.call_terms(_feature_cfg(cfg), H, B)}


def predict_call_flops(cfg: dict, n_var_samples: int, batch_size: int,
                       builds_per_call: float) -> float:
    """One ``predict`` call: the marginal on its batch, and the chain
    posterior at ``builds_per_call``, the share of calls that need a new
    one."""
    return (sum(call_terms(cfg, n_var_samples, batch_size).values())
            + builds_per_call * sum(posterior_terms(cfg, n_var_samples).values()))

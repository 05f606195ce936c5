"""Closed-form multivariate-normal operations.

Counterpart of ``vargp_tpu/gpmath/mvn.py``: the KL between two MVNs given
by scale factors, the log-density, reparameterised sampling with the
noise passed in, and the diagonal normal KL of the kernel
hyperparameters.
"""

import math

import torch

from vargp_tpu_torch.gpmath.linalg import mm, tri_half_split, tri_solve


def _log_diag(L: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.diagonal(L, dim1=-2, dim2=-1))


def mvn_kl(mu_q: torch.Tensor, L_q: torch.Tensor, mu_p: torch.Tensor,
           L_p: torch.Tensor, Lp_inv: torch.Tensor | None = None) -> torch.Tensor:
    """KL( N(mu_q, L_q L_q^T) || N(mu_p, L_p L_p^T) ), batched.

    mu_q, mu_p: ... x k;  L_q, L_p: ... x k x k lower-triangular;
    Lp_inv: the inverse of L_p, or None to solve against L_p instead.
    Returns ... (a batch of scalars)."""
    k = mu_q.shape[-1]
    Lq_b = torch.broadcast_to(L_q, torch.broadcast_shapes(L_q.shape, L_p.shape))
    diff = (mu_p - mu_q)[..., None]
    if Lp_inv is None:
        trace = torch.sum(torch.square(tri_solve(L_p, Lq_b)), dim=(-2, -1))
        w = tri_solve(L_p, diff)
    else:
        h = tri_half_split(k)
        if h is not None:
            # both factors are lower-triangular, so their product is too:
            # the 2x2 block split skips its structurally-zero upper block
            a1, a2, a3 = Lp_inv[..., :h, :h], Lp_inv[..., h:, :h], Lp_inv[..., h:, h:]
            b1, b2, b3 = Lq_b[..., :h, :h], Lq_b[..., h:, :h], Lq_b[..., h:, h:]
            trace = (
                torch.sum(torch.square(mm(a1, b1)), dim=(-2, -1))
                + torch.sum(torch.square(mm(a2, b1) + mm(a3, b2)), dim=(-2, -1))
                + torch.sum(torch.square(mm(a3, b3)), dim=(-2, -1))
            )
        else:
            trace = torch.sum(torch.square(mm(Lp_inv, Lq_b)), dim=(-2, -1))
        w = mm(Lp_inv, diff)
    maha = torch.sum(torch.square(w), dim=(-2, -1))
    logdet = torch.sum(_log_diag(L_p), dim=-1) - torch.sum(_log_diag(L_q), dim=-1)
    return 0.5 * (trace + maha - k) + logdet


def mvn_log_prob(x: torch.Tensor, mu: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """log N(x; mu, L L^T), batched: x, mu ... x k, L ... x k x k."""
    k = x.shape[-1]
    w = tri_solve(L, (x - mu)[..., None])
    maha = torch.sum(torch.square(w), dim=(-2, -1))
    logdet = torch.sum(_log_diag(L), dim=-1)
    return -0.5 * (k * math.log(2.0 * math.pi) + maha) - logdet


def mvn_sample(mu: torch.Tensor, L: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Reparameterised samples mu + L eps: mu ... x k, L ... x k x k, eps
    (sample_shape x ... x k) the standard-normal draws, passed in."""
    return mu + torch.einsum("...ij,...j->...i", L, eps)


def diag_normal_kl(mu_q: torch.Tensor, logvar_q: torch.Tensor,
                   mu_p: torch.Tensor, logvar_p: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(mu_q, e^{logvar_q}) || N(mu_p, e^{logvar_p}) )."""
    var_ratio = torch.exp(logvar_q - logvar_p)
    maha = torch.square(mu_q - mu_p) * torch.exp(-logvar_p)
    return 0.5 * (var_ratio + maha - 1.0 - logvar_q + logvar_p)

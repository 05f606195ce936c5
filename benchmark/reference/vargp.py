"""Plain PyTorch reference of VAR-GP: the ELBO of the current task over an
auto-regressive chain of sparse GPs, its gradient, Yogi's update, and the
predictive class probabilities.

Written from the mathematics of VAR-GP (Kapoor, Karaletsos & Bui, ICML
2021, arXiv:2006.05468; the reference code uber-research/vargp) and
nothing of the program: torch's own Cholesky, triangular solves and
autograd.  Every quantity the program derives (the hyper samples, the
Grams, the chain's factor, the whitened posterior, the parameter updates)
is worked out again here from the raw inputs the benchmark made.

The model, per class o and hyper sample theta = (log lengthscales, log
scale) ~ q(theta) = N(log_mean, diag exp(log_logvar)):

- k(a, b) = gamma^2 exp(-|(a - b) / l|^2 / 2), gamma^2 = exp(2 theta_D),
  l = exp(theta_:D); K = k(Z, Z) + jitter I over the chain's inducing
  rows Z (T tasks of M rows, S = T M), K = L L^T.
- The AR posterior: u = L w, each task's whitened block independent,
  w_t = L_tt^-1 (m_t + U_t xi_t), U_t lower-triangular (the current
  task's unpacked row-major from ``u_tril_vec``, softplus on the
  diagonal).
- The marginal at x: W = L^-1 k(Z, x), f_mean = v^T W (v_t = L_tt^-1 m_t),
  f_var = gamma^2 - |W|^2 + sum_t |(L_tt^-1 U_t)^T W_t|^2.
- The current task's KL against its conditional prior given a sample of
  the earlier tasks: mean L21 w_<t, scale L22; q's mean is that plus m_t.
- The likelihood: f = f_mean + sqrt(f_var) eps per function sample, a
  softmax over classes; the ELBO's nll is the Monte-Carlo mean of -log
  p(y), summed over the batch's weighted rows; predictions average the
  softmax over every hyper and function sample.
- The objective beta KL(q(theta) || p(theta)) + KL_u + n_train / sum(w) nll,
  minimised by Yogi (b1 0.9, b2 0.999, eps 1e-3, moments started at 1e-6).

``Arith`` sets the precision: ``F64`` is the reference; ``TF32`` is the
control, float32 whose every matrix product rounds its operands to TF32
(10 mantissa bits) as the card's tensor cores do with TF32 allowed, in the
backward too.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

B1, B2, YOGI_EPS, YOGI_INIT = 0.9, 0.999, 1e-3, 1e-6


class Arith(NamedTuple):
    dtype: torch.dtype
    tf32: bool


F64 = Arith(torch.float64, False)
TF32 = Arith(torch.float32, True)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        sa, sb = ctx.shapes
        rg = tf32_round(g)
        da = torch.matmul(rg, rb.transpose(-1, -2)).sum_to_size(sa)
        db = torch.matmul(ra.transpose(-1, -2), rg).sum_to_size(sb)
        return da, db


def mm(arith: Arith, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The matrix product a @ b in ``arith``'s precision."""
    if arith.tf32:
        return _TF32Matmul.apply(a, b)
    return torch.matmul(a, b)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def unpack_tril(vec: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m(m+1)/2) packed row-major -> (..., m, m) lower-triangular,
    softplus on the diagonal."""
    rows, cols = torch.tril_indices(m, m, device=vec.device)
    out = vec.new_zeros((*vec.shape[:-1], m, m))
    out[..., rows, cols] = vec
    diag = torch.diagonal(out, dim1=-2, dim2=-1)
    return out - torch.diag_embed(diag) + torch.diag_embed(F.softplus(diag))


def hypers(log_mean, log_logvar, hyper_eps):
    """theta (H, D+1) -> (1 / lengthscales (H, D), gamma^2 (H,))."""
    theta = log_mean + torch.exp(0.5 * log_logvar) * hyper_eps
    return torch.exp(-theta[:, :-1]), torch.exp(2.0 * theta[:, -1])


def rbf(arith: Arith, inv_ls, gamma2, a, b):
    """k(a, b) per hyper sample: a (O, N, D), b (O, K, D) or (K, D) shared
    by the classes -> (H, O, N, K)."""
    sa = a[None] * inv_ls[:, None, None, :]
    sb = b[None] * inv_ls[:, None, None, :] if b.dim() == 3 else (b[None] * inv_ls[:, None, :])[:, None]
    na = torch.sum(sa * sa, dim=-1)[..., :, None]
    nb = torch.sum(sb * sb, dim=-1)[..., None, :]
    d2 = torch.clamp(na + nb - 2.0 * mm(arith, sa, sb.transpose(-1, -2)), min=0.0)
    return gamma2[:, None, None, None] * torch.exp(-0.5 * d2)


class Posterior(NamedTuple):
    inv_ls: torch.Tensor  # (H, D)
    gamma2: torch.Tensor  # (H,)
    z_all: torch.Tensor  # (O, S, D)
    L: torch.Tensor  # (H, O, S, S)
    v: list  # per task (H, O, M, 1): L_tt^-1 m_t
    w: list  # per task (H, O, M, M): L_tt^-1 U_t


def posterior(arith: Arith, chain: list, current: dict, hyper_eps, jitter: float) -> Posterior:
    """The AR posterior over the whole chain.  ``chain`` holds the earlier
    tasks' dicts (z, u_mean, u_tril: unpacked), ``current`` the task's
    parameters (z, u_mean, u_tril_vec, log_mean, log_logvar)."""
    M = current["z"].shape[-2]
    inv_ls, gamma2 = hypers(current["log_mean"], current["log_logvar"], hyper_eps)
    z_all = torch.cat([t["z"] for t in chain] + [current["z"]], dim=-2)
    S = z_all.shape[-2]
    K = rbf(arith, inv_ls, gamma2, z_all, z_all)
    K = K + jitter * torch.eye(S, dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(K)
    means = [t["u_mean"] for t in chain] + [current["u_mean"]]
    trils = [t["u_tril"] for t in chain] + [unpack_tril(current["u_tril_vec"], M)]
    v, w = [], []
    for t, (m_t, U_t) in enumerate(zip(means, trils)):
        Ltt = L[..., t * M:(t + 1) * M, t * M:(t + 1) * M]
        v.append(solve_lower(Ltt, m_t.expand(*Ltt.shape[:-1], 1)))
        w.append(solve_lower(Ltt, U_t.expand(Ltt.shape)))
    return Posterior(inv_ls, gamma2, z_all, L, v, w)


def marginal(arith: Arith, post: Posterior, x: torch.Tensor):
    """(f_mean, f_var), each (H, O, B), at the rows x (B, D)."""
    Kzx = rbf(arith, post.inv_ls, post.gamma2, post.z_all, x)
    W = solve_lower(post.L, Kzx)
    M = post.w[0].shape[-1]
    v = torch.cat(post.v, dim=-2)
    f_mean = mm(arith, v.transpose(-1, -2), W)[..., 0, :]
    var = post.gamma2[:, None, None] - torch.sum(W * W, dim=-2)
    for t, w_t in enumerate(post.w):
        C = mm(arith, w_t.transpose(-1, -2), W[..., t * M:(t + 1) * M, :])
        var = var + torch.sum(C * C, dim=-2)
    return f_mean, torch.clamp(var, min=0.0)


def kl_u(arith: Arith, post: Posterior, current: dict, prefix_eps, ep_var_mean: bool = True):
    """The current task's KL against its conditional prior, averaged over
    the prefix samples and hyper samples, summed over classes.  With
    ``ep_var_mean`` q's mean is the prior's conditional mean plus m_t,
    else m_t alone."""
    M = current["z"].shape[-2]
    L = post.L
    S = L.shape[-1]
    c = S - M
    U = unpack_tril(current["u_tril_vec"], M)
    m = current["u_mean"][..., 0]
    if c == 0:
        mu_p = torch.zeros_like(m)
        L22 = L
        mu_q = m
    else:
        eps = prefix_eps  # (n_v, H, O, c)
        blocks = []
        for t in range(c // M):
            e_t = eps[..., t * M:(t + 1) * M, None]
            blocks.append(post.v[t] + mm(arith, post.w[t], e_t))
        w_pre = torch.cat(blocks, dim=-2)  # (n_v, H, O, c, 1)
        mu_p = mm(arith, L[..., c:, :c], w_pre)[..., 0]  # (n_v, H, O, M)
        mu_q = mu_p + m if ep_var_mean else m.expand_as(mu_p)
        L22 = L[..., c:, c:]
    A = solve_lower(L22, U.expand(L22.shape))
    trace = torch.sum(A * A, dim=(-2, -1))
    diff = solve_lower(L22, (mu_p - mu_q)[..., None])
    maha = torch.sum(diff * diff, dim=(-2, -1))
    logdet = (torch.sum(torch.log(torch.diagonal(L22, dim1=-2, dim2=-1)), dim=-1)
              - torch.sum(torch.log(torch.diagonal(U, dim1=-2, dim2=-1)), dim=-1))
    kl = 0.5 * (trace + maha - M) + logdet
    return torch.mean(torch.sum(kl, dim=-1))


def kl_hypers(current: dict, prior: dict):
    lq, vq = current["log_mean"], current["log_logvar"]
    lp, vp = prior["log_mean"], prior["log_logvar"]
    return torch.sum(0.5 * (torch.exp(vq - vp) + (lq - lp) ** 2 * torch.exp(-vp) - 1.0 - vq + vp))


def nll(f_mean, f_var, y, w, lik_eps):
    f = f_mean[:, None] + torch.sqrt(f_var)[:, None] * lik_eps  # (H, n_f, O, B)
    logp = torch.log_softmax(f, dim=-2)
    picked = torch.gather(logp, -2, y.reshape(1, 1, 1, -1).expand(*logp.shape[:2], 1, -1))
    return -torch.sum(torch.mean(picked[..., 0, :], dim=(0, 1)) * w)


PARAM_KEYS = ("z", "u_mean", "u_tril_vec", "log_mean", "log_logvar")


def to_arith(tree: dict, arith: Arith) -> dict:
    return {k: v.to(arith.dtype) if v.is_floating_point() else v for k, v in tree.items()}


def elbo(arith: Arith, current: dict, chain: list, prior: dict, batch: dict, noise: dict,
         hp: dict):
    """(objective, (kl_hypers, kl_u, nll)) of one step."""
    post = posterior(arith, chain, current, noise["hyper_eps"], hp["jitter"])
    f_mean, f_var = marginal(arith, post, batch["x"])
    klh = kl_hypers(current, prior)
    klu = kl_u(arith, post, current, noise.get("prefix_eps"), hp["ep_var_mean"])
    ll = nll(f_mean, f_var, batch["y"], batch["w"], noise["lik_eps"])
    scale = hp["n_train"] / torch.clamp(torch.sum(batch["w"]), min=1.0)
    return hp["beta"] * klh + klu + scale * ll, (klh, klu, ll)


def yogi_init(params: dict) -> dict:
    return {"count": 0, "mu": {k: torch.full_like(v, YOGI_INIT) for k, v in params.items()},
            "nu": {k: torch.full_like(v, YOGI_INIT) for k, v in params.items()}}


def yogi_update(params: dict, grads: dict, state: dict, lr: float):
    c = state["count"] + 1
    bc1, bc2 = 1.0 - B1 ** c, 1.0 - B2 ** c
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = (1.0 - B1) * g + B1 * state["mu"][k]
        g2 = g * g
        v = state["nu"][k] - (1.0 - B2) * torch.sign(state["nu"][k] - g2) * g2
        new_p[k] = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + YOGI_EPS)
        mu[k], nu[k] = m, v
    return new_p, {"count": c, "mu": mu, "nu": nu}


def train_steps(arith: Arith, params: dict, chain: list, prior: dict, steps: list, hp: dict):
    """Follow ``steps`` (each a dict of batch x, y, w and noise) from
    ``params``.  Returns (losses, first step's gradients, parameters after
    the last step), in ``arith``'s dtype."""
    params = {k: params[k].to(arith.dtype) for k in PARAM_KEYS}
    chain = [to_arith(t, arith) for t in chain]
    prior = to_arith(prior, arith)
    state = yogi_init(params)
    losses, first_grads = [], None
    for step in steps:
        batch = to_arith(step["batch"], arith)
        noise = to_arith(step["noise"], arith)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            total, _ = elbo(arith, leaves, chain, prior, batch, noise, hp)
        grads = torch.autograd.grad(total, [leaves[k] for k in PARAM_KEYS])
        grads = dict(zip(PARAM_KEYS, grads))
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in grads.items()}
        losses.append(float(total.detach()))
        params, state = yogi_update({k: v.detach() for k, v in params.items()}, grads, state,
                                    hp["lr"])
    return losses, first_grads, params


def predict(arith: Arith, current: dict, chain: list, x: torch.Tensor, noise: dict,
            jitter: float, hyper_block: int = 4) -> torch.Tensor:
    """Class probabilities (B, O): the softmax averaged over every hyper and
    function sample, the hyper samples taken ``hyper_block`` at a time so
    that the posterior fits beside the program's freed state."""
    current = to_arith(current, arith)
    chain = [to_arith(t, arith) for t in chain]
    x = x.to(arith.dtype)
    hyper_eps, lik_eps = noise["hyper_eps"].to(arith.dtype), noise["lik_eps"].to(arith.dtype)
    total = 0.0
    for h0 in range(0, hyper_eps.shape[0], hyper_block):
        post = posterior(arith, chain, current, hyper_eps[h0:h0 + hyper_block], jitter)
        f_mean, f_var = marginal(arith, post, x)
        f = f_mean[:, None] + torch.sqrt(f_var)[:, None] * lik_eps[h0:h0 + hyper_block]
        total = total + torch.sum(torch.softmax(f, dim=-2), dim=(0, 1))
    n = hyper_eps.shape[0] * lik_eps.shape[1]
    return (total / n).T


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))

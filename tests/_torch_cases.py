"""Shared small VAR-GP cases for the port's parity tests: the same numpy
parameters and data handed to the JAX package and to vargp_tpu_torch, and
the JAX package's own noise replayed for the port."""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vargp_tpu import gpmath as jgm
from vargp_tpu.models import vargp as JV
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.utils import convert

f32 = np.float32

# The suite runs its files in several worker processes on shared cores,
# and torch's OpenMP threads spin while they wait for each other: one
# intra-op thread per process (set when the test files are collected)
# runs the port's tests several times faster there.
torch.set_num_threads(1)

# S = 3 x 64 = 192 (blocked 2 x 96), padded S = 4 x 64 = 256 (2 x 128);
# S = 4 x 128 = 512 takes K2 and the triangle-skip Cholesky backward
# (tri_half_split(512) = 256) on both sides.
SIZES = {
    "small": dict(O=3, M=64, D=16, B=32, H=2, N_F=4, n_prev=2),
    "long": dict(O=2, M=128, D=16, B=32, H=2, N_F=4, n_prev=3),
}


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest with ties
    away from zero, 10 mantissa bits kept (on the int32 view: add half of
    the dropped 13 bits to the magnitude, then clear them)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """The kernels' 3xTF32 product: big = tf32(x), small = tf32(x - big),
    small*big + big*small + big*big summed in f32."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return torch.matmul(asm, bb) + torch.matmul(ab, bsm) + torch.matmul(ab, bb)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build(size: str, seed: int = 0) -> dict:
    d = SIZES[size]
    O, M, D, B, H, N_F = (d[k] for k in ("O", "M", "D", "B", "H", "N_F"))
    rng = np.random.default_rng(seed)
    prev = tuple(
        JV.TaskPosterior(
            z=jnp.asarray((rng.standard_normal((O, M, D)) * 0.3).astype(f32)),
            u_mean=jnp.asarray((rng.standard_normal((O, M, 1)) * 0.3).astype(f32)),
            u_tril=jgm.vec2tril(jnp.asarray(
                (rng.standard_normal((O, M * (M + 1) // 2)) * 0.1).astype(f32))),
        )
        for _ in range(d["n_prev"])
    )
    cfg = JV.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H)
    z = jnp.asarray((rng.standard_normal((O, M, D)) * 0.3).astype(f32))
    params, prior = JV.init_params(jax.random.key(seed), z, cfg)
    params = params._replace(u_tril_vec=params.u_tril_vec + jnp.asarray(
        (rng.standard_normal(params.u_tril_vec.shape) * 0.05).astype(f32)))
    prior = prior._replace(log_mean=prior.log_mean + 0.3)
    x = jnp.asarray((rng.standard_normal((B, D)) * 0.3).astype(f32))
    y = jnp.asarray(rng.integers(0, O, B))
    w = jnp.asarray((rng.random(B) > 0.2).astype(f32))
    tcfg = TV.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H)
    return dict(cfg=cfg, tcfg=tcfg, params=params, prior=prior, prev=prev, x=x, y=y, w=w,
                dims=d)


# The JAX package's random MLP maps these inputs to features 0.05 apart,
# where K_zz is nearly singular (kl_u ~ 1e5) and f32 rounding in either
# package moves the ELBO by 2e-5 relative.  Scaling the last layer by 4
# spreads the features as the plain model's inputs are spread (kl_u ~ 1e3).
PHI_GAIN = 4.0


def build_dkl(size: str = "small", seed: int = 0) -> dict:
    """``build``'s case under the deep kernel: the JAX package's own
    ``init_params`` (phi from its ``init_mlp``), the last layer scaled by
    PHI_GAIN, the same perturbed scale factor and prior shift."""
    m = build(size, seed)
    cfg, tcfg = replace(m["cfg"], dkl=True), replace(m["tcfg"], dkl=True)
    params, prior = JV.init_params(jax.random.key(seed), m["params"].z, cfg)
    phi = params.phi
    phi = phi._replace(weights=(*phi.weights[:-1], phi.weights[-1] * PHI_GAIN),
                       biases=(*phi.biases[:-1], phi.biases[-1] * PHI_GAIN))
    params = params._replace(u_tril_vec=m["params"].u_tril_vec, phi=phi)
    prior = prior._replace(log_mean=prior.log_mean + 0.3)
    return dict(m, cfg=cfg, tcfg=tcfg, params=params, prior=prior)


def chain(m: dict, case: str):
    """(prev, chain_mask) of the JAX side: the whole chain, no chain
    (task 0), or the chain padded by one inert slot."""
    if case == "chain":
        return m["prev"], None
    if case == "task0":
        return (), None
    return JV.pad_chain(m["prev"], m["cfg"], len(m["prev"]) + 2)


def jax_draws(m: dict, key, c: int):
    """The draws ``JV.loss`` makes from ``key``: hyper samples, prefix draws
    of u_{<t} (with a chain of c rows) and function samples."""
    d, cfg = m["dims"], m["cfg"]
    O, B, N_F = d["O"], d["B"], d["N_F"]
    n_v = cfg.n_var_samples
    H = 1 if cfg.map_est_hypers else n_v  # MAP draws no hypers: the port ignores them
    k_fwd, k_lik = jax.random.split(key)
    k_hyp, k_u = jax.random.split(k_fwd)
    hyper = jax.random.normal(k_hyp, (n_v, JV._theta_size(cfg) + 1), jnp.float32)
    prefix = jax.random.normal(k_u, (n_v, H, O, c), jnp.float32) if c else None
    lik = jax.random.normal(k_lik, (H, N_F, O, B), jnp.float32)
    return hyper, prefix, lik


def port_inputs(m: dict, prev, mask, key, params=None):
    """The port's (params, prev, prior, x, y, w, noise, chain_mask) on the
    CPU for the JAX case, with the JAX draws of ``key``."""
    tp, tprev, tprior = convert.params_from_numpy(
        np_tree(m["params"] if params is None else params), np_tree(prev),
        np_tree(m["prior"]), device="cpu")
    hyper, prefix, lik = jax_draws(m, key, len(prev) * m["dims"]["M"])
    noise = convert.noise_for_loss(hyper, prefix, lik, device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))
    return (tp, tprev, tprior, t(m["x"]), t(m["y"]), t(m["w"]), noise,
            None if mask is None else t(mask))


def _loss_draws(key, cfg, O: int, B: int, c: int):
    """``JV.loss``'s draws from ``key`` for a config and a chain of c rows."""
    n_v = cfg.n_var_samples
    H = 1 if cfg.map_est_hypers else n_v
    k_fwd, k_lik = jax.random.split(key)
    k_hyp, k_u = jax.random.split(k_fwd)
    hyper = jax.random.normal(k_hyp, (n_v, JV._theta_size(cfg) + 1), jnp.float32)
    prefix = jax.random.normal(k_u, (n_v, H, O, c), jnp.float32) if c else None
    lik = jax.random.normal(k_lik, (H, cfg.n_f, O, B), jnp.float32)
    return hyper, prefix, lik


def _mlp_uniform(key, dims):
    """The U[0, 1) draws the JAX package's ``init_mlp`` makes from ``key``."""
    draws = []
    for i in range(len(dims) - 1):
        key, wk, bk = jax.random.split(key, 3)
        draws += [jax.random.uniform(wk, (dims[i], dims[i + 1])),
                  jax.random.uniform(bk, (dims[i + 1],))]
    return draws


class JaxDraws:
    """A draw source for the port's ``train_task`` that replays the draws
    the JAX ``train_task`` makes from ``key``: ``k_init`` for the inducing
    rows and the initial parameters, then one key split off ``k_run`` per
    train block (each epoch's permutation from ``fold_in(k_blk, e)``, step
    s's loss noise from ``fold_in(k_blk, n_epochs + s)``) and per
    evaluation (``make_device_eval_fn``'s: theta from ``k_post``, batch
    i's function samples from ``fold_in(k_lik, i)``; per batch,
    ``predict``'s draws from ``fold_in(k_ev, i)``)."""

    def __init__(self, key):
        self.k_init, self.key_seq = jax.random.split(key)

    @staticmethod
    def _t(a):
        return torch.tensor(np.asarray(a))

    def inducing(self, data, M, out_size):
        z = JV.select_inducing(self.k_init, jnp.asarray(data.numpy()), M, out_size)
        return self._t(z).to(data.device)

    def init(self, cfg, with_phi):
        from vargp_tpu.kernels.deep import DEFAULT_FEATURES, DEFAULT_HIDDEN

        k_kern, k_u, k_phi = jax.random.split(self.k_init, 3)
        out = {"kernel_eps": self._t(jax.random.normal(k_kern, (JV._theta_size(cfg) + 1,))),
               "u_eps": self._t(jax.random.normal(k_u, (cfg.out_size, cfg.M, 1)))}
        if with_phi:
            dims = [cfg.in_size, DEFAULT_HIDDEN, DEFAULT_HIDDEN, DEFAULT_FEATURES]
            out["phi_uniform"] = [self._t(u) for u in _mlp_uniform(k_phi, dims)]
        return out

    def block(self, n_pad, batch_size, n_epochs, cfg, n_prev):
        self.key_seq, k_blk = jax.random.split(self.key_seq)
        steps = n_pad // batch_size
        for e in range(n_epochs):
            perm = self._t(jax.random.permutation(jax.random.fold_in(k_blk, e), n_pad)).long()
            for s in range(steps):
                k = jax.random.fold_in(k_blk, n_epochs + e * steps + s)
                hyper, prefix, lik = _loss_draws(k, cfg, cfg.out_size, batch_size,
                                                 n_prev * cfg.M)
                yield (perm[s * batch_size:(s + 1) * batch_size],
                       convert.noise_for_loss(hyper, prefix, lik, device="cpu"))

    def evaluation(self, cfg_eval, n_batches, batch_size, per_batch):
        self.key_seq, k_ev = jax.random.split(self.key_seq)
        return jax_eval_draws(k_ev, cfg_eval, n_batches, batch_size, per_batch)


def jax_eval_draws(k_ev, cfg_eval, n_batches, batch_size, per_batch):
    """The draws of the JAX ``make_device_eval_fn`` from ``k_ev`` as the
    port's evaluation noise: hyper_eps (n_v, P+1), or (K, n_v, P+1) per
    batch, and lik_eps (K, H, n_f, O, B)."""
    t = JaxDraws._t
    H = 1 if cfg_eval.map_est_hypers else cfg_eval.n_var_samples
    O, n_v, P = cfg_eval.out_size, cfg_eval.n_var_samples, JV._theta_size(cfg_eval)
    lik_shape = (H, cfg_eval.n_f, O, batch_size)
    if per_batch:
        hyper, lik = [], []
        for i in range(n_batches):
            k_fwd, k_lik = jax.random.split(jax.random.fold_in(k_ev, i))
            k_hyp, _ = jax.random.split(k_fwd)
            hyper.append(jax.random.normal(k_hyp, (n_v, P + 1)))
            lik.append(jax.random.normal(k_lik, lik_shape))
        return {"hyper_eps": t(jnp.stack(hyper)), "lik_eps": t(jnp.stack(lik))}
    k_post, k_lik = jax.random.split(k_ev)
    return {
        "hyper_eps": t(jax.random.normal(k_post, (n_v, P + 1))),
        "lik_eps": t(jnp.stack([jax.random.normal(jax.random.fold_in(k_lik, i), lik_shape)
                                for i in range(n_batches)])),
    }

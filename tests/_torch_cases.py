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
from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten
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

    def block(self, n_pad, batch_size, n_epochs, cfg, *shape):
        """The port's ``block`` seam: one key split off the run's per train
        block, epoch e's permutation from ``fold_in(k_blk, e)``, step s's
        loss draws from ``fold_in(k_blk, n_epochs + s)`` (``step_noise``)."""
        self.key_seq, k_blk = jax.random.split(self.key_seq)
        steps = n_pad // batch_size
        for e in range(n_epochs):
            perm = self._t(jax.random.permutation(jax.random.fold_in(k_blk, e), n_pad)).long()
            for s in range(steps):
                k = jax.random.fold_in(k_blk, n_epochs + e * steps + s)
                yield (perm[s * batch_size:(s + 1) * batch_size],
                       self.step_noise(k, cfg, batch_size, *shape))

    @staticmethod
    def step_noise(k, cfg, batch_size, n_prev):
        hyper, prefix, lik = _loss_draws(k, cfg, cfg.out_size, batch_size, n_prev * cfg.M)
        return convert.noise_for_loss(hyper, prefix, lik, device="cpu")

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


# ---------------------------------------------------------------------------
# The global continual SVGP
# ---------------------------------------------------------------------------

GLOBAL = dict(O=3, M=6, M_grown=9, D=5, B=16, H=2, N_F=4)


def global_cfgs(M: int, **kw):
    """The JAX and the port's ``GlobalSVGPConfig`` at GLOBAL's widths."""
    from vargp_tpu.models import global_svgp as JG
    from vargp_tpu_torch.models import global_svgp as TG

    d = GLOBAL
    args = dict(M=M, out_size=d["O"], in_size=d["D"], n_f=d["N_F"], n_var_samples=d["H"], **kw)
    return JG.GlobalSVGPConfig(**args), TG.GlobalSVGPConfig(**args)


def build_global(case: str, seed: int = 0) -> dict:
    """A global SVGP case at GLOBAL's widths, the JAX side's trees:
    ``task0`` (no previous task, M = 6), ``grown`` (a previous task of 6
    rows, M = 9: its rows followed by 3 new ones) and ``copy`` (M = 6, z a
    copy of prev.z: the first step of a task that grows nothing, where
    Kxx - W^T W is rounding around 0).  The current task's u_tril_vec and
    the prior are perturbed off their initial values."""
    from vargp_tpu.models import global_svgp as JG

    d = GLOBAL
    O, D, B = d["O"], d["D"], d["B"]
    rng = np.random.default_rng(seed)
    rows = lambda n: jnp.asarray((rng.standard_normal((O, n, D)) * 0.5).astype(f32))
    prev = None
    M = d["M_grown"] if case == "grown" else d["M"]
    if case == "task0":
        z = rows(M)
    else:
        jcfg_prev, _ = global_cfgs(d["M"])
        pp, _ = JG.init_params(jax.random.key(seed + 1), rows(d["M"]), jcfg_prev)
        noise = lambda a, s: jnp.asarray((rng.standard_normal(a.shape) * s).astype(f32))
        pp = pp._replace(u_mean=pp.u_mean + noise(pp.u_mean, 0.3),
                         u_tril_vec=noise(pp.u_tril_vec, 0.2))
        prev = JG.freeze_task(pp)
        z = (jnp.concatenate([prev.z, rows(M - d["M"])], axis=-2) if case == "grown"
             else jnp.array(prev.z))
    jcfg, tcfg = global_cfgs(M)
    params, prior = JG.init_params(jax.random.key(seed), z, jcfg)
    params = params._replace(u_tril_vec=params.u_tril_vec + jnp.asarray(
        (rng.standard_normal(params.u_tril_vec.shape) * 0.05).astype(f32)))
    prior = prior._replace(log_mean=prior.log_mean + 0.3)
    x = jnp.asarray((rng.standard_normal((B, D)) * 0.5).astype(f32))
    y = jnp.asarray(rng.integers(0, O, B))
    w = jnp.asarray((rng.random(B) > 0.2).astype(f32))
    return dict(cfg=jcfg, tcfg=tcfg, params=params, prior=prior, prev=prev, x=x, y=y, w=w)


def global_loss_draws(key, cfg, B: int, M_prev: int | None, dtype=jnp.float32):
    """The draws ``global_svgp.loss`` makes from ``key`` (split three ways:
    forward, likelihood, regulariser): hyper samples (n_v, D+1), function
    samples (H, n_f, O, B) and, with a previous task, the regulariser's
    (n_v, H, O, M_prev), in the parameters' ``dtype``."""
    n_v = cfg.n_var_samples
    H = 1 if cfg.map_est_hypers else n_v
    k_fwd, k_lik, k_reg = jax.random.split(key, 3)
    hyper = jax.random.normal(k_fwd, (n_v, cfg.in_size + 1), dtype)
    lik = jax.random.normal(k_lik, (H, cfg.n_f, cfg.out_size, B), dtype)
    reg = None
    if M_prev is not None:
        reg = jax.random.normal(k_reg, (n_v, H, cfg.out_size, M_prev), dtype)
    return hyper, lik, reg


def global_predict_draws(key, cfg, B: int, dtype=jnp.float32):
    """The draws ``global_svgp.predict`` makes from ``key`` at ``cfg``'s
    budgets: hyper samples, then function samples."""
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    k_fwd, k_lik = jax.random.split(key)
    return (jax.random.normal(k_fwd, (cfg.n_var_samples, cfg.in_size + 1), dtype),
            jax.random.normal(k_lik, (H, cfg.n_f, cfg.out_size, B), dtype))


def to_f64(tree):
    """A JAX tree with its f32 leaves as float64 (inside ``jax.enable_x64``)."""
    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)

    return jax.tree_util.tree_map(cast, tree)


class JaxGlobalDraws(JaxDraws):
    """A draw source for the port's global ``train_task`` that replays the
    JAX ``loop_global.train_task``'s draws from ``key``: ``k_init`` for the
    inducing rows (or the rows grown onto the previous task's) AND for the
    initial parameters (the JAX function hands the one key to both), then
    one key split off ``k_run`` per train block (epoch e's permutation from
    ``fold_in(k_blk, e)``, step s's loss draws from
    ``fold_in(k_blk, n_epochs + s)``) and per evaluation (batch i's
    ``predict`` draws from ``fold_in(k_ev, i)``, shared by the splits)."""

    def grow(self, prev_z, data, M, out_size):
        from vargp_tpu.models import global_svgp as JG

        z = JG.grow_inducing(self.k_init, jnp.asarray(prev_z.numpy()), jnp.asarray(data.numpy()),
                             M, out_size)
        return self._t(z).to(data.device)

    def init(self, cfg, with_phi):
        k_kern, k_u = jax.random.split(self.k_init)
        return {"kernel_eps": self._t(jax.random.normal(k_kern, (cfg.in_size + 1,))),
                "u_eps": self._t(jax.random.normal(k_u, (cfg.out_size, cfg.M, 1)))}

    @staticmethod
    def step_noise(k, cfg, batch_size, M_prev):
        return convert.noise_for_global_loss(*global_loss_draws(k, cfg, batch_size, M_prev),
                                             device="cpu")

    def evaluation(self, cfg_eval, n_batches, batch_size, per_batch):
        self.key_seq, k_ev = jax.random.split(self.key_seq)
        hyper, lik = zip(*(global_predict_draws(jax.random.fold_in(k_ev, i), cfg_eval, batch_size)
                           for i in range(n_batches)))
        return {"hyper_eps": self._t(jnp.stack(hyper)), "lik_eps": self._t(jnp.stack(lik))}


def global_port(m: dict, dtype=torch.float32):
    """The port's (params, prev, prior, x, y, w) on the CPU in ``dtype`` for
    a ``build_global`` case."""
    tp, tprev, tprior = convert.params_from_numpy(np_tree(m["params"]), np_tree(m["prev"]),
                                                  np_tree(m["prior"]), device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))
    cast = lambda tree: None if tree is None else tree_unflatten(
        tree, [a.to(dtype) for a in tree_leaves(tree)])
    return cast(tp), cast(tprev), cast(tprior), t(m["x"]).to(dtype), t(m["y"]), t(m["w"]).to(dtype)


def global_noise(m: dict, key, dtype=torch.float32) -> dict:
    """``global_svgp.loss``'s noise for a ``build_global`` case: the JAX
    draws of ``key`` in ``dtype`` (float64 draws under ``jax.enable_x64``)."""
    M_prev = None if m["prev"] is None else m["prev"].z.shape[-2]
    with jax.enable_x64(dtype == torch.float64):
        draws = global_loss_draws(key, m["cfg"], m["x"].shape[0], M_prev,
                                  jnp.float64 if dtype == torch.float64 else jnp.float32)
        return {k: torch.tensor(np.asarray(v)) for k, v in
                zip(("hyper_eps", "lik_eps", "reg_eps"), draws) if v is not None}


# ---------------------------------------------------------------------------
# The VAR-GP Retrain ablation
# ---------------------------------------------------------------------------

RETRAIN = dict(O=3, M=5, D=2, B=10, H=2, N_F=4)


def retrain_cfgs(**kw):
    """The JAX and the port's ``RetrainConfig`` at RETRAIN's widths."""
    from vargp_tpu.models import vargp_retrain as JR
    from vargp_tpu_torch.models import vargp_retrain as TR

    d = RETRAIN
    args = dict(M=d["M"], out_size=d["O"], in_size=d["D"], n_f=d["N_F"], n_var_samples=d["H"],
                **kw)
    return JR.RetrainConfig(**args), TR.RetrainConfig(**args)


def build_retrain(case: str, seed: int = 3) -> dict:
    """A Retrain case at RETRAIN's widths, the JAX side's trees, after
    ``tests/test_global_retrain.py::TestRetrain._setup``: ``task0`` (no
    previous task), ``step0`` (task 1 at its first step: one previous
    task of random raw parameters, trainable again and frozen into the
    snapshot, so z_all[:M] is a copy of z~ and the conditional covariance
    is rounding around 0 before its jitter) and ``moved`` (task 1 after
    training has moved tasks[0]'s z, u_mean and u_tril_vec off the
    snapshot).  The current task's u_tril_vec and the prior are perturbed
    off their initial values."""
    from vargp_tpu.models import vargp_retrain as JR

    d = RETRAIN
    O, M, D, B = d["O"], d["M"], d["D"], d["B"]
    rng = np.random.default_rng(seed)
    arr = lambda *shape, s=1.0: jnp.asarray((rng.standard_normal(shape) * s).astype(f32))
    prev_chain = ()
    if case != "task0":
        prev_chain = (JR.TaskRaw(z=arr(O, M, D), u_mean=arr(O, M, 1),
                                 u_tril_vec=arr(O, M * (M + 1) // 2, s=0.5)),)
    jcfg, tcfg = retrain_cfgs()
    params, prior, frozen = JR.init_params(jax.random.key(seed), arr(O, M, D), jcfg,
                                           prev_chain=prev_chain)
    cur = params.tasks[-1]
    cur = cur._replace(u_tril_vec=cur.u_tril_vec + arr(*cur.u_tril_vec.shape, s=0.05))
    tasks = (*params.tasks[:-1], cur)
    if case == "moved":
        t0 = tasks[0]
        tasks = (t0._replace(z=t0.z + arr(O, M, D, s=0.1), u_mean=t0.u_mean + arr(O, M, 1, s=0.1),
                             u_tril_vec=t0.u_tril_vec + arr(*t0.u_tril_vec.shape, s=0.1)), cur)
    params = params._replace(tasks=tasks)
    prior = prior._replace(log_mean=prior.log_mean + 0.3)
    x = arr(B, D)
    y = jnp.asarray(rng.integers(0, O, B))
    w = jnp.asarray((rng.random(B) > 0.2).astype(f32))
    return dict(cfg=jcfg, tcfg=tcfg, params=params, prior=prior, frozen=frozen, x=x, y=y, w=w)


def retrain_loss_draws(key, cfg, B: int, S: int, c: int, dtype=jnp.float32):
    """The draws ``vargp_retrain.loss`` makes from ``key`` (split four ways:
    hypers, likelihood, u_{<=t}, u~_{<t}): hyper samples (n_v, D+1),
    function samples (H, n_f, O, B) and, with c frozen rows, u_eps
    (n_v, H, O, S) and ut_eps (n_v, n_v, H, O, c); None without them."""
    n_v, O = cfg.n_var_samples, cfg.out_size
    H = 1 if cfg.map_est_hypers else n_v
    k_hyp, k_lik, k_u, k_ut = jax.random.split(key, 4)
    hyper = jax.random.normal(k_hyp, (n_v, cfg.in_size + 1), dtype)
    lik = jax.random.normal(k_lik, (H, cfg.n_f, O, B), dtype)
    if not c:
        return hyper, lik, None, None
    return (hyper, lik, jax.random.normal(k_u, (n_v, H, O, S), dtype),
            jax.random.normal(k_ut, (n_v, n_v, H, O, c), dtype))


def retrain_predict_draws(key, cfg, B: int, dtype=jnp.float32):
    """The draws ``vargp_retrain.predict`` makes from ``key``: hyper
    samples, then function samples."""
    k_hyp, k_lik = jax.random.split(key)
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    return (jax.random.normal(k_hyp, (cfg.n_var_samples, cfg.in_size + 1), dtype),
            jax.random.normal(k_lik, (H, cfg.n_f, cfg.out_size, B), dtype))


def retrain_port(m: dict, dtype=torch.float32):
    """The port's (params, frozen, prior, x, y, w) on the CPU in ``dtype``
    for a ``build_retrain`` case."""
    tp, tfrozen, tprior = convert.params_from_numpy(np_tree(m["params"]), np_tree(m["frozen"]),
                                                    np_tree(m["prior"]), device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))
    cast = lambda tree: tree_unflatten(tree, [a.to(dtype) for a in tree_leaves(tree)])
    return (cast(tp), cast(tfrozen), cast(tprior), t(m["x"]).to(dtype), t(m["y"]),
            t(m["w"]).to(dtype))


def retrain_noise(m: dict, key, dtype=torch.float32) -> dict:
    """``vargp_retrain.loss``'s noise for a ``build_retrain`` case: the JAX
    draws of ``key`` in ``dtype`` (float64 draws under ``jax.enable_x64``)."""
    S = sum(t.z.shape[-2] for t in m["params"].tasks)
    c = sum(p.z.shape[-2] for p in m["frozen"])
    with jax.enable_x64(dtype == torch.float64):
        draws = retrain_loss_draws(key, m["cfg"], m["x"].shape[0], S, c,
                                   jnp.float64 if dtype == torch.float64 else jnp.float32)
        return {k: torch.tensor(np.asarray(v)) for k, v in
                zip(("hyper_eps", "lik_eps", "u_eps", "ut_eps"), draws) if v is not None}


class JaxRetrainDraws(JaxDraws):
    """A draw source for the port's Retrain ``train_task`` that replays the
    JAX ``retrain_run.toy``'s draws for one task from its keys (k_sel,
    k_init, k_task): the inducing rows from k_sel, the initial parameters
    from k_init (split into the kernel's and u_mean's keys), then one key
    split off k_task per train block (epoch e's permutation from
    ``fold_in(k_blk, e)``, step s's loss draws from
    ``fold_in(k_blk, n_epochs + s)``) and per evaluation (``predict``'s
    draws of k_ev); the final accuracy's from what is left of k_task."""

    def __init__(self, k_sel, k_init, k_task):
        self.k_sel, self.k_init, self.key_seq = k_sel, k_init, k_task

    def inducing(self, data, M, out_size):
        z = JV.select_inducing(self.k_sel, jnp.asarray(data.numpy()), M, out_size)
        return self._t(z).to(data.device)

    def init(self, cfg):
        k_kern, k_u = jax.random.split(self.k_init)
        return {"kernel_eps": self._t(jax.random.normal(k_kern, (cfg.in_size + 1,))),
                "u_eps": self._t(jax.random.normal(k_u, (cfg.out_size, cfg.M, 1)))}

    @staticmethod
    def step_noise(k, cfg, batch_size, S, c):
        return convert.noise_for_retrain_loss(*retrain_loss_draws(k, cfg, batch_size, S, c),
                                              device="cpu")

    def evaluation(self, cfg, batch_size):
        self.key_seq, k_ev = jax.random.split(self.key_seq)
        return convert.noise_for_retrain_loss(*retrain_predict_draws(k_ev, cfg, batch_size),
                                              device="cpu")

    def final(self, cfg, batch_size):
        return convert.noise_for_retrain_loss(*retrain_predict_draws(self.key_seq, cfg,
                                                                     batch_size), device="cpu")


def jax_retrain_task_draws(seed: int):
    """``retrain_run.toy``'s ``task_draws`` replaying the JAX driver at
    ``seed``: task t's keys split four ways off the run's key, in order
    (the run's next key, k_sel, k_init, k_task)."""
    state = {"key": jax.random.key(seed)}

    def task_draws(t):
        state["key"], k_sel, k_init, k_task = jax.random.split(state["key"], 4)
        return JaxRetrainDraws(k_sel, k_init, k_task)

    return task_draws

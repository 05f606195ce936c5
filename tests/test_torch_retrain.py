"""The port's VAR-GP Retrain ablation (``models/vargp_retrain.py``) against
the JAX package's on the CPU.

Cases (``tests/_torch_cases.py::build_retrain``, after
``tests/test_global_retrain.py::TestRetrain._setup``): 3 classes, M = 5 a
task, D = 2, B = 10, 2 hyper samples, 4 function samples; task 0, task 1
at its first step (z_all[:M] a copy of the frozen z~, where the
conditional covariance K(z~, z~) - W^T W is rounding around 0 before its
jitter) and task 1 after tasks[0] has moved off the snapshot.  Both sides
get the same parameters and the JAX package's own draws.

Tolerances: the three ELBO pieces agree to 1e-5 relative, each leaf's
gradient of each piece to 2e-5 of that leaf's largest magnitude,
probabilities to 1e-6 absolute.  The comparisons run in float64 (the JAX
side under ``jax.enable_x64``, on its float64 draws), where both sides
compute the same function with rounding far below those limits, and in
f32 on the f32 draws, where the JAX package's own rounding reaches the
limits (the ELBO's kl_u cancels a large KL against the importance term).
So an f32 piece, gradient or probability of the port is held to the
exact value on the same draws (the port in float64, which the float64
comparisons hold to the JAX package), within the limit or within twice
the JAX package's own f32 distance from it, whichever is larger.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu import data as jdata
from vargp_tpu.models import vargp_retrain as JR
from vargp_tpu.utils import checkpoint as jckpt
from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.experiments import retrain_run as TRR
from vargp_tpu_torch.kernels import gram, sample_hypers
from vargp_tpu_torch.models import vargp_retrain as TR
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten
from vargp_tpu_torch.utils import checkpoint as tckpt
from vargp_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINTED = os.path.join(REPO, "results", "toy_retrain_full")
RTOL = 1e-5
TOL_GRAD = 2e-5
ATOL_PROBS = 1e-6
PIECES = ("kl_hypers", "kl_u", "nll")

_jit_predict = jax.jit(JR.predict, static_argnames="cfg")
_JAX_CACHE = {}


def _jax_pieces_and_grads(case, key, f64):
    """The JAX loss's three pieces and each piece's gradient (one list of
    leaves per piece), jitted, once per (case, precision) for the module."""
    if (case, f64) in _JAX_CACHE:
        return _JAX_CACHE[case, f64]
    m = C.build_retrain(case)
    with jax.enable_x64(f64):
        cast = C.to_f64 if f64 else (lambda t: t)
        params, frozen, prior, x, w = (cast(m[k]) for k in ("params", "frozen", "prior", "x", "w"))

        def run(p):
            out, vjp = jax.vjp(lambda q: JR.loss(q, frozen, prior, x, m["y"], key, m["cfg"],
                                                 weights=w), p)
            one_hot = [tuple(jnp.asarray(float(i == j), out[0].dtype) for j in range(3))
                       for i in range(3)]
            return out, [vjp(c)[0] for c in one_hot]

        out, grads = jax.jit(run)(params)
        res = ([float(v) for v in out],
               [[np.asarray(g) for g in jax.tree_util.tree_leaves(gs)] for gs in grads])
    _JAX_CACHE[case, f64] = res
    return res


def _port_pieces_and_grads(m, noise, dtype):
    tp, tfrozen, tprior, x, y, w = C.retrain_port(m, dtype)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    out = TR.loss(tree_unflatten(tp, leaves), tfrozen, tprior, x, y,
                  {k: v.to(dtype) for k, v in noise.items()}, m["tcfg"], weights=w, device="cpu")
    grads = []
    for piece in out:
        got = torch.autograd.grad(piece, leaves, retain_graph=True, allow_unused=True)
        grads.append([np.zeros(tuple(t.shape)) if g is None else g.double().numpy()
                      for t, g in zip(leaves, got)])
    return [float(v.detach()) for v in out], grads


def _limit(tol, scale, exact, want32):
    """The f32 limit against the exact value: ``tol`` of ``scale``, or twice
    the JAX package's own f32 distance from it."""
    return max(tol * scale, 2.0 * float(np.max(np.abs(np.asarray(want32) - exact))))


def _leaf_names(m):
    return [k for k, _ in tckpt.flatten_with_paths(C.retrain_port(m)[0])]


@pytest.mark.parametrize("precision", ["float64", "f32"])
@pytest.mark.parametrize("case", ["task0", "step0", "moved"])
def test_loss_pieces_and_gradients_match_jax(case, precision):
    """Each ELBO piece and each leaf's gradient of it (every task's z,
    u_mean, u_tril_vec and the kernel's log_mean and log_logvar).  float64:
    both packages in float64 on the JAX key's float64 draws.  f32: the
    pieces and gradients against the exact ones on the same f32 draws
    (the port in float64), within the limits or twice the JAX package's
    own f32 distance from them."""
    m = C.build_retrain(case)
    key = jax.random.key(3)
    f64 = precision == "float64"
    want_out, want = _jax_pieces_and_grads(case, key, f64)
    noise = C.retrain_noise(m, key, torch.float64 if f64 else torch.float32)
    out, got = _port_pieces_and_grads(m, noise, torch.float64 if f64 else torch.float32)
    if not f64:
        exact_out, exact = _port_pieces_and_grads(m, noise, torch.float64)
    names = _leaf_names(m)
    assert len(names) == (5 if case == "task0" else 8)
    for i, name in enumerate(PIECES):
        if f64:
            np.testing.assert_allclose(out[i], want_out[i], rtol=RTOL, err_msg=name)
        else:
            lim = _limit(RTOL, abs(exact_out[i]), exact_out[i], want_out[i])
            np.testing.assert_allclose(out[i], exact_out[i], rtol=0, atol=lim, err_msg=name)
        ref = want[i] if f64 else exact[i]
        for k, (leaf, g, r) in enumerate(zip(names, got[i], ref)):
            scale = max(float(np.max(np.abs(r))), 1e-30)
            atol = TOL_GRAD * scale if f64 else _limit(TOL_GRAD, scale, r, want[i][k])
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=f"d {name} / d {leaf}")


@pytest.mark.parametrize("case", ["step0", "moved"])
def test_importance_term_reaches_only_the_kernel(case):
    """The importance term's samples carry no gradient: its gradient
    reaches the kernel's log_mean and log_logvar (through L~ and the
    frozen chain's posterior) and no task's raw parameters.  The whole
    ELBO still trains tasks[0] (the previous task is retrained: z, u_mean
    and u_tril_vec get a non-zero gradient)."""
    m = C.build_retrain(case)
    tp, tfrozen, tprior, x, y, w = C.retrain_port(m, torch.float64)
    noise = C.retrain_noise(m, jax.random.key(3), torch.float64)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    p = tree_unflatten(tp, leaves)
    theta = sample_hypers(p.kernel, noise["hyper_eps"])
    z_all, L, post = TR._chain(theta, p.tasks, m["tcfg"].jitter)
    term = TR.importance_term(theta, z_all, L, post, tfrozen, noise["u_eps"], noise["ut_eps"],
                              m["tcfg"].jitter)
    grads = torch.autograd.grad(term, leaves, allow_unused=True)
    names = _leaf_names(m)
    for name, g in zip(names, grads):
        if name.startswith(".kernel"):
            assert g is not None and float(g.abs().max()) > 1e-6, name
        else:
            assert g is None or float(g.abs().max()) == 0.0, name
    total = sum(TR.loss(p, tfrozen, tprior, x, y, noise, m["tcfg"], weights=w, device="cpu"))
    grads = dict(zip(names, torch.autograd.grad(total, leaves)))
    for leaf in (".tasks[0].z", ".tasks[0].u_mean", ".tasks[0].u_tril_vec"):
        assert float(grads[leaf].abs().sum()) > 0, leaf


def test_shared_gram_entries_round_alike():
    """At a task's first step z_all[:c] is a copy of z~: the shared entries of
    K(z~, z~) and K(z_all, z~) are bitwise equal at D = 2 (the small
    kernel's plain version sums the same squared differences for both),
    so the conditional covariance cancels on equal roundings."""
    m = C.build_retrain("step0")
    tp, tfrozen, _, _, _, _ = C.retrain_port(m)
    theta = sample_hypers(tp.kernel, C.retrain_noise(m, jax.random.key(3))["hyper_eps"])
    z_all = torch.cat([t.z for t in tp.tasks], dim=-2)
    Ktt = gram(theta, tfrozen[0].z)
    Kzx_t = gram(theta, z_all, tfrozen[0].z)
    c = tfrozen[0].z.shape[-2]
    assert torch.equal(Kzx_t[..., :c, :], Ktt)
    assert torch.equal(gram(theta, z_all)[..., :c, :c], Ktt)


@pytest.mark.parametrize("case", ["task0", "moved"])
def test_predict_matches_jax(case):
    """``predict`` on the JAX key's draws, in f32: probabilities within
    1e-6."""
    m = C.build_retrain(case)
    key = jax.random.key(5)
    want = _jit_predict(m["params"], m["x"], key, cfg=m["cfg"])
    hyper, lik = C.retrain_predict_draws(key, m["cfg"], m["x"].shape[0])
    tp, _, _, x, _, _ = C.retrain_port(m)
    got = TR.predict(tp, x, convert.noise_for_retrain_loss(hyper, lik, device="cpu"), m["tcfg"],
                     device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_PROBS)
    with pytest.raises(ValueError, match="expected shape"):  # noise of another batch
        TR.predict(tp, x[:4], convert.noise_for_retrain_loss(hyper, lik, device="cpu"),
                   m["tcfg"], device="cpu")


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("prior_from", [False, True])
def test_init_params_matches_jax(prev, prior_from):
    """The same parameters, prior and frozen snapshot from the draws of the
    JAX key: u_tril_vec raw ones, the previous tasks ahead of the new one,
    the snapshot holding vec2tril of their u_tril_vec, the prior the
    previous kernel posterior when given."""
    jcfg, tcfg = C.retrain_cfgs()
    src = C.build_retrain("moved")
    key = jax.random.key(9)
    z = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5, 2)).astype(np.float32))
    chain = src["params"].tasks[:1] if prev else ()
    kern = src["params"].kernel if prior_from else None
    want_p, want_prior, want_frozen = JR.init_params(key, z, jcfg, prev_chain=chain,
                                                     kernel_prior_from=kern)
    k_kern, k_u = jax.random.split(key)
    t = lambda a: torch.tensor(np.asarray(a))
    tsrc = C.retrain_port(src)[0]
    got_p, got_prior, got_frozen = TR.init_params(
        t(jax.random.normal(k_kern, (3,))), t(jax.random.normal(k_u, (3, 5, 1))), t(z), tcfg,
        prev_chain=tsrc.tasks[:1] if prev else (),
        kernel_prior_from=tsrc.kernel if prior_from else None)
    assert type(got_p).__name__ == "RetrainParams" and len(got_p.tasks) == 1 + prev
    assert len(got_frozen) == len(want_frozen) == int(prev)
    for g, w in zip(tree_leaves(got_p) + list(got_prior) + tree_leaves(got_frozen),
                    jax.tree_util.tree_leaves((want_p, want_prior, want_frozen))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    for f in got_frozen:
        assert not f.z.requires_grad and f.z.data_ptr() != got_p.tasks[0].z.data_ptr()


def _minted_tree(t):
    """ckpt{t} of the minted toy_retrain_full run through the port's
    template of t + 1 tasks, its structure string checked against the
    one the JAX package wrote."""
    tcfg = TR.RetrainConfig(M=20, out_size=4, in_size=2)
    template = TR.params_template(tcfg, t + 1)
    path = os.path.join(MINTED, f"ckpt{t}.npz")
    with open(path + ".structure.json") as f:
        assert json.load(f)["treedef"] == tckpt._treedef(template)
    return path, tckpt.load_pytree(path, template), tcfg


@pytest.mark.parametrize("t", [0, 1])
def test_minted_toy_retrain_chain_predicts_as_jax(t):
    """``results/toy_retrain_full/ckpt{t}.npz`` read through the port's
    per-task template, then the toy's 4 classes (200 rows, one 512-row
    batch) at the model's budgets (H = 3, n_f = 10) on the JAX key's
    draws: probabilities within 1e-6 of the JAX package's in float64, and
    in f32 within 1e-6 of the exact ones (or twice the JAX package's own
    f32 distance from them)."""
    _, tree, tcfg = _minted_tree(t)
    jcfg = JR.RetrainConfig(M=20, out_size=4, in_size=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, JR.RetrainParams(
        tuple(JR.TaskRaw(*e) for e in tree.tasks), JR.RBFParams(*tree.kernel)))
    x = next(jdata.eval_batches(jdata.make_toy_dataset(seed=0), 512)).x
    key = jax.random.key(2)
    tp = convert.params_from_numpy(tree, device="cpu")[0]
    assert isinstance(tp, TR.RetrainParams) and len(tp.tasks) == t + 1

    def port(dtype, hyper, lik):
        p = tree_unflatten(tp, [a.to(dtype) for a in tree_leaves(tp)])
        noise = {"hyper_eps": hyper.to(dtype), "lik_eps": lik.to(dtype)}
        return TR.predict(p, torch.tensor(x).to(dtype), noise, tcfg,
                          device="cpu").double().numpy()

    want = {}
    for f64 in (True, False):
        with jax.enable_x64(f64):
            jdt = jnp.float64 if f64 else jnp.float32
            jp = C.to_f64(jparams) if f64 else jparams
            want[f64] = (np.asarray(_jit_predict(jp, jnp.asarray(x, jdt), key, cfg=jcfg),
                                    np.float64),
                         [torch.tensor(np.asarray(a))
                          for a in C.retrain_predict_draws(key, jcfg, 512, jdt)])
    want64, draws64 = want[True]
    np.testing.assert_allclose(port(torch.float64, *draws64), want64, rtol=0, atol=ATOL_PROBS)
    want32, draws32 = want[False]
    exact = port(torch.float64, *draws32)
    got32 = port(torch.float32, *draws32)
    np.testing.assert_allclose(got32, exact, rtol=0, atol=_limit(ATOL_PROBS, 1.0, exact, want32))
    y = next(jdata.eval_batches(jdata.make_toy_dataset(seed=0), 512)).y[:200]
    acc = float(np.mean(got32[:200].argmax(-1) == y))
    assert acc > 0.5  # a trained model: task 1's accuracy over the four classes


def test_minted_checkpoint_round_trips_bitwise(tmp_path):
    """The minted ckpt1 read by the port, written back by the port's
    ``save_pytree``: the same keys, bitwise equal arrays and the same
    structure string as the JAX package's file; the JAX ``load_pytree``
    reads the port's file back bitwise."""
    path, tree, _ = _minted_tree(1)
    out = str(tmp_path / "ckpt1.npz")
    tckpt.save_pytree(out, convert.params_from_numpy(tree, device="cpu")[0])
    with np.load(path) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
    for p in (path, out):
        with open(p + ".structure.json") as f:
            assert json.load(f)["treedef"] == tckpt._treedef(tree)
    jtemplate = JR.RetrainParams(
        tuple(JR.TaskRaw(*(jnp.zeros(np.shape(a)) for a in e)) for e in tree.tasks),
        JR.RBFParams(*(jnp.zeros(np.shape(a)) for a in tree.kernel)))
    back = jckpt.load_pytree(out, jtemplate)
    for g, w in zip(jax.tree_util.tree_leaves(back), tree_leaves(tree)):
        assert np.array_equal(np.asarray(g), w)


def test_convert_round_trip():
    """A JAX RetrainParams, its frozen snapshot, prior and the optax Yogi
    state of ``make_optimizer`` (after one update, so mu and nu are
    live) carried into the port's trees and back leaf for leaf, bitwise;
    a tree with ``tasks`` is never read as the global SVGP's."""
    from vargp_tpu.train import loop as JL

    m = C.build_retrain("moved")
    tp, tfrozen, tprior = convert.params_from_numpy(C.np_tree(m["params"]),
                                                    C.np_tree(m["frozen"]),
                                                    C.np_tree(m["prior"]), device="cpu")
    assert isinstance(tp, TR.RetrainParams) and isinstance(tp.tasks[0], TR.TaskRaw)
    assert type(tfrozen[0]).__name__ == "TaskPosterior"
    back = convert.params_to_numpy(tp)
    for g, w in zip(tree_leaves(back), jax.tree_util.tree_leaves(m["params"])):
        assert np.array_equal(g, np.asarray(w))
    tx = JL.make_optimizer(JL.TrainHyperparams(lr=1e-2))
    state = tx.init(m["params"])
    grads = jax.tree_util.tree_map(lambda a: jnp.full_like(a, 0.3), m["params"])
    _, state = tx.update(grads, state, m["params"])
    assert isinstance(state[0], optax.ScaleByAdamState)
    ts = convert.opt_state_from_numpy(C.np_tree(state[0]), device="cpu")
    assert isinstance(ts.mu, TR.RetrainParams) and int(ts.count) == 1
    tb = convert.opt_state_to_numpy(ts)
    for g, w in zip(tree_leaves(tb.mu) + tree_leaves(tb.nu),
                    jax.tree_util.tree_leaves((state[0].mu, state[0].nu))):
        assert np.array_equal(g, np.asarray(w))


def _toy_task0():
    return tdata.filter_by_class(tdata.make_toy_dataset(seed=0), [0, 1])


@pytest.mark.parametrize("call", ["loss", "predict", "train_task", "toy_retrain"])
def test_entry_points_need_a_card_unless_asked(call, tmp_path):
    """With no card, device=None raises before any work (the driver before
    it writes a file); device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None would run on it")
    m = C.build_retrain("step0")
    tp, tfrozen, tprior, x, y, w = C.retrain_port(m)
    noise = C.retrain_noise(m, jax.random.key(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "loss":
            TR.loss(tp, tfrozen, tprior, x, y, noise, m["tcfg"], weights=w)
        elif call == "predict":
            TR.predict(tp, x, {k: noise[k] for k in ("hyper_eps", "lik_eps")}, m["tcfg"])
        elif call == "train_task":
            tr = _toy_task0()
            TRR.train_task(None, 0, tr, tr, m["tcfg"], TL.TrainHyperparams())
        else:
            TRR.toy(log_dir=str(tmp_path))
    assert not os.listdir(tmp_path)
    if call == "loss":
        out = TR.loss(tp, tfrozen, tprior, x, y, noise, m["tcfg"], weights=w, device="cpu")
        assert all(np.isfinite(float(v)) for v in out)

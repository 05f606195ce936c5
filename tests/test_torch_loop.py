"""The port's ``train_task`` and its parts against the JAX package's on
the CPU: the early stopper, the evaluation stacks, the evaluation
function, the DKL phi-grouped optimizer and ``train_task`` itself, each
with the JAX package's own draws replayed (``_torch_cases.JaxDraws``).

Tolerances: the stopper, the stacks and the decisions are exact.  The
evaluation's correct counts are equal (the probabilities agree to 1e-6
at these sizes, far from any argmax tie of the cases).  The optimizer is
the same elementwise f32 arithmetic as optax's: 1e-6 relative, as in
test_torch_train.py (or 1e-6 of the leaf's largest magnitude, for the
entries near 0 of phi's weights).  ``train_task`` runs tens of ELBO steps, whose
gradients agree to 2e-5 of each leaf's largest (test_torch_grad.py):
its logged accuracies are equal, its ELBO pieces within 1e-5 relative,
its best parameters within 2e-5 of each leaf's largest value.
"""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu import data as jdata
from vargp_tpu.models import vargp as JV
from vargp_tpu.train import loop as JL
from vargp_tpu.train.stopper import EarlyStopper as JStopper
from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train import optim as TO
from vargp_tpu_torch.train.stopper import EarlyStopper as TStopper
from vargp_tpu_torch.utils import convert

f32 = np.float32


# ---------------------------------------------------------------------------
# EarlyStopper
# ---------------------------------------------------------------------------

STOPPER_CASES = {
    # name: (patience, scores)
    "stops after two flat": (2, [0.5, 0.5, 0.49]),
    "improves then stops": (2, [0.1, 0.3, 0.30005, 0.2, 0.4]),
    "delta resets": (1, [0.5, 0.5002, 0.5003, 0.5004]),
    "patience zero": (0, [0.7]),
    "disabled": (-1, [0.1] * 30 + [0.2, 0.1]),
}


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("case", sorted(STOPPER_CASES))
def test_early_stopper_matches_jax(case, lazy):
    """The same decisions, best score and best payload; a lazy payload is
    called exactly on the improving scores."""
    patience, scores = STOPPER_CASES[case]
    calls = {"jax": [], "torch": []}
    stoppers = {"jax": JStopper(patience=patience), "torch": TStopper(patience=patience)}
    for i, score in enumerate(scores):
        done = {k: s.is_done() for k, s in stoppers.items()}
        assert done["jax"] == done["torch"], (i, done)
        if done["jax"]:
            break
        for k, s in stoppers.items():
            if lazy:
                s(score, lambda _k=k, _i=i: calls[_k].append(_i) or ("payload", _i))
            else:
                s(score, ("payload", i))
    assert stoppers["torch"].info() == stoppers["jax"].info()
    assert stoppers["torch"].best_score() == stoppers["jax"].best_score()
    assert stoppers["torch"].is_done() == stoppers["jax"].is_done()
    assert calls["torch"] == calls["jax"]
    if patience < 0:
        assert not stoppers["torch"].is_done()


# ---------------------------------------------------------------------------
# Evaluation stacks and the evaluation function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rows,batch,pad", [(70, 32, None), (70, 32, 5), (64, 32, 1), (5, 8, 3)])
def test_stack_eval_set_and_eval_batches_are_bitwise_jax(n_rows, batch, pad):
    rng = np.random.default_rng(n_rows)
    x = rng.standard_normal((n_rows, 6)).astype(f32)
    y = rng.integers(0, 4, n_rows).astype(np.int32)
    jds, tds = jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)
    jhp = JL.TrainHyperparams(batch_size=batch, pad_eval_batches=pad)
    thp = TL.TrainHyperparams(batch_size=batch, pad_eval_batches=pad)
    k = TL._eval_batches(thp, tds)
    assert k == JL._eval_batches(jhp, jds)
    want = JL.stack_eval_set(jds, batch, k)
    got = TL.stack_eval_set(tds, batch, k, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32


def _eval_case(seed=0):
    m = C.build("small", seed)
    d = m["dims"]
    rng = np.random.default_rng(seed + 7)
    K, B = 3, d["B"]
    xs = (rng.standard_normal((K, B, d["D"])) * 0.3).astype(f32)
    ys = rng.integers(0, d["O"], (K, B))
    ws = np.ones((K, B), f32)
    ws[-1, B // 2:] = 0.0  # a padded last batch
    return m, xs, ys, ws


@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("chain", ["chain", "padded"])
def test_eval_fn_matches_make_device_eval_fn(chain, resample):
    """Shared theta (one posterior a split) and per-batch resampling, on
    the whole chain and a padded one, at the evaluation budgets of hp:
    the same correct count as the JAX scanned evaluation, on its draws."""
    m, xs, ys, ws = _eval_case()
    prev, mask = C.chain(m, chain)
    kw = dict(eval_n_f=5, eval_n_var_samples=3, eval_resample_per_batch=resample)
    jhp, thp = JL.TrainHyperparams(**kw), TL.TrainHyperparams(**kw)
    if mask is None:
        mask = jnp.ones((len(prev),), jnp.float32)
    key = jax.random.key(11)
    want, wtot = JL.make_device_eval_fn(m["cfg"], jhp)(m["params"], prev, mask, jnp.asarray(xs),
                                                       jnp.asarray(ys), jnp.asarray(ws), key)
    cfg_eval = JV.eval_budget_cfg(m["cfg"], n_f=5, n_var_samples=3)
    ev = C.jax_eval_draws(key, cfg_eval, xs.shape[0], xs.shape[1], resample)
    tp, tprev, _ = convert.params_from_numpy(C.np_tree(m["params"]), C.np_tree(prev),
                                             device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))
    got, tot = TL.make_device_eval_fn(m["tcfg"], thp)(tp, tprev, t(mask), t(xs), t(ys), t(ws), ev,
                                                     device="cpu")
    assert float(tot) == float(wtot) == float(ws.sum())
    assert float(got) == float(want)
    assert 0 < float(got) < float(ws.sum())


def test_eval_fn_poisons_the_count_on_nan():
    """After tests/test_train.py::test_scanned_eval_poisons_on_nan: NaN
    probabilities make the count NaN on both sides, finite ones do not."""
    cfg = JV.VARGPConfig(M=4, out_size=3, in_size=2, n_f=2, n_var_samples=1)
    tcfg = TL.V.VARGPConfig(M=4, out_size=3, in_size=2, n_f=2, n_var_samples=1)
    key = jax.random.key(0)
    z = jax.random.normal(key, (cfg.out_size, cfg.M, cfg.in_size))
    params, _ = JV.init_params(key, z, cfg)
    xs, ys, ws = jnp.zeros((2, 8, 2)), jnp.zeros((2, 8), jnp.int32), jnp.ones((2, 8))
    mask = jnp.ones((0,), jnp.float32)
    jeval = JL.make_device_eval_fn(cfg)
    teval = TL.make_device_eval_fn(tcfg)
    ev = C.jax_eval_draws(key, cfg, 2, 8, False)
    t = lambda a: torch.tensor(np.asarray(a))
    for bad in (False, True):
        p = params._replace(u_mean=params.u_mean * jnp.nan) if bad else params
        want, _ = jeval(p, (), mask, xs, ys, ws, key)
        tp, _, _ = convert.params_from_numpy(C.np_tree(p), device="cpu")
        got, _ = teval(tp, (), t(mask), t(xs), t(ys), t(ws), ev, device="cpu")
        assert np.isnan(float(got)) == np.isnan(float(want)) == bad
        if not bad:
            assert float(got) == float(want)


@pytest.mark.parametrize("chain", ["chain", "task0"])
def test_make_predict_fn_matches_jax(chain):
    """``make_predict_fn`` at hp's evaluation budgets on ``predict``'s own
    draws of the JAX key: probabilities within 1e-6."""
    m, xs, _, _ = _eval_case()
    prev, _ = C.chain(m, chain)
    jhp = JL.TrainHyperparams(eval_n_f=5, eval_n_var_samples=3)
    thp = TL.TrainHyperparams(eval_n_f=5, eval_n_var_samples=3)
    key = jax.random.key(5)
    want = JL.make_predict_fn(m["cfg"], jhp)(m["params"], prev, jnp.asarray(xs[0]), key)
    cfg_eval = JV.eval_budget_cfg(m["cfg"], n_f=5, n_var_samples=3)
    k_fwd, k_lik = jax.random.split(key)
    k_hyp, _ = jax.random.split(k_fwd)
    noise = convert.noise_for_predict(
        jax.random.normal(k_hyp, (3, JV._theta_size(cfg_eval) + 1)),
        jax.random.normal(k_lik, (3, 5, m["dims"]["O"], xs.shape[1])), device="cpu")
    tp, tprev, _ = convert.params_from_numpy(C.np_tree(m["params"]), C.np_tree(prev),
                                             device="cpu")
    got = TL.make_predict_fn(m["tcfg"], thp)(tp, tprev, torch.tensor(xs[0]), noise, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The DKL phi-grouped optimizer
# ---------------------------------------------------------------------------

PHI_KNOBS = {
    "none": {},
    "phi_lr": dict(phi_lr=3e-4),
    "phi_weight_decay": dict(phi_weight_decay=1e-2),
    "freeze": dict(freeze_phi_after_first=True),
    "all three": dict(phi_lr=3e-4, phi_weight_decay=1e-2, freeze_phi_after_first=True),
}


def _assert_tree_close(got, want, rtol=1e-6):
    """Each leaf within ``rtol`` relative, or ``rtol`` of the leaf's
    largest magnitude (a few f32 ulps of its scale, for entries near 0)."""
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(w), initial=0.0)))


@pytest.mark.parametrize("optimizer", ["yogi", "adam"])
@pytest.mark.parametrize("knobs", sorted(PHI_KNOBS))
def test_phi_group_optimizer_matches_make_optimizer(knobs, optimizer):
    """Five steps of ``make_optimizer(hp)`` on a DKL tree: two in optax,
    the state carried into the port, three there (the phi scale set to 0
    before the last under the freeze knob, on both sides), the state
    carried back out; equal to five optax steps.  With no knob the port
    builds its plain Yogi / Adam and optax its plain yogi / adam."""
    m = C.build_dkl("small")
    params = m["params"]
    kw = dict(lr=3e-3, optimizer=optimizer, **PHI_KNOBS[knobs])
    tx = JL.make_optimizer(JL.TrainHyperparams(**kw))
    opt = TL.make_optimizer(TL.TrainHyperparams(**kw))
    if knobs == "none":
        assert type(opt) is (TO.Yogi if optimizer == "yogi" else TO.Adam)
        plain = optax.yogi(3e-3) if optimizer == "yogi" else optax.adam(3e-3)
        assert (jax.tree_util.tree_structure(tx.init(params))
                == jax.tree_util.tree_structure(plain.init(params)))
    else:
        assert isinstance(opt, TO.PhiGroup)
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(f32) * 10.0 ** rng.integers(-4, 1)),
        params) for _ in range(5)]
    freeze_at = 4 if "freeze_phi_after_first" in kw else None

    state, jp = tx.init(params), params
    for k in range(5):
        if k == freeze_at:
            state = JL.set_phi_update_scale(state, 0.0)
        upd, state = tx.update(grads[k], state, jp)
        jp = optax.apply_updates(jp, upd)
        if k == 1:
            carried = (jp, state)

    p0, s0 = carried
    tp, _, _ = convert.params_from_numpy(C.np_tree(p0), device="cpu")
    ts = convert.opt_state_from_numpy(C.np_tree(s0 if knobs != "none" else s0[0]), device="cpu")
    for k in range(2, 5):
        if k == freeze_at:
            ts = TO.set_phi_update_scale(ts, 0.0)
        g = [torch.tensor(np.asarray(a)) for a in jax.tree_util.tree_leaves(grads[k])]
        tp, ts = opt.update(g, ts, tp)
    _assert_tree_close(convert.params_to_numpy(tp), jp)
    out = convert.opt_state_to_numpy(ts)
    moments = out.moments if knobs != "none" else out
    jmom = state[0]
    assert int(moments.count) == int(jmom.count) == 5
    _assert_tree_close(moments.mu, jmom.mu)
    _assert_tree_close(moments.nu, jmom.nu)
    if freeze_at is not None:
        assert float(out.phi_scale) == float(state[-1].scale) == 0.0
        # the frozen step moved no phi leaf, on either side
        before = jax.tree_util.tree_leaves(carried[0].phi)
        assert not all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(before, jax.tree_util.tree_leaves(jp.phi)))


# ---------------------------------------------------------------------------
# train_task
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step=0):
        self.rows.append((tag, int(step), float(value)))


TOY_TASK = dict(M=8, n_f=4, n_var_samples=2)
TOY_HP = dict(epochs=8, lr=1e-2, batch_size=32, beta=1.0, eval_interval=2, patience=1,
              pad_tasks_to=2, pad_data_rows=100, pad_eval_batches=7)


def _toy_run(side: str, hp_kw: dict, cfg_kw: dict):
    """Two toy tasks through ``train_task`` of ``side``, task t from
    jax.random.key(40 + t) (the port replays its draws); (chain, infos,
    logged rows)."""
    toy = jdata.make_toy_dataset(seed=0)
    log = _Recorder()
    chain, infos, shared = [], [], {}
    for t in range(2):
        tr = jdata.filter_by_class(toy, [2 * t, 2 * t + 1])
        ev = jdata.filter_by_class(toy, range(2 * t + 2))
        key = jax.random.key(40 + t)
        if side == "jax":
            cfg = JV.VARGPConfig(out_size=4, in_size=2, **cfg_kw)
            p, info = JL.train_task(key, t, tr, ev, ev, cfg, JL.TrainHyperparams(**hp_kw),
                                    prev_chain=chain, logger=log, seed=t, shared=shared)
        else:
            cfg = TL.V.VARGPConfig(out_size=4, in_size=2, **cfg_kw)
            tds = [tdata.ArrayDataset(d.data, d.targets) for d in (tr, ev)]
            p, info = TL.train_task(None, t, tds[0], tds[1], tds[1], cfg,
                                    TL.TrainHyperparams(**hp_kw), prev_chain=chain, logger=log,
                                    shared=shared, device="cpu", draws=C.JaxDraws(key))
        chain.append(p)
        infos.append(info)
    return chain, infos, log.rows


def test_train_task_matches_jax_with_its_draws():
    """Two toy tasks (M = 8, batches of 32, 4 steps an epoch, an
    evaluation every 2 epochs, patience 1): the same (tag, step) log, at
    least two evaluations a task and one early stop; accuracies equal,
    ELBO pieces within 1e-5 relative, the best parameters within 2e-5 of
    each leaf's largest value, the best step and summary equal."""
    jchain, jinfos, jrows = _toy_run("jax", TOY_HP, TOY_TASK)
    tchain, tinfos, trows = _toy_run("torch", TOY_HP, TOY_TASK)
    assert [(tag, step) for tag, step, _ in trows] == [(tag, step) for tag, step, _ in jrows]
    evals = [sum(1 for tag, _, _ in jrows if tag == f"task{t}/val/acc") for t in range(2)]
    assert min(evals) >= 2, evals
    assert min(evals) < TOY_HP["epochs"] // TOY_HP["eval_interval"], evals  # an early stop
    for (tag, step, got), (_, _, want) in zip(trows, jrows):
        if "/loss/" in tag:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{tag} at {step}")
        else:
            assert got == want, (tag, step, got, want)
    for t in range(2):
        assert tinfos[t]["step"] == jinfos[t]["step"]
        assert tinfos[t]["acc_summary"] == jinfos[t]["acc_summary"]
        got = convert.params_to_numpy(tchain[t])
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jchain[t])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * float(np.abs(w).max()))


def test_phi_freeze_after_first_in_train_task():
    """After tests/test_train.py::test_phi_freeze_after_first_in_train_task,
    on the port: under freeze_phi_after_first, task 1 keeps phi bitwise as
    task 0 left it (its warm start) while its variational mean moves.  (A
    deep kernel on the toy's two inputs gives a nearly singular K_zz, so
    the two packages' ELBOs part by more than 1e-5 within a few steps:
    the phi group's arithmetic is held to optax above instead.)"""
    toy = tdata.make_toy_dataset(seed=0)
    sets = [tdata.filter_by_class(toy, [2 * t, 2 * t + 1]) for t in range(2)]
    cfg = TL.V.VARGPConfig(M=4, out_size=4, in_size=2, n_f=3, n_var_samples=2, dkl=True)
    hp = TL.TrainHyperparams(epochs=4, lr=1e-2, batch_size=32, eval_interval=4, patience=10,
                             freeze_phi_after_first=True)
    p0, _ = TL.train_task(0, 0, sets[0], sets[0], sets[0], cfg, hp, device="cpu")
    p1, _ = TL.train_task(1, 1, sets[1], sets[1], sets[1], cfg, hp, prev_chain=[p0],
                          device="cpu")
    for a, b in zip(TO.tree_leaves(p0.phi), TO.tree_leaves(p1.phi)):
        assert torch.equal(a, b)
    assert not torch.equal(p0.u_mean, p1.u_mean)


@pytest.mark.parametrize("what", ["scan_epoch=False", "mesh"])
def test_train_task_refuses_what_is_not_ported(what):
    """The per-minibatch mode and a mesh raise at entry, before any draw."""
    toy = tdata.make_toy_dataset(seed=0)
    cfg = TL.V.VARGPConfig(M=4, out_size=4, in_size=2)
    hp = TL.TrainHyperparams(scan_epoch=what != "scan_epoch=False")
    mesh = object() if what == "mesh" else None
    with pytest.raises(NotImplementedError, match="not ported"):
        TL.train_task(0, 0, toy, toy, toy, cfg, hp, mesh=mesh, device="cpu")

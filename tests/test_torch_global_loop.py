"""The global continual SVGP's training loop (``train/loop_global.py``)
against the JAX package's (``vargp_tpu/train/loop_global.py``) on the CPU:
the evaluation's draw rule (every batch of a split its own draws, as the
JAX scan folds the batch index into the key), its NaN poisoning, one ELBO
step with the optimizer state carried over from optax, and ``train_task``
over two tasks with the JAX draws replayed
(``tests/_torch_cases.py::JaxGlobalDraws``).

Tolerances: correct counts are equal (probabilities agree to 1e-6 at
these sizes, ``tests/test_torch_global.py``); the ELBO step's loss and
pieces within 1e-5 relative, its parameters and moments within 2e-5 of
each leaf's largest value; ``train_task`` (f32, on the toy protocol's
data): its logged accuracies are equal, its ELBO pieces within 1e-5
relative, its best parameters within 1e-5 of each leaf's largest value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu import data as jdata
from vargp_tpu.models import global_svgp as JG
from vargp_tpu.train import loop as JL
from vargp_tpu.train import loop_global as JLG
from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.models import global_svgp as TG
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train import loop_global as TLG
from vargp_tpu_torch.utils import convert

RTOL = 1e-5
TOL_GRAD = 2e-5

_port = C.global_port
_port_noise = C.global_noise


@pytest.mark.parametrize("case", ["task0", "grown"])
def test_eval_fn_draws_per_batch_as_make_device_eval_fn_global(case):
    """Every batch of a split predicts with its own draws (the JAX scan
    folds the batch index into the key): the same correct count as the JAX
    evaluation on its draws, over 3 batches the last of them padded; one
    draw shared by every batch, the VAR-GP evaluation's rule, gives
    other probabilities."""
    m = C.build_global(case)
    rng = np.random.default_rng(4)
    K, B = 3, m["x"].shape[0]
    xs = (rng.standard_normal((K, B, 5)) * 0.5).astype(np.float32)
    ys = rng.integers(0, 3, (K, B))
    ws = np.ones((K, B), np.float32)
    ws[-1, B // 2:] = 0.0
    kw = dict(eval_n_f=5, eval_n_var_samples=3)
    key = jax.random.key(11)
    want, wtot = JLG.make_device_eval_fn_global(m["cfg"], JL.TrainHyperparams(**kw))(
        m["params"], m["prev"], jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ws), key)
    draws = C.JaxGlobalDraws(jax.random.key(0))
    draws.key_seq = jax.random.split(key)[0]  # so that evaluation() splits off ``key``...
    cfg_eval = JL.V.eval_budget_cfg(m["cfg"], n_f=5, n_var_samples=3)
    hyper, lik = zip(*(C.global_predict_draws(jax.random.fold_in(key, i), cfg_eval, B)
                       for i in range(K)))
    ev = {"hyper_eps": torch.tensor(np.asarray(jnp.stack(hyper))),
          "lik_eps": torch.tensor(np.asarray(jnp.stack(lik)))}
    tp, tprev, *_ = _port(m)
    t = torch.tensor
    eval_acc = TLG.make_device_eval_fn_global(m["tcfg"], TL.TrainHyperparams(**kw))
    got, tot = eval_acc(tp, tprev, t(xs), t(ys), t(ws), ev, device="cpu")
    assert float(tot) == float(wtot) == float(ws.sum())
    assert float(got) == float(want)
    assert 0 < float(got) < float(ws.sum())
    shared = {k: v[:1].expand_as(v) for k, v in ev.items()}
    p_own = TG.predict(tp, tprev, t(xs[1]), {k: v[1] for k, v in ev.items()}, m["tcfg"],
                       n_f=5, n_var_samples=3, device="cpu")
    p_shared = TG.predict(tp, tprev, t(xs[1]), {k: v[1] for k, v in shared.items()}, m["tcfg"],
                          n_f=5, n_var_samples=3, device="cpu")
    assert float((p_own - p_shared).abs().max()) > 1e-3


def test_eval_fn_poisons_the_count_on_nan():
    m = C.build_global("task0")
    tp, tprev, *_ = _port(m)
    bad = tp._replace(u_mean=tp.u_mean * float("nan"))
    xs, ys = torch.zeros((2, 16, 5)), torch.zeros((2, 16), dtype=torch.long)
    ws = torch.ones((2, 16))
    g = torch.Generator().manual_seed(0)
    ev = TLG.GlobalDraws(g).evaluation(m["tcfg"], 2, 16, True)
    eval_acc = TLG.make_device_eval_fn_global(m["tcfg"])
    assert np.isnan(float(eval_acc(bad, tprev, xs, ys, ws, ev, device="cpu")[0]))
    assert np.isfinite(float(eval_acc(tp, tprev, xs, ys, ws, ev, device="cpu")[0]))


# ---------------------------------------------------------------------------
# train_task
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step=0):
        self.rows.append((tag, int(step), float(value)))


GLOBAL_HP = dict(epochs=8, lr=1e-2, batch_size=32, beta=1.0, eval_interval=2, patience=1,
                 max_steps_per_dispatch=8, eval_n_f=5, eval_n_var_samples=3)


def _global_run(side: str):
    """The toy protocol's two tasks (4 classes, D = 2: classes {0, 1}, then
    {2, 3}, evaluated on the classes seen) with M = 6, then 9 (grown),
    through ``train_task`` of ``side``, task t from jax.random.key(60 + t)
    (the port replays its draws)."""
    toy = jdata.make_toy_dataset(seed=0)
    log = _Recorder()
    chain, infos, prev = [], [], None
    for t in range(2):
        tr = jdata.filter_by_class(toy, [2 * t, 2 * t + 1])
        ev = jdata.filter_by_class(toy, range(2 * t + 2))
        kw = dict(M=6 if t == 0 else 9, out_size=4, in_size=2, n_f=4, n_var_samples=2)
        key = jax.random.key(60 + t)
        if side == "jax":
            p, info = JLG.train_task(key, t, tr, ev, ev, JG.GlobalSVGPConfig(**kw),
                                     JL.TrainHyperparams(**GLOBAL_HP), prev_state=prev,
                                     logger=log, seed=t)
        else:
            tr, ev = (tdata.ArrayDataset(d.data, d.targets) for d in (tr, ev))
            p, info = TLG.train_task(None, t, tr, ev, ev, TG.GlobalSVGPConfig(**kw),
                                     TL.TrainHyperparams(**GLOBAL_HP), prev_state=prev,
                                     logger=log, device="cpu", draws=C.JaxGlobalDraws(key))
        prev = p
        chain.append(p)
        infos.append(info)
    return chain, infos, log.rows


def test_train_task_matches_jax_with_its_draws():
    """Two toy tasks, the second grown from 6 to 9 rows a class, 4 steps an
    epoch in blocks of at most two epochs (max_steps_per_dispatch 8), an
    evaluation every 2 epochs at n_f = 5, H = 3, patience 1: the same
    (tag, step) log, u_prev_reg logged (0 at task 0, live at task 1); the
    accuracies equal, the ELBO pieces within 1e-5 relative, the best
    parameters within 1e-5 of each leaf's largest value, the best step and
    summary equal.  kl_hypers is a sum of D + 1 = 3 terms of order 1 that
    nearly cancel at task 1 (its prior is task 0's posterior: 0.026 after
    two epochs), so it is held to 1e-5 of those terms, 3e-5 absolute.
    (A change of one ulp in the learning rate moves the JAX package's own
    task 1 parameters by 2.6e-6 of their scale.)"""
    jchain, jinfos, jrows = _global_run("jax")
    tchain, tinfos, trows = _global_run("torch")
    assert [(tag, step) for tag, step, _ in trows] == [(tag, step) for tag, step, _ in jrows]
    reg = [v for tag, _, v in jrows if tag.endswith("/loss/u_prev_reg")]
    assert reg and any(v == 0.0 for v in reg) and any(abs(v) > 1.0 for v in reg)
    for (tag, step, got), (_, _, want) in zip(trows, jrows):
        if "/loss/" in tag:
            atol = RTOL * 3 if tag.endswith("kl_hypers") else 0.0
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=f"{tag} at {step}")
        else:
            assert got == want, (tag, step, got, want)
    for t in range(2):
        assert tinfos[t]["step"] == jinfos[t]["step"]
        assert tinfos[t]["acc_summary"] == jinfos[t]["acc_summary"]
        got = convert.params_to_numpy(tchain[t])
        assert tuple(got.z.shape) == (4, 6 if t == 0 else 9, 2)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jchain[t])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * float(np.abs(w).max()))


def test_elbo_step_and_optimizer_state_carry_over_from_optax():
    """One JAX ``_global_step`` (yogi) with the optimizer state converted
    into the port and one port step (``gradient_step`` on the global
    ``elbo``) on the same draws: the same
    loss, pieces, parameters and moments."""
    m = C.build_global("grown")
    hp = JL.TrainHyperparams(lr=1e-2)
    tx = JL.make_optimizer(hp)
    key = jax.random.key(8)
    state = tx.init(m["params"])
    jp, jstate, jloss, jaux = JLG._global_step(
        m["params"], state, m["prev"], m["prior"], m["x"], m["y"], m["w"], key,
        cfg=m["cfg"], tx=tx, beta=2.0, n_train=100.0)
    tp, tprev, tprior, x, y, w = _port(m)
    tstate = convert.opt_state_from_numpy(C.np_tree(state[0]), device="cpu")
    noise = _port_noise(m, key)
    got_p, got_state, loss, aux = TL.gradient_step(
        tp, tstate, lambda p: TLG.elbo(p, tprev, tprior, x, y, w, noise, cfg=m["tcfg"], beta=2.0,
                                       n_train=100.0, device="cpu"),
        TL.make_optimizer(TL.TrainHyperparams(lr=1e-2)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for g, j in zip(aux, jaux):
        np.testing.assert_allclose(float(g), float(j), rtol=RTOL, atol=1e-30)
    out = convert.opt_state_to_numpy(got_state)
    for g, j in zip(jax.tree_util.tree_leaves((convert.params_to_numpy(got_p), out.mu, out.nu)),
                    jax.tree_util.tree_leaves((jp, jstate[0].mu, jstate[0].nu))):
        j = np.asarray(j)
        np.testing.assert_allclose(g, j, rtol=0, atol=TOL_GRAD * max(float(np.abs(j).max()), 1e-30))


def _toy_task0():
    return tdata.filter_by_class(tdata.make_toy_dataset(seed=0), [0, 1])


def test_train_task_refuses_the_per_minibatch_mode():
    tr = _toy_task0()
    _, tcfg = C.global_cfgs(6)
    with pytest.raises(NotImplementedError, match="not ported"):
        TLG.train_task(0, 0, tr, tr, tr, tcfg, TL.TrainHyperparams(scan_epoch=False),
                       device="cpu")



"""The port's training pieces against the JAX package on the CPU: Yogi and
Adam against optax, ``elbo_step`` against the JAX ``elbo_step`` with the
JAX package's noise replayed, the train block against a loop of the
port's own steps, the blocks' schedule against the loops it replaced,
and the construction of a task's parameters.

Tolerances: the optimizers are the same elementwise f32 arithmetic as
optax's, so their states agree to 1e-6 relative.  Three ELBO steps carry
the gradients' f32 differences (2e-5 of each leaf's largest gradient, see
test_torch_grad.py) into the parameters through Yogi, whose update is
about lr in size: the ELBO pieces agree to 1e-5 relative, the parameters
to 5e-6 absolute (lr = 3e-3, so under 1e-3 of what three steps can move
them; the largest error seen is 1.3e-6).  The train block and the loop of steps run
the same operations in the same order, so they agree exactly.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu.data.core import ArrayDataset
from vargp_tpu.models import vargp as JV
from vargp_tpu.train import loop as JL
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import Adam, Yogi, tree_leaves
from vargp_tpu_torch.utils import convert

f32 = np.float32
LR = 3e-3


def _assert_tree_close(got, want, rtol=1e-6, atol=0.0):
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["yogi", "adam"])
def test_optimizer_matches_optax_with_state_carried_both_ways(name):
    """2 optax steps, the state carried into the port, 3 port steps, the
    state carried back out: equal to 5 optax steps."""
    m = C.build("small")
    params = m["params"]
    tx = optax.yogi(LR) if name == "yogi" else optax.adam(LR)
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=LR, optimizer=name))
    assert isinstance(opt, Yogi if name == "yogi" else Adam)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(f32) * 10.0 ** rng.integers(-4, 1)),
        params) for _ in range(5)]
    grads[3] = jax.tree_util.tree_map(jnp.zeros_like, grads[3])  # sign(nu - 0) on a zero step

    state = tx.init(params)
    jp = params
    for k in range(5):
        upd, state = tx.update(grads[k], state, jp)
        jp = optax.apply_updates(jp, upd)
        if k == 1:
            carried = (jp, state)

    p0, s0 = carried
    tp, _, _ = convert.params_from_numpy(C.np_tree(p0), device="cpu")
    ts = convert.opt_state_from_numpy(C.np_tree(s0[0]), device="cpu")
    for k in range(2, 5):
        g = [torch.tensor(np.asarray(a)) for a in jax.tree_util.tree_leaves(grads[k])]
        tp, ts = opt.update(g, ts, tp)

    out_state = convert.opt_state_to_numpy(ts)
    assert int(out_state.count) == int(state[0].count) == 5
    _assert_tree_close(convert.params_to_numpy(tp), jp)
    _assert_tree_close(out_state.mu, state[0].mu)
    _assert_tree_close(out_state.nu, state[0].nu)


def test_optimizer_init_matches_optax():
    m = C.build("small")
    tp, _, _ = convert.params_from_numpy(C.np_tree(m["params"]), device="cpu")
    for tx, opt in ((optax.yogi(LR), Yogi(LR)), (optax.adam(LR), Adam(LR))):
        want = tx.init(m["params"])[0]
        got = convert.opt_state_to_numpy(opt.init(tp))
        assert int(got.count) == int(want.count) == 0
        _assert_tree_close(got.mu, want.mu, rtol=0)
        _assert_tree_close(got.nu, want.nu, rtol=0)


@pytest.mark.parametrize("size,map_est", [("small", False), ("long", False), ("small", True)])
def test_three_elbo_steps_match_jax(size, map_est):
    """Yogi steps on the whole chain (S = 192, and S = 512 through K2's
    route and the triangle-skip backward), beta and n_train as the
    drivers set them, the JAX package's noise replayed each step.  Under
    MAP hypers log_logvar is unread: its gradient is 0 on both sides."""
    m = C.build(size)
    if map_est:
        from dataclasses import replace

        m = dict(m, cfg=replace(m["cfg"], map_est_hypers=True),
                 tcfg=replace(m["tcfg"], map_est_hypers=True))
    beta, n_train = 1.64, 1000
    tx = optax.yogi(LR)
    step = jax.jit(partial(JL.elbo_step, cfg=m["cfg"], tx=tx, beta=beta, n_train=n_train))
    jp, js = m["params"], tx.init(m["params"])
    opt = Yogi(LR)
    keys = [jax.random.key(20 + k) for k in range(3)]
    tp, tprev, tprior, x, y, w, _, _ = C.port_inputs(m, m["prev"], None, keys[0])
    ts = opt.init(tp)
    for key in keys:
        jp, js, jloss, jaux = step(jp, js, m["prev"], m["prior"], m["x"], m["y"], m["w"], key)
        *_, noise, _ = C.port_inputs(m, m["prev"], None, key)
        tp, ts, tloss, taux = TL.elbo_step(tp, ts, tprev, tprior, x, y, w, noise, cfg=m["tcfg"],
                                           opt=opt, beta=beta, n_train=n_train, device="cpu")
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        for name, a, b in zip(("kl_hypers", "kl_u", "nll"), taux, jaux):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5, err_msg=name)
    _assert_tree_close(convert.params_to_numpy(tp), jp, rtol=0, atol=5e-6)
    out = convert.opt_state_to_numpy(ts)
    assert int(out.count) == int(js[0].count) == 3


def _block_data(m, n_rows, seed=3):
    rng = np.random.default_rng(seed)
    d = m["dims"]
    data = (rng.standard_normal((n_rows, d["D"])) * 0.3).astype(f32)
    targets = rng.integers(0, d["O"], n_rows)
    return data, targets


def test_train_block_is_a_loop_of_elbo_steps():
    """Two epochs over 80 rows padded to 96 (batch 32): one permutation per
    epoch, then each step's noise, from one generator."""
    m = C.build("small")
    d = m["dims"]
    B = d["B"]
    tp, tprev, tprior, *_ = C.port_inputs(m, m["prev"], None, jax.random.key(0))
    data, targets = _block_data(m, 80)
    x, y, w = TL.pad_dataset_to_device(data, targets, B, device="cpu")
    assert x.shape == (96, d["D"]) and float(w.sum()) == 80.0
    opt = Yogi(LR)
    kw = dict(cfg=m["tcfg"], opt=opt, beta=1.0, device="cpu")

    got_p, got_s, losses, pieces = TL.train_block(
        tp, opt.init(tp), tprev, tprior, None, 80, x, y, w, torch.Generator().manual_seed(7),
        batch_size=B, n_epochs=2, **kw)
    assert losses.shape == (6,) and pieces.shape == (6, 3)
    assert bool(torch.isfinite(losses).all())

    gen = torch.Generator().manual_seed(7)
    p, s, want_losses = tp, opt.init(tp), []
    for _ in range(2):
        perm = torch.randperm(96, generator=gen)
        for k in range(3):
            idx = perm[k * B:(k + 1) * B]
            noise = TL.draw_noise(gen, m["tcfg"], len(tprev), B)
            p, s, loss, _ = TL.elbo_step(p, s, tprev, tprior, x[idx], y[idx], w[idx], noise,
                                         n_train=80, **kw)
            want_losses.append(loss)
    np.testing.assert_array_equal(losses.numpy(), torch.stack(want_losses).numpy())
    for a, b in zip(tree_leaves(got_p), tree_leaves(p)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(got_s.count) == 6
    with pytest.raises(ValueError, match="multiple"):
        TL.train_block(tp, opt.init(tp), tprev, tprior, None, 80, x[:90], y[:90], w[:90],
                       torch.Generator(), batch_size=B, n_epochs=1, **kw)


def _old_blocks(rule, epochs, eval_interval, steps_per_epoch, max_steps):
    """(block sizes, evaluated epochs) of the loops the models had before
    ``epoch_blocks``, verbatim: ``vargp`` VAR-GP's and the global model's
    ``train_task`` (on the cadence and at the last epoch), ``retrain``
    Retrain's (on the cadence only)."""
    blocks, evals = [], []
    if rule == "vargp":
        epoch, last_eval = -1, 0
        max_block_epochs = max(1, max_steps // max(steps_per_epoch, 1))
        while epoch + 1 < epochs:
            to_eval = eval_interval - ((epoch + 1) - last_eval)
            block = min(max(to_eval, 1), epochs - (epoch + 1), max_block_epochs)
            blocks.append(block)
            epoch += block
            if (epoch + 1) - last_eval >= eval_interval or epoch + 1 >= epochs:
                last_eval = epoch + 1
                evals.append(epoch + 1)
        return blocks, evals
    epoch = 0
    max_block = max(1, max_steps // max(steps_per_epoch, 1))
    while epoch < epochs:
        to_eval = eval_interval - (epoch % eval_interval)
        block = min(to_eval, epochs - epoch, max_block)
        blocks.append(block)
        epoch += block
        if epoch % eval_interval == 0:
            evals.append(epoch)
    return blocks, evals


class _Steps:
    """A logger that keeps the epoch of each accuracy it is given."""

    def __init__(self):
        self.evals = []

    def add_scalar(self, tag, value, step=0):
        if tag.endswith("/acc"):
            self.evals.append(step)


def _vargp_blocks(epochs, eval_interval, steps_per_epoch, max_steps):
    """``train.loop.fit``'s blocks and evaluated epochs (one val/acc tag an
    evaluation), the train blocks and evaluations stubbed."""
    hp = TL.TrainHyperparams(epochs=epochs, eval_interval=eval_interval, patience=-1,
                             max_steps_per_dispatch=max_steps)
    blocks, log = [], _Steps()

    def block(params, opt_state, n_epochs):
        blocks.append(n_epochs)
        return params, opt_state, torch.zeros(1), torch.zeros(1, 3)

    accs = {f"task0/{s}/acc": 0.5 for s in ("train", "val", "test")}
    info = TL.fit(None, None, block, lambda params: accs, hp, 0, steps_per_epoch,
                  ("kl_hypers", "kl_u", "lik"), log)
    assert info["epochs"] == epochs and info["steps"] == sum(blocks) * steps_per_epoch
    return blocks, log.evals[::3]


def _retrain_blocks(epochs, eval_interval, steps_per_epoch, max_steps, monkeypatch):
    """Retrain's ``train_task`` on a 100-row toy task in ``steps_per_epoch``
    batches: its blocks' epochs (recorded by the draw source) and its
    logged epochs, the train blocks and accuracies stubbed."""
    from vargp_tpu_torch import data as tdata
    from vargp_tpu_torch.experiments import retrain_run as TRR
    from vargp_tpu_torch.models import vargp_retrain as TR

    blocks = []

    class Draws(TRR.RetrainDraws):
        def block(self, n_pad, batch_size, n_epochs, *shape):
            assert n_pad // batch_size == steps_per_epoch
            blocks.append(n_epochs)
            return ()

    monkeypatch.setattr(TRR, "step_block", lambda step, params, opt_state, *a: (
        params, opt_state, torch.zeros(1), torch.zeros(1, 3)))
    monkeypatch.setattr(TRR, "accuracy", lambda *a, **kw: 0.5)
    toy = tdata.filter_by_class(tdata.make_toy_dataset(seed=0), [0, 1])
    hp = TL.TrainHyperparams(epochs=epochs, eval_interval=eval_interval, patience=-1,
                             max_steps_per_dispatch=max_steps, batch_size=100 // steps_per_epoch)
    log = _Steps()
    _, info = TRR.train_task(Draws(torch.Generator().manual_seed(0)), 0, toy, toy,
                             TR.RetrainConfig(M=3, out_size=4, in_size=2), hp, logger=log,
                             device="cpu")
    assert info["epochs"] == epochs and info["steps"] == sum(blocks) * steps_per_epoch
    return blocks, log.evals


# (epochs, eval_interval, steps a epoch, max_steps_per_dispatch)
SCHEDULES = [
    (20, 10, 1, 128),  # blocks of the interval
    (25, 10, 1, 128),  # an interval that does not divide the epochs
    (30, 10, 20, 64),  # a cap of 3 epochs below the interval
    (7, 3, 5, 10),  # a cap of 2 below the interval, which does not divide the epochs
    (12, 4, 50, 16),  # a step cap below one epoch: blocks of one epoch
    (0, 10, 1, 128),  # no epoch
]


@pytest.mark.parametrize("rule,schedule", [("vargp", s) for s in SCHEDULES + [(5, 0, 1, 128)]]
                         + [("retrain", s) for s in SCHEDULES])
def test_epoch_blocks_keep_the_old_loops_blocks_and_evaluations(rule, schedule, monkeypatch):
    """``epoch_blocks`` with each caller's evaluation rule gives the block
    sizes and evaluated epochs of the loops it replaced: VAR-GP and the
    global model (``fit``, an interval of 0 included) on the cadence and at
    the last epoch, Retrain on the cadence only."""
    got = (_vargp_blocks(*schedule) if rule == "vargp"
           else _retrain_blocks(*schedule, monkeypatch))
    assert got == _old_blocks(rule, *schedule)


def test_draw_noise_shapes_fit_loss():
    m = C.build("small")
    cfg = m["tcfg"]
    noise = TL.draw_noise(torch.Generator().manual_seed(0), cfg, 2, 32)
    TV._check_noise(noise, cfg, 2 * cfg.M, 32, True)
    assert "prefix_eps" not in TL.draw_noise(torch.Generator(), cfg, 0, 32)


def test_pad_dataset_matches_jax():
    m = C.build("small")
    data, targets = _block_data(m, 70)
    want = JL.pad_dataset_to_device(ArrayDataset(data, targets.astype(np.int32)), 32, n_rows=100)
    got = TL.pad_dataset_to_device(data, targets, 32, n_rows=100, device="cpu")
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    with pytest.raises(ValueError):
        TL.pad_dataset_to_device(data, targets, 32, n_rows=10, device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        TL.make_optimizer(TL.TrainHyperparams(optimizer="sgd"))


@pytest.mark.parametrize("chained", [False, True])
def test_init_params_and_freeze_task_match_jax(chained):
    m = C.build("small")
    cfg, tcfg, d = m["cfg"], m["tcfg"], m["dims"]
    z = m["params"].z
    key = jax.random.key(5)
    kw = dict(kernel_prior_from=m["params"].kernel, log_lengthscale_init=0.7) if chained else {}
    want_p, want_prior = JV.init_params(key, z, cfg, **kw)
    k_kern, k_u, _ = jax.random.split(key, 3)  # the draws init_params makes
    kernel_eps = jax.random.normal(k_kern, (d["D"] + 1,), jnp.float32)
    u_eps = jax.random.normal(k_u, (d["O"], d["M"], 1))
    t = lambda a: torch.tensor(np.asarray(a))
    tkw = {}
    if chained:
        tkw = dict(kernel_prior_from=TV.RBFParams(t(m["params"].kernel.log_mean),
                                                  t(m["params"].kernel.log_logvar)),
                   log_lengthscale_init=0.7)
    got_p, got_prior = TV.init_params(t(kernel_eps), t(u_eps), t(z), tcfg, **tkw)
    _assert_tree_close(convert.params_to_numpy(got_p), want_p)
    _assert_tree_close(convert.params_to_numpy(got_prior), want_prior, rtol=0)
    frozen = TV.freeze_task(got_p)
    _assert_tree_close(convert.params_to_numpy(frozen), JV.freeze_task(want_p))
    assert not any(a.requires_grad for a in frozen)
    np.testing.assert_array_equal(TV._diag_mask_vec(7).numpy(), np.asarray(JV._diag_mask_vec(7)))


def test_median_log_lengthscale_matches_jax():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((40, 6)).astype(f32)
    data[3] = data[1]  # a zero distance, which the median skips
    for n in (40, 17):  # an even and an odd count of distances
        want = float(JV.median_log_lengthscale(jnp.asarray(data), n_sample=n))
        got = float(TV.median_log_lengthscale(torch.tensor(data), n_sample=n))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n", [5, 50])
def test_select_inducing_draws_with_replacement_below_m(n):
    """Below M rows the draw repeats rows (the JAX package's fix for a
    silent truncation); from M rows up a class head never repeats one."""
    M, O, D = 12, 3, 4
    data = np.arange(n * D, dtype=f32).reshape(n, D)
    want = JV.select_inducing(jax.random.key(0), jnp.asarray(data), M, O)
    got = TV.select_inducing(torch.Generator().manual_seed(0), torch.tensor(data), M, O)
    assert tuple(got.shape) == want.shape == (O, M, D)
    rows = got[..., 0].numpy() / D  # row index of every draw
    assert np.all(np.isin(rows, np.arange(n)))
    for r in rows:
        assert (len(np.unique(r)) < M) == (n < M)

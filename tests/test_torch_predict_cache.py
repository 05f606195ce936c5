"""``models.vargp.predict``'s posterior memo on the CPU: the last chain
posterior built is reused while its inputs (the parameters, the chain,
``noise["hyper_eps"]``, ``chain_mask``) are the same unchanged tensors.

- Over a pass of batches with one noise dict, a call builds once and
  reuses after, and every call's probabilities are bitwise those of a
  call with the memo cleared first.
- An input changed in place, a new noise dict, another evaluation config,
  another ``chain_mask`` object or another route knob each rebuild, and
  the result is the uncached call's.
- With autograd recording a parameter, or for inference tensors, nothing
  is kept, and gradients are those of ``forward`` and ``softmax_predict``
  composed by hand.
- The memo keeps no caller's tensor alive: dropping the parameters or the
  noise frees the posterior.
- Noise of the wrong shapes still raises before any lookup.
"""

import weakref

import pytest
import torch

from vargp_tpu_torch.likelihoods import softmax_predict
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten
from vargp_tpu_torch.utils import tracing

# a 3-class task after two earlier tasks, the chain padded to four tasks
O, M, D, B, H, N_F, T_MAX, N_BATCHES = 3, 8, 5, 16, 2, 3, 4, 4


@pytest.fixture(autouse=True)
def _fresh():
    V.clear_posterior_cache()
    tracing.POSTERIOR.clear()
    yield
    V.clear_posterior_cache()
    tracing.POSTERIOR.clear()


def _case(seed: int = 0, dkl: bool = False) -> dict:
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen)

    cfg = V.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H, dkl=dkl)
    P = V._theta_size(cfg)
    dims = [D, 256, 256, P]
    phi = [torch.rand(s, generator=gen) for i in range(3) for s in ((dims[i], dims[i + 1]),
                                                                     (dims[i + 1],))]
    tasks = [V.init_params(normal(P + 1), normal(O, M, 1), normal(O, M, D, scale=0.3), cfg,
                           phi_uniform=phi)[0] for _ in range(3)]
    prev, mask = V.pad_chain(tuple(V.freeze_task(p) for p in tasks[:2]), cfg, T_MAX,
                             device="cpu")
    return dict(params=tasks[2], prev=prev, mask=mask, cfg=cfg,
                xs=[normal(B, D, scale=0.3) for _ in range(N_BATCHES)],
                noise=TL.draw_noise(gen, cfg, 0, B))


def _predict(c: dict, x, *, noise=None, params=None, mask=None, **kw):
    with torch.no_grad():
        return V.predict(c["params"] if params is None else params, c["prev"], x,
                         c["noise"] if noise is None else noise, c["cfg"],
                         chain_mask=c["mask"] if mask is None else mask, device="cpu", **kw)


def _uncached(c: dict, x, **kw):
    V.clear_posterior_cache()
    return _predict(c, x, **kw)


@pytest.mark.parametrize("model", ["plain", "dkl"])
def test_a_pass_builds_once_and_is_bitwise_the_uncached_predict(model):
    c = _case(dkl=model == "dkl")
    cached = [_predict(c, x) for x in c["xs"]]
    assert tracing.POSTERIOR == {"build": 1, "reuse": N_BATCHES - 1}
    for x, got in zip(c["xs"], cached):
        assert torch.equal(got, _uncached(c, x))
    assert tracing.POSTERIOR == {"build": 1 + N_BATCHES, "reuse": N_BATCHES - 1}


def _change_in_place(c: dict, which: str) -> None:
    with torch.no_grad():
        if which == "param leaf":
            c["params"].kernel.log_mean.add_(0.1)
        elif which == "prev leaf":
            c["prev"][0].z.mul_(0.9)
        elif which == "hyper_eps":
            c["noise"]["hyper_eps"].mul_(0.5)
        else:  # the second earlier task masked off
            c["mask"][1] = 0.0


@pytest.mark.parametrize("which", ["param leaf", "prev leaf", "hyper_eps", "chain_mask"])
def test_an_input_changed_in_place_is_rebuilt(which):
    """The stale-entry fault: a tensor of the key written in place keeps
    its identity, and only its version tells the memo."""
    c = _case()
    x = c["xs"][0]
    first = _predict(c, x)
    _change_in_place(c, which)
    second = _predict(c, x)
    assert tracing.POSTERIOR == {"build": 2}
    assert not torch.equal(second, first)
    assert torch.equal(second, _uncached(c, x))


@pytest.mark.parametrize("other", ["a new noise dict", "cfg_eval n_var_samples",
                                   "a new chain_mask object", "route knob"])
def test_other_inputs_rebuild(other, monkeypatch):
    c = _case()
    x = c["xs"][1]
    first = _predict(c, x)
    if other == "a new noise dict":  # the same values in new tensors
        second = _predict(c, x, noise={k: v.clone() for k, v in c["noise"].items()})
        assert torch.equal(second, first)
    elif other == "a new chain_mask object":
        second = _predict(c, x, mask=c["mask"].clone())
        assert torch.equal(second, first)
    elif other == "cfg_eval n_var_samples":
        cfg3 = V.eval_budget_cfg(c["cfg"], n_var_samples=H + 1)
        noise3 = TL.draw_noise(torch.Generator().manual_seed(5), cfg3, 0, B)
        _predict(c, x, noise=noise3, n_var_samples=H + 1)
        second = _predict(c, x)  # the entry was replaced: built again
        assert torch.equal(second, first)
    else:
        monkeypatch.setenv("VARGP_TPU_AR_FORM", "materialized")
        second = _predict(c, x)
        assert tracing.POSTERIOR == {"build": 2}
        assert torch.equal(second, _uncached(c, x))
    builds = 3 if other in ("cfg_eval n_var_samples", "route knob") else 2
    assert tracing.POSTERIOR == {"build": builds}


def test_with_grad_nothing_is_kept_and_gradients_are_unchanged():
    c = _case()
    params, x = c["params"], c["xs"][0]
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    w = torch.linspace(0.5, 1.5, B * O).reshape(B, O)

    def grads(probs):
        return torch.autograd.grad(torch.sum(torch.log(probs) * w), leaves)

    got = [V.predict(params, c["prev"], x, c["noise"], c["cfg"], chain_mask=c["mask"],
                     device="cpu") for _ in range(2)]
    assert tracing.POSTERIOR == {"build": 2}
    assert V._entry is None
    out = V.forward(params, c["prev"], None, x, c["noise"], c["cfg"], with_kl=False,
                    chain_mask=c["mask"])
    want = softmax_predict(out.f_mean, out.f_var, c["noise"]["lik_eps"])
    assert all(torch.equal(probs.detach(), want.detach()) for probs in got)
    want_grads = grads(want)
    for probs in got:
        for g, r in zip(grads(probs), want_grads):
            assert torch.equal(g, r)
    # with grad enabled and no key tensor recorded, the memo engages
    detached = tree_unflatten(params, [t.detach() for t in leaves])
    tracing.POSTERIOR.clear()
    for _ in range(2):
        V.predict(detached, c["prev"], x, c["noise"], c["cfg"], chain_mask=c["mask"], device="cpu")
    assert tracing.POSTERIOR == {"build": 1, "reuse": 1}


def test_inference_tensors_build_and_keep_nothing():
    with torch.inference_mode():
        c = _case()
        got = [V.predict(c["params"], c["prev"], c["xs"][0], c["noise"], c["cfg"],
                         chain_mask=c["mask"], device="cpu") for _ in range(2)]
    assert tracing.POSTERIOR == {"build": 2}
    assert V._entry is None
    assert torch.equal(got[0], got[1])


def _posterior_of(c: dict) -> weakref.ref:
    _predict(c, c["xs"][0])
    assert V._entry is not None
    return weakref.ref(V._entry.cp.L)


@pytest.mark.parametrize("dropped", ["params", "noise"])
def test_dropping_an_input_frees_the_posterior(dropped):
    c = _case()
    cp_L = _posterior_of(c)
    del c[dropped]
    assert V._entry is None
    assert cp_L() is None


@pytest.mark.parametrize("bad", ["no hyper_eps", "hyper_eps of another shape"])
def test_bad_noise_raises_before_any_lookup(bad):
    c = _case()
    _predict(c, c["xs"][0])
    entry = V._entry
    noise = dict(c["noise"])
    if bad == "no hyper_eps":
        del noise["hyper_eps"]
    else:
        noise["hyper_eps"] = noise["hyper_eps"][:, :-1]
    with pytest.raises(ValueError, match="hyper_eps"):
        _predict(c, c["xs"][0], noise=noise)
    assert tracing.POSTERIOR == {"build": 1}
    assert V._entry is entry

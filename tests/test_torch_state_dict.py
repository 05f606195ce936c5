"""Reference-checkpoint migration (``utils/torch_compat.py``) against the
JAX package's: a reference VARGP ``state_dict`` (the upstream keys ``z``,
``u_mean``, ``u_tril_vec``, ``kernel.log_mean``, ``kernel.log_logvar``,
``kernel.prior_log_*`` and, under the deep kernel,
``kernel.phi.{0,2,4}.{weight,bias}`` with torch's (out, in) weights) is
built by hand from the shared small cases (no reference checkout here),
as torch tensors and as numpy arrays.  Both packages' maps give equal
leaves, and the port's ``loss`` on its map equals the JAX package's on
its own within the parity suite's 1e-5 relative (``tests/test_torch_vargp.py``,
``tests/test_torch_dkl.py``).
"""

import numpy as np
import jax
import pytest
import torch

from tests._torch_cases import build, build_dkl, jax_draws, np_tree
from vargp_tpu.models import vargp as JV
from vargp_tpu.utils import torch_compat as jcompat
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.train.optim import tree_leaves
from vargp_tpu_torch.utils import convert
from vargp_tpu_torch.utils import torch_compat as tcompat

RTOL_LOSS = 1e-5


def _case(dkl: bool) -> dict:
    return build_dkl("small") if dkl else build("small")


def _state_dict(m: dict, as_numpy: bool) -> dict:
    """The reference's keys for the case's parameters and prior: Linear
    weights stored (out, in)."""
    p, prior = np_tree(m["params"]), np_tree(m["prior"])
    sd = {"z": p.z, "u_mean": p.u_mean, "u_tril_vec": p.u_tril_vec,
          "kernel.log_mean": p.kernel.log_mean, "kernel.log_logvar": p.kernel.log_logvar,
          "kernel.prior_log_mean": prior.log_mean, "kernel.prior_log_logvar": prior.log_logvar}
    if p.phi is not None:
        for i, w, b in zip((0, 2, 4), p.phi.weights, p.phi.biases):
            sd[f"kernel.phi.{i}.weight"] = np.ascontiguousarray(w.T)
            sd[f"kernel.phi.{i}.bias"] = b
    return sd if as_numpy else {k: torch.tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("as_numpy", [False, True])
@pytest.mark.parametrize("dkl", [False, True])
def test_both_maps_give_equal_leaves(dkl, as_numpy):
    m = _case(dkl)
    sd = _state_dict(m, as_numpy)
    jp, jprior = jcompat.params_from_state_dict(sd), jcompat.prior_from_state_dict(sd)
    tp, tprior = (tcompat.params_from_state_dict(sd, device="cpu"),
                  tcompat.prior_from_state_dict(sd, device="cpu"))
    assert (tp.phi is None) == (not dkl)
    jleaves = jax.tree_util.tree_leaves((jp, jprior))
    tleaves = tree_leaves((tp, tprior))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.dtype == torch.float32 and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("dkl", [False, True])
def test_port_loss_on_the_migrated_params_matches_jax(dkl):
    m = _case(dkl)
    sd = _state_dict(m, as_numpy=False)
    jp, jprior = jcompat.params_from_state_dict(sd), jcompat.prior_from_state_dict(sd)
    tp, tprior = (tcompat.params_from_state_dict(sd, device="cpu"),
                  tcompat.prior_from_state_dict(sd, device="cpu"))
    prev = m["prev"]
    key = jax.random.key(2)
    want = JV.loss(jp, prev, jprior, m["x"], m["y"], key, m["cfg"], weights=m["w"])
    hyper, prefix, lik = jax_draws(m, key, len(prev) * m["dims"]["M"])
    _, tprev, _ = convert.params_from_numpy(np_tree(m["params"]), np_tree(prev), device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    got = TV.loss(tp, tprev, tprior, t(m["x"]), t(m["y"]),
                  convert.noise_for_loss(hyper, prefix, lik, device="cpu"), m["tcfg"],
                  weights=t(m["w"]), device="cpu")
    for name, g, j in zip(("kl_hypers", "kl_u", "nll"), got, want):
        assert np.isfinite(float(g)), name
        np.testing.assert_allclose(float(g), float(j), rtol=RTOL_LOSS, err_msg=name)


def test_chain_from_torch_checkpoints(tmp_path):
    """A saved chain of reference state dicts loads as the same parameters,
    file by file, through ``torch.load(..., map_location=device)``."""
    m = _case(False)
    paths, zs = [], []
    for t in range(2):
        sd = _state_dict(m, as_numpy=False)
        sd["z"] = sd["z"] + t
        zs.append(sd["z"])
        paths.append(tmp_path / f"ckpt{t}.pt")
        torch.save(sd, paths[-1])
    chain = tcompat.chain_from_torch_checkpoints(paths, device="cpu")
    jchain = jcompat.chain_from_torch_checkpoints(paths)
    assert len(chain) == len(jchain) == 2
    for tp, jp in zip(chain, jchain):
        for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for tp, z in zip(chain, zs):
        assert torch.equal(tp.z, z)

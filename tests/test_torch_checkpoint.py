"""The port's checkpoints (``vargp_tpu_torch/utils/checkpoint.py``) against
the JAX package's, on the CPU, bitwise: the minted chains read as the JAX
package reads them, chains the port writes read by the JAX package with
the same structure file, and mismatched files refused with
``CheckpointStructureError``.  Loads copy bytes, so every comparison is
exact."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu.models import vargp as JV
from vargp_tpu.utils import checkpoint as jckpt
from vargp_tpu_torch.experiments.analysis import params_template
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.train.optim import tree_leaves
from vargp_tpu_torch.utils import checkpoint as tckpt
from vargp_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINTED = {  # chain: (tasks, M, in_size, dkl)
    "sdigits_r4": (5, 20, 64, False),
    "sdigits_dkl": (5, 20, 64, True),
    "smnist_dkl": (5, 60, 784, True),
}


def _jax_template(M, D, dkl):
    cfg = JV.VARGPConfig(M=M, out_size=10, in_size=D, dkl=dkl)
    return JV.init_params(jax.random.key(0), jnp.zeros((10, M, D)), cfg)[0]


@pytest.mark.parametrize("chain", sorted(MINTED))
def test_minted_chain_reads_as_the_jax_package_reads_it(chain):
    T, M, D, dkl = MINTED[chain]
    log_dir = os.path.join(REPO, "results", chain)
    cfg = TV.VARGPConfig(M=M, out_size=10, in_size=D, dkl=dkl)
    got = tckpt.load_chain(log_dir, T, params_template(cfg))
    template = _jax_template(M, D, dkl)
    for t in range(T):
        want = jckpt.load_pytree(os.path.join(log_dir, f"ckpt{t}.npz"), template)
        g, w = tree_leaves(got[t]), jax.tree_util.tree_leaves(want)
        assert len(g) == len(w) == (11 if dkl else 5)
        assert (got[t].phi is None) == (not dkl)
        for a, b in zip(g, w):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("dkl", [False, True])
def test_chain_written_by_the_port_loads_in_jax(tmp_path, dkl):
    """Tensors written by the port: the JAX package reads them back bitwise,
    and the structure file equals the one the JAX package writes for the
    same tree."""
    m = C.build_dkl() if dkl else C.build("small")
    tp = convert.params_from_numpy(C.np_tree(m["params"]), device="cpu")[0]
    chain = [tp, tp._replace(u_mean=tp.u_mean + 1.0)]
    for t, p in enumerate(chain):
        path = tckpt.save_chain(str(tmp_path / "port"), t, p)
        assert path.endswith(f"ckpt{t}.npz")
    loaded = jckpt.load_chain(str(tmp_path / "port"), 2, [m["params"]] * 2)
    for p, q in zip(chain, loaded):
        for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(q)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jckpt.save_pytree(str(tmp_path / "jax" / "ckpt0.npz"), m["params"])
    with open(tmp_path / "jax" / "ckpt0.npz.structure.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "ckpt0.npz.structure.json") as f:
        assert json.load(f) == want
    # and the port reads what the JAX package wrote
    back = tckpt.load_pytree(str(tmp_path / "jax" / "ckpt0.npz"), tp)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(m["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_mismatched_checkpoints_raise(tmp_path):
    """A shape unlike the template's, a plain file read as DKL, and a DKL
    file read as plain: each raises, naming the file."""
    cfg = TV.VARGPConfig(M=20, out_size=10, in_size=64)
    plain = os.path.join(REPO, "results", "sdigits_r4", "ckpt0.npz")
    with pytest.raises(tckpt.CheckpointStructureError, match="shape"):
        tckpt.load_pytree(plain, params_template(TV.VARGPConfig(M=21, out_size=10, in_size=64)))
    with pytest.raises(tckpt.CheckpointStructureError, match="missing leaves"):
        tckpt.load_pytree(plain, params_template(TV.VARGPConfig(M=20, out_size=10, in_size=64,
                                                                dkl=True)))
    dkl = os.path.join(REPO, "results", "sdigits_dkl", "ckpt0.npz")
    with pytest.raises(tckpt.CheckpointStructureError, match="unexpected leaves"):
        tckpt.load_pytree(dkl, params_template(cfg))


def test_legacy_leaf_keys_are_count_checked(tmp_path):
    """The round-1 format (``leaf_{i}`` in tree order) loads when the count
    matches, as in the JAX package, and raises when it does not."""
    tmpl = params_template(TV.VARGPConfig(M=3, out_size=2, in_size=4))
    leaves = [np.full(a.shape, i, np.float32) for i, a in enumerate(tree_leaves(tmpl))]
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    got = tckpt.load_pytree(path, tmpl)
    want = jckpt.load_pytree(path, _jax_like(tmpl))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves[:4])})
    with pytest.raises(tckpt.CheckpointStructureError, match="legacy"):
        tckpt.load_pytree(path, tmpl)


def _jax_like(tmpl):
    return JV.VARGPParams(z=tmpl.z, u_mean=tmpl.u_mean, u_tril_vec=tmpl.u_tril_vec,
                          kernel=JV.RBFParams(*tmpl.kernel))


def test_load_chain_takes_one_named_tuple_template_or_a_list(tmp_path):
    """One NamedTuple template serves every task (the JAX package would take
    a NamedTuple for a list of templates, one per field); a list gives each
    task its own."""
    small = params_template(TV.VARGPConfig(M=3, out_size=2, in_size=4))
    big = params_template(TV.VARGPConfig(M=5, out_size=2, in_size=4))
    tckpt.save_chain(str(tmp_path), 0, small)
    tckpt.save_chain(str(tmp_path), 1, small)
    assert [p.z.shape for p in tckpt.load_chain(str(tmp_path), 2, small)] == [(2, 3, 4)] * 2
    tckpt.save_chain(str(tmp_path), 1, big)
    got = tckpt.load_chain(str(tmp_path), 2, [small, big])
    assert [p.z.shape for p in got] == [(2, 3, 4), (2, 5, 4)]
    with pytest.raises(tckpt.CheckpointStructureError):
        tckpt.load_chain(str(tmp_path), 2, small)


def test_loaded_leaves_go_to_the_device_as_they_are():
    """``params_from_numpy`` on a loaded checkpoint keeps every bit."""
    log_dir = os.path.join(REPO, "results", "sdigits_dkl")
    cfg = TV.VARGPConfig(M=20, out_size=10, in_size=64, dkl=True)
    p = tckpt.load_pytree(os.path.join(log_dir, "ckpt4.npz"), params_template(cfg))
    tp = convert.params_from_numpy(p, device="cpu")[0]
    for a, b in zip(tree_leaves(tp), tree_leaves(p)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)

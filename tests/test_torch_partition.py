"""The contract of ``vargp_tpu/ops/partition.py`` in the port.

In the JAX package ``custom_partitioning`` keeps XLA from replicating an
opaque ``pallas_call`` on a mesh: the kernels run on shard-local blocks
because the rules say so.  In the port each rank calls the
``vargp_torch::`` operators on its own shard, so they run on shard-local
blocks by construction; the rules and ``VARGP_TPU_PARTITION_KERNELS``
have no counterpart.  What tests/test_partition.py holds the JAX rules
to is held here of a 2 x 2 mesh of gloo ranks on the CPU
(``tests/_torch_parallel_ranks.py::partition_checks``):

- on each rank's classes and rows, the plain K1 (sym-Gram), K4 (cross
  Gram), K5 (the deep kernel's Gram) and ``chol_and_inv_blocked`` (K3 on
  the diagonal blocks) equal the slice of the whole within 1e-6 (the
  tolerance of tests/test_partition.py: a product on fewer rows may add
  in another order);
- one sharded ELBO step calls every operator on shard-local blocks only
  (the rank's O / mp classes, its B / dp rows), and its collectives are
  the function samples' gather, the loss pieces' sums and the gradients'
  sums: no Gram and no factor crosses ranks.
"""

import numpy as np
import jax
import pytest
import torch

from tests import _torch_cases as C
from tests import _torch_parallel_ranks as R
from tests.test_torch_parallel import BETA, LR, N_TRAIN, RANK_TIMEOUT, tiny_case
from vargp_tpu_torch import parallel
from vargp_tpu_torch.kernels import init_mlp, sym_gram
from vargp_tpu_torch.models import vargp as TV

H, O, M, D, B, BLOCK = 2, 8, 8, 6, 16, 4  # S = 2 blocks of 4


def _kernel_inputs(seed=5):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    theta = t(np.concatenate([0.3 * rng.standard_normal((H, D)), np.zeros((H, 1))], axis=1))
    z = t(rng.standard_normal((O, M, D)))
    dims = [D, 256, 256, 64]
    phi = init_mlp([t(rng.random(s)) for a, b in zip(dims, dims[1:]) for s in ((a, b), (b,))], D)
    theta_dkl = t(np.concatenate([rng.standard_normal((H, 64)) * 0.1 + 1.0, np.zeros((H, 1))],
                                 axis=1))
    K = sym_gram(theta, z) + 0.1 * torch.eye(M)
    return dict(theta=theta, z=z, x=t(rng.standard_normal((B, D))), phi=phi,
                theta_dkl=theta_dkl, K=K, block=BLOCK)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    m = tiny_case()
    tp, tprev, tprior, x, y, w, noise, _ = C.port_inputs(m, m["prev"], None, jax.random.key(42))
    plain = dict(cfg=m["tcfg"], params=tp, prev=tprev, prior=tprior, x=x, y=y, w=w, noise=noise,
                 lr=LR, beta=BETA, n_train=N_TRAIN)
    d = tmp_path_factory.mktemp("partition")
    torch.save(dict(kernels=_kernel_inputs(), plain=plain), d / "case.pt")
    # the port reads no partitioning knob: a value the JAX package refuses
    # changes nothing (the ranks inherit the environment)
    mp = pytest.MonkeyPatch()
    mp.setenv("VARGP_TPU_PARTITION_KERNELS", "bogus")
    try:
        out = parallel.spawn_ranks(R.partition_checks, ["cpu"] * 4, (str(d / "case.pt"), 2),
                                   timeout=RANK_TIMEOUT, store_dir=d)
    finally:
        mp.undo()
    return out, plain


@pytest.mark.parametrize("kernel", ["sym_gram", "cross_gram", "rbf_gram", "chol", "chol_inv"])
def test_kernels_on_a_shard_equal_the_slice_of_the_whole(ranks, kernel):
    out, _ = ranks
    for r in out:
        got, want = r["pairs"][kernel]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=kernel)


def test_a_sharded_step_runs_the_operators_on_shard_local_blocks(ranks):
    """Every operator call of the step (forward and backward) sees the
    rank's O / mp classes, and K4 its B / dp rows; the step's loss is the
    same on every rank."""
    out, plain = ranks
    dp, mp = out[0]["shape"]
    O_local, B_local = O // mp, plain["x"].shape[0] // dp
    for r in out:
        names = {n for n, _ in r["calls"]}
        assert {"vargp_torch::sym_gram", "vargp_torch::cross_gram"} <= names, names
        for name, shapes in r["calls"]:
            if name == "vargp_torch::cross_gram":
                z, x = shapes[0], shapes[1]
                assert z[0] == O_local and x[0] == B_local, (name, shapes)
            elif name in ("vargp_torch::sym_gram", "vargp_torch::sym_gram_tri"):
                assert shapes[0][0] == O_local, (name, shapes)
            else:  # the factorisations: batches of H x O / mp blocks
                assert np.prod(shapes[0][:-2]) == plain["cfg"].n_var_samples * O_local, (
                    name, shapes)
        assert r["loss"] == out[0]["loss"]


def test_a_sharded_step_communicates_only_f_the_loss_and_the_gradients(ranks):
    """The collectives of one step at 2 x 2: the gather of (f_mean, f_var)
    over "model" and its backward, the batch weight, kl_u and the nll's
    sums, and one sum of each kind of gradient leaf."""
    out, plain = ranks
    cfg, p = plain["cfg"], plain["params"]
    dp, mp = out[0]["shape"]
    n_f = (2, cfg.n_var_samples, cfg.out_size, plain["x"].shape[0] // dp)
    n_class = sum(t.numel() for t in (p.z, p.u_mean, p.u_tril_vec)) // mp
    n_repl = sum(t.numel() for t in p.kernel)
    want = sorted([("gather f", "model", n_f), ("gather f backward", "model", n_f),
                   ("sum w", "data", ()), ("sum kl_u", "model", ()), ("sum nll", "data", ()),
                   ("sum class-sharded grads", "data", (n_class,)),
                   ("sum replicated grads", "all", (n_repl,))])
    for r in out:
        assert sorted(r["log"]) == want


def test_shard_params_takes_contiguous_class_slices():
    """``shard_params`` on a 1 x 1 mesh is the whole tree (copies), and
    the class slice of rank (d, m) is classes m O / mp .. (m + 1) O / mp."""
    m = tiny_case()
    tp = C.port_inputs(m, m["prev"], None, jax.random.key(0))[0]
    mesh = parallel.make_mesh(1, devices=["cpu"])
    sharded = parallel.shard_params(tp, mesh, O)
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(C.tree_leaves(sharded), C.tree_leaves(tp)))
    mesh = parallel.Mesh((2, 4), rank=6, device="cpu", groups={})
    assert mesh.coords == (1, 2) and mesh.class_slice(O) == slice(4, 6)
    assert mesh.row_slice(B) == slice(8, 16)
    assert mesh.local_cfg(TV.VARGPConfig(M=4, out_size=O, in_size=D)).out_size == 2

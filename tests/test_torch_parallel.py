"""The port's ("data", "model") mesh on the CPU: gloo ranks spawned by
``vargp_tpu_torch.parallel.spawn_ranks`` (a ``file://`` store under
tmp_path, each rank joined under its own timeout), held to the port's
single-device functions and to the JAX package, as tests/test_parallel.py
holds the JAX mesh.

Sizes as tests/test_parallel.py::tiny_problem: 8 classes, M = 4, D = 6,
B = 16, one previous task.  Each mesh shape (1 x 2, 2 x 1, 2 x 2) is one
spawn that runs every check (``tests/_torch_parallel_ranks.py``).

Tolerances.  Against the port's single-device step: the loss within
1e-5 relative, the parameters within 1e-4 relative and 1e-6 absolute
(the sharded sums add in another order, and the products run on other
batch shapes), Yogi's moments within 1e-4 of each leaf's largest
magnitude (a first moment is a tenth of the gradient, whose f32 noise
is ~2e-5 of its largest entry, see test_torch_grad.py; phi's last bias,
whose gradient is exactly 0, of phi's largest bias moment); under DKL
1e-5 and 2e-4 (``STEP_TOL``).  Against the JAX
package's single-device step and its 8-device mesh step, with the JAX
draws replayed: JAX's own limits, loss 1e-4, leaves 1e-3 / 1e-5.  The
evaluation's counts are equal, the probabilities within 1e-6, the
sharding round trip bitwise.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests import _torch_cases as C
from tests import _torch_parallel_ranks as R
from vargp_tpu import gpmath as jgm
from vargp_tpu import parallel as jpar
from vargp_tpu.models import vargp as JV
from vargp_tpu.train import loop as JL
from vargp_tpu_torch import parallel
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.parallel import distributed
from vargp_tpu_torch.parallel.mesh import PartitionSpec as P
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import tree_leaves
from vargp_tpu_torch.utils import convert

f32 = np.float32
LR, BETA, N_TRAIN = 1e-2, 1.0, 100
RANK_TIMEOUT = 120.0
MESHES = {"1x2": (2, 2), "2x1": (2, 1), "2x2": (4, 2)}  # n ranks, model_parallel


def tiny_case(seed=0, dkl=False, O=8, M=4, D=6, B=16, n_prev=1):
    """tests/test_parallel.py::tiny_problem in the form ``_torch_cases``
    takes; some rows weigh 0, so the batch's weight sum is not B.  Under
    DKL the last layer is scaled as ``_torch_cases.build_dkl`` scales it."""
    rng = np.random.default_rng(seed)
    prev = tuple(
        JV.TaskPosterior(
            z=jnp.asarray(rng.standard_normal((O, M, D)).astype(f32)),
            u_mean=jnp.asarray(rng.standard_normal((O, M, 1)).astype(f32) * 0.3),
            u_tril=jgm.vec2tril(jnp.asarray(
                rng.standard_normal((O, M * (M + 1) // 2)).astype(f32) * 0.2)),
        )
        for _ in range(n_prev)
    )
    cfg = JV.VARGPConfig(M=M, out_size=O, in_size=D, n_f=4, n_var_samples=2, dkl=dkl)
    z_init = jnp.asarray(rng.standard_normal((O, M, D)).astype(f32))
    params, prior = JV.init_params(jax.random.key(seed), z_init, cfg)
    if dkl:
        phi = params.phi
        params = params._replace(phi=phi._replace(
            weights=(*phi.weights[:-1], phi.weights[-1] * C.PHI_GAIN),
            biases=(*phi.biases[:-1], phi.biases[-1] * C.PHI_GAIN)))
    x = jnp.asarray(rng.standard_normal((B, D)).astype(f32))
    y = jnp.asarray(rng.integers(0, O, B))
    w = jnp.asarray((rng.random(B) > 0.2).astype(f32))
    tcfg = TV.VARGPConfig(M=M, out_size=O, in_size=D, n_f=4, n_var_samples=2, dkl=dkl)
    return dict(cfg=cfg, tcfg=tcfg, params=params, prior=prior, prev=prev, x=x, y=y, w=w,
                dims=dict(O=O, M=M, D=D, B=B, H=2, N_F=4, n_prev=n_prev))


def _step_case(m, key):
    tp, tprev, tprior, x, y, w, noise, _ = C.port_inputs(m, m["prev"], None, key)
    return dict(cfg=m["tcfg"], params=tp, prev=tprev, prior=tprior, x=x, y=y, w=w,
                noise=noise, lr=LR, beta=BETA, n_train=N_TRAIN)


def _port_step(c):
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=c["lr"]))
    p, s, loss, pieces = TL.elbo_step(
        c["params"], opt.init(c["params"]), c["prev"], c["prior"], c["x"], c["y"], c["w"],
        c["noise"], cfg=c["cfg"], opt=opt, beta=c["beta"], n_train=c["n_train"],
        chain_mask=c.get("mask"), device="cpu")
    return dict(loss=float(loss), pieces=[float(v) for v in pieces], params=p, opt=s)


def _jax_steps(m, key):
    """The JAX package's step on one device and on the 8-device (4 x 2)
    mesh: (loss, params) each."""
    tx = optax.yogi(LR)
    step = jax.jit(lambda p, s, k: JL.elbo_step(p, s, m["prev"], m["prior"], m["x"], m["y"],
                                                m["w"], k, cfg=m["cfg"], tx=tx, beta=BETA,
                                                n_train=N_TRAIN))
    p1, _, loss1, _ = step(m["params"], tx.init(m["params"]), key)
    mesh = jpar.make_mesh(8)
    O = m["cfg"].out_size
    p2 = jpar.shard_params(m["params"], mesh, O)
    prev = jpar.shard_params(m["prev"], mesh, O)
    xs, ys, ws = jpar.shard_batch(m["x"], m["y"], m["w"], mesh)
    update = jpar.make_sharded_update_fn(m["cfg"], tx, beta=BETA, n_train=N_TRAIN, mesh=mesh)
    p2, _, loss2, _ = update(p2, jpar.shard_params(tx.init(p2), mesh, O), prev, m["prior"], xs,
                             ys, ws, key)
    return {"JAX single device": (float(loss1), C.np_tree(p1)),
            "JAX 4 x 2 mesh": (float(loss2), jpar.unshard_to_host(p2, mesh))}


def _block_case(m, seed=7):
    """The padded chain (one real task in a 3-task chain) and a train block
    of 2 epochs over 2B rows."""
    jprev, jmask = JV.pad_chain(m["prev"], m["cfg"], 3)
    tp, tprev, tprior, x, y, w, _, mask = C.port_inputs(m, jprev, jmask, jax.random.key(0))
    data = TL.pad_dataset_to_device(np.concatenate([x.numpy(), 2.0 * x.numpy()]),
                                    np.concatenate([y.numpy(), y.numpy()]), x.shape[0],
                                    device="cpu")
    return dict(cfg=m["tcfg"], params=tp, prev=tprev, prior=tprior, mask=mask, lr=LR, beta=BETA,
                batch_size=x.shape[0], n_epochs=2, n_train=2 * x.shape[0], data=data, seed=seed)


def _port_block(b):
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=b["lr"]))
    return TL.train_block(b["params"], opt.init(b["params"]), b["prev"], b["prior"], b["mask"],
                          b["n_train"], *b["data"], torch.Generator().manual_seed(b["seed"]),
                          cfg=b["cfg"], opt=opt, beta=b["beta"], batch_size=b["batch_size"],
                          n_epochs=b["n_epochs"], device="cpu")


def _eval_case(b, seed=11):
    cfg = b["cfg"]
    x = b["data"][0][: b["batch_size"]]
    y = b["data"][1][: b["batch_size"]]
    xs, ys = torch.stack([x, 0.5 * x]), torch.stack([y, y])
    ws = torch.ones_like(xs[..., 0])
    ws[1, -3:] = 0.0
    hps = {"shared posterior": TL.TrainHyperparams(),
           "per batch": TL.TrainHyperparams(eval_resample_per_batch=True, eval_n_f=3)}
    draws = {}
    for name, hp in hps.items():
        cfg_eval = TV.eval_budget_cfg(cfg, n_f=hp.eval_n_f, n_var_samples=hp.eval_n_var_samples)
        draws[name] = TL.GeneratorDraws(torch.Generator().manual_seed(seed)).evaluation(
            cfg_eval, 2, x.shape[0], hp.eval_resample_per_batch)
    gen = torch.Generator().manual_seed(seed + 1)
    pnoise = {"hyper_eps": torch.randn(cfg.n_var_samples, TV._theta_size(cfg) + 1, generator=gen),
              "lik_eps": torch.randn(cfg.n_var_samples, cfg.n_f, cfg.out_size, x.shape[0],
                                     generator=gen)}
    return dict(cfg=cfg, params=b["params"], prev=b["prev"], mask=b["mask"], xs=xs, ys=ys, ws=ws,
                hps=hps, draws=draws, pnoise=pnoise)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The inputs (one file for every rank) and the single-device results."""
    m, m_dkl = tiny_case(), tiny_case(dkl=True)
    key = jax.random.key(42)
    plain, dkl = _step_case(m, key), _step_case(m_dkl, jax.random.key(43))
    block = _block_case(m)
    ev = _eval_case(block)
    path = tmp_path_factory.mktemp("parallel") / "case.pt"
    torch.save(dict(plain=plain, dkl=dkl, block=block, eval=ev), path)
    want = dict(plain=_port_step(plain), dkl=_port_step(dkl), block=_port_block(block),
                jax=_jax_steps(m, key))
    want["eval"] = {
        name: tuple(float(v) for v in TL.make_device_eval_fn(ev["cfg"], hp)(
            ev["params"], ev["prev"], ev["mask"], ev["xs"], ev["ys"], ev["ws"],
            ev["draws"][name], device="cpu"))
        for name, hp in ev["hps"].items()}
    with torch.no_grad():
        want["predict"] = TV.predict(ev["params"], ev["prev"], ev["xs"][0], ev["pnoise"],
                                     ev["cfg"], chain_mask=ev["mask"], device="cpu")
    return dict(path=str(path), want=want, eval=ev)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, cases, tmp_path_factory):
    n, mp = MESHES[request.param]
    out = parallel.spawn_ranks(R.mesh_checks, ["cpu"] * n, (cases["path"], mp),
                               timeout=RANK_TIMEOUT,
                               store_dir=tmp_path_factory.mktemp(request.param))
    return request.param, out


def _leaves_close(got, want, rtol, atol, what, of_largest=None):
    """Each leaf within rtol / atol, or within ``of_largest`` of the
    leaf's largest magnitude."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        b = np.asarray(b)
        if of_largest is not None:
            atol = of_largest * float(np.abs(b).max())
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol, err_msg=what)


# Under DKL the last bias of phi shifts every feature alike and the RBF
# kernel sees only feature differences: its gradient is exactly 0, and its
# moments hold rounding noise, held to phi's largest bias moment instead.
SHIFT_LEAF = ".phi.biases[2]"


# (parameters' absolute tolerance, moments' share of their leaf's largest
# magnitude) of a step against the single-device step; under DKL phi's
# gradients sum the f32 noise of kl_u's and the nll's large terms (phi's
# exactly-zero last-bias gradient reads 1.6e-5 on the 2 x 1 mesh, 8e-5 of
# phi's largest), which Yogi turns into ~5e-6 of a step of lr 1e-2
STEP_TOL = {"plain": (1e-6, 1e-4), "dkl": (1e-5, 2e-4)}


def _moments_close(got, want, params, what, of_largest):
    """Yogi's state: the count equal, each moment within ``of_largest`` of
    its leaf's largest magnitude."""
    from vargp_tpu_torch.utils.checkpoint import flatten_with_paths

    names = [n for n, _ in flatten_with_paths(params)]
    got, want = tree_leaves(got), [t.numpy() for t in tree_leaves(want)]
    assert len(got) == len(want) == 1 + 2 * len(names) and got[0] == want[0]
    for k, moment in enumerate(("mu", "nu")):
        part = slice(1 + k * len(names), 1 + (k + 1) * len(names))
        largest = {n: float(np.abs(w).max()) for n, w in zip(names, want[part])}
        largest[SHIFT_LEAF] = max((v for n, v in largest.items() if n.startswith(".phi.biases")),
                                  default=0.0)
        for n, a, b in zip(names, got[part], want[part]):
            np.testing.assert_allclose(a, b, rtol=0, atol=of_largest * largest[n],
                                       err_msg=f"{what} {moment}{n}")


def test_sharded_step_matches_the_single_device_port(mesh_run, cases):
    """Loss and pieces (the whole job's, equal on every rank), parameters
    and Yogi's moments after one step, plain and under the deep kernel."""
    name, ranks = mesh_run
    dp, mp = ranks[0]["shape"]
    assert dp * mp == len(ranks) and name == f"{dp}x{mp}"
    for kind in ("plain", "dkl"):
        want = cases["want"][kind]
        for r in ranks:
            got = r[kind]
            assert got["loss"] == ranks[0][kind]["loss"]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=kind)
            np.testing.assert_allclose(got["pieces"], want["pieces"], rtol=1e-5, err_msg=kind)
            atol, of_largest = STEP_TOL[kind]
            _leaves_close(got["params"], convert.params_to_numpy(want["params"]), 1e-4, atol,
                          f"{name} {kind} params")
            _moments_close(got["opt"], want["opt"], want["params"], f"{name} {kind}",
                           of_largest)


def test_sharded_step_matches_the_jax_package(mesh_run, cases):
    """The same step against the JAX ``elbo_step`` and JAX's
    ``make_sharded_update_fn`` on the 8-device mesh, the JAX draws
    replayed."""
    name, ranks = mesh_run
    for label, (loss, params) in cases["want"]["jax"].items():
        got = ranks[0]["plain"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, err_msg=label)
        _leaves_close(got["params"], params, 1e-3, 1e-5, f"{name} against {label}")


def test_sharded_block_matches_the_single_device_port(mesh_run, cases):
    """Six steps of the padded chain's train block, each rank its rows of
    each minibatch and every rank the whole permutation and noise."""
    name, ranks = mesh_run
    p, _, losses, pieces = cases["want"]["block"]
    for r in ranks:
        np.testing.assert_allclose(r["block"]["losses"].numpy(), losses.numpy(), rtol=1e-5)
        np.testing.assert_allclose(r["block"]["pieces"].numpy(), pieces.numpy(), rtol=1e-5)
        _leaves_close(r["block"]["params"], convert.params_to_numpy(p), 1e-4, 1e-6,
                      f"{name} block")


def test_sharded_evaluation_and_predict(mesh_run, cases):
    """The split's counts (one posterior per split, and per batch) equal;
    each rank's rows of ``predict`` within 1e-6 of the whole's."""
    name, ranks = mesh_run
    for r in ranks:
        assert r["eval"] == cases["want"]["eval"], name
    probs = cases["want"]["predict"]
    covered = torch.zeros(probs.shape[0], dtype=torch.bool)
    for r in ranks:
        rows, got = r["predict"]
        assert got.shape == (rows.stop - rows.start, probs.shape[1])
        np.testing.assert_allclose(got.numpy(), probs[rows].numpy(), rtol=0, atol=1e-6)
        covered[rows] = True
    assert bool(covered.all())


def test_unshard_to_host_is_the_single_device_tree(mesh_run, cases):
    name, ranks = mesh_run
    want = cases["eval"]["params"]
    for r in ranks:
        got = tree_leaves(r["round_trip"])
        assert len(got) == len(tree_leaves(want))
        for a, b in zip(got, tree_leaves(want)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_single_device_loss_and_step_are_unchanged(cases):
    """``V.loss`` and the single-device step are the code they were: the
    step's pieces are ``V.loss``'s bitwise, and a 1 x 1 mesh (no
    collective, every share the whole) gives the same step bitwise."""
    c = torch.load(cases["path"], weights_only=False)["plain"]
    pieces = TV.loss(c["params"], c["prev"], c["prior"], c["x"], c["y"], c["noise"], c["cfg"],
                     weights=c["w"], device="cpu")
    want = cases["want"]["plain"]
    assert [float(v) for v in pieces] == want["pieces"]
    mesh = parallel.make_mesh(1, devices=["cpu"])
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=LR))
    p, s, loss, aux = parallel.make_sharded_update_fn(c["cfg"], opt, BETA, N_TRAIN, mesh)(
        c["params"], opt.init(c["params"]), c["prev"], c["prior"], c["x"], c["y"], c["w"],
        c["noise"])
    assert float(loss) == want["loss"] and not mesh.log
    for a, b in zip(tree_leaves(p), tree_leaves(want["params"])):
        assert torch.equal(a, b)


def test_mesh_rules_and_param_shardings():
    """``infer_param_shardings`` on a parameter tree and its optimizer
    state; the rules a single process can check."""
    m = tiny_case()
    tp, tprev, *_ = C.port_inputs(m, m["prev"], None, jax.random.key(0))
    mesh = parallel.make_mesh(1, devices=["cpu"])
    sh = parallel.infer_param_shardings(tp, mesh, 8)
    assert sh.z == P("model", None, None) and sh.u_tril_vec == P("model", None)
    assert sh.u_mean == P("model", None, None) and sh.kernel.log_mean == P()
    state = TL.make_optimizer(TL.TrainHyperparams()).init(tp)
    ssh = parallel.infer_param_shardings(state, mesh, 8)
    assert ssh.count == P() and ssh.mu.z == P("model", None, None)
    assert ssh.nu.kernel.log_logvar == P()
    assert parallel.infer_param_shardings(tprev, mesh, 8)[0].u_tril == P("model", None, None)
    dkl = tiny_case(dkl=True)
    tdkl = C.port_inputs(dkl, dkl["prev"], None, jax.random.key(0))[0]
    phi = tree_leaves(parallel.infer_param_shardings(tdkl, mesh, 8).phi)
    assert len(phi) == 6 and all(s == P() for s in phi)
    # a leaf whose first axis is not the class count stays whole
    assert parallel.infer_param_shardings(tp, mesh, 4).z == P()
    assert parallel.batch_shardings(mesh) == (P("data", None), P("data"), P("data"))
    with pytest.raises(ValueError, match="only 1 rank"):
        parallel.make_mesh(1024)
    with pytest.raises(ValueError, match="only 1 rank"):
        parallel.make_mesh(7, model_parallel=2)


def test_mesh_rules_in_a_job_and_initialize(tmp_path):
    """In a job of two CPU ranks: the mesh's ValueErrors, the default
    mesh (1 x 2, gloo), and ``initialize``'s second call a no-op; outside
    a job, ``initialize()`` leaves the process single-rank and a malformed
    explicit request raises at once."""
    (out, _) = parallel.spawn_ranks(R.job_checks, ["cpu", "cpu"], timeout=RANK_TIMEOUT,
                                    store_dir=tmp_path)
    assert set(out["errors"]) == {"more than the world", "fewer than the world", "not divisible",
                                  "too few devices", "odd classes", "odd rows"}
    assert "only 2 rank" in out["errors"]["more than the world"]
    assert "only 1 device" in out["errors"]["too few devices"]
    assert out["shape"] == (1, 2) and out["default"] == (1, 2)
    assert out["world"] == 2 and out["backend"] == "gloo"

    distributed.initialize()
    assert not torch.distributed.is_initialized()
    for bad in (dict(coordinator_address="localhost", num_processes=2, process_id=0),
                dict(coordinator_address="localhost:29500", num_processes=2, process_id=2),
                dict(num_processes=2, process_id=0)):
        with pytest.raises(ValueError):
            distributed.initialize(**bad, device="cpu")
    assert not torch.distributed.is_initialized()
    assert distributed.backend_for(["cpu", "cpu"]) == "gloo"
    assert distributed.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert distributed.backend_for(["cuda:0", "cuda:1"]) == "nccl"


def test_a_failed_rank_fails_the_job(tmp_path):
    """A rank that raises stops the job: ``spawn_ranks`` raises with its
    traceback instead of waiting on the others."""
    with pytest.raises(RuntimeError, match="failed"):
        parallel.spawn_ranks(R.fail_on_rank_one, ["cpu", "cpu"], timeout=RANK_TIMEOUT,
                             store_dir=tmp_path)


def test_driver_on_two_ranks_matches_one_device(tmp_path):
    """``toy`` at ``n_devices=2, device="cpu"`` (a 1 x 2 mesh of spawned
    ranks) within 0.02 of the single-device run on every task's
    accuracies, as tests/test_parallel.py holds the JAX mesh; rank 0
    writes the checkpoints once, and they load into the single-device
    template."""
    from vargp_tpu_torch.experiments import analysis as TA
    from vargp_tpu_torch.experiments import vargp_run
    from vargp_tpu_torch.utils.checkpoint import load_chain

    kw = dict(epochs=4, M=6, batch_size=128, eval_interval=2, seed=0, n_tasks=2, device="cpu")
    _, single = vargp_run.toy(log_dir=str(tmp_path / "single"), **kw)
    chain, sharded = vargp_run.toy(log_dir=str(tmp_path / "mesh"), n_devices=2, **kw)
    assert len(single) == len(sharded) == 2
    for t, (a, b) in enumerate(zip(single, sharded)):
        assert a and set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) < 0.02, (t, k, a[k], b[k])
    cfg = TV.VARGPConfig(M=6, out_size=4, in_size=2)
    loaded = load_chain(str(tmp_path / "mesh"), 2, TA.params_template(cfg))
    for p, q in zip(chain, loaded):
        for a, b in zip(tree_leaves(p), tree_leaves(q)):
            np.testing.assert_array_equal(a.numpy(), b)
    with open(tmp_path / "mesh" / "metrics.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("task1/val/acc_best") == 1  # one writer


def test_driver_refuses_more_ranks_than_cards():
    """Asking the card for more ranks than it has raises before any rank
    starts (here: no card at all)."""
    from vargp_tpu_torch.experiments import vargp_run

    if torch.cuda.is_available():
        n = torch.cuda.device_count() + 1
        with pytest.raises(ValueError, match="visible"):
            vargp_run.toy(n_devices=n, epochs=1)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vargp_run.toy(n_devices=2, epochs=1)



def test_cli_multi_process_job(tmp_path):
    """Two processes of one job through the command line, as
    tests/test_parallel.py runs the JAX CLI's: ``--coordinator_address``
    (a free localhost port), ``--num_processes``, ``--process_id`` and
    ``--n_devices=2`` over the job's ranks; both finish, process 0 alone
    writes the checkpoints and the metrics."""
    import os
    import random
    import socket
    import subprocess
    import sys

    # a free port below the kernel's ephemeral range, which the gloo
    # connections of other tests' ranks draw from
    rng = random.Random(os.getpid())
    for _ in range(100):
        port = rng.randrange(20000, 32000)
        with socket.socket() as sock:
            try:
                sock.bind(("localhost", port))
                break
            except OSError:
                continue
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    logs = [tmp_path / "lead", tmp_path / "other"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vargp_tpu_torch", "toy", "--device=cpu",
         f"--coordinator_address=localhost:{port}", "--num_processes=2", f"--process_id={i}",
         "--n_devices=2", "--epochs=2", "--M=4", "--batch_size=64", "--eval_interval=1",
         "--seed=0", f"--log_dir={logs[i]}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=tmp_path, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "\n---\n".join(o[-3000:] for o in outs)
    assert "[toy] task 1:" in outs[0] and "[toy] task" not in outs[1]
    for t in range(2):
        assert (logs[0] / f"ckpt{t}.npz").exists()
    assert (logs[0] / "metrics.jsonl").exists() and not logs[1].exists()


def test_run_meta_names_the_mesh(tmp_path):
    """A driver's ``run_meta.json`` gains ``mesh`` under a mesh."""
    from vargp_tpu_torch.experiments import vargp_run

    cfg = TV.VARGPConfig(M=4, out_size=4, in_size=2)
    vargp_run._run_task_stream("x", iter(()), cfg, TL.TrainHyperparams(), 0, str(tmp_path),
                               meta={"data_source": "none"},
                               mesh=parallel.make_mesh(1, devices=["cpu"]))
    with open(tmp_path / "run_meta.json") as f:
        assert json.load(f) == {"data_source": "none", "mesh": "1 data x 1 model"}

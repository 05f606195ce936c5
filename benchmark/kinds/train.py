"""The ``train`` kind of work: ``vargp_tpu_torch.train.loop.train_block``
over the task's training set, padded on the device, in blocks of whole
epochs of at most ``max_steps_per_dispatch`` steps, as ``train_task``
dispatches them; the host reads each block's losses.  Each step's row
indices and noise are drawn block by block inside the window and handed
in through ``draws=``.  One closed loop: one training job.

Set-up builds the training object and drives it through its first
``first_steps`` steps (one step, then the rest, each through
``train_block``), which the reference follows; the window goes on from
there.  The mix's keys: ``first_steps``, ``trace_blocks``.
"""

import itertools
import time

import torch

from benchmark import check, costs, inputs, port
from benchmark.reference import vargp as R


class Mix:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.hp = cfg["train"]

    def unit_flops(self) -> int:
        """The model FLOPs of one ELBO step."""
        return costs.train_step_flops(self.cfg, self.hp["batch_size"])

    def setup(self):
        V, TL, kernels = port.port_modules()
        cfg, dev, B = self.cfg, self.dev, self.hp["batch_size"]
        self.gen = gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.data = x, y, w = inputs.train_set(gen, cfg)
        self.n_pad = x.shape[0]
        self.problem = inputs.make_problem(gen, cfg, x[:cfg["train_rows"]])
        self.raw = (port.clone(self.problem.current), [port.clone(t) for t in self.problem.chain],
                    port.clone(self.problem.prior))
        self.pcfg, self.thp = port.model_config(cfg), port.train_config(cfg)
        params, prev = port.port_params(self.problem)
        mask = torch.ones((len(prev),), device=dev)  # the whole chain: no padded task
        prior = kernels.RBFPrior(self.problem.prior["log_mean"], self.problem.prior["log_logvar"])
        self.opt = TL.make_optimizer(self.thp)
        self.epochs_per_block = max(1, self.thp.max_steps_per_dispatch // (self.n_pad // B))
        self.fixed = dict(prev=prev, prior=prior, chain_mask=mask,
                          n_train=torch.tensor(float(cfg["train_rows"]), device=dev),
                          data_x=x, data_y=y, data_w=w, gen=None)
        # the first steps: rows that all differ, from one epoch's permutation
        first = list(itertools.islice(inputs.block_draws(gen, cfg, self.n_pad, B, 1),
                                      self.mix["first_steps"]))
        self.first = [(idx, {k: v.clone() for k, v in noise.items()}) for idx, noise in first]
        s0 = self.opt.init(params)
        p1, s1, l1, _ = self.block(params, s0, self.first[:1])
        p, s, l2, _ = self.block(p1, s1, self.first[1:])
        losses = torch.cat([l1, l2]).cpu()
        mu1 = port.leaves(s1.mu)
        self.prog = {
            "losses": [float(v) for v in losses],
            "grad_norms": {k: R.norm(check.first_grad_from_moment(m)) for k, m in mu1.items()},
            "change_norms": {k: R.norm(port.leaves(p)[k] - self.raw[0][k]) for k in mu1},
        }
        self.params, self.state = p, s

    def block(self, params, state, draws):
        _, TL, _ = port.port_modules()
        return TL.train_block(params, state, **self.fixed, cfg=self.pcfg, opt=self.opt,
                              beta=self.thp.beta, batch_size=self.thp.batch_size,
                              n_epochs=self.epochs_per_block, device=self.dev, draws=draws)

    def _run_block(self):
        draws = inputs.block_draws(self.gen, self.cfg, self.n_pad, self.hp["batch_size"],
                                   self.epochs_per_block)
        self.params, self.state, losses, _ = self.block(self.params, self.state, draws)
        host = losses.cpu()
        return len(host), int((~torch.isfinite(host)).sum())

    def window(self, seconds: float) -> dict:
        steps = failed = 0
        t0 = t = time.perf_counter()
        blocks = []
        while True:
            n, bad = self._run_block()
            steps, failed = steps + n, failed + bad
            t, last = time.perf_counter(), t
            blocks.append(round(t - last, 4))
            if t - t0 >= seconds:
                break
        self.rate = steps / (t - t0)
        return {"attempted": steps, "failed": failed,
                "metrics": {"train_steps_per_s": steps / (t - t0)},
                "detail": f"{steps} steps in {len(blocks)} blocks, seconds a block {blocks}"}

    def traced(self) -> int:
        """Run the traced slice; returns the steps it took."""
        return sum(self._run_block()[0] for _ in range(self.mix["trace_blocks"]))

    def release(self):
        for name in ("params", "state", "fixed", "problem", "opt"):
            setattr(self, name, None)

    def program_outputs(self) -> dict:
        return self.prog

    def reference(self, arith: R.Arith = R.F64) -> dict:
        """The reference's losses, first gradients' norms and changes' norms
        over the first steps, from the inputs the benchmark made."""
        current, chain, prior = self.raw
        x, y, w = self.data
        steps = [{"batch": {"x": x[idx], "y": y[idx], "w": w[idx]}, "noise": noise}
                 for idx, noise in self.first]
        hp = {"beta": self.hp["beta"], "lr": self.hp["lr"],
              "jitter": self.cfg["model"]["jitter"],
              "ep_var_mean": self.cfg["model"]["ep_var_mean"],
              "n_train": float(self.cfg["train_rows"])}
        losses, grads, params = R.train_steps(arith, current, port.reference_chain(chain, arith),
                                              prior, steps, hp)
        return {"losses": losses, "grad_norms": {k: R.norm(g) for k, g in grads.items()},
                "change_norms": {k: R.norm(params[k] - current[k].to(arith.dtype))
                                 for k in R.PARAM_KEYS}}

    @staticmethod
    def numbers(out: dict, ref: dict) -> dict:
        return check.train_numbers(out, ref)


def unchanged_state():
    """Every ELBO step returns the parameters and the optimizer state it
    was given."""
    _, TL, _ = port.port_modules()

    def make(step):
        def faulty(params, opt_state, *args, **kwargs):
            _, _, loss, aux = step(params, opt_state, *args, **kwargs)
            return params, opt_state, loss, aux
        return faulty

    return port.wrapped(TL, "elbo_step", make)


def half_batch():
    """Every ELBO step leaves out the second half of its batch (weight 0),
    so its nll is the mean over the rest."""
    _, TL, _ = port.port_modules()

    def make(step):
        def faulty(params, opt_state, prev, prior, x, y, w, *args, **kwargs):
            w = w.clone()
            w[w.shape[0] // 2:] = 0.0
            return step(params, opt_state, prev, prior, x, y, w, *args, **kwargs)
        return faulty

    return port.wrapped(TL, "elbo_step", make)


# the faults of the timed path this kind can have (``readings.py`` on the
# card, the tests on the CPU); one chip has no exchange to leave out
FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}

"""The ``predict_dkl`` kind of work: the ``predict`` kind (``predict.py``)
on the VAR-GP chain under the deep kernel (the configuration's ``model``
sets ``dkl``).  The traffic is the same: fixed-shape batches of the test
splits in turn, one noise draw a pass, rows copied from the host with each
call, one client in a closed loop, a window of whole passes.  What
differs: the parameters carry the feature map phi (``inputs_dkl.py``), the
hyper noise has P + 1 entries, the reference applies phi
(``reference/vargp_dkl.py``), and the model FLOPs count phi and the Grams
on P features (``costs_dkl.py``).

The mix's keys are ``predict``'s.
"""

import os

import torch

from benchmark import cell as C
from benchmark import costs_dkl, inputs, inputs_dkl, port
from benchmark.reference import vargp as R
from benchmark.reference import vargp_dkl as RD

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_predict = C.kind(ROOT, "predict")


class Mix(_predict.Mix):
    def unit_flops(self) -> float:
        """The model FLOPs of one call, with the chain posterior (phi over
        the chain among it) once a pass."""
        B = self.mix["batch_size"]
        per_pass = [-(-n // B) for n in self.cfg["test_splits"]["rows"]]
        return costs_dkl.predict_call_flops(self.cfg, self.mix["n_var_samples"], B,
                                            len(per_pass) / sum(per_pass))

    def setup(self):
        V, _, kernels = port.port_modules()
        cfg, mix, dev = self.cfg, self.mix, self.dev
        self.gen = gen = torch.Generator(device=dev).manual_seed(self.seed)
        _, self.splits = self._splits(gen)
        self.problem, phi = inputs_dkl.make_problem(gen, cfg)
        self.raw = (port.clone(self.problem.current), [port.clone(t) for t in self.problem.chain],
                    [t.detach().clone() for t in phi])
        self.pcfg = port.model_config(cfg)
        params, prev = port.port_params(self.problem)
        self.params = params._replace(phi=kernels.MLPParams(weights=tuple(phi[0::2]),
                                                            biases=tuple(phi[1::2])))
        self.prev, self.mask = V.pad_chain(prev, self.pcfg, cfg["task"] + 1, device=dev)
        self.cfg_eval = V.eval_budget_cfg(self.pcfg, n_f=mix["n_f"],
                                          n_var_samples=mix["n_var_samples"])
        self.calls = []  # (pass, split, batch, seconds, host probabilities)
        self.passes = 0
        noise = self._noise(-1)
        for _ in range(mix["warmup_calls"]):
            self._call(noise, self.splits[0][0][0])

    def _noise(self, k: int) -> dict:
        self.gen.manual_seed(inputs.pass_seed(self.seed, k))
        return inputs_dkl.predict_noise(self.gen, self.cfg, self.mix["n_var_samples"],
                                        self.mix["n_f"], self.mix["batch_size"])

    def reference(self, arith: R.Arith = R.F64) -> dict:
        """The reference's probabilities for each sampled call."""
        current, chain, phi = self.raw
        chain = port.reference_chain(chain, arith)
        out = {}
        for i in self.sample():
            k, s, b, _, _ = self.calls[i]
            noise = self._noise(k)
            x = torch.from_numpy(self.splits[s][0][b]).to(self.dev)
            p = RD.predict(arith, current, chain, phi, x, noise, self.cfg["model"]["jitter"],
                           self.mix["reference_hyper_block"])
            out[i] = p.double().cpu().numpy()
        return out


# a call that returns its first row's probabilities reversed, as in
# ``predict``; one chip has no exchange to leave out
FAULTS = {"altered_answer": _predict.altered_answer}

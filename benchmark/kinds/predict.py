"""The ``predict`` kind of work: ``vargp_tpu_torch.models.vargp.predict``
at the evaluation's budgets on fixed-shape batches of the test splits the
analysis evaluates, taken in turn; a split's last batch is padded with
zero rows, and only real rows count.  Each pass over a split draws one set
of noise for all its batches.  Rows are held on the host and copied to
the card with each call; one client calls one batch at a time, and a call
is timed until its probabilities are on the host.  The window ends with
the pass in which its seconds run out, so the share of calls that draw
new noise, and build the chain posterior anew, is the traffic's and not
the clock's.

The mix's keys: ``batch_size``, ``n_var_samples``, ``n_f``,
``warmup_calls``, ``trace_calls``, ``sample_calls``,
``reference_hyper_block``.
"""

import time

import numpy as np
import torch

from benchmark import costs, inputs, port
from benchmark.reference import vargp as R


class Mix:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device

    def unit_flops(self) -> float:
        """The model FLOPs of one ``predict`` call, with the chain posterior
        once a pass: a pass's calls share its noise, and with it the
        hyper draw the posterior depends on."""
        B = self.mix["batch_size"]
        per_pass = [-(-n // B) for n in self.cfg["test_splits"]["rows"]]
        return costs.predict_call_flops(self.cfg, self.mix["n_var_samples"], B,
                                        len(per_pass) / sum(per_pass))

    def _splits(self, gen):
        """The test splits on the host, each (batches, B, D) with its real
        row count: disjoint row sets, or one set under each task's pixel
        permutation (the first the identity)."""
        B, D = self.mix["batch_size"], self.cfg["model"]["in_size"]
        spec = self.cfg["test_splits"]
        if spec["permuted"]:
            base = inputs.rows(gen, spec["rows"][0], D)
            perms = [torch.arange(D, device=self.dev)] + [
                torch.randperm(D, generator=gen, device=self.dev) for _ in spec["rows"][1:]]
            parts = [base[:, p] for p in perms]
        else:
            base = inputs.rows(gen, sum(spec["rows"]), D)
            parts = list(torch.split(base, spec["rows"]))
        splits = []
        for part in parts:
            n = part.shape[0]
            padded = torch.zeros((-(-n // B) * B, D), device=self.dev)
            padded[:n] = part
            splits.append((padded.reshape(-1, B, D).cpu().numpy(), n))
        return base, splits

    def setup(self):
        V, _, _ = port.port_modules()
        cfg, mix, dev = self.cfg, self.mix, self.dev
        self.gen = gen = torch.Generator(device=dev).manual_seed(self.seed)
        base, self.splits = self._splits(gen)
        self.problem = inputs.make_problem(gen, cfg, base)
        self.raw = (port.clone(self.problem.current), [port.clone(t) for t in self.problem.chain])
        self.pcfg = port.model_config(cfg)
        self.params, prev = port.port_params(self.problem)
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
        return inputs.predict_noise(self.gen, self.cfg, self.mix["n_var_samples"],
                                    self.mix["n_f"], self.mix["batch_size"])

    def _call(self, noise, xb):
        V, _, _ = port.port_modules()
        with torch.no_grad():
            x = torch.from_numpy(xb).to(self.dev)
            probs = V.predict(self.params, self.prev, x, noise, self.cfg_eval,
                              chain_mask=self.mask, device=self.dev)
            return probs.cpu().numpy()

    def _calls(self, stop):
        """Call batch after batch, split after split, until ``stop(calls
        made, seconds since the first call, whether the call ended a
        pass)``; returns the real rows and the seconds from the first
        call's start to the last's end."""
        rows, t0 = 0, time.perf_counter()
        n0 = len(self.calls)
        while True:
            k = self.passes
            s = k % len(self.splits)
            batches, n = self.splits[s]
            noise = self._noise(k)
            self.passes += 1
            for b, xb in enumerate(batches):
                tc = time.perf_counter()
                out = self._call(noise, xb)
                te = time.perf_counter()
                self.calls.append((k, s, b, te - tc, out))
                rows += min(n - b * len(xb), len(xb))
                if stop(len(self.calls) - n0, te - t0, b == len(batches) - 1):
                    return rows, te - t0

    def window(self, seconds: float) -> dict:
        rows, took = self._calls(lambda n, t, end: end and t >= seconds)
        self.n_window = len(self.calls)
        lat = np.array([c[3] for c in self.calls]) * 1e3
        failed = sum(not np.all(np.isfinite(c[4])) for c in self.calls)
        self.rate = len(self.calls) / took
        q = np.percentile(lat, [0, 5, 25, 50, 75, 95, 99, 100]).round(3).tolist()
        first = np.array([c[2] == 0 for c in self.calls])
        apart = "; ".join(f"{name}: {len(x)}, median {np.median(x):.3f} ms, max {x.max():.3f} ms"
                          for name, x in (("first calls of a pass", lat[first]),
                                          ("the others", lat[~first])) if len(x))
        return {"attempted": len(self.calls), "failed": int(failed),
                "metrics": {"predict_rows_per_s": rows / took,
                            "predict_ms_p95": float(np.percentile(lat, 95)),
                            "predict_ms_p99": float(np.percentile(lat, 99))},
                "detail": f"{len(self.calls)} calls, {rows} rows, {self.passes} passes in "
                          f"{took:.3f} s; ms a call at 0 5 25 50 75 95 99 100 %: {q}; {apart}"}

    def traced(self) -> int:
        self._calls(lambda n, t, end: n >= self.mix["trace_calls"])
        return self.mix["trace_calls"]

    def release(self):
        for name in ("params", "prev", "mask", "problem"):
            setattr(self, name, None)

    def sample(self) -> list:
        """The window's calls that are compared, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        n = min(self.mix["sample_calls"], self.n_window)
        return sorted(rng.choice(self.n_window, size=n, replace=False).tolist())

    def program_outputs(self) -> dict:
        return {i: self.calls[i][4] for i in self.sample()}

    def reference(self, arith: R.Arith = R.F64) -> dict:
        """The reference's probabilities for each sampled call."""
        current, chain = self.raw
        chain = port.reference_chain(chain, arith)
        out = {}
        for i in self.sample():
            k, s, b, _, _ = self.calls[i]
            noise = self._noise(k)
            x = torch.from_numpy(self.splits[s][0][b]).to(self.dev)
            p = R.predict(arith, current, chain, x, noise, self.cfg["model"]["jitter"],
                          self.mix["reference_hyper_block"])
            out[i] = p.double().cpu().numpy()
        return out

    @staticmethod
    def numbers(out: dict, ref: dict) -> dict:
        return {"probs": max(float(np.max(np.abs(out[i] - p))) for i, p in ref.items())}


def altered_answer():
    """Every ``predict`` call returns its first row's class probabilities
    in reverse order."""
    V, _, _ = port.port_modules()

    def make(predict):
        def faulty(*args, **kwargs):
            probs = predict(*args, **kwargs).clone()
            probs[0] = probs[0].flip(-1)
            return probs
        return faulty

    return port.wrapped(V, "predict", make)


# the faults of the timed path this kind can have; one chip has no
# exchange to leave out, and prediction keeps no state
FAULTS = {"altered_answer": altered_answer}

"""The comparisons that decide ``correct``, and the numbers they print.

Training (the first steps of the object the window trains, against the
reference following them from the same inputs):

- ``loss``: the widest relative gap of a step's loss;
- ``grad``: the widest gap, over the parameter leaves, between the norm of
  the program's first gradient (worked out from Yogi's first moment after
  one step: g = (m - b1 m0) / (1 - b1)) and the reference's, against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
- ``change``: the same of the parameters' change over the first steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (Yogi moves those by rounding alone).

Prediction: ``probs``, the widest absolute gap of a class probability over
a sample of the window's calls.

Each number has a limit of its own, in ``limits/<cell>.json``.
"""

import statistics

from benchmark.reference import vargp as R


def _gaps(prog: dict, ref: dict, keys) -> float:
    floor = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-300) for k in keys)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (a list), ``grad_norms`` and
    ``change_norms`` (leaf name -> norm)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True))
    grad_floor = statistics.median(ref["grad_norms"].values())
    moved = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * grad_floor]
    return {
        "loss": loss,
        "grad": _gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"]),
        "change": _gaps(prog["change_norms"], ref["change_norms"], moved),
    }


def first_grad_from_moment(mu):
    """The gradient Yogi saw at its first step, from its first moment."""
    return (mu - R.B1 * R.YOGI_INIT) / (1.0 - R.B1)


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is finite and within its limit."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} against limits {sorted(limits)}")
    return all(v == v and v <= limits[k] for k, v in numbers.items())


def lines(numbers: dict, limits: dict) -> list:
    """One line per number compared: its name, value and limit."""
    return [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in sorted(numbers)]

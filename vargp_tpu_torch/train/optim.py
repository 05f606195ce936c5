"""Yogi and Adam, written out to match ``optax.yogi(lr)`` and
``optax.adam(lr)`` (optax 0.2.6) step for step.

torch has no Yogi, and ``torch.optim.Adam`` places eps differently from
optax, so both are here by hand, as functions of a parameter tree
(NamedTuples and tuples of tensors, nested; None for an absent subtree)
and a state ``OptState(count, mu, nu)`` with mu and nu of the
parameters' structure, as optax's ``ScaleByAdamState``.  One update of leaf p with gradient g, count
c = state.count + 1:

  Yogi  mu = (1 - b1) g + b1 mu
        nu = nu - (1 - b2) sign(nu - g^2) g^2       (sign(0) = 0)
  Adam  mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu
  both  p += -lr (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps)

Yogi starts both moments at 1e-6 and has eps = 1e-3; Adam starts them at
0 and has eps = 1e-8; b1 = 0.9, b2 = 0.999, eps_root = 0 for both.  The
update is functional: new tensors, the inputs are left as they were.
"""

from typing import Any, NamedTuple

import torch


class OptState(NamedTuple):
    count: torch.Tensor  # int32 scalar, steps taken
    mu: Any  # first moments, the parameters' structure
    nu: Any  # second moments


def tree_leaves(tree) -> list:
    """The leaves of a tree of NamedTuples, tuples and lists, in field order
    (the JAX package's flattening order); None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in field order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            subs = [build(s) for s in t]
            return type(t)(*subs) if hasattr(t, "_fields") else tuple(subs)
        return next(it)

    return build(like)


class _Moments:
    b1, b2, eps, init_value = 0.9, 0.999, 0.0, 0.0

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        mu = tree_unflatten(params, [torch.full_like(p, self.init_value) for p in leaves])
        nu = tree_unflatten(params, [torch.full_like(p, self.init_value) for p in leaves])
        return OptState(count, mu, nu)

    def _second(self, g, v):
        raise NotImplementedError

    def update(self, grads, state: OptState, params):
        """(new params, new state) after one step with ``grads`` (a tree of
        the parameters' structure, or a list of its leaves)."""
        count = state.count + 1
        c = count.to(torch.float32)
        # 1 - b^c in f32 on the device, as optax computes its bias
        # corrections; no host value is copied in, so nothing waits
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        new_p, new_mu, new_nu = [], [], []
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            m = (1.0 - self.b1) * g + self.b1 * m
            v = self._second(g, v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            new_p.append(p + u * (-self.lr))
            new_mu.append(m)
            new_nu.append(v)
        return tree_unflatten(params, new_p), OptState(
            count, tree_unflatten(params, new_mu), tree_unflatten(params, new_nu)
        )


class Yogi(_Moments):
    """``optax.yogi(lr)``: scale_by_yogi() then -lr."""

    eps, init_value = 1e-3, 1e-6

    def _second(self, g, v):
        g2 = g * g
        return v - (1.0 - self.b2) * torch.sign(v - g2) * g2


class Adam(_Moments):
    """``optax.adam(lr)``: scale_by_adam() then -lr."""

    eps, init_value = 1e-8, 0.0

    def _second(self, g, v):
        return (1.0 - self.b2) * (g * g) + self.b2 * v

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

``PhiGroup`` is the chain ``make_optimizer`` builds in the JAX package
when a knob of the deep kernel's feature map (phi) is set
(``vargp_tpu/train/loop.py:58-151``), in optax's order: the
preconditioner, decoupled weight decay on the phi leaves, -lr, phi_lr / lr
on the phi leaves, and a phi update scale held in the state
(``set_phi_update_scale``: 0 freezes phi with no change to the update's
structure).
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

    def direction(self, grads, state: OptState):
        """(the preconditioned updates as a list of leaves, new state):
        ``scale_by_yogi`` / ``scale_by_adam`` of optax, before the learning
        rate."""
        count = state.count + 1
        g_leaves = tree_leaves(grads)
        c = count.to(g_leaves[0].dtype)
        # 1 - b^c on the device in the parameters' float type (f32 in
        # training), as optax computes its bias corrections in JAX's default
        # float type; no host value is copied in, so nothing waits
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        upd, new_mu, new_nu = [], [], []
        for g, m, v in zip(g_leaves, tree_leaves(state.mu), tree_leaves(state.nu)):
            m = (1.0 - self.b1) * g + self.b1 * m
            v = self._second(g, v)
            upd.append((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            new_mu.append(m)
            new_nu.append(v)
        return upd, OptState(count, tree_unflatten(state.mu, new_mu),
                             tree_unflatten(state.nu, new_nu))

    def update(self, grads, state: OptState, params):
        """(new params, new state) after one step with ``grads`` (a tree of
        the parameters' structure, or a list of its leaves)."""
        upd, state = self.direction(grads, state)
        new_p = [p + u * (-self.lr) for p, u in zip(tree_leaves(params), upd)]
        return tree_unflatten(params, new_p), state


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


class GroupState(NamedTuple):
    moments: OptState  # the preconditioner's state
    phi_scale: torch.Tensor  # f32 scalar multiplying phi's updates (1 trains, 0 freezes)


def _n_phi(params) -> int:
    """How many of the parameters' trailing leaves are phi's."""
    return len(tree_leaves(getattr(params, "phi", None)))


class PhiGroup:
    """The phi-grouped chain around ``inner`` (a ``Yogi`` or ``Adam``):
    preconditioner, + phi_weight_decay * p on phi, * -lr, * phi_lr / lr on
    phi (when phi_lr is set and differs from lr), * the state's phi scale
    on phi (when ``freeze``)."""

    def __init__(self, inner: _Moments, phi_lr: float | None = None,
                 phi_weight_decay: float = 0.0, freeze: bool = False):
        self.inner, self.lr = inner, inner.lr
        self.weight_decay = phi_weight_decay
        self.ratio = None if phi_lr is None or phi_lr == inner.lr else phi_lr / inner.lr
        self.freeze = freeze

    def init(self, params) -> GroupState:
        state = self.inner.init(params)
        return GroupState(state, torch.ones((), device=state.count.device))

    def update(self, grads, state: GroupState, params):
        upd, moments = self.inner.direction(grads, state.moments)
        leaves = tree_leaves(params)
        first_phi = len(leaves) - _n_phi(params)
        new_p = []
        for i, (p, u) in enumerate(zip(leaves, upd)):
            phi = i >= first_phi
            if phi and self.weight_decay:
                u = u + self.weight_decay * p
            u = (-self.lr) * u
            if phi and self.ratio is not None:
                u = self.ratio * u
            if phi and self.freeze:
                u = u * state.phi_scale
            new_p.append(p + u)
        return tree_unflatten(params, new_p), GroupState(moments, state.phi_scale)


def set_phi_update_scale(state, value: float):
    """``state`` with its phi update scale set to ``value``; a state
    without one (no phi knob) is returned as it is, as in the JAX package."""
    if isinstance(state, GroupState):
        return state._replace(phi_scale=torch.full_like(state.phi_scale, value))
    return state

"""Gradients of the port's ``loss`` against ``jax.vjp`` of the JAX
package's, on the CPU, every parameter leaf, each ELBO piece on its own.

Cases: the 3-task chain (S = 192, blocked 2 x 96, dense Cholesky
backward), its padded form (S = 256), task 0 (S = 64, one K3 block), and
a 4-task chain of M = 128 (S = 512: K2's route and the triangle-skip
Cholesky backward at h = 256 on both sides).  Both sides get the same
parameters and the JAX package's own noise.

Tolerance: both sides run f32 on the CPU and differ by summation order,
the factorisation's column order and the backward's block order; each
leaf's gradient is held to 2e-5 of that leaf's largest magnitude (the
largest error seen is 8.4e-6 of it, on the padded chain).  The ELBO
pieces themselves agree to 1e-5 relative.
"""

import numpy as np
import jax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu.models import vargp as JV
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten

TOL = 2e-5
PIECES = ("kl_hypers", "kl_u", "nll")


def _jax_grads(m, prev, mask, key):
    def pieces(p):
        return JV.loss(p, prev, m["prior"], m["x"], m["y"], key, m["cfg"],
                       weights=m["w"], chain_mask=mask)

    @jax.jit
    def run(params):
        out, vjp = jax.vjp(pieces, params)
        one_hot = [tuple(jax.numpy.float32(i == j) for j in range(3)) for i in range(3)]
        return out, [vjp(c)[0] for c in one_hot]

    out, grads = run(m["params"])
    return [float(v) for v in out], [[np.asarray(g) for g in jax.tree_util.tree_leaves(gs)]
                                     for gs in grads]


@pytest.mark.parametrize("size,case", [
    ("small", "chain"), ("small", "padded"), ("small", "task0"), ("long", "chain"),
])
def test_loss_gradients_match_jax(size, case):
    m = C.build(size)
    prev, mask = C.chain(m, case)
    key = jax.random.key(3)
    want_out, want = _jax_grads(m, prev, mask, key)
    tp, tprev, tprior, x, y, w, noise, tmask = C.port_inputs(m, prev, mask, key)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    out = TV.loss(tree_unflatten(tp, leaves), tprev, tprior, x, y, noise, m["tcfg"],
                  weights=w, chain_mask=tmask, device="cpu")
    for i, name in enumerate(PIECES):
        np.testing.assert_allclose(float(out[i].detach()), want_out[i], rtol=1e-5, err_msg=name)
        got = torch.autograd.grad(out[i], leaves, retain_graph=True, allow_unused=True)
        for leaf, g, j in zip(("z", "u_mean", "u_tril_vec", "log_mean", "log_logvar"), got,
                              want[i]):
            g = np.zeros_like(j) if g is None else g.numpy()
            scale = max(float(np.max(np.abs(j))), 1e-30)
            np.testing.assert_allclose(g, j, rtol=0, atol=TOL * scale,
                                       err_msg=f"d {name} / d {leaf}")

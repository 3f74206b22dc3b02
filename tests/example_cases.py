"""Shared helpers of tests/test_torch_examples.py and
tests/test_torch_examples_parity.py: the points and the loss-and-gradient
comparison of an example's equation in pydens_tpu and pydens_tpu_torch at
the same theta."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils.criteria import mse_loss

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def jax_mse(a, b):
    return jnp.mean((a - b) ** 2)


def copy_params(js, ts):
    """The JAX solver's parameters into the port's."""
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return ts


def points(ts, n=64, seed=7):
    """``n`` points inside the domain, from a numpy seed."""
    dom = np.asarray(ts.model.domain, np.float32)
    u = np.random.default_rng(seed).uniform(size=(n, len(dom)))
    return (dom[:, 0] + (dom[:, 1] - dom[:, 0]) * u).astype(np.float32)


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(tree)])


def assert_loss_matches(js, ts, terms, pts, causal=None, eps=None):
    """The same plan in both packages, then the loss (rtol 2e-5) and the
    theta-gradient (rtol 2e-3 / atol 2e-5) of the port's ``_build_loss_fn``
    at ``pts`` against pydens_tpu's."""
    assert ts._plan_ok == js._plan_ok
    assert set(map(tuple, ts._plan_derivs)) == set(map(tuple,
                                                       js._plan_derivs))
    jloss_fn, *_ = js._build_loss_fn(terms, jax_mse, use_plan=True,
                                     causal=causal)
    leaves = [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]
    jeps = None if eps is None else jnp.float32(eps)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, leaves, None, None, jeps)))(js.model.params)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True,
                                causal=causal)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts), causal_eps=None
                   if eps is None else torch.tensor(eps))
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), flat(jg), **GRAD_TOL)

"""Shared workloads and helpers of tests/test_torch_ensemble.py and
tests/test_torch_ensemble_steps.py: pydens_tpu and pydens_tpu_torch
ensembles of one workload, the port holding the JAX members, and each
package's per-member losses and (K, P) gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu.solver import _flatten_stacked
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils.criteria import mse_loss

K = 3
LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _ode(pdt):
    return dict(equation=lambda f, x: pdt.D(f, x)
                - 2 * np.pi * pdt.cos(2 * np.pi * x),
                ndims=1, initial_condition=.5, activation="Tanh",
                layout="fafaf", features=[12, 10, 1])


def _poisson(pdt):
    return dict(equation=lambda f, x, y: pdt.D(pdt.D(f, x), x)
                + pdt.D(pdt.D(f, y), y) - 5 * pdt.sin(np.pi * (x + y)),
                ndims=2, boundary_condition=1, layout="fa fa f",
                features=[8, 6, 1], activation="Tanh")


def _inverse(pdt):
    # V in the initial condition, pinned by a constraint at fixed points,
    # and V in the equation.
    return dict(equation=lambda f, x: pdt.D(f, x) - 2 * np.pi
                * pdt.cos(2 * np.pi * x) + 0 * pdt.V("c", data=[0.5]),
                ndims=1, layout="fafaf", features=[8, 6, 1],
                initial_condition=lambda *a: pdt.V("init",
                                                   data=np.array([0.1])),
                constraints=lambda f, x: f(np.array([0.5])) - 0.7)


def _heat(pdt):
    return dict(equation=lambda f, x, t: pdt.D(f, t)
                - 0.1 * pdt.D(pdt.D(f, x), x),
                ndims=2, initial_condition=lambda x: pdt.sin(np.pi * x),
                layout="fa fa f", features=[8, 8, 1], activation="Tanh")


def _system(pdt):
    def system(f, x):
        u, v = f[:, 0:1], f[:, 1:2]
        return (pdt.D(u, x) - v, pdt.D(v, x) + u)
    return dict(equation=system, ndims=1, initial_condition=[0.0, 1.0],
                layout="fa f", features=[8, 2], activation="Tanh")


def _ritz(pdt):
    # tests/test_variational.py's Deep Ritz energy of -u'' = pi^2 sin.
    return dict(equation=lambda f, x: 0.5 * pdt.D(f, x) ** 2
                - np.pi ** 2 * pdt.sin(np.pi * x) * f,
                ndims=1, boundary_condition=0, activation="Tanh",
                layout="fa fa f", features=[8, 8, 1],
                formulation="variational")


WORKLOADS = {"ode": _ode, "poisson": _poisson, "inverse": _inverse,
             "heat": _heat, "system": _system, "ritz": _ritz}
INVERSE_TERMS = (("equation", 1.0), ("constraint_0", 5.0))


def _pair(make, n_models=K, seed=0, **extra):
    """The JAX and the port's ensembles, the port holding the JAX members
    (params_from_jax of the stacked tree)."""
    jkw, tkw = make(jpdt), make(tpdt)
    jkw.update(extra)
    tkw.update(extra)
    js = jpdt.Solver(jkw.pop("equation"), seed=seed, n_models=n_models,
                     **jkw)
    ts = tpdt.Solver(tkw.pop("equation"), seed=seed, n_models=n_models,
                     device="cpu", **tkw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _points(n, total, seed=7):
    return np.random.default_rng(seed).uniform(
        size=(n, total)).astype(np.float32)


def _leaves(pts):
    return [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]


def _jax_mse(a, b):
    return jnp.mean((a - b) ** 2)


def _jax_members(js, terms, pts, use_plan=True, causal=None, eps=None):
    """Each member's loss and the (K, P) gradient, by jax.vmap of the JAX
    loss over the stacked parameters (the leaves shared)."""
    jloss_fn, *_ = js._build_loss_fn(terms, _jax_mse, use_plan=use_plan,
                                     causal=causal)
    args = (None, None, None if eps is None else jnp.float32(eps))
    value_and_grad = jax.vmap(jax.value_and_grad(
        lambda p: jloss_fn(p, _leaves(pts), *args)))
    jl, jg = value_and_grad(js.model.params)
    return np.asarray(jl), np.asarray(_flatten_stacked(jg, js.n_models))


def _port_members(ts, terms, pts, use_plan=True, causal=None, eps=None):
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=use_plan,
                                causal=causal)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts),
                   causal_eps=None if eps is None else torch.tensor(eps))
    grad, = torch.autograd.grad(loss.sum(), theta)
    return loss.detach().numpy(), grad.numpy(), loss_fn, theta


class _Fixed:
    """Host-protocol sampler returning fixed points, for both packages."""

    def __init__(self, pts):
        self.pts = pts

    def sample(self, size):
        return self.pts[:size]


def _theta(s):
    if isinstance(s, tpdt.Solver):
        return s._spec().flatten(s.model.params).detach().numpy()
    return np.asarray(_flatten_stacked(s.model.params, s.n_models))

"""Examples 08, 26-28 and 31 held to pydens_tpu at a fixed theta at width
8, where a plain loss comparison does not reach their option:
examples/08 as an ensemble of 2 (each member's loss and the (K, P)
gradient against jax.vmap), the separable 26-28 on a grid of a few points
an axis (28 with its causal slices), and examples/31's balanced weights
after one NTK rebalance with the probes fed in.  Tolerances: loss rtol
2e-5, gradient rtol 2e-3 / atol 2e-5 (the solver tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import pydens_tpu as jpdt
import pydens_tpu.numpy as jnp_sym
import pydens_tpu_torch as tpdt
from pydens_tpu_torch.solver import _Collocation, _FitStep
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

from ensemble_cases import _jax_members, _port_members
from example_cases import (GRAD_TOL, LOSS_RTOL, copy_params, flat, jax_mse,
                           points)
from one_thread import one_thread  # noqa: F401

TERMS = (("equation", 1.0),)
ZERO = np.array([0.0], np.float32)

def test_ensemble_example_matches_pydens_tpu_per_member():
    # examples/08's ensemble at K = 2: each member's loss and the (K, P)
    # gradient against jax.vmap of pydens_tpu's loss.
    def build(pkg):
        return (lambda f, x: pkg.D(f, x) - 2 * np.pi * pkg.cos(2 * np.pi * x),
                dict(ndims=1, initial_condition=.5, activation="Tanh",
                     layout="fafaf", features=[8, 8, 1], n_models=2))
    jeq, jkw = build(jpdt)
    js = jpdt.Solver(jeq, seed=0, **jkw)
    teq, tkw = build(tpdt)
    ts = copy_params(js, tpdt.Solver(teq, seed=0, device="cpu", **tkw))
    assert ts._plan_ok == js._plan_ok
    terms = TERMS
    pts = points(ts)
    jl, jg = _jax_members(js, terms, pts)
    tl, tg, *_ = _port_members(ts, terms, pts)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)


def _separable(name, pkg, m):
    """Examples 26-28 at width 8: equation and Solver keywords."""
    D = pkg.D
    if name == "26_separable_poisson3d":
        return (lambda f, x, y, z: D(D(f, x), x) + D(D(f, y), y)
                + D(D(f, z), z) + 3 * np.pi ** 2 * m.sin(np.pi * x)
                * m.sin(np.pi * y) * m.sin(np.pi * z),
                dict(ndims=3, boundary_condition=0.0, layout="fa fa f",
                     features=[8, 8, 8], activation="Tanh"))
    if name == "27_separable_wave2d":
        return (lambda f, x, y, t: D(D(f, t), t) - D(D(f, x), x)
                - D(D(f, y), y),
                dict(ndims=3, boundary_condition=0.0,
                     initial_condition=lambda x, y: m.sin(np.pi * x)
                     * m.sin(np.pi * y), initial_condition_t=0.0,
                     layout="fa fa f", features=[8, 8, 8],
                     activation="Tanh"))
    return (lambda f, x, t: D(f, t) - 1e-4 * D(D(f, x), x)
            - 5.0 * (f - f ** 3),
            dict(ndims=2, domain=[(-1, 1), (0, 1)],
                 initial_condition=lambda x: x ** 2 * m.cos(np.pi * x),
                 periodic={0: 10}, periodic_ic_decay=False,
                 activation="Tanh", layout="fa fa fa f",
                 features=[8, 8, 8, 8]))


@pytest.mark.parametrize("name", ["26_separable_poisson3d",
                                  "27_separable_wave2d",
                                  "28_separable_allen_cahn"])
def test_separable_example_matches_pydens_tpu_on_a_grid(name):
    # The grid of 5 points an axis (unsorted samples of the domain); 28
    # with its causal slices at eps 20.
    causal, eps = ((1, 0.0, 1.0), 20.0) if name.startswith("28") else (
        None, None)
    jeq, jkw = _separable(name, jpdt, jnp_sym)
    js = jpdt.Solver(jeq, model=jpdt.SeparableModel, seed=0, **jkw)
    teq, tkw = _separable(name, tpdt, torch)
    ts = copy_params(js, tpdt.Solver(teq, model=tpdt.SeparableModel, seed=0,
                                     device="cpu", **tkw))
    assert ts._plan_ok == js._plan_ok
    pts = points(ts, n=5, seed=11)
    terms = TERMS
    jloss_fn, *_ = js._build_loss_fn(terms, jax_mse, use_plan=False,
                                     causal=causal)
    total = pts.shape[1]
    leaves = [jnp.asarray(pts[:, k]).reshape(
        (1,) * k + (-1,) + (1,) * (total - k)) for k in range(total)]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(
        p, leaves, None, None,
        None if eps is None else jnp.float32(eps))))(js.model.params)
    loss_fn = ts._build_loss_fn(terms, mse_loss, causal=causal)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts),
                   causal_eps=None if eps is None else torch.tensor(eps))
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), flat(jg), **GRAD_TOL)


def test_helmholtz_weights_after_one_ntk_rebalance_match_jax():
    # examples/31's three terms from weights (1, 1, 1): the equation
    # block's trace with 4 probes fed in (the mean of |J^T u|^2 against
    # jax.vjp with the same u), the constraints' exact (1 entry each,
    # against jax.jacfwd); the anchored, clipped EMA of the inverse
    # traces; then the step's loss with the new weights.  Weights rtol
    # 2e-3 (the gradients'), loss rtol 2e-5.
    def build(pkg):
        return (lambda f, x: pkg.D(pkg.D(f, x), x) + 144.0 * f,
                dict(ndims=1, layout="fa fa fa f", features=[8, 8, 8, 1],
                     activation="Tanh",
                     constraints=(lambda f, x: f(ZERO),
                                  lambda f, x: f.grad(ZERO, wrt=0) - 12.0)))
    jeq, jkw = build(jpdt)
    js = jpdt.Solver(jeq, seed=0, **jkw)
    teq, tkw = build(tpdt)
    ts = copy_params(js, tpdt.Solver(teq, seed=0, device="cpu", **tkw))
    terms = TERMS + (("constraint_0", 1.0), ("constraint_1", 1.0))
    pts = points(ts)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True)
    step = _FitStep(loss_fn, resolve_optimizer("Adam", 0.0, {}), None,
                    loss_fn.spec.flatten(ts.model.params), 1, len(pts),
                    False, False, False,
                    options=_Collocation(balance_every=1, balance_mode="ntk"),
                    generator=torch.Generator().manual_seed(0))
    step.points[0].copy_(torch.from_numpy(pts))
    probes = np.random.default_rng(4).choice(
        [-1.0, 1.0], size=(4, len(pts))).astype(np.float32)
    step.probes = {0: torch.from_numpy(probes)}
    loss = step._loss(rebalance=True)

    jloss_fn, _, jresvec = js._build_loss_fn(terms, jax_mse, use_plan=True)
    params, unravel = ravel_pytree(js.model.params)
    leaves = [jnp.asarray(pts)]

    def blocks(th):
        return jresvec.term_blocks(unravel(th), leaves)

    res, pull = jax.vjp(blocks, params)
    eq = np.mean([float(jnp.sum(pull((jnp.asarray(u),)
                                     + tuple(jnp.zeros_like(r)
                                             for r in res[1:]))[0] ** 2))
                  for u in probes])
    traces = np.asarray([eq] + [float(jnp.sum(jax.grad(
        lambda th, j=j: jnp.sum(blocks(th)[j]))(params) ** 2))
        for j in (1, 2)])
    lam = np.clip(traces[0] / (traces + 1e-12), 0.01, 100.0)
    lam[0] = 1.0
    np.testing.assert_allclose(step.wts.numpy(), 0.7 + 0.3 * lam,
                               rtol=2e-3)
    jl = jloss_fn(js.model.params, leaves, None, jnp.asarray(step.wts))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)

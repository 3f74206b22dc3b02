"""The vector-calculus operators and the grid helpers of pydens_tpu_torch
against pydens_tpu: each operator's value and the plan taps it records
equal nested ``D``'s and JAX's; a ``laplace`` residual's loss and gradient
equal JAX's at the same theta and points, on the Taylor plan;
``cart_prod`` and ``uniform_grid`` equal JAX's arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu.ops.tokens import EvalContext as JaxContext
from pydens_tpu.ops.tokens import Expr as JaxExpr
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.ops.tokens import EvalContext, Expr
from pydens_tpu_torch.utils.criteria import mse_loss

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _cols(n=6, total=3, seed=3):
    return np.random.default_rng(seed).uniform(
        0.1, 1.0, (n, total)).astype(np.float32)


def _field(v):
    # A smooth field of three coordinates with every mixed partial nonzero.
    x, y, z = v[0], v[1], v[2]
    return x ** 3 * y + y ** 2 * z + x * z ** 2


def _torch_ctx(pts):
    leaves = [torch.from_numpy(pts[:, k:k + 1].copy()).requires_grad_(True)
              for k in range(pts.shape[1])]
    ctx = EvalContext(leaves)
    f = Expr(lambda: _field(ctx.leaves), ctx, deriv=())
    coords = [Expr((lambda k: lambda: ctx.leaves[k])(k), ctx, leaf_index=k)
              for k in range(len(leaves))]
    return ctx, f, coords


def _jax_ctx(pts):
    leaves = [jnp.asarray(pts[:, k:k + 1]) for k in range(pts.shape[1])]
    ctx = JaxContext(leaves)
    f = JaxExpr(_field, ctx, deriv=())
    coords = [JaxExpr((lambda k: lambda ls: ls[k])(k), ctx, leaf_index=k)
              for k in range(len(leaves))]
    return ctx, f, coords


def _value(out):
    if isinstance(out, tuple):
        return [_value(o) for o in out]
    v = out.value
    return np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)


# (operator call, its nested-D spelling), each given (pdt, f, x, y, z).
OPERATORS = {
    "grad": (lambda p, f, x, y, z: p.grad(f, x, y, z),
             lambda p, f, x, y, z: (p.D(f, x), p.D(f, y), p.D(f, z))),
    "div": (lambda p, f, x, y, z: p.div((f, f * x, f), x, y, z),
            lambda p, f, x, y, z: p.D(f, x) + p.D(f * x, y) + p.D(f, z)),
    "laplace": (lambda p, f, x, y, z: p.laplace(f, x, y, z),
                lambda p, f, x, y, z: (p.D(p.D(f, x), x) + p.D(p.D(f, y), y)
                                       + p.D(p.D(f, z), z))),
    "hessian_diag": (lambda p, f, x, y, z: p.hessian_diag(f, x, z),
                     lambda p, f, x, y, z: (p.D(p.D(f, x), x),
                                            p.D(p.D(f, z), z))),
    "dt": (lambda p, f, x, y, z: p.dt(f, z),
           lambda p, f, x, y, z: p.D(f, z)),
    "dn": (lambda p, f, x, y, z: p.dn(f, x, 3),
           lambda p, f, x, y, z: p.D(p.D(p.D(f, x), x), x)),
}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_equals_nested_d_and_jax(name):
    # The operator's value equals nested D's (values rtol/atol 2e-5) and
    # JAX's operator's, and it records the same plan taps (and plan
    # validity) as nested D in both packages: a Laplacian stays planned.
    op, nested = OPERATORS[name]
    pts = _cols()
    ctx, f, coords = _torch_ctx(pts)
    got = _value(op(tpdt, f, *coords))
    ctx_n, f_n, coords_n = _torch_ctx(pts)
    ref = _value(nested(tpdt, f_n, *coords_n))
    jctx, jf, jcoords = _jax_ctx(pts)
    jax_out = _value(op(jpdt, jf, *jcoords))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **VALUE_TOL)
    np.testing.assert_allclose(np.asarray(got), np.asarray(jax_out),
                               **VALUE_TOL)
    assert ctx.derivs == ctx_n.derivs == set(jctx.derivs)
    assert ctx.plan_ok == ctx_n.plan_ok == jctx.plan_ok


def test_div_needs_one_component_per_coordinate():
    for pdt, (_, f, coords) in ((tpdt, _torch_ctx(_cols())),
                                (jpdt, _jax_ctx(_cols()))):
        with pytest.raises(ValueError, match="one component per coordinate"):
            pdt.div((f,), *coords[:2])


def _poisson2(pdt):
    # README's 2D Poisson, the Laplacian by the operator.
    return (lambda f, x, y: pdt.laplace(f, x, y)
            - 5 * pdt.sin(np.pi * (x + y)),
            dict(ndims=2, boundary_condition=1, layout="fa fa f",
                 features=[10, 10, 1], activation="Tanh"))


def _poisson3(pdt):
    # examples/17's residual at a narrow width.
    return (lambda f, x, y, z: pdt.laplace(f, x, y, z)
            + 3 * np.pi ** 2 * (pdt.sin(np.pi * x) * pdt.sin(np.pi * y)
                                * pdt.sin(np.pi * z)),
            dict(ndims=3, boundary_condition=0, layout="fa fa f",
                 features=[12, 12, 1], activation="Tanh"))


@pytest.mark.parametrize("make", [_poisson2, _poisson3],
                         ids=["poisson2d", "poisson3d"])
@pytest.mark.parametrize("use_plan", [True, False], ids=["plan", "nested"])
def test_laplace_residual_matches_jax(make, use_plan):
    # Both solvers plan the Laplacian (examples/17 asserts _plan_ok) with
    # the same taps; at theta copied from JAX and 128 seeded points the
    # loss agrees at rtol 2e-5 and the gradient at rtol 2e-3 / atol 2e-5,
    # on the plan and on nested D.
    jeq, jkw = make(jpdt)
    teq, tkw = make(tpdt)
    js = jpdt.Solver(jeq, seed=0, **jkw)
    ts = tpdt.Solver(teq, seed=0, device="cpu", **tkw)
    assert js._plan_ok and ts._plan_ok
    assert set(ts._plan_derivs) == set(js._plan_derivs)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    pts = np.random.default_rng(7).uniform(
        size=(128, ts.model.total)).astype(np.float32)
    terms = (("equation", 1.0),)
    jloss_fn, *_ = js._build_loss_fn(
        terms, lambda a, b: jnp.mean((a - b) ** 2), use_plan=use_plan)
    jl, jg = jax.value_and_grad(lambda p: jloss_fn(
        p, [jnp.asarray(pts[:, k:k + 1]) for k in range(pts.shape[1])]))(
            js.model.params)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=use_plan)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts))
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        grad.numpy(),
        np.concatenate([np.ravel(np.asarray(g))
                        for g in jax.tree.leaves(jg)]), **GRAD_TOL)


GRID_CASES = {
    "cart_prod_2": ("cart_prod", (np.array([0, 1]), np.array([2, 3, 4]))),
    "cart_prod_3": ("cart_prod", (np.linspace(0, 1, 3), np.arange(2.0),
                                  np.array([-1.5, 0.5, 2.0, 7.0]))),
    "uniform_2d": ("uniform_grid", ([(0, 1), (-1, 1)], [3, 5])),
    "uniform_1d": ("uniform_grid", ((0, 2), 5)),
    "uniform_3d_int": ("uniform_grid", ([(0, 1), (0, 2), (-1, 0)], 4)),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grids_equal_jax(case):
    # Host numpy in both packages: equal arrays, shape and dtype.
    name, args = GRID_CASES[case]
    got = getattr(tpdt, name)(*args)
    ref = getattr(jpdt, name)(*args)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)

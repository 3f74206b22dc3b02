"""``Solver.predict_grad`` and ``Solver.residual`` of pydens_tpu_torch
against pydens_tpu at the same parameters: on a planned chain (one Taylor
forward with first-order streams only), on a model without a plan (a
``TorchModel`` subclass, and a separable model), on a system ensemble
(K = 2, the member mean), on a stacked grid; ``residual`` on a stacked
grid and in an ensemble."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.ops import fused_taylor

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


class _JaxTiny(jpdt.Model):
    # tests/test_diagnostics.py's custom model: no Taylor plan.
    def network_init(self, key):
        return {"w": jax.random.normal(key, (self.total, 1)) * 0.3}

    def network_apply(self, net, xs):
        return jnp.tanh(xs @ net["w"])


class _TorchTiny(tpdt.TorchModel):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.w = nn.Parameter(torch.zeros((self.total, 1),
                                          device=self.device))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.w.copy_(0.3 * torch.randn(self.w.shape, generator=generator))

    def network_params(self):
        return {"w": self.w}

    def network_apply(self, net, xs):
        return torch.tanh(xs @ net["w"])


def _ode(pdt):
    return (lambda f, x: pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x),
            dict(ndims=1, initial_condition=.5, activation="Tanh",
                 layout="fafaf", features=[12, 10, 1]))


def _poisson(pdt):
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y),
            dict(ndims=2, boundary_condition=0.5, layout="fa fa f",
                 features=[10, 10, 1], activation="Tanh"))


def _poisson3(pdt):
    # examples/17's chain shape at a narrow width: 3 inputs.
    return (lambda f, x, y, z: pdt.laplace(f, x, y, z) - 1.0,
            dict(ndims=3, boundary_condition=0, layout="fa fa f",
                 features=[12, 12, 1], activation="Tanh"))


def _system(pdt):
    def system(f, x):
        return (pdt.D(f[:, 0:1], x) - 1.0, pdt.D(f[:, 1:2], x) + 1.0)
    return system, dict(ndims=1, layout="fa f", features=[8, 2])


def _heat_system(pdt):
    # Two outputs of two inputs with an initial condition per component.
    def system(f, x, t):
        u, v = f[..., 0:1], f[..., 1:2]
        return (pdt.D(u, t) - pdt.D(pdt.D(v, x), x), pdt.D(v, t) + u)
    return system, dict(ndims=2, initial_condition=np.array([0.0, 1.0]),
                        layout="fa fa f", features=[8, 8, 2],
                        activation="Tanh")


def _tiny(pdt):
    return (lambda f, x, y: pdt.D(f, x) + pdt.D(f, y),
            dict(ndims=2, model=_JaxTiny if pdt is jpdt else _TorchTiny))


def _separable(pdt):
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y),
            dict(ndims=2, boundary_condition=0.0, model=pdt.SeparableModel,
                 layout="fa f", features=[8, 4], activation="Tanh"))


# workload, n_models, inputs (stacked grid or columns), planned
GRAD_CASES = {
    "planned_chain": (_ode, 1, "columns", True),
    "planned_3d": (_poisson3, 1, "stacked", True),
    "planned_system": (_heat_system, 1, "stacked", True),
    "torch_model": (_tiny, 1, "columns", False),
    "system_ensemble": (_system, 2, "columns", True),
    "stacked_grid": (_poisson, 1, "stacked", True),
    "stacked_grid_ensemble": (_poisson, 2, "stacked", True),
    "separable": (_separable, 1, "stacked", False),
}


def _pair(make, n_models=1):
    jeq, jkw = make(jpdt)
    teq, tkw = make(tpdt)
    js = jpdt.Solver(jeq, seed=0, n_models=n_models, **jkw)
    ts = tpdt.Solver(teq, seed=0, n_models=n_models, device="cpu", **tkw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _inputs(total, kind, n=37):
    pts = np.random.default_rng(4).uniform(size=(n, total)).astype(
        np.float32)
    if kind == "stacked" and total > 1:
        return (pts,)
    return tuple(pts[:, k] for k in range(total))


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_predict_grad_matches_jax(case, monkeypatch):
    # The derivative of every column, (N, total) or (N, total, n_out), the
    # member mean of an ensemble: equal to JAX's at rtol 2e-3 / atol 2e-5.
    # A planned model takes one call of the Taylor forward's wrapper with
    # the first-order streams alone (on the card: one kernel launch, every
    # member in it); any other takes nested D.
    make, k, kind, planned = GRAD_CASES[case]
    js, ts = _pair(make, k)
    assert ts.model.supports_taylor == planned
    calls = []
    wrapper = fused_taylor.fused_taylor_forward

    def counted(packed, x, plan):
        calls.append(plan)
        return wrapper(packed, x, plan)
    monkeypatch.setattr(fused_taylor, "fused_taylor_forward", counted)
    xs = _inputs(ts.model.total, kind)
    got = ts.predict_grad(*xs)
    ref = np.asarray(js.predict_grad(*xs))
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **GRAD_TOL)
    if planned:
        assert len(calls) == 1
        assert calls[0].pairs == []
        assert calls[0].firsts == list(range(ts.model.total))
    else:
        assert calls == []


def test_predict_grad_shapes():
    # Scalar problems drop the output axis; systems keep it.
    _, ts = _pair(_ode)
    assert ts.predict_grad(np.linspace(0, 1, 5)).shape == (5, 1)
    _, ts = _pair(_system, 2)
    assert ts.predict_grad(np.linspace(0, 1, 5)).shape == (5, 1, 2)
    _, ts = _pair(_poisson)
    assert ts.predict_grad(np.zeros((6, 2), np.float32)).shape == (6, 2)


@pytest.mark.parametrize("n_models", [1, 2])
def test_residual_on_a_stacked_grid_matches_jax(n_models):
    # The (N, 1) |residual| on a stacked (N, 2) grid equals the per-column
    # call's and JAX's (rtol/atol 2e-5); a wrong column count is a named
    # error.
    js, ts = _pair(_poisson, n_models)
    grid = tpdt.uniform_grid([(0, 1), (0, 1)], 6).astype(np.float32)
    r = ts.residual(grid)
    assert r.shape == (36, 1)
    np.testing.assert_allclose(r, ts.residual(grid[:, 0:1], grid[:, 1:2]),
                               rtol=1e-6)
    np.testing.assert_allclose(r, np.asarray(js.residual(grid)), **VALUE_TOL)
    with pytest.raises(ValueError, match="coordinate columns"):
        ts.residual(np.zeros(5))


def test_residual_of_a_separable_model_is_pointwise():
    # Solver.residual evaluates a separable model at the given points
    # (the pointwise path), as JAX's does.
    js, ts = _pair(_separable)
    pts = _inputs(2, "stacked")[0]
    np.testing.assert_allclose(ts.residual(pts), np.asarray(js.residual(pts)),
                               **VALUE_TOL)

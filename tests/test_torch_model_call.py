"""The model call and ``Solver.ctx`` against pydens_tpu.

``solver.model(...)``, ``solver.model.forward(...)`` and
``solver.ctx.run(solver.model, xs)`` of the port, holding the JAX
parameters (``params_from_jax`` at the same seed), against the same calls
of ``pydens_tpu`` at rtol / atol 2e-5: a planned chain (``w1``), a
parametric model, a two-output system, a K = 3 ensemble, a separable model,
a periodic (embedded) chain and a bfloat16 model (float32 out).  Columns, a
stacked array and a stacked tensor give the port's own ``predict``
bitwise.  Then the cases of tests/test_round3_fixes.py and
tests/test_solver.py that pin the call, and the last flow of
tutorials_torch/2_torch_examples.ipynb (the inverse ``V('init')`` problem:
the body frozen, three Adam steps on a fixed batch, then the call)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.ops import fused_mlp

from ensemble_cases import _Fixed
from one_thread import one_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 2e-5


def _w1(pdt):
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
            - 5 * pdt.sin(np.pi * (x + y)),
            dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
                 activation="Tanh", units=[10, 12, 15, 1]))


def _parametric(pdt):
    return (lambda f, x, e: pdt.D(f, x) - e * np.pi * pdt.cos(e * np.pi * x),
            dict(ndims=1, nparams=1, initial_condition=2.0,
                 layout="fa fa f", features=[12, 10, 1]))


def _system(pdt):
    def oscillator(f, x):
        u, v = f[:, 0:1], f[:, 1:2]
        return (pdt.D(u, x) - v, pdt.D(v, x) + 4.0 * u)
    return oscillator, dict(ndims=1, initial_condition=np.array([0.0, 2.0]),
                            layout="fa fa f", features=[16, 16, 2],
                            activation="Tanh")


def _ensemble(pdt):
    eq, kw = _w1(pdt)
    return eq, dict(kw, units=[8, 6, 1], layout="fa fa f", n_models=3)


def _separable(pdt):
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
            - 1.0,
            dict(ndims=2, boundary_condition=0.0, model=pdt.SeparableModel,
                 layout="fa f", features=[12, 8], activation="Tanh"))


def _periodic(pdt):
    return (lambda f, x, t: pdt.D(f, t) - 0.25 * pdt.D(pdt.D(f, x), x),
            dict(ndims=2, periodic=(0,),
                 initial_condition=lambda x: pdt.sin(2 * np.pi * x),
                 layout="fa fa f", features=[12, 12, 1], activation="Tanh"))


def _bfloat16(pdt):
    return (lambda f, x: pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x),
            dict(ndims=1, initial_condition=.5, activation="Tanh",
                 layout="fafaf", features=[12, 10, 1],
                 dtype=jnp.bfloat16 if pdt is jpdt else torch.bfloat16))


CASES = {"w1": _w1, "parametric": _parametric, "system": _system,
         "ensemble": _ensemble, "separable": _separable,
         "periodic": _periodic, "bfloat16": _bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    """One JAX Solver a case for the module: the tests only call it."""
    eq, kw = CASES[name](jpdt)
    return jpdt.Solver(eq, seed=0, **kw)


def _pair(name):
    js = _jax_solver(name)
    eq, kw = CASES[name](tpdt)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), js.model.params),
        dtype=ts.model.dtype))
    return js, ts


def _columns(total, n=33, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(size=n).astype(np.float32)
                 for _ in range(total))


def _f32(out):
    return np.asarray(out).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_model_call_matches_jax(name):
    js, ts = _pair(name)
    cols = _columns(ts.model.total)
    stacked = np.stack(cols, axis=1)
    want = _f32(js.model(*cols))
    calls = {"columns": ts.model(*cols), "stacked": ts.model(stacked),
             "forward": ts.model.forward(*cols),
             "ctx": ts.ctx.run(ts.model, stacked)}
    for how, got in calls.items():
        assert got.dtype == np.float32 and got.shape == want.shape, how
        np.testing.assert_allclose(got, want, err_msg=how, **TOL)
    np.testing.assert_allclose(_f32(js.ctx.run(js.model, stacked)), want,
                               **TOL)
    np.testing.assert_allclose(_f32(js.model.forward(*cols)), want, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_call_forms_are_bitwise_predict(name):
    # Columns, a stacked array and a stacked tensor are one call, and the
    # call is Solver.predict (the ensemble mean) bit for bit.
    _, ts = _pair(name)
    cols = _columns(ts.model.total, n=17, seed=4)
    stacked = np.stack(cols, axis=1)
    want = ts.predict(*cols)
    for got in (ts.model(*cols), ts.model(stacked),
                ts.model(torch.from_numpy(stacked)),
                ts.model.forward(torch.from_numpy(stacked.copy())),
                ts.ctx.run(ts.model, stacked), ts.predict(stacked)):
        assert np.array_equal(got, want)


def test_a_chain_in_the_kernels_scope_takes_the_mlp_once(monkeypatch):
    # The call runs predict_apply: one fused MLP wrapper call (on the card
    # one mlp_fwd_kernel launch), whatever the input form.
    _, ts = _pair("w1")
    assert ts.model._mlp_plan is not None
    calls = []
    wrapper = fused_mlp.fused_mlp_forward

    def counted(*args):
        calls.append(1)
        return wrapper(*args)
    monkeypatch.setattr(fused_mlp, "fused_mlp_forward", counted)
    cols = _columns(2)
    ts.model(*cols)
    ts.ctx.run(ts.model, np.stack(cols, axis=1))
    ts.model.forward(torch.from_numpy(np.stack(cols, axis=1)))
    assert len(calls) == 3


def test_a_model_with_no_parameters_raises():
    # A model built outside a Solver has no V variables yet: as in
    # pydens_tpu, the call refuses.
    with pytest.raises(RuntimeError, match="no parameters"):
        jpdt.ConvBlockModel(ndims=1)(np.zeros(3))
    with pytest.raises(RuntimeError, match="no parameters"):
        tpdt.ConvBlockModel(ndims=1, device="cpu")(np.zeros(3))


def test_stacked_columns_must_match_the_problem():
    _, ts = _pair("w1")
    with pytest.raises(ValueError, match="coordinate columns"):
        ts.model(np.zeros((4, 3), np.float32))


# tests/test_round3_fixes.py:22-47 and tests/test_solver.py:178-183.

def test_ctx_run_reference_idiom():
    def pde(f, x, y):
        return (tpdt.D(tpdt.D(f, x), x) + tpdt.D(tpdt.D(f, y), y)
                - 5 * tpdt.sin(np.pi * (x + y)))

    solver = tpdt.Solver(pde, ndims=2, boundary_condition=1, seed=0,
                         device="cpu")
    solver.fit(niters=5, batch_size=16, progress=False)
    xs = np.stack([np.linspace(0, 1, 40),
                   np.linspace(0, 1, 40)], axis=1).astype(np.float32)
    via_ctx = np.asarray(solver.ctx.run(solver.model, xs))
    assert via_ctx.shape == (40, 1)
    np.testing.assert_allclose(via_ctx, solver.predict(xs), atol=1e-6)
    assert solver.ctx.run(lambda a, b: a + b, 1, 2) == 3
    assert solver.ctx.run(lambda a, b=0: a * b, 2, b=4) == 8


def test_model_call_stacked_vs_columns():
    def pde(f, x, y):
        return tpdt.D(tpdt.D(f, x), x) + tpdt.D(tpdt.D(f, y), y)

    solver = tpdt.Solver(pde, ndims=2, boundary_condition=0, seed=0,
                         device="cpu")
    solver.fit(niters=2, batch_size=16, progress=False)
    cols = (np.linspace(0, 1, 9), np.linspace(0, 1, 9))
    stacked = np.stack(cols, axis=1).astype(np.float32)
    np.testing.assert_allclose(np.asarray(solver.model(*cols)),
                               np.asarray(solver.model(stacked)), atol=1e-6)


def test_model_call_like_reference():
    solver = tpdt.Solver(lambda f, x: tpdt.D(f, x), ndims=1, seed=0,
                         device="cpu")
    out = solver.model(np.linspace(0, 1, 9))
    assert out.shape == (9, 1)


# The last flow of the second notebook at pydens_tpu's theta.

def _inverse_ic(pdt, tensor):
    def odevar(u, t):
        return pdt.D(u, t) - 2 * np.pi * pdt.cos(2 * np.pi * t)

    def initial(*args):
        return pdt.V("init", data=tensor([4.0]))

    return odevar, dict(ndims=1, initial_condition=initial,
                        constraints=lambda u, t: u(tensor([0.5])) - 2)


def test_notebook_two_phase_flow_matches_jax():
    jeq, jkw = _inverse_ic(jpdt, np.array)
    teq, tkw = _inverse_ic(tpdt, torch.Tensor)
    js = jpdt.Solver(jeq, seed=0, **jkw)
    ts = tpdt.Solver(teq, seed=0, device="cpu", **tkw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    for s in (js, ts):
        s.model.freeze_layers(["fc1", "fc2", "fc3"], ["log_scale"])
        s.model.unfreeze_layers(variables=["init"])
    jmask = jax.tree.leaves(js.model.trainable_mask(js.model.params))
    tmask = jax.tree.leaves(ts.model.trainable_mask(ts.model.params))
    assert [bool(m) for m in jmask] == [bool(m) for m in tmask]
    assert sum(map(bool, tmask)) == 1           # init alone trains

    pts = np.random.default_rng(11).uniform(size=(100, 1)).astype(
        np.float32)
    fit = dict(niters=3, batch_size=100, lr=0.1, sampler=_Fixed(pts),
               resample=False,
               losses=["equation", "constraint_0"], progress=False)
    js.fit(**fit)
    ts.fit(**fit)
    np.testing.assert_allclose(ts.losses, js.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        ts.model.params["variables"]["init"].detach().numpy(),
        np.asarray(js.model.params["variables"]["init"]), **TOL)
    xs = np.linspace(0, 1, 100)
    want = np.asarray(js.ctx.run(js.model, xs))
    got = np.asarray(ts.ctx.run(ts.model, xs))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got, ts.predict(xs))


@pytest.mark.parametrize("name", ["single", "ensemble", "bfloat16"])
def test_a_variable_reads_back_through_numpy(name):
    # The notebooks read an inverse problem's answer as pydens_tpu's users
    # do, float(np.asarray(solver.params['variables'][name])[0]): the port's
    # variable reads back on the host, detached and copied (a bfloat16
    # value as float32), whatever its device.
    def make(pdt, **kw):
        if name == "ensemble":
            kw["n_models"] = 2
        if name == "bfloat16":
            kw["dtype"] = jnp.bfloat16 if pdt is jpdt else torch.bfloat16
        return pdt.Solver(lambda f, x: pdt.D(f, x)
                          + pdt.V("c", data=np.array([1.25])), ndims=1,
                          initial_condition=1, seed=0, **kw)
    js, ts = make(jpdt), make(tpdt, device="cpu")
    want = np.asarray(js.params["variables"]["c"]).astype(np.float32)
    got = np.asarray(ts.params["variables"]["c"])
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert float(np.asarray(ts.params["variables"]["c"]).ravel()[0]) == 1.25
    got[...] = 0.0            # a copy: the parameter is untouched
    assert float(ts.params["variables"]["c"].detach().ravel()[0]) == 1.25
    ts.fit(niters=2, batch_size=16, lr=0.1, progress=False)
    assert type(ts.params["variables"]["c"]).__name__ == "Variable"
    assert not np.array_equal(np.asarray(ts.params["variables"]["c"]), want)

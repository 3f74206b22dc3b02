"""The ported slice end to end against pydens_tpu: the README Poisson
workload (w1 of benchmarks/bench_loss_parity.py) at its full widths, and
the ODE with an initial condition (w2).  Collocation points come from
seeded numpy and the parameters are copied from the JAX solver, so both
packages evaluate the same function on the same inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _poisson(pdt):
    def pde(f, x, y):
        return (pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
                - 5 * pdt.sin(np.pi * (x + y)))
    return pde, dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
                     activation="Tanh", units=[10, 12, 15, 1])


def _ode_ic(pdt):
    def ode(f, x):
        return pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
    return ode, dict(ndims=1, initial_condition=.5, activation="Tanh",
                     layout="fafaf", features=[12, 10, 1])


def _poisson_v(pdt):
    # A V-token coefficient: discovered at construction, trained, planned.
    def pde(f, x, y):
        return (pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
                - pdt.V("k", 2.0) * pdt.sin(np.pi * (x + y)))
    return pde, dict(ndims=2, boundary_condition=0.5, layout="fa fa f",
                     activation="Sigmoid", units=[16, 16, 1])


WORKLOADS = {"poisson_readme": _poisson, "ode_ic": _ode_ic,
             "poisson_v": _poisson_v}


@functools.lru_cache(maxsize=None)
def _jax_solver(name, log_scale):
    """One JAX Solver per (workload, log_scale) for the whole module: the
    tests only read it."""
    jeq, kw = WORKLOADS[name](jpdt)
    js = jpdt.Solver(jeq, seed=0, **kw)
    if log_scale is not None:
        js.model.params["log_scale"] = jnp.asarray(log_scale, jnp.float32)
    return js


def _pair(name, log_scale=None):
    """The JAX and the port's Solver of one workload with the JAX
    parameters copied into the port."""
    teq, kw = WORKLOADS[name](tpdt)
    js = _jax_solver(name, log_scale)
    ts = tpdt.Solver(teq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _points(n, total, seed=7):
    return np.random.default_rng(seed).uniform(
        size=(n, total)).astype(np.float32)


def _jax_value_and_grad(js, pts, use_plan=True):
    crit = lambda a, b: jnp.mean((a - b) ** 2)
    loss_fn, *_ = js._build_loss_fn((("equation", 1.0),), crit,
                                    use_plan=use_plan)
    leaves = [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]
    loss, grad = jax.value_and_grad(loss_fn)(js.model.params, leaves)
    flat = np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(grad)])
    return float(loss), flat


def _torch_value_and_grad(ts, pts, use_plan=True):
    loss_fn = ts._build_loss_fn((("equation", 1.0),), mse_loss,
                                use_plan=use_plan)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts))
    grad, = torch.autograd.grad(loss, theta)
    return float(loss.detach()), grad.numpy()


@pytest.mark.parametrize("name,log_scale", [("poisson_readme", None),
                                            ("ode_ic", 0.3),
                                            ("poisson_v", None)])
def test_loss_and_grads_match_jax(name, log_scale):
    # Fixed 100 points, copied theta: loss rtol 2e-5, grads rtol 2e-3 /
    # atol 2e-5 (tests/test_pallas_taylor.py's tolerances; the flat theta
    # orders leaves like jax.tree.leaves in both packages).
    js, ts = _pair(name, log_scale)
    assert ts._plan_ok and ts._plan_derivs == js._plan_derivs
    pts = _points(100, ts.model.total)
    jl, jg = _jax_value_and_grad(js, pts)
    tl, tg = _torch_value_and_grad(ts, pts)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)


@pytest.mark.parametrize("name", ["poisson_readme", "ode_ic"])
def test_plan_equals_nested_gradients(name):
    # The invariant of the Taylor plan: the one-traversal tap table and the
    # nested autograd.grad path are the same function (loss rtol 2e-5,
    # grads rtol 2e-3 / atol 2e-5).
    _, ts = _pair(name, 0.3 if name == "ode_ic" else None)
    pts = _points(100, ts.model.total, seed=3)
    pl, pg = _torch_value_and_grad(ts, pts, use_plan=True)
    fl, fg = _torch_value_and_grad(ts, pts, use_plan=False)
    np.testing.assert_allclose(pl, fl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pg, fg, **GRAD_TOL)


def test_five_adam_steps_match_optax():
    # Each step moves theta by at most lr and the gradients agree to f32,
    # so five steps agree to max|d theta| <= 1e-5.
    js, ts = _pair("poisson_readme")
    batches = [_points(100, 2, seed=s) for s in range(5)]
    crit = lambda a, b: jnp.mean((a - b) ** 2)
    jloss_fn, *_ = js._build_loss_fn((("equation", 1.0),), crit,
                                     use_plan=True)
    params = js.model.params
    opt = optax.adam(0.005)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(jloss_fn))
    for pts in batches:
        g = grad_fn(params, [jnp.asarray(pts[:, i:i + 1]) for i in range(2)])
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    jtheta = np.concatenate([np.ravel(np.asarray(p))
                             for p in jax.tree.leaves(params)])

    loss_fn = ts._build_loss_fn((("equation", 1.0),), mse_loss,
                                use_plan=True)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    adam = resolve_optimizer("Adam", 0.005, {})
    ostate = adam.init(theta.detach())
    for pts in batches:
        grad, = torch.autograd.grad(loss_fn(theta, torch.from_numpy(pts)),
                                    theta)
        adam.update(theta, grad, ostate)
    assert float(np.abs(theta.detach().numpy() - jtheta).max()) <= 1e-5


def test_predict_matches_jax_and_binds_boundary():
    # rtol/atol 2e-5 on a 33 x 33 grid (the fused-MLP path's plain version
    # on the CPU against the JAX forward); the ansatz makes the boundary
    # exact to 1e-5.
    js, ts = _pair("poisson_readme")
    xs = np.linspace(0, 1, 33, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    out = ts.predict(grid[:, 0:1], grid[:, 1:2])
    assert out.shape == (33 * 33, 1)
    np.testing.assert_allclose(out, js.predict(grid[:, 0:1], grid[:, 1:2]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ts.predict(grid), out, rtol=0, atol=0)
    edge = ts.predict(np.zeros(5), np.linspace(0, 1, 5)).ravel()
    np.testing.assert_allclose(edge, 1.0, atol=1e-5)


def test_ode_ic_predict_matches_jax():
    js, ts = _pair("ode_ic", 0.3)
    xs = np.linspace(0, 1, 50, dtype=np.float32)
    np.testing.assert_allclose(ts.predict(xs), js.predict(xs), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ts.predict(np.zeros(3)).ravel(), 0.5,
                               atol=1e-6)


def test_readme_torch_verbatim_equation_runs():
    # README.md's equation spelled with torch.sin on the coordinate symbols.
    def pde(f, x, y):
        return (tpdt.D(tpdt.D(f, x), x) + tpdt.D(tpdt.D(f, y), y)
                - 5 * torch.sin(np.pi * (x + y)))

    solver = tpdt.Solver(equation=pde, ndims=2, boundary_condition=1,
                         layout="fa fa fa f", activation="Tanh",
                         units=[10, 12, 15, 1], device="cpu")
    assert solver._plan_ok
    solver.fit(batch_size=100, niters=20, progress=False)
    assert len(solver.losses) == 20 and np.isfinite(solver.losses).all()


def test_short_fit_lowers_the_loss_and_reuses_adam():
    pde, kw = _poisson(tpdt)
    solver = tpdt.Solver(pde, device="cpu", **kw)
    with pytest.raises(ValueError, match="previous fit"):
        solver.fit(niters=1, batch_size=10, optimizer=None)
    solver.fit(batch_size=100, niters=300, progress=False, chunk_size=128)
    losses = np.asarray(solver.losses)
    assert losses.shape == (300,) and np.isfinite(losses).all()
    assert losses[-20:].mean() < 0.1 * losses[:20].mean()
    count = float(solver._opt_state["count"])
    solver.fit(batch_size=100, niters=5, optimizer=None, progress=False)
    assert float(solver._opt_state["count"]) == count + 5
    assert len(solver.losses) == 305


def test_reshape_and_concat_matches_jax():
    inputs = [np.linspace(0, 1, 6), 0.5, [1, 2, 3, 4, 5, 6]]
    np.testing.assert_array_equal(
        tpdt.Solver.reshape_and_concat(inputs),
        jpdt.Solver.reshape_and_concat(inputs))
    quirk = [np.arange(4.0), np.array([7.0, 8.0])]   # tiled from 1st element
    np.testing.assert_array_equal(
        tpdt.Solver.reshape_and_concat(quirk),
        jpdt.Solver.reshape_and_concat(quirk))


def test_default_sampler_ignores_domain():
    # Reference quirk kept: U(0, 1) per column whatever the domain.
    pde, kw = _poisson(tpdt)
    kw = dict(kw, domain=(2, 3))
    solver = tpdt.Solver(pde, device="cpu", **kw)
    pts = solver._sample(None, 3, 50)
    assert pts.shape == (3, 50, 2)
    assert float(pts.min()) >= 0.0 and float(pts.max()) < 1.0


def test_unported_options_raise():
    pde, kw = _poisson(tpdt)
    # The model options are ported: periodic=True on this Dirichlet problem
    # raises pydens_tpu's ValueError, and a periodic x builds and plans.
    for pkg, extra in ((tpdt, dict(device="cpu")), (jpdt, {})):
        with pytest.raises(ValueError, match="no effect"):
            pkg.Solver(_poisson(pkg)[0], periodic=True, **extra, **kw)
    assert tpdt.Solver(pde, device="cpu", periodic=(0,), **kw)._plan_ok
    # pydens_tpu.Solver's mesh: its default is taken, another value names
    # its item.  n_models is ported: an ensemble builds with its members on
    # every leaf, and a count that is not an int >= 1 raises.  Both
    # formulations are ported, and any other raises pydens_tpu's
    # ValueError.
    with pytest.raises(NotImplementedError, match="mesh.*Queue 1 item 15"):
        tpdt.Solver(pde, device="cpu", mesh=object(), **kw)
    ens = tpdt.Solver(pde, device="cpu", n_models=2, **kw)
    assert ens._plan_ok and ens.params["net"]["fc1"]["w"].shape[0] == 2
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="n_models"):
            tpdt.Solver(pde, device="cpu", n_models=bad, **kw)
    assert tpdt.Solver(pde, device="cpu", formulation="residual",
                       n_models=1, mesh=None, **kw)._plan_ok
    assert tpdt.Solver(pde, device="cpu", formulation="variational",
                       **kw).formulation == "variational"
    for pkg in (tpdt, jpdt):
        with pytest.raises(ValueError, match="formulation"):
            pkg.Solver(pde, formulation="weak",
                       **(dict(device="cpu") if pkg is tpdt else {}), **kw)
    # The finishers are ported: the registry builds them and a fit runs.
    solver = tpdt.Solver(pde, device="cpu", **kw)
    solver.fit(niters=1, batch_size=4, optimizer="LBFGS", resample=False,
               progress=False)
    with pytest.raises(ValueError, match="MSE"):
        solver.fit(niters=1, batch_size=4, optimizer="LM",
                   criterion="L1Loss", progress=False)
    # The collocation options are ported: an invalid one raises
    # pydens_tpu's ValueError.
    with pytest.raises(ValueError, match=">= 2"):
        tpdt.Solver(pde, device="cpu", **kw).fit(niters=1, batch_size=4,
                                                 adaptive=1)
    with pytest.raises(TypeError, match="weight_decay"):
        tpdt.Solver(pde, device="cpu", **kw).fit(niters=1, batch_size=4,
                                                 weight_decay=0.1)


@pytest.mark.parametrize("name", ["MSELoss", "L1Loss", "HuberLoss",
                                  "SmoothL1Loss"])
def test_criteria_match_jax(name):
    from pydens_tpu.utils.criteria import resolve_criterion as jresolve
    from pydens_tpu_torch.utils.criteria import resolve_criterion
    a = np.random.default_rng(0).normal(scale=2.0, size=(64, 1))
    a = a.astype(np.float32)
    ref = float(jresolve(name)[0](jnp.asarray(a), jnp.zeros((64, 1))))
    out = float(resolve_criterion(name)[0](torch.from_numpy(a),
                                           torch.zeros(64, 1)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert resolve_criterion(torch.nn.MSELoss())[1] == "mseloss"


def test_numpy_ufuncs_stay_symbolic():
    # np.* math on the coordinate symbols (the reference mixes np and torch
    # freely): same loss as the pdt.* spelling, plan and nested gradients.
    def pde_np(f, x):
        return tpdt.D(f, x) - 2 * np.pi * np.cos(2 * np.pi * x)

    pde, kw = _ode_ic(tpdt)
    pts = _points(50, 1, seed=5)
    a = tpdt.Solver(pde, device="cpu", **kw)
    b = tpdt.Solver(pde_np, device="cpu", **kw)
    for use_plan in (True, False):
        np.testing.assert_allclose(
            _torch_value_and_grad(b, pts, use_plan)[0],
            _torch_value_and_grad(a, pts, use_plan)[0], rtol=1e-6)


def test_device_none_means_the_card(monkeypatch):
    # Without a device the port runs on the CUDA card: on a machine without
    # one, Solver and ConvBlockModel raise and say how to ask for the CPU;
    # with device="cpu" they build there.
    from pydens_tpu_torch.models import ConvBlockModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pde, kw = _poisson(tpdt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpdt.Solver(pde, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConvBlockModel(ndims=1)
    assert tpdt.Solver(pde, device="cpu", **kw).device.type == "cpu"
    assert ConvBlockModel(ndims=1, device="cpu").device.type == "cpu"

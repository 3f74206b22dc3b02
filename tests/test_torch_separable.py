"""``SeparableModel`` and the Solver's grid training in pydens_tpu_torch
against pydens_tpu: the pointwise and the grid forward agree and equal
JAX's ``apply_leaves``; grid ``D`` of orders 1 and 2 and mixed equals the
pointwise ``D`` at the same points and JAX's grid taps (forward mode: the
reverse-mode gradient of the sum would sum over the other grid axes); one
step's loss and gradient on a fixed grid batch (Poisson, the periodic heat
IC, causal weighting, a parametric axis, an ensemble) equal JAX's, by
nested ``D`` and by the fit's planned route (the grid taps on jets,
forward mode: no ``autograd.grad`` while the loss is built); the
grid-shape probe; the validation and refusal messages; ``predict_grid`` on
a separable ensemble and its pointwise fallback; a checkpoint round trip;
short fits through every optimizer kind."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu.ops.tokens import EvalContext as JaxContext
from pydens_tpu.ops.tokens import Expr as JaxExpr
from pydens_tpu.ops.tokens import variable_scope as jax_scope
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.ops.tokens import EvalContext, Expr, variable_scope
from pydens_tpu_torch.utils.criteria import mse_loss

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _poisson(pdt):
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
            + 2 * np.pi ** 2 * pdt.sin(np.pi * x) * pdt.sin(np.pi * y),
            dict(ndims=2, boundary_condition=0.0, layout="fa fa f",
                 features=[12, 12, 8], activation="Tanh"))


def _bc_callable(pdt):
    # tests/test_separable.py's pointwise == grid case.
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y) - f,
            dict(ndims=2, boundary_condition=lambda x, y: x + 2 * y,
                 layout="fa f", features=[16, 8]))


def _heat_periodic(pdt):
    return (lambda f, x, t: pdt.D(f, t) - 0.25 * pdt.D(pdt.D(f, x), x),
            dict(ndims=2, domain=[(0, 1), (0, 1)],
                 initial_condition=lambda x: pdt.sin(2 * np.pi * x),
                 periodic=(0,), layout="fa fa f", features=[12, 12, 8],
                 activation="Tanh"))


def _wave(pdt):
    # examples/27 at a narrow width: three axes, both initial conditions.
    return (lambda f, x, y, t: pdt.D(pdt.D(f, t), t) - pdt.D(pdt.D(f, x), x)
            - pdt.D(pdt.D(f, y), y),
            dict(ndims=3, boundary_condition=0.0,
                 initial_condition=lambda x, y: pdt.sin(np.pi * x)
                 * pdt.sin(np.pi * y), initial_condition_t=0.0,
                 layout="fa f", features=[10, 6], activation="Tanh"))


def _allen_cahn(pdt):
    # examples/28 at a narrow width: harmonics, another domain, a cubic.
    return (lambda f, x, t: pdt.D(f, t) - 1e-4 * pdt.D(pdt.D(f, x), x)
            - 5.0 * (f - f ** 3),
            dict(ndims=2, domain=[(-1, 1), (0, 1)],
                 initial_condition=lambda x: x ** 2 * pdt.cos(np.pi * x),
                 periodic={0: 3}, periodic_ic_decay=False,
                 layout="fa fa f", features=[12, 12, 8], activation="Tanh"))


def _system(pdt):
    def good(f, x, t):
        u, v = f[..., 0:1], f[..., 1:2]
        return (pdt.D(u, t) - v, pdt.D(v, t) + u)
    return good, dict(ndims=2, n_out=2, initial_condition=np.array([0.0, 1.0]),
                      layout="fa f", features=[16, 8])


def _parametric(pdt):
    return (lambda f, x, e: pdt.D(f, x) - e,
            dict(ndims=1, nparams=1, initial_condition=0.0,
                 layout="fa fa f", features=[12, 12, 8], activation="Tanh"))


def _v_token(pdt):
    return (lambda f, x, y: pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
            - pdt.V("a", 2.0) * x,
            dict(ndims=2, boundary_condition=0.0, layout="fa f",
                 features=[12, 6]))


def _poisson_neumann(pdt):
    # Poisson with a constraint that takes D of the forward closure on a
    # coordinate expression (a Neumann line at y = 0.5, on grid leaves).
    eq, kw = _poisson(pdt)
    return eq, dict(kw, constraints=(
        lambda fwd, x, y: pdt.D(fwd(x, 0.0 * y + 0.5), x) - 1.0,))


CASES = {"poisson": _poisson, "poisson_neumann": _poisson_neumann,
         "bc_callable": _bc_callable,
         "heat_periodic": _heat_periodic, "wave": _wave,
         "allen_cahn": _allen_cahn, "system": _system,
         "parametric": _parametric, "v_token": _v_token}


@functools.lru_cache(maxsize=None)
def _jax_solver(name, n_models=1, seed=0):
    jeq, jkw = CASES[name](jpdt)
    return jpdt.Solver(jeq, model=jpdt.SeparableModel, seed=seed,
                       n_models=n_models, **jkw)


def _pair(name, n_models=1, seed=0):
    """The JAX and the port's separable Solver of a case, the JAX
    parameters copied into the port (the JAX solver is shared: no test
    changes it)."""
    js = _jax_solver(name, n_models, seed)
    teq, tkw = CASES[name](tpdt)
    ts = tpdt.Solver(teq, model=tpdt.SeparableModel, seed=seed,
                     n_models=n_models, device="cpu", **tkw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _axes(ts, n, seed=5):
    """One sorted sample of ``n`` points per axis inside the domain
    (parameter axes in [0, 1])."""
    dom = list(ts.model.domain) + [(0.0, 1.0)] * ts.model.nparams
    rng = np.random.default_rng(seed)
    return [np.sort(rng.uniform(lo, hi, n)).astype(np.float32)
            for lo, hi in dom]


def _torch_leaves(axes, grad=False):
    total = len(axes)
    return [torch.from_numpy(a.copy()).reshape(
        (1,) * k + (-1,) + (1,) * (total - k)).requires_grad_(grad)
        for k, a in enumerate(axes)]


def _jax_leaves(axes):
    total = len(axes)
    return [jnp.asarray(a).reshape((1,) * k + (-1,) + (1,) * (total - k))
            for k, a in enumerate(axes)]


def _mesh(axes):
    return np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                    axis=1)


GRID_CASES = ["bc_callable", "heat_periodic", "wave", "allen_cahn",
              "system", "parametric"]


@pytest.mark.parametrize("name", GRID_CASES)
def test_pointwise_equals_grid_forward(name):
    # The same parameters on two paths (the per-point product and the
    # factorized einsum with the grid ansatz) agree, as predict_grid does;
    # pins anzatc_grid to Model.anzatc.
    _, ts = _pair(name)
    axes = _axes(ts, 5)
    with torch.no_grad():
        grid = ts.model.apply_leaves(ts.model.params,
                                     _torch_leaves(axes)).numpy()
    shape = tuple(a.size for a in axes) + (grid.shape[-1],)
    pw = ts.predict(_mesh(axes)).reshape(shape)
    np.testing.assert_allclose(grid, pw, atol=1e-5)
    np.testing.assert_allclose(ts.predict_grid(*axes), pw, atol=1e-5)


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_forward_matches_jax(name):
    # apply_leaves on broadcast-shaped leaves equals JAX's at the same
    # parameters (values rtol/atol 2e-5).
    js, ts = _pair(name)
    axes = _axes(ts, 6)
    with torch.no_grad():
        got = ts.model.apply_leaves(ts.model.params, _torch_leaves(axes))
    ref = js.model.apply_leaves(js.model.params, _jax_leaves(axes))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VALUE_TOL)


def _port_taps(ts, leaves, derivs):
    params = ts.model.params
    with variable_scope("read", params["variables"]):
        ctx = EvalContext(leaves)
        f = Expr(lambda: ts.model.apply_leaves(params, ctx.leaves), ctx,
                 deriv=())
        coords = [Expr((lambda k: lambda: ctx.leaves[k])(k), ctx,
                       leaf_index=k) for k in range(len(leaves))]
        out = []
        for mi in derivs:
            e = f
            for k in mi:
                e = tpdt.D(e, coords[k])
            out.append(e.value.detach().numpy())
    return out


def _jax_taps(js, leaves, derivs):
    params = js.model.params
    with jax_scope("read", params["variables"]):
        ctx = JaxContext(leaves)
        f = JaxExpr(lambda ls: js.model.apply_leaves(params, ls), ctx,
                    deriv=())
        coords = [JaxExpr((lambda k: lambda ls: ls[k])(k), ctx, leaf_index=k)
                  for k in range(len(leaves))]
        out = []
        for mi in derivs:
            e = f
            for k in mi:
                e = jpdt.D(e, coords[k])
            out.append(np.asarray(e.value))
    return out


@pytest.mark.parametrize("name", ["bc_callable", "heat_periodic", "wave",
                                  "allen_cahn", "system"])
def test_grid_derivatives_match_pointwise_and_jax(name):
    # D of order 1 and 2 and mixed on the grid: each tap equals the
    # pointwise D at the grid's points and JAX's grid tap (rtol/atol
    # 2e-5).  Under a reverse-mode D on the grid leaves (the gradient of
    # y.sum()) every tap would be summed over the other grid axes.
    js, ts = _pair(name)
    total = ts.model.total
    derivs = [(0,), (1,), (0, 0), (1, 1), (0, 1)]
    if total == 3:
        derivs += [(2,), (2, 2), (0, 2)]
    axes = _axes(ts, 4)
    got = _port_taps(ts, _torch_leaves(axes, grad=True), derivs)
    pts = _mesh(axes)
    pointwise = _port_taps(ts, [torch.from_numpy(pts[:, k:k + 1].copy())
                                .requires_grad_(True) for k in range(total)],
                           derivs)
    ref = _jax_taps(js, _jax_leaves(axes), derivs)
    for mi, g, p, r in zip(derivs, got, pointwise, ref):
        np.testing.assert_allclose(g.reshape(p.shape), p, **VALUE_TOL,
                                   err_msg=str(mi))
        np.testing.assert_allclose(g, r, **VALUE_TOL, err_msg=str(mi))


def _jax_grid_loss(js, terms, pts, causal=None, eps=None):
    jloss_fn, *_ = js._build_loss_fn(terms, lambda a, b: jnp.mean((a - b) ** 2),
                                     use_plan=False, causal=causal)
    leaves = _jax_leaves([pts[:, k] for k in range(pts.shape[1])])
    args = (None, None, None if eps is None else jnp.float32(eps))
    fn = jax.value_and_grad(lambda p: jloss_fn(p, leaves, *args))
    return jax.jit(jax.vmap(fn) if js.n_models > 1 else fn)(js.model.params)


def _flat(tree, n_models=1):
    leaves = jax.tree.leaves(tree)
    if n_models == 1:
        return np.concatenate([np.ravel(np.asarray(g)) for g in leaves])
    return np.concatenate([np.asarray(g).reshape(n_models, -1)
                           for g in leaves], axis=1)


STEP_CASES = {
    "poisson": ("poisson", None, None, 1),
    "heat_periodic": ("heat_periodic", None, None, 1),
    "wave": ("wave", None, None, 1),
    "system": ("system", None, None, 1),
    "parametric": ("parametric", None, None, 1),
    "v_token": ("v_token", None, None, 1),
    "causal_eps5": ("heat_periodic", (1, 0.0, 1.0), 5.0, 1),
    "allen_cahn_causal": ("allen_cahn", (1, 0.0, 1.0), 20.0, 1),
    "ensemble": ("poisson", None, None, 2),
    "ensemble_causal": ("heat_periodic", (1, 0.0, 1.0), 5.0, 2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_loss_and_grads_match_jax(case):
    # A fixed grid batch (12 unsorted samples per axis, the grid of their
    # columns): the loss at rtol 2e-5 and the gradient at rtol 2e-3 / atol
    # 2e-5 against JAX's grid loss (an ensemble's per member, against
    # jax.vmap); causal weighting by exact time slices.
    name, causal, eps, k = STEP_CASES[case]
    js, ts = _pair(name, n_models=k)
    pts = np.random.default_rng(11).uniform(
        size=(12, ts.model.total)).astype(np.float32)
    dom = list(ts.model.domain) + [(0.0, 1.0)] * ts.model.nparams
    lo = np.asarray([d[0] for d in dom], np.float32)
    pts = lo + np.asarray([d[1] - d[0] for d in dom], np.float32) * pts
    terms = (("equation", 1.0),)
    jl, jg = _jax_grid_loss(js, terms, pts, causal, eps)
    loss_fn = ts._build_loss_fn(terms, mse_loss, causal=causal)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts),
                   causal_eps=None if eps is None else torch.tensor(eps))
    grad, = torch.autograd.grad(loss.sum(), theta)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), _flat(jg, k), **GRAD_TOL)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_planned_grid_step_composes_in_forward_mode(case, monkeypatch):
    # The fit's route on the grid (use_plan: SeparableModel.grid_taps, the
    # grid forward and ansatz on jets) calls no torch.autograd.grad or
    # backward while it builds the loss (a spy on both), so no tap depends
    # on the order in which the engine runs nodes; its loss and gradient
    # equal JAX's at the tolerances of the nested route's test above.
    name, causal, eps, k = STEP_CASES[case]
    js, ts = _pair(name, n_models=k)
    assert ts._grid_plan_ok and not ts._plan_ok
    pts = np.random.default_rng(11).uniform(
        size=(12, ts.model.total)).astype(np.float32)
    dom = list(ts.model.domain) + [(0.0, 1.0)] * ts.model.nparams
    lo = np.asarray([d[0] for d in dom], np.float32)
    pts = lo + np.asarray([d[1] - d[0] for d in dom], np.float32) * pts
    terms = (("equation", 1.0),)
    jl, jg = _jax_grid_loss(js, terms, pts, causal, eps)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True,
                                causal=causal)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    calls = []
    for fn in ("grad", "backward"):
        real = getattr(torch.autograd, fn)
        monkeypatch.setattr(torch.autograd, fn, lambda *a, real=real,
                            fn=fn, **kw: calls.append(fn) or real(*a, **kw))
    loss = loss_fn(theta, torch.from_numpy(pts),
                   causal_eps=None if eps is None else torch.tensor(eps))
    assert calls == []
    monkeypatch.undo()
    grad, = torch.autograd.grad(loss.sum(), theta)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), _flat(jg, k), **GRAD_TOL)


@pytest.mark.parametrize("use_plan", [False, True])
def test_grid_step_with_a_constraint_d_matches_jax(use_plan):
    # A constraint's D on a coordinate expression differentiates the grid
    # leaves (a planned fit's equation reads its taps from the jets, its
    # constraints do not): the leaves require grad on both routes.  The
    # loss and gradient against JAX's at the tolerances above, and a short
    # fit on the route fit() picks.
    js, ts = _pair("poisson_neumann")
    assert ts._grid_plan_ok
    pts = np.random.default_rng(11).uniform(size=(12, 2)).astype(np.float32)
    terms = (("equation", 1.0), ("constraint_0", 3.0))
    jl, jg = _jax_grid_loss(js, terms, pts)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=use_plan)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts))
    grad, = torch.autograd.grad(loss.sum(), theta)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), _flat(jg), **GRAD_TOL)
    ts.fit(niters=3, batch_size=8, loss_terms=dict(terms),
           fast_taps="auto" if use_plan else False, progress=False)
    assert np.isfinite(ts.losses).all() and len(ts.losses) == 3


@pytest.mark.parametrize("name", ["heat_periodic", "allen_cahn"])
def test_causal_eps_zero_is_the_plain_grid_mse(name):
    # The self-normalized slice weighting at eps = 0 is the plain MSE on
    # the grid (rtol 1e-6), as pydens_tpu's fits agree at eps 0.
    _, ts = _pair(name)
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(10, 2)).astype(np.float32))
    terms = (("equation", 1.0),)
    plain = ts._build_loss_fn(terms, mse_loss)
    theta = plain.spec.flatten(ts.model.params).detach()
    causal = ts._build_loss_fn(terms, mse_loss, causal=(1, 0.0, 1.0))
    np.testing.assert_allclose(
        float(causal(theta, pts, causal_eps=torch.tensor(0.0)).detach()),
        float(plain(theta, pts).detach()), rtol=1e-6)


def test_grid_probe_rejects_a_collapsed_axis():
    # f[..., k] builds and trains; the pointwise f[:, k] collapses a grid
    # axis and is rejected at construction with JAX's message.
    _, ts = _pair("system")
    ts.fit(niters=3, batch_size=8, progress=False)
    assert np.isfinite(ts.losses).all()

    def bad(pdt):
        def system(f, x, t):
            u, v = f[:, 0:1], f[:, 1:2]
            return (pdt.D(u, t) - v, pdt.D(v, t) + u)
        return system

    msgs = []
    for pdt, kw in ((jpdt, {}), (tpdt, dict(device="cpu"))):
        with pytest.raises(ValueError, match=r"f\[\.\.\., k") as err:
            pdt.Solver(bad(pdt), ndims=2, model=pdt.SeparableModel, n_out=2,
                       initial_condition=np.array([0.0, 1.0]),
                       layout="fa f", features=[16, 8], seed=0, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


REFUSALS = {
    "adaptive": ("fit", dict(niters=1, batch_size=8, adaptive=4)),
    "rba": ("fit", dict(niters=1, batch_size=8, resample=False, rba=True)),
    "fourier_features": ("build", dict(fourier_features=8)),
    "arch": ("build", dict(arch="modified")),
    "branch_tokens": ("build", dict(layout="fa B f .")),
    "branches": ("build", dict(branches=[None])),
    "rank": ("build", dict(features=[8, 0])),
    "periodic_bc": ("build", dict(periodic=True, boundary_condition=0.0)),
    "adaptive_activation": ("build", dict(layout="f f",
                                          adaptive_activation=5.0)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_validation_and_refusals_match_jax(case):
    # Each invalid configuration raises ValueError with the same message
    # in both packages (pydens_tpu/models/separable.py:58-145,
    # pydens_tpu/solver.py:1862-1874).
    kind, kw = REFUSALS[case]
    msgs = []
    for pdt, dev in ((jpdt, {}), (tpdt, dict(device="cpu"))):
        eq, base = _poisson(pdt)
        base = dict(base, layout="fa f", features=[8, 4])
        with pytest.raises(ValueError) as err:
            if kind == "build":
                pdt.Solver(eq, model=pdt.SeparableModel, seed=0,
                           **dict(base, **kw), **dev)
            else:
                s = pdt.Solver(eq, model=pdt.SeparableModel, seed=0,
                               **base, **dev)
                s.fit(progress=False, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1], msgs


def test_ensemble_predict_grid_matches_jax():
    # K = 2: predict_grid (the factorized path, no bucket padding) is the
    # member mean and equals JAX's; predict_all's members differ.
    js, ts = _pair("poisson", n_models=2)
    axes = [np.linspace(0, 1, 9, dtype=np.float32),
            np.linspace(0, 1, 7, dtype=np.float32)]
    got = ts.predict_grid(*axes)
    assert got.shape == (9, 7, 1)
    np.testing.assert_allclose(got, js.predict_grid(*axes), **VALUE_TOL)
    pw = ts.predict_all(_mesh(axes))
    assert not np.allclose(pw[0], pw[1])
    np.testing.assert_allclose(got.reshape(-1, 1), pw.mean(0), **VALUE_TOL)
    with pytest.raises(ValueError, match="one 1-D array per input column"):
        ts.predict_grid(axes[0])


def test_predict_grid_pointwise_fallback_matches_jax():
    # A pointwise model takes meshgrid + predict, with the same contract.
    kw = dict(ndims=2, boundary_condition=0.5, layout="fa f",
              features=[8, 1], activation="Tanh")
    js = jpdt.Solver(lambda f, x, y: jpdt.D(f, x) - 1.0, seed=0, **kw)
    ts = tpdt.Solver(lambda f, x, y: tpdt.D(f, x) - 1.0, seed=0,
                     device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    xs, ys = np.linspace(0, 1, 5), np.linspace(0, 1, 3)
    out = ts.predict_grid(xs, ys)
    assert out.shape == (5, 3, 1)
    np.testing.assert_allclose(out.reshape(-1, 1),
                               ts.predict(_mesh([xs, ys])), rtol=1e-6)
    np.testing.assert_allclose(out, js.predict_grid(xs, ys), **VALUE_TOL)


def test_checkpoint_round_trip(tmp_path):
    # Saved after a fit and loaded into a solver of another seed: its
    # predictions on the grid and pointwise equal bit for bit.
    _, ts = _pair("poisson")
    ts.fit(niters=5, batch_size=8, progress=False)
    path = str(tmp_path / "sep.npz")
    ts.save(path)
    teq, tkw = _poisson(tpdt)
    ts2 = tpdt.Solver(teq, model=tpdt.SeparableModel, seed=7, device="cpu",
                      **tkw)
    ts2.load(path)
    xs = np.linspace(0, 1, 9)
    np.testing.assert_array_equal(ts2.predict(xs, xs), ts.predict(xs, xs))
    np.testing.assert_array_equal(ts2.predict_grid(xs, xs),
                                  ts.predict_grid(xs, xs))


def test_fits_on_the_grid():
    # Short fits through each step kind on the grid, all finite: Adam with
    # a V token, a fixed batch (resample=False), L-BFGS and LM on it, and
    # a causal fit whose eps changes between fits (one cached step).
    _, ts = _pair("v_token")
    ts.fit(niters=4, batch_size=8, progress=False)
    ts.fit(niters=3, batch_size=8, resample=False, optimizer="LBFGS",
           progress=False)
    ts.fit(niters=2, batch_size=8, resample=False, optimizer="LM",
           cg_iters=4, progress=False)
    assert np.isfinite(ts.losses).all() and len(ts.losses) == 9
    assert "a" in ts.params["variables"]
    _, tc = _pair("heat_periodic")
    for eps in (1.0, 5.0):
        tc.fit(niters=3, batch_size=8, causal=eps, progress=False)
    assert len(tc._step_cache) == 1 and np.isfinite(tc.losses).all()


def test_default_sampler_draws_the_declared_domain():
    # batch_size is points per axis; the default sampler draws each axis
    # over its domain (no U(0, 1) quirk), parameter columns U(0, 1).
    _, ts = _pair("allen_cahn")
    pts = ts._sample(None, 2, 400).numpy()
    assert pts.shape == (2, 400, 2)
    assert pts[..., 0].min() < -0.9 and pts[..., 0].max() > 0.9
    assert pts[..., 0].min() >= -1 and pts[..., 1].min() >= 0
    _, tp = _pair("parametric")
    pts = tp._sample(None, 1, 400).numpy()
    assert 0 <= pts.min() and pts.max() <= 1

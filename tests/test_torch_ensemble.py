"""Ensembles (Solver(n_models=K)) of pydens_tpu_torch against pydens_tpu
at K = 3 on narrow chains: the stacked theta is carried across from the JAX
solver (params_from_jax on a stacked tree) and the points come from a
numpy seed.  Per-member losses and the (K, P) gradient, member
independence, an ensemble of one, the member-axis plain traversal of every
model option, the predicts and residual, V per member, freezing, reset and
checkpoints (the steps: tests/test_torch_ensemble_steps.py).  Tolerances
are the single-model parity tests': losses rtol 2e-5, gradients rtol 2e-3
/ atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu_torch as tpdt
from ensemble_cases import (GRAD_TOL, INVERSE_TERMS, K, LOSS_RTOL, WORKLOADS,
                            _heat, _inverse, _jax_members, _ode, _pair,
                            _points, _poisson, _port_members)
from pydens_tpu_torch.utils.criteria import mse_loss


LOSS_CASES = {
    "ode_plan": ("ode", (("equation", 1.0),), True),
    "ode_nested": ("ode", (("equation", 1.0),), False),
    "poisson_plan": ("poisson", (("equation", 1.0),), True),
    "inverse_constraint": ("inverse", INVERSE_TERMS, True),
    "system": ("system", (("equation", 1.0),), True),
    "variational": ("ritz", (("equation", 1.0),), True),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_member_losses_and_gradient_match_jax(case):
    # Fixed 64 points, the JAX members' theta: each member's loss (rtol
    # 2e-5), their mean (the recorded loss) and the (K, P) gradient of
    # their sum, one member a row (rtol 2e-3 / atol 2e-5), on the plan
    # (the Taylor kernels' plain version with the member axis), on nested
    # gradients (each member's derivative leaves its own rows), with a
    # constraint and V per member, for a system and for a Deep Ritz
    # energy (each member's mean).
    name, terms, plan = LOSS_CASES[case]
    js, ts = _pair(WORKLOADS[name])
    pts = _points(64, ts.model.total)
    jl, jg = _jax_members(js, terms, pts, plan)
    tl, tg, _, _ = _port_members(ts, terms, pts, plan)
    assert tl.shape == (K,) and tg.shape == jg.shape == (K, tg.shape[1])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl.mean(), jl.mean(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)
    assert len({float(v) for v in tl}) == K      # the members differ


def test_members_are_independent():
    # Perturbing member 0's parameters leaves member 1's and 2's losses and
    # gradients bitwise unchanged (plan and nested paths).
    _, ts = _pair(_inverse)
    pts = torch.from_numpy(_points(48, 1))
    for plan in (True, False):
        loss_fn = ts._build_loss_fn(INVERSE_TERMS, mse_loss, use_plan=plan)
        theta = loss_fn.spec.flatten(ts.model.params).detach()
        out = []
        for th in (theta, theta.clone().index_add_(
                0, torch.tensor([0]), 0.01 * torch.ones_like(theta[:1]))):
            th = th.requires_grad_()
            loss = loss_fn(th, pts)
            grad, = torch.autograd.grad(loss.sum(), th)
            out.append((loss.detach(), grad))
        (l0, g0), (l1, g1) = out
        assert l0[0] != l1[0]
        assert torch.equal(l0[1:], l1[1:]) and torch.equal(g0[1:], g1[1:])


def test_each_member_is_the_single_model_on_its_parameters():
    # Member k's loss and gradient equal a single model's holding member
    # k's parameters (rtol 2e-5 / the gradients' tolerance: batched and
    # unbatched products), and n_models=1 is today's single model: the
    # same parameters, losses and theta, bit for bit, after a short fit.
    _, ts = _pair(_ode)
    pts = _points(64, 1)
    tl, tg, loss_fn, theta = _port_members(ts, (("equation", 1.0),), pts)
    eq = _ode(tpdt).pop("equation")
    kw = {k: v for k, v in _ode(tpdt).items() if k != "equation"}
    one = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    spec1 = one._spec()
    for k in range(K):
        one.model.load_params(spec1.unflatten(theta[k].detach()))
        l1, g1, _, _ = _port_members(one, (("equation", 1.0),), pts)
        np.testing.assert_allclose(tl[k], l1, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tg[k], g1, **GRAD_TOL)
    a = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    b = tpdt.Solver(eq, seed=0, device="cpu", n_models=1, **kw)
    for s in (a, b):
        s.fit(niters=15, batch_size=64, lr=0.02, progress=False)
    assert a.losses == b.losses
    assert torch.equal(a._spec().flatten(a.model.params),
                       b._spec().flatten(b.model.params))


OPTIONS = {
    "periodic": dict(periodic={0: 2}, initial_condition=0.5),
    "fourier": dict(fourier_features=(4, 1.0), initial_condition=0.5),
    "modified": dict(arch="modified", layout="fafaf", features=[6, 6, 1],
                     initial_condition=0.5),
    "laaf": dict(adaptive_activation=5.0, initial_condition=0.5),
    "branch": dict(layout="fa B f .", features=[6, 1],
                   branches=[dict(layout="fa f", features=[4, 1])],
                   initial_condition=0.5),
}


def _wave_like(pdt):
    return dict(equation=lambda f, x, t: pdt.D(f, t) + pdt.D(f, x)
                - 0.05 * pdt.D(pdt.D(f, x), x),
                ndims=2, layout="fa fa f", features=[6, 6, 1],
                activation="Tanh")


@pytest.mark.parametrize("option", list(OPTIONS))
def test_model_option_traversal_with_members_matches_jax(option):
    # The member-axis plain traversal of each model option that JAX vmaps
    # (periodic, Fourier features, the modified MLP, LAAF, a branch with a
    # concatenation join): per-member losses and the (K, P) gradient at 48
    # points against jax.vmap, the tolerances above; predict_all too.
    js, ts = _pair(_wave_like, **OPTIONS[option])
    pts = _points(48, 2, seed=11)
    terms = (("equation", 1.0),)
    jl, jg = _jax_members(js, terms, pts)
    tl, tg, _, _ = _port_members(ts, terms, pts)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)
    xs = _points(20, 2, seed=12)
    np.testing.assert_allclose(ts.predict_all(xs), js.predict_all(xs),
                               rtol=2e-5, atol=2e-6)


def test_predicts_and_residual_match_jax():
    # predict (the member mean), predict_all (K, N, n_out), predict_std
    # (ddof 0) and residual (the member mean) against pydens_tpu from the
    # same members: rtol 2e-5 / atol 2e-6 (residual atol 1e-5); one model's
    # predict_all is (1, N, n_out) and its predict_std raises JAX's
    # ValueError.
    js, ts = _pair(_poisson)
    xs = _points(50, 2, seed=13)
    tol = dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ts.predict(xs), js.predict(xs), **tol)
    allp = ts.predict_all(xs)
    assert allp.shape == (K, 50, 1)
    np.testing.assert_allclose(allp, js.predict_all(xs), **tol)
    np.testing.assert_allclose(ts.predict_std(xs), js.predict_std(xs),
                               **tol)
    np.testing.assert_allclose(ts.predict_std(xs), allp.std(0), **tol)
    np.testing.assert_allclose(ts.residual(xs), js.residual(xs), rtol=2e-5,
                               atol=1e-5)
    one_j, one_t = _pair(_poisson, n_models=1)
    assert one_t.predict_all(xs).shape == (1, 50, 1)
    for s in (one_j, one_t):
        with pytest.raises(ValueError, match="n_models"):
            s.predict_std(xs)


def test_variables_freeze_reset_and_checkpoint(tmp_path):
    # V per member (K, 1); a frozen layer stays put in every member; reset
    # redraws the members (reset(seed) as a new ensemble of that seed) and
    # clears the losses; a checkpoint of an ensemble reloads into another
    # solver's members and predicts alike; params_from_jax of a stacked
    # tree loads leaf for leaf.
    js, ts = _pair(_inverse)
    assert tuple(ts.params["variables"]["init"].shape) == (K, 1)
    for path, leaf in (("net", "fc1"), ("net", "fc2")):
        np.testing.assert_array_equal(
            ts.params[path][leaf]["w"].detach().numpy(),
            np.asarray(js.params[path][leaf]["w"]))
    np.testing.assert_array_equal(ts.params["log_scale"].detach().numpy(),
                                  np.asarray(js.params["log_scale"]))
    ts.model.freeze_trainable(layers=["fc1"])
    w = ts.params["net"]["fc1"]["w"].detach().clone()
    ts.fit(niters=20, batch_size=64, loss_terms=dict(INVERSE_TERMS),
           progress=False)
    assert torch.equal(ts.params["net"]["fc1"]["w"], w)
    assert not torch.equal(ts.params["variables"]["init"],
                           torch.full((K, 1), 0.1))
    xs = np.linspace(0, 1, 9)
    preds = ts.predict_all(xs)
    path = str(tmp_path / "ens.npz")
    ts.save(path)
    eq = _inverse(tpdt)
    other = tpdt.Solver(eq.pop("equation"), seed=7, n_models=K,
                        device="cpu", **eq)
    other.load(path)
    np.testing.assert_array_equal(other.predict_all(xs), preds)
    ts.reset(seed=5)
    assert ts.losses == [] and ts.params["net"]["fc1"]["w"].shape[0] == K
    eq = _inverse(tpdt)
    fresh = tpdt.Solver(eq.pop("equation"), seed=5, n_models=K,
                        device="cpu", **eq)
    assert torch.equal(ts._spec().flatten(ts.model.params),
                       fresh._spec().flatten(fresh.model.params))
    assert torch.equal(ts.params["variables"]["init"],
                       torch.full((K, 1), 0.1))


@pytest.mark.parametrize("make,derivs", [
    (_poisson, [(0, 0), (1, 1)]), (_heat, [(1,), (0, 0)])],
    ids=["poisson", "heat"])
def test_full_taps_composes_in_forward_mode(monkeypatch, make, derivs):
    # Model.full_taps calls no torch.autograd.grad or backward (a spy on
    # both): the ansatz composes in forward mode, so no tap depends on the
    # order in which the engine runs nodes.  Its taps, a single model's
    # and an ensemble's member-major rows, equal jax.vmap of pydens_tpu's
    # full_taps (rtol 2e-5 / atol 2e-5), and their gradient is the
    # members' own.
    js, ts = _pair(make)
    pts = _points(40, ts.model.total, seed=21)
    calls = []
    for name in ("grad", "backward"):
        real = getattr(torch.autograd, name)
        monkeypatch.setattr(torch.autograd, name, lambda *a, real=real,
                            name=name, **k: calls.append(name)
                            or real(*a, **k))
    table = ts.model.full_taps(ts.model.params, torch.from_numpy(pts),
                               derivs)
    assert calls == []
    monkeypatch.undo()
    jtable = jax.vmap(lambda p: js.model.full_taps(p, jnp.asarray(pts),
                                                   derivs))(js.model.params)
    for mi, tap in table.items():
        assert tuple(tap.shape) == (K * 40, 1)
        np.testing.assert_allclose(
            tap.detach().numpy(), np.asarray(jtable[mi]).reshape(K * 40, -1),
            rtol=2e-5, atol=2e-5)

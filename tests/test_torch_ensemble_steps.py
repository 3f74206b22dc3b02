"""Ensemble steps of pydens_tpu_torch against pydens_tpu at K = 3, from
the same stacked theta and seeded points (tests/ensemble_cases.py): one
Adam chunk, L-BFGS steps (each member its own stepsize and linesearch) and
an LM step (each member its own damping), causal weighting inside each
member's loss, the member-mean residual the adaptive pool and RBA rank,
grad balancing over the (K, P) gradient and NTK traces averaged over
members with their own probes, and short fits of every collocation option
JAX takes with an ensemble."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu_torch as tpdt
from ensemble_cases import (GRAD_TOL, INVERSE_TERMS, K, LOSS_RTOL, _Fixed,
                            _heat, _inverse, _jax_members, _jax_mse, _leaves,
                            _ode, _pair, _points, _port_members, _theta)
from pydens_tpu.solver import _flatten_stacked
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.solver import _Collocation, _FitStep
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

from one_thread import one_thread  # noqa: F401


def test_adam_chunk_matches_jax():
    # 25 Adam steps on one fixed batch of 96 points from the same theta:
    # the recorded (member-mean) losses rtol 1e-4 and theta rtol 1e-4 /
    # atol 1e-5 (f32 Adam on each member's own gradient).
    js, ts = _pair(_ode)
    pts = _points(96, 1, seed=3)
    fit = dict(niters=25, batch_size=96, lr=0.01, resample=False,
               sampler=_Fixed(pts), progress=False)
    js.fit(**fit)
    ts.fit(**fit)
    np.testing.assert_allclose(ts.losses, js.losses, rtol=1e-4)
    np.testing.assert_allclose(_theta(ts), _theta(js), rtol=1e-4, atol=1e-5)


def test_lbfgs_steps_match_jax_per_member():
    # From the JAX ensemble after 200 Adam steps, three one-step L-BFGS
    # fits on 128 fixed points: each member's stepsize and linesearch
    # count equal JAX's vmapped optax (rtol 1e-4), theta rtol 1e-4 / atol
    # 1e-5, and the members took different stepsizes.
    js, ts = _pair(_ode)
    js.fit(niters=200, batch_size=128, lr=0.02, progress=False)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    pts = _points(128, 1, seed=5)
    fit = dict(niters=1, batch_size=128, resample=False,
               sampler=_Fixed(pts), progress=False)
    steps = []
    for i in range(3):
        opt = "LBFGS" if i == 0 else None
        js.fit(optimizer=opt, **fit)
        ts.fit(optimizer=opt, **fit)
        zoom = js._opt_state[-1]
        np.testing.assert_array_equal(
            ts._opt_state["num_linesearch_steps"].numpy(),
            np.asarray(zoom.info.num_linesearch_steps))
        np.testing.assert_allclose(ts._opt_state["learning_rate"].numpy(),
                                   np.asarray(zoom.learning_rate), rtol=1e-4)
        np.testing.assert_allclose(_theta(ts), _theta(js), rtol=1e-4,
                                   atol=1e-5)
        steps.append(ts._opt_state["learning_rate"].numpy())
    np.testing.assert_allclose(ts.losses, js.losses[200:], rtol=1e-4)
    assert any(len(set(s.tolist())) > 1 for s in steps)


def test_lm_step_matches_jax_per_member():
    # One LM step from the JAX ensemble after 100 Adam steps on 128 fixed
    # points, with 5 CG iterations (f32 CG on these systems is chaotic
    # after about five, in either package: tests/test_torch_lm.py): each
    # member's step (rtol 1e-3 / atol 1e-3 max|d|), each member's (lambda,
    # nu) as JAX's (K, 2) state (rtol 1e-3), the member-mean loss (rtol
    # 2e-5).
    js, ts = _pair(_ode)
    js.fit(niters=100, batch_size=128, lr=0.02, progress=False)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    theta0 = _theta(js)
    pts = _points(128, 1, seed=5)
    fit = dict(niters=1, batch_size=128, optimizer="LM", resample=False,
               sampler=_Fixed(pts), progress=False, cg_iters=5)
    js.fit(**fit)
    ts.fit(**fit)
    jd, td = theta0 - _theta(js), theta0 - _theta(ts)
    assert np.abs(jd).max() > 0
    np.testing.assert_allclose(td, jd, rtol=1e-3,
                               atol=1e-3 * np.abs(jd).max())
    assert tuple(ts._opt_state["damping"].shape) == np.shape(js._opt_state)
    np.testing.assert_allclose(ts._opt_state["damping"].numpy(),
                               np.asarray(js._opt_state), rtol=1e-3)
    np.testing.assert_allclose(ts.losses[-1], js.losses[-1], rtol=2e-5)


def test_causal_and_point_residual_match_jax():
    # Causal weighting inside each member's loss (eps 5, the time column's
    # 32 bins of the member's own residual), and the member-mean
    # |residual| that the adaptive pool and RBA rank, against
    # jax.vmap(...).mean(0): rtol 2e-5 (residual atol 1e-6).
    js, ts = _pair(_heat)
    pts = _points(96, 2, seed=9)
    terms = (("equation", 1.0),)
    causal = (1, 0.0, 1.0)
    jl, jg = _jax_members(js, terms, pts, causal=causal, eps=5.0)
    tl, tg, loss_fn, theta = _port_members(ts, terms, pts, causal=causal,
                                           eps=5.0)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)
    _, jres, _ = js._build_loss_fn(terms, _jax_mse, use_plan=True)
    jr = jax.vmap(jres, in_axes=(0, None))(js.model.params,
                                           _leaves(pts)).mean(0)
    tr = loss_fn.point_residual(theta.detach(), torch.from_numpy(pts))
    assert tuple(tr.shape) == (96, 1)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr),
                               rtol=2e-5, atol=1e-6)


def _step(ts, terms, options, pts):
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True)
    step = _FitStep(loss_fn, resolve_optimizer("Adam", 0.0, {}), None,
                    loss_fn.spec.flatten(ts.model.params), 1, len(pts),
                    False, False, False, options=options,
                    generator=torch.Generator().manual_seed(0))
    step.points[0].copy_(torch.from_numpy(pts))
    return step


def test_grad_rebalance_and_ntk_traces_match_jax():
    # Grad balancing: each term's mean |gradient| over the whole (K, P)
    # gradient (JAX's vmapped one-hot gradients), the anchored EMA from
    # (1, 3): rtol 2e-3.  NTK: each member's own 4 probes on the equation
    # block and the exact basis of the constraint's block, traces averaged
    # over the members, against jax.vjp of each member: rtol 2e-3.
    js, ts = _pair(_inverse)
    pts = _points(64, 1)
    step = _step(ts, INVERSE_TERMS, _Collocation(balance_every=1), pts)
    w0 = np.array([1.0, 3.0], np.float32)
    step.wts.copy_(torch.from_numpy(w0))
    step._loss(rebalance=True)
    jloss_fn, _, jresvec = js._build_loss_fn(INVERSE_TERMS, _jax_mse,
                                             use_plan=True)
    leaves = _leaves(pts)
    norms = []
    for j in range(2):
        one_hot = jnp.zeros((2,)).at[j].set(1.0)
        g = jax.vmap(jax.grad(lambda p: jloss_fn(p, leaves, None, one_hot)))(
            js.model.params)
        norms.append(float(jnp.mean(jnp.abs(_flatten_stacked(g, K)))))
    norms = np.asarray(norms)
    lam = np.clip(norms[0] / (norms + 1e-12), 0.01, 100.0)
    lam[0] = 1.0
    np.testing.assert_allclose(step.wts.numpy(), 0.7 * w0 + 0.3 * lam,
                               rtol=2e-3)

    step = _step(ts, INVERSE_TERMS,
                 _Collocation(balance_every=1, balance_mode="ntk"), pts)
    probes = np.random.default_rng(4).choice(
        [-1.0, 1.0], size=(4, K, 64)).astype(np.float32)
    step.probes = {0: torch.from_numpy(probes)}
    residuals, values, _ = step.loss_fn.evaluate(step.theta, step.points[0])
    blocks = step.loss_fn.blocks(residuals, values)
    assert [tuple(b.shape) for b in blocks] == [(K, 64), (K, 1)]
    traces = step._ntk_traces(blocks).detach().numpy()
    expected = []
    for k in range(K):
        member = jax.tree.map(lambda t: t[k], js.model.params)
        res, pull = jax.vjp(lambda p: jresvec.term_blocks(p, leaves), member)
        eq = np.mean([float(jnp.sum(_flatten_stacked(jax.tree.map(
            lambda t: t[None], pull((jnp.asarray(u[k]),
                                     jnp.zeros_like(res[1])))[0]), 1) ** 2))
            for u in probes])
        con = float(jnp.sum(_flatten_stacked(jax.tree.map(
            lambda t: t[None], pull((jnp.zeros_like(res[0]),
                                     jnp.ones_like(res[1])))[0]), 1) ** 2))
        expected.append([eq, con])
    np.testing.assert_allclose(traces, np.mean(expected, 0), rtol=2e-3)


@pytest.mark.parametrize("kw", [
    dict(adaptive=2), dict(rba=True, resample=False), dict(causal=1.0),
    dict(loss_balancing=("grad", 5)), dict(loss_balancing=("ntk", 5))],
    ids=["adaptive", "rba", "causal", "grad", "ntk"])
def test_collocation_options_train_an_ensemble(kw):
    # Each collocation option that JAX takes with an ensemble fits one:
    # finite losses that fall over 60 steps at batch 64.
    make = _inverse if "loss_balancing" in kw else _heat
    terms = dict(INVERSE_TERMS) if "loss_balancing" in kw else "equation"
    _, ts = _pair(make)
    ts.fit(niters=60, batch_size=64, lr=0.03, loss_terms=terms,
           progress=False, **kw)
    assert np.isfinite(ts.losses).all()
    assert np.mean(ts.losses[-5:]) < np.mean(ts.losses[:5])



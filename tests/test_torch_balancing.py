"""Loss balancing and the per-step options through the port's fit step,
against pydens_tpu: one grad-norm rebalance (the weights of JAX's
``rebalance`` and ``_anchored_ema`` on the same theta, points and weights,
with and without a frozen layer), the NTK traces (exact on blocks of at
most 4 entries; with the probes fed in, ``sum |J^T u|^2`` of ``jax.vjp``
on larger ones), the rebalance window (fit-local, restarting each fit),
and short CPU fits of every option: adaptive, RBA, causal annealing on one
cached step, L-BFGS with causal and adaptive, Deep Ritz."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.solver import _Collocation, _FitStep
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

from one_thread import one_thread  # noqa: F401


LEFT = np.array([0.0], np.float32)
RIGHT = np.array([1.0], np.float32)
TERMS = (("equation", 1.0), ("constraint_0", 2.0), ("constraint_1", 0.5))


def _beam(pdt):
    # An order-2 cousin of tests/test_loss_balancing.py's mis-scaled beam:
    # its residual is O(100), its constraints pointwise (f.grad, 1 entry).
    return dict(equation=lambda f, x: pdt.D(pdt.D(f, x), x) + 100.0,
                ndims=1, boundary_condition=0, layout="fa fa f",
                features=[10, 10, 1], activation="Tanh",
                constraints=(lambda f, x: f.grad(LEFT, wrt=0) - 0.3,
                             lambda f, x: f.grad(RIGHT, wrt=0) + 0.3))


def _pair(make=_beam):
    jkw, tkw = make(jpdt), make(tpdt)
    js = jpdt.Solver(jkw.pop("equation"), seed=0, **jkw)
    ts = tpdt.Solver(tkw.pop("equation"), seed=0, device="cpu", **tkw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _points(n, seed=7):
    return np.random.default_rng(seed).uniform(size=(n, 1)).astype(
        np.float32)


def _step(ts, options, pts, mask=None):
    """A fit step of the port at ts's parameters on the fixed ``pts``."""
    loss_fn = ts._build_loss_fn(TERMS, mse_loss, use_plan=True)
    step = _FitStep(loss_fn, resolve_optimizer("Adam", 0.0, {}), mask,
                    loss_fn.spec.flatten(ts.model.params), 1, len(pts),
                    False, False, False, options=options,
                    generator=torch.Generator().manual_seed(0))
    step.points[0].copy_(torch.from_numpy(pts))
    return step


def _jax_mse(a, b):
    return jnp.mean((a - b) ** 2)


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "frozen"])
def test_grad_rebalance_matches_jax(frozen):
    # The weights after one rebalance from wts = (1, 3, 0.2): each term's
    # mean |gradient| (a one-hot term-weight gradient in JAX, masked), the
    # anchored, clipped EMA; then the step's loss with the new weights
    # (rtol 2e-5).  The weights are within rtol 2e-3 (the gradients').
    js, ts = _pair()
    pts = _points(64)
    mask = None
    if frozen:
        ts.model.freeze_trainable(layers=["fc1"])
        js.model.freeze_trainable(layers=["fc1"])
        mask = ts._flat_mask(ts._build_loss_fn(TERMS, mse_loss).spec)
    w0 = np.array([1.0, 3.0, 0.2], np.float32)
    step = _step(ts, _Collocation(balance_every=1), pts, mask)
    step.wts.copy_(torch.from_numpy(w0))
    loss = step._loss(rebalance=True)

    jloss_fn, *_ = js._build_loss_fn(TERMS, _jax_mse, use_plan=True)
    leaves = [jnp.asarray(pts)]
    flat, unravel = ravel_pytree(js.model.params)
    jmask = (np.ones(flat.shape, np.float32) if mask is None
             else mask.numpy())
    norms = []
    for j in range(3):
        one_hot = jnp.zeros((3,)).at[j].set(1.0)
        g = jax.grad(lambda th: jloss_fn(unravel(th), leaves, None,
                                         one_hot))(flat)
        norms.append(float(jnp.mean(jnp.abs(g * jmask))))
    norms = np.asarray(norms)
    lam = np.clip(norms[0] / (norms + 1e-12), 0.01, 100.0)
    lam[0] = 1.0
    expected = 0.7 * w0 + 0.3 * lam
    np.testing.assert_allclose(step.wts.numpy(), expected, rtol=2e-3)
    assert step.wts[0] == 1.0
    jl = jloss_fn(js.model.params, leaves, None, jnp.asarray(step.wts))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)


def test_ntk_traces_match_jax():
    # Blocks of 1 entry (the constraints): exact traces |d b / d theta|^2
    # against jax.jacfwd.  The equation block (64 entries) with 4 probes fed
    # in: the mean of |J^T u|^2 over them against jax.vjp with the same u.
    # rtol 2e-3 (the gradients' tolerance).
    js, ts = _pair()
    pts = _points(64)
    step = _step(ts, _Collocation(balance_every=1, balance_mode="ntk"), pts)
    probes = np.random.default_rng(4).choice(
        [-1.0, 1.0], size=(4, 64)).astype(np.float32)
    step.probes = {0: torch.from_numpy(probes)}
    loss_fn = step.loss_fn
    residuals, values, _ = loss_fn.evaluate(step.theta, step.points[0])
    traces = step._ntk_traces(loss_fn.blocks(residuals, values)).detach()

    _, _, jresvec = js._build_loss_fn(TERMS, _jax_mse, use_plan=True)
    flat, unravel = ravel_pytree(js.model.params)
    leaves = [jnp.asarray(pts)]

    def blocks(th):
        return jresvec.term_blocks(unravel(th), leaves)

    res, pull = jax.vjp(blocks, flat)
    eq = np.mean([float(jnp.sum(pull((jnp.asarray(u),
                                      jnp.zeros_like(res[1]),
                                      jnp.zeros_like(res[2])))[0] ** 2))
                  for u in probes])
    jac = jax.jacfwd(blocks)(flat)
    exact = [float(jnp.sum(j * j)) for j in jac[1:]]
    np.testing.assert_allclose(traces.numpy(), [eq] + exact, rtol=2e-3)
    assert len(step.probes) == 1    # the constraints enumerate their basis


def test_ntk_rebalance_draws_probes_and_anchors():
    # From no probes: the first rebalance makes one probe set for the
    # equation block, of +-1 entries, and the anchored weights follow.
    _, ts = _pair()
    step = _step(ts, _Collocation(balance_every=1, balance_mode="ntk"),
                 _points(64))
    step._loss(rebalance=True)
    (u,) = step.probes.values()
    assert u.shape == (4, 64) and set(u.unique().tolist()) == {-1.0, 1.0}
    w = step.wts.numpy()
    assert w[0] == 1.0 and np.all(np.isfinite(w)) and np.all(w > 0)


def test_rebalance_window_is_fit_local_and_restarts():
    # loss_balancing=5 on a 60-step fit rebalances at its steps 0, 5, ...,
    # 45 (10 steps); a second fit of the same configuration on the warm
    # solver rebalances 10 more times; a 3-step fit once, from the
    # loss_terms weights (tests/test_loss_balancing.py:61-76).
    _, ts = _pair()
    fit = dict(batch_size=32, lr=0.005, loss_terms=dict(TERMS),
               loss_balancing=5, progress=False)
    ts.fit(niters=60, **fit)
    (step,) = ts._step_cache.values()
    assert step.rebalance_eager == 10 and step.eager_steps == 50
    first = ts.history[-1]["balanced_weights"]
    assert first[0] == 1.0 and first != [1.0, 2.0, 0.5]
    ts.fit(niters=60, **fit)
    assert step.rebalance_eager == 20
    short = tpdt.Solver(**_beam(tpdt), seed=0, device="cpu")
    short.fit(niters=3, **dict(fit, chunk_size=1))
    once = short.history[-1]["balanced_weights"]
    short.fit(niters=3, **dict(fit, chunk_size=1))
    (step,) = short._step_cache.values()
    assert step.rebalance_eager == 2
    # Both fits start from loss_terms: one EMA step from (1, 2, 0.5) each,
    # which the same statistic would make equal; the second fit's theta
    # moved, so the weights are close but need not be equal.
    np.testing.assert_allclose(short.history[-1]["balanced_weights"], once,
                               rtol=0.2)


def test_causal_anneal_reuses_the_step():
    # A new eps is a buffer value: one cached step for both fits.
    def heat(f, x, t):
        return tpdt.D(f, t) - 0.1 * tpdt.D(tpdt.D(f, x), x)
    s = tpdt.Solver(heat, ndims=2, initial_condition=lambda x: tpdt.sin(
        np.pi * x), layout="fa f", features=[8, 1], device="cpu")
    s.fit(niters=20, batch_size=64, causal=5.0, progress=False)
    s.fit(niters=20, batch_size=64, causal=20.0, progress=False)
    (step,) = s._step_cache.values()
    assert float(step.causal_eps) == 20.0 and step.eager_steps == 40
    assert np.isfinite(s.losses).all() and len(s.losses) == 40


def _stiff(pdt):
    def ode(f, x):
        return pdt.D(f, x) - 100 * pdt.exp(-2000 * (x - 0.8) ** 2)
    return ode


def test_adaptive_and_rba_fits_move_the_residual(monkeypatch):
    # examples/09's stiff source and solver at 600 of its 1500 steps (CPU).
    # The adaptive fit trains on the batches its design gives: over its 600
    # steps the half picked by |residual| lies in the source's bump (|x -
    # 0.8| < 0.05, a tenth of the domain) at least twice as often as the
    # uniform half (0.313 against 0.098), and its importance weights undo
    # the pick, so that the weighted share is the domain's (0.103) and the
    # mean weight 1 (1.005).  Its mean residual on 2000 points ends below a
    # quarter of its start (0.596 of 3.975); whether it beats a uniform
    # fit at this budget is a draw of the seed in both packages
    # (tests/test_torch_adaptive_seeds.py holds the port's adaptive fits
    # to pydens_tpu's over seeds).  The RBA fit's (BENCHMARKS.md:726-738's
    # arm, batch 256) ends below half its start; its weights stay
    # positive.
    xs = np.linspace(0, 1, 2000, dtype=np.float32)
    res, seen = {}, []
    batch = _FitStep._batch

    def recorded(self):
        pts, weight = batch(self)
        seen.append((pts[:, 0].clone(), weight))
        return pts, weight

    for name, kw in (("adaptive", dict(batch_size=128, adaptive=8)),
                     ("rba", dict(batch_size=256, rba=(0.01, 0.99),
                                  resample=False))):
        s = tpdt.Solver(_stiff(tpdt), ndims=1, initial_condition=0.0,
                        activation="Tanh", layout="fafaf",
                        features=[32, 32, 1], device="cpu")
        res["start"] = float(s.residual(xs).mean())
        with monkeypatch.context() as m:
            m.setattr(_FitStep, "_batch", recorded)
            s.fit(niters=600, lr=0.01, progress=False, **kw)
        assert np.isfinite(s.losses).all() and len(s.losses) == 600
        res[name] = float(s.residual(xs).mean())
        if name == "adaptive":
            assert len(seen) == 600
            x = torch.stack([p for p, _ in seen]).numpy()
            w = torch.stack([w for _, w in seen]).numpy()
            bump = np.abs(x - 0.8) < 0.05
            share = dict(uniform=bump[:, :64].mean(),
                         picked=bump[:, 64:].mean(),
                         weighted=(w[:, 64:] * bump[:, 64:]).mean(),
                         weight=w[:, 64:].mean())
            assert np.all(w[:, :64] == 1), share
            assert abs(share["uniform"] - 0.1) < 0.01, share
            assert share["picked"] > 2 * share["uniform"], share
            assert abs(share["weighted"] - 0.1) < 0.01, share
            assert abs(share["weight"] - 1) < 0.1, share
    (step,) = s._step_cache.values()
    assert float(step.rba_w.min()) > 0
    assert res["adaptive"] < 0.25 * res["start"], res
    assert res["rba"] < 0.5 * res["start"], res


def test_rba_weights_restart_each_fit():
    s = tpdt.Solver(_stiff(tpdt), ndims=1, initial_condition=0.0,
                    layout="fa f", features=[8, 1], device="cpu")
    fit = dict(niters=5, batch_size=32, resample=False, rba=0.05,
               progress=False)
    s.fit(**fit)
    (step,) = s._step_cache.values()
    after_one = step.rba_w.clone()
    s.fit(**fit)
    # Ones at the start, then the same 5 updates on a new batch: every
    # weight is within the range 5 updates from 1 can reach.
    lo, hi = 0.999 ** 5, 0.999 ** 5 + 0.05 * 5
    assert float(step.rba_w.min()) >= lo - 1e-6
    assert float(step.rba_w.max()) <= hi + 1e-6
    assert not torch.equal(after_one, step.rba_w)


def test_lbfgs_runs_with_causal_and_adaptive():
    # pydens_tpu lets the linesearch take the causal and adaptive
    # objectives (its value_fn carries the point weights and eps).
    def heat(f, x, t):
        return tpdt.D(f, t) - 0.1 * tpdt.D(tpdt.D(f, x), x)
    s = tpdt.Solver(heat, ndims=2, initial_condition=lambda x: tpdt.sin(
        np.pi * x), layout="fa f", features=[8, 1], device="cpu")
    s.fit(niters=5, batch_size=64, optimizer="LBFGS", resample=False,
          causal=5.0, progress=False)
    s.fit(niters=5, batch_size=64, optimizer="LBFGS", adaptive=4,
          progress=False)
    assert np.isfinite(s.losses).all() and len(s.losses) == 10
    assert s.losses[4] < s.losses[0]


def test_deep_ritz_fit_reaches_a_negative_energy():
    # tests/test_variational.py's 1D energy at a CPU budget: the plain
    # mean (not a square) shows in the loss sign; the true minimum is
    # -pi^2/4.
    def energy(f, x):
        return 0.5 * tpdt.D(f, x) ** 2 - np.pi ** 2 * tpdt.sin(np.pi * x) * f
    s = tpdt.Solver(energy, ndims=1, boundary_condition=0, layout="fa fa f",
                    features=[16, 16, 1], activation="Tanh",
                    formulation="variational", device="cpu")
    s.fit(niters=400, batch_size=256, lr=5e-3, progress=False)
    assert np.mean(s.losses[-50:]) < -1.0
    xs = np.linspace(0, 1, 101, dtype=np.float32)
    assert np.max(np.abs(s.predict(xs).ravel() - np.sin(np.pi * xs))) < 0.2

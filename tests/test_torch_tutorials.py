"""The tutorial workloads w3-w5 of benchmarks/bench_loss_parity.py (heat
2D+t, the parametric family, the inverse V-token problem) in the port
against pydens_tpu: the loss and its gradient at fixed points with the JAX
parameters copied, constraints and their forward closure, freezing, the
masked Adam step, a short two-phase fit, the divergence guard, until_loss
and the fit history."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu.ops import tokens as jtokens
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.ops import tokens as ttokens
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

LOSS_RTOL = 2e-5
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _heat(pdt):
    def pde(f, x, y, t, a):
        D = pdt.D
        return D(D(f, x), x) + D(D(f, y), y) - a * D(f, t)
    return pde, dict(ndims=3, nparams=1,
                     initial_condition=lambda x, y: 10 * x * y * (1 - x)
                     * (1 - y),
                     boundary_condition=0, layout="fafaf",
                     features=[30, 40, 1], activation="Sigmoid")


def _parametric(pdt):
    def odeparam(f, x, e):
        return pdt.D(f, x) - e * np.pi * pdt.cos(e * np.pi * x)
    return odeparam, dict(ndims=1, initial_condition=2.0, nparams=1)


def _inverse(pdt):
    def odevar(f, x):
        return (pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
                + pdt.V("new_var", data=np.array([1.0])))
    return odevar, dict(ndims=1, initial_condition=1,
                        constraints=lambda f, x: f(np.array([0.5])))


WORKLOADS = {"w3_heat": _heat, "w4_parametric": _parametric,
             "w5_inverse": _inverse}


def _sampler(pdt, name):
    """The tutorials' own samplers (bench_loss_parity.py)."""
    NS = pdt.NS
    if name == "w3_heat":
        return (NS("u", dim=2, seed=0) & NS("u", low=0, high=.5, seed=1)
                & NS("u", low=.1, high=4, seed=2))
    if name == "w4_parametric":
        return NS("u", seed=0) & NS("u", low=.5, high=5.5, seed=1)
    return None


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    """One JAX Solver per workload for the module; tests only read it."""
    eq, kw = WORKLOADS[name](jpdt)
    return jpdt.Solver(eq, seed=0, **kw)


def _port(name, params=None):
    eq, kw = WORKLOADS[name](tpdt)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    if params is not None:
        ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    return ts


def _points(name, n=100, seed=7):
    """Seeded points in the tutorial's own box."""
    rng = np.random.default_rng(seed)
    total = {"w3_heat": 4, "w4_parametric": 2, "w5_inverse": 1}[name]
    pts = rng.uniform(size=(n, total))
    if name == "w3_heat":
        pts[:, 2] *= .5
        pts[:, 3] = .1 + 3.9 * pts[:, 3]
    elif name == "w4_parametric":
        pts[:, 1] = .5 + 5 * pts[:, 1]
    return pts.astype(np.float32)


def _jax_value_and_grad(js, pts, terms, use_plan):
    crit = lambda a, b: jnp.mean((a - b) ** 2)
    loss_fn, *_ = js._build_loss_fn(terms, crit, use_plan=use_plan)
    leaves = [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]
    loss, grad = jax.value_and_grad(loss_fn)(js.model.params, leaves)
    flat = np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(grad)])
    return float(loss), flat


def _torch_value_and_grad(ts, pts, terms, use_plan):
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=use_plan)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts))
    grad, = torch.autograd.grad(loss, theta)
    return float(loss.detach()), grad.numpy()


EQUATION = (("equation", 1.0),)
WITH_CONSTRAINT = (("equation", 1.0), ("constraint_0", 1.0))


@pytest.mark.parametrize("use_plan", [True, False], ids=["plan", "nested"])
@pytest.mark.parametrize("name,terms", [
    ("w3_heat", EQUATION), ("w4_parametric", EQUATION),
    ("w5_inverse", EQUATION), ("w5_inverse", WITH_CONSTRAINT)],
    ids=["w3", "w4", "w5", "w5_constraint"])
def test_tutorial_loss_and_grads_match_jax(name, terms, use_plan):
    # 100 fixed points in the tutorial's box, copied theta: loss rtol 2e-5,
    # grads rtol 2e-3 / atol 2e-5 (test_torch_solver.py's tolerances).
    js = _jax_solver(name)
    ts = _port(name, js.model.params)
    assert ts._plan_ok and ts._plan_derivs == js._plan_derivs
    pts = _points(name)
    jl, jg = _jax_value_and_grad(js, pts, terms, use_plan)
    tl, tg = _torch_value_and_grad(ts, pts, terms, use_plan)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)


def test_w3_plan_runs_the_six_stream_sigmoid_closure():
    # The heat equation plans first derivatives in x, y, t and the two
    # pure second derivatives: 6 streams over 4 inputs, in the kernel's
    # scope (no plain routing on the card).
    from pydens_tpu_torch.ops import fused_taylor
    ts = _port("w3_heat")
    closure = ts.model.plan_closure(ts._plan_derivs)
    assert closure == [(0,), (1,), (2,), (0, 0), (1, 1)]
    plan = ts.model._fused_taylor_plan(closure)
    assert plan is not None and plan.n_streams == 6 and plan.in_dim == 4
    assert all(fused_taylor.act_kind(a) == fused_taylor.SIGMOID
               for a in ts.model.net.activations)


@pytest.mark.parametrize("name", ["w3_heat", "w4_parametric", "w5_inverse"])
def test_tutorial_shapes_are_in_both_kernels_scope(name):
    # Every training step of the tutorial can run the Taylor kernels and
    # predict the MLP kernel: neither is routed to its plain version.
    ts = _port(name)
    closure = ts.model.plan_closure(ts._plan_derivs)
    assert ts.model._fused_taylor_plan(closure) is not None
    assert ts.model._mlp_plan is not None


# -- constraints -------------------------------------------------------------

def _probe(pdt):
    """A 2-D problem with no conditions (so every constraint value is
    nontrivial) and one constraint per forward-closure feature."""
    D = pdt.D

    def pde(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y)

    constraints = [
        lambda f, x, y: f(np.array([0.5]), 0.25),              # fixed point
        lambda f, x, y: f(np.linspace(0, 1, 7), 0.3),          # tiled scalar
        lambda f, x, y: D(f(x, 0.0), x),                       # D inside
        lambda f, x, y: D(D(f(x, y), y), y),
        lambda f, x, y: f.grad(np.linspace(0, 1, 5), 0.3, wrt=0),
        lambda f, x, y: f.grad(x, 0.5, wrt=(0, 0)),
        lambda f, x, y: f(x, y) - pdt.V("c", data=[0.3]),      # V only here
    ]
    return pde, dict(ndims=2, layout="fa fa f", units=[8, 8, 1],
                     activation="Tanh", constraints=constraints)


@functools.lru_cache(maxsize=None)
def _probe_pair():
    jeq, kw = _probe(jpdt)
    js = jpdt.Solver(jeq, seed=0, **kw)
    teq, kw = _probe(tpdt)
    ts = tpdt.Solver(teq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def test_v_used_only_in_a_constraint_is_registered():
    js, ts = _probe_pair()
    assert set(js.model.params["variables"]) == {"c"}
    assert set(ts.model.params["variables"]) == {"c"}
    # The constraint's D does not void the equation's plan.
    assert ts._plan_ok and ts._plan_derivs == js._plan_derivs


@pytest.mark.parametrize("k", range(7))
def test_constraint_forward_closure_matches_jax(k):
    # Values of fwd(...) at fixed points, D of fwd(coords), and fwd.grad
    # with wrt=0 and wrt=(0, 0), at 20 points: rtol/atol 2e-5.
    js, ts = _probe_pair()
    pts = np.random.default_rng(3).uniform(size=(20, 2)).astype(np.float32)

    jleaves = [jnp.asarray(pts[:, i:i + 1]) for i in range(2)]
    jctx = jtokens.EvalContext(jleaves)
    jcoords = [jtokens.Expr(lambda ls, i=i: ls[i], jctx, leaf_index=i)
               for i in range(2)]
    jparams = js.model.params
    with jtokens.variable_scope("read", jparams["variables"]):
        ref = np.asarray(jtokens.as_array(js.constraints[k](
            js._make_forward(jparams, jctx), *jcoords)))

    tleaves = [torch.from_numpy(pts[:, i:i + 1]).requires_grad_(True)
               for i in range(2)]
    tctx = ttokens.EvalContext(tleaves)
    tcoords = [ttokens.Expr(lambda i=i: tctx.leaves[i], tctx, leaf_index=i)
               for i in range(2)]
    tparams = ts.model.params
    with ttokens.variable_scope("read", tparams["variables"]):
        out = ttokens.as_array(ts.constraints[k](
            ts._make_forward(tparams, tctx), *tcoords))
    out = out.detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **VALUE_TOL)


@pytest.mark.parametrize("use_plan", [True, False], ids=["plan", "nested"])
def test_every_constraint_term_matches_jax(use_plan):
    # All seven constraints as weighted loss terms, in a shuffled request
    # order and spelled both ways, with no equation term (allowed, as in
    # pydens_tpu): loss rtol 2e-5, grads rtol 2e-3 / atol 2e-5.
    js, ts = _probe_pair()
    terms = tuple((f"constraint_{k}" if k % 2 else f"constraint{k}",
                   0.5 + k) for k in (3, 0, 6, 2, 5, 1, 4))
    pts = np.random.default_rng(4).uniform(size=(100, 2)).astype(np.float32)
    jl, jg = _jax_value_and_grad(js, pts, terms, use_plan)
    tl, tg = _torch_value_and_grad(ts, pts, terms, use_plan)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)


def test_constraint_term_names_are_checked_as_in_jax():
    js, ts = _probe_pair()
    for bad, match in [("constraint_9", "only 7 constraints"),
                       ("constraint_x", "malformed")]:
        with pytest.raises(ValueError, match=match):
            js._build_loss_fn(((bad, 1.0),), mse_loss)
        with pytest.raises(ValueError, match=match):
            ts._build_loss_fn(((bad, 1.0),), mse_loss)


def test_misspelled_dict_loss_term_raises():
    # pydens_tpu rejects any dict key but 'equation' / 'constraint_<k>';
    # the list form keeps the reference's silent drop of unknown names.
    ts = _port("w5_inverse")
    with pytest.raises(ValueError, match="unknown loss term 'equaton'"):
        ts.fit(niters=2, batch_size=8, progress=False,
               loss_terms={"equation": 1.0, "equaton": 3.0})
    ts.fit(niters=2, batch_size=8, progress=False,
           loss_terms=["equation", "equaton"])
    assert ts.history[-1]["loss_terms"] == [("equation", 1.0),
                                            ("equaton", 1.0)]
    with pytest.raises(ValueError, match="unknown loss term 'equaton'"):
        _jax_solver("w5_inverse").fit(
            niters=2, batch_size=8, progress=False,
            loss_terms={"equation": 1.0, "equaton": 3.0})


# -- freezing ----------------------------------------------------------------

def _flat_jax_mask(js):
    return [bool(m) for m in jax.tree.leaves(
        js.model.trainable_mask(js.model.params))]


@pytest.mark.parametrize("layers,variables", [
    ((), ("new_var",)), (("fc1",), ("log_scale",)), (("conv_block",), ()),
    (("net",), ("new_var", "log_scale"))])
def test_trainable_mask_matches_jax(layers, variables):
    eq, kw = _inverse(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    ts = _port("w5_inverse")
    for s in (js, ts):
        s.model.freeze_layers(layers=layers, variables=variables)
    from pydens_tpu_torch.solver import _tree_leaves
    tmask = [m for _, m in _tree_leaves(
        ts.model.trainable_mask(ts.model.params))]
    assert tmask == _flat_jax_mask(js)
    spec = ts._build_loss_fn(EQUATION, mse_loss).spec
    flat = ts._flat_mask(spec)
    assert flat is not None and flat.shape == (spec.offsets[-1],)
    # unfreeze_layers is the alias of unfreeze_trainable.
    ts.model.unfreeze_layers(layers=layers, variables=variables)
    assert ts._flat_mask(spec) is None


def test_unknown_freeze_names_raise():
    ts = _port("w5_inverse")
    with pytest.raises(AttributeError, match="unknown layer 'fc9'"):
        ts.model.freeze_trainable(layers=["fc9"])
    with pytest.raises(AttributeError, match="unknown trainable variable"):
        ts.model.freeze_trainable(variables=["new_vra"])
    # Before the Solver created the variables, names are checked lazily.
    model = tpdt.ConvBlockModel(ndims=1, device="cpu")
    model.freeze_trainable(layers=["fc9"], variables=["k"])
    with pytest.raises(AttributeError, match="unknown frozen layer"):
        model.trainable_mask(model.params)
    model.unfreeze_trainable(layers=["fc9"])
    with pytest.raises(AttributeError, match="unknown frozen variable"):
        model.trainable_mask(model.params)


def test_five_masked_adam_steps_match_optax():
    # As test_torch_solver.py's five-step test: each step moves theta by at
    # most lr and the gradients agree to f32, so five steps at lr 0.005
    # agree to max|d theta| <= 1e-5.  Frozen entries stay bitwise the same.
    eq, kw = _inverse(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    js.model.freeze_trainable(layers=["fc2"], variables=["new_var"])
    ts = _port("w5_inverse", js.model.params)
    ts.model.freeze_trainable(layers=["fc2"], variables=["new_var"])
    batches = [_points("w5_inverse", 64, seed=s) for s in range(5)]

    crit = lambda a, b: jnp.mean((a - b) ** 2)
    jloss_fn, *_ = js._build_loss_fn(WITH_CONSTRAINT, crit, use_plan=True)
    mask = jax.tree.map(lambda m, p: jnp.full(p.shape, m, jnp.float32),
                        js.model.trainable_mask(js.model.params),
                        js.model.params)
    params = js.model.params
    opt = optax.adam(0.005)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(jloss_fn))
    for pts in batches:
        g = grad_fn(params, [jnp.asarray(pts)])
        g = jax.tree.map(lambda a, m: a * m, g, mask)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    jtheta = np.concatenate([np.ravel(np.asarray(p))
                             for p in jax.tree.leaves(params)])

    loss_fn = ts._build_loss_fn(WITH_CONSTRAINT, mse_loss, use_plan=True)
    tmask = ts._flat_mask(loss_fn.spec)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    theta0 = theta.detach().clone()
    adam = resolve_optimizer("Adam", 0.005, {})
    ostate = adam.init(theta.detach())
    for pts in batches:
        grad, = torch.autograd.grad(loss_fn(theta, torch.from_numpy(pts)),
                                    theta)
        adam.update(theta, grad * tmask, ostate)
    theta = theta.detach()
    frozen = tmask == 0
    assert int(frozen.sum()) == 20 * 30 + 30 + 1
    assert torch.equal(theta[frozen], theta0[frozen])
    assert float(np.abs(theta.numpy() - jtheta).max()) <= 1e-5


# -- fits on one fixed host batch ------------------------------------------

class _FixedBatch:
    """Host-protocol sampler (no device path) returning fixed points."""

    def __init__(self, pts):
        self.pts = pts

    def sample(self, size):
        return self.pts[:size]


def _two_phase(solver, pts, n1, n2):
    solver.model.freeze_trainable(variables=("new_var",))
    solver.fit(niters=n1, batch_size=len(pts), lr=0.1, progress=False,
               sampler=_FixedBatch(pts), resample=False)
    solver.model.unfreeze_trainable(variables=["new_var"])
    solver.fit(niters=n2, batch_size=len(pts), lr=0.1, progress=False,
               sampler=_FixedBatch(pts), resample=False,
               loss_terms=["equation", "constraint_0"])
    return solver


def test_two_phase_w5_fit_tracks_jax():
    # w5's two phases (new_var frozen, then unfrozen with the constraint
    # term) for 8 + 8 Adam steps at the tutorial's lr 0.1 on one fixed
    # batch.  Adam moves each entry by at most lr per step and its update
    # is scale-free in the gradient, so f32-level gradient differences
    # (~1e-6 relative) change each step by ~lr * 1e-6 apart from entries
    # whose gradient is near zero; 16 steps at lr 0.1 bound the drift well
    # inside 1e-3, the tolerance here.  new_var stays exactly 1 in phase 1.
    pts = _points("w5_inverse", 256, seed=11)
    eq, kw = _inverse(jpdt)
    js = _two_phase(jpdt.Solver(eq, seed=0, **kw), pts, 8, 8)
    eq, kw = _inverse(jpdt)
    ref0 = jpdt.Solver(eq, seed=0, **kw).model.params
    ts = _two_phase(_port("w5_inverse", ref0), pts, 8, 8)
    np.testing.assert_allclose(ts.losses, js.losses, rtol=1e-3)
    jtheta = np.concatenate([np.ravel(np.asarray(p))
                             for p in jax.tree.leaves(js.model.params)])
    ttheta = ts._build_loss_fn(EQUATION, mse_loss).spec.flatten(
        ts.model.params).detach().numpy()
    assert float(np.abs(ttheta - jtheta).max()) <= 1e-3
    assert [h["niters"] for h in ts.history] == [8, 8]
    assert ts.history[0]["loss_terms"] == [("equation", 1.0)]
    assert set(ts.history[-1]) == set(js.history[-1])
    for key in ("niters", "batch_size", "optimizer", "lr", "loss_terms",
                "resample"):
        assert ts.history[-1][key] == js.history[-1][key], key


def _guarded_fit(solver, pts, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solver.fit(batch_size=len(pts), progress=False, resample=False,
                   sampler=_FixedBatch(pts), **kw)
    return [str(w.message) for w in caught]


@pytest.mark.parametrize("chunk_size", [500, 2])
def test_divergence_guard_stops_where_jax_does(chunk_size):
    # lr 30 on w5 blows the loss up to NaN at iteration 3 in pydens_tpu.
    # The port stops at the same iteration with the same warning, keeps the
    # offending loss, and keeps the parameters after that iteration's own
    # update (rtol 1e-3 / atol 1e-4 or NaN in the same places: three
    # lr-30 steps); later steps of the chunk were no-ops.
    pts = _points("w5_inverse", 64, seed=0)
    eq, kw = _inverse(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    jmsgs = _guarded_fit(js, pts, niters=30, lr=30.0)
    ts = _port("w5_inverse", jpdt.Solver(eq, seed=0, **kw).model.params)
    tmsgs = _guarded_fit(ts, pts, niters=30, lr=30.0, chunk_size=chunk_size)
    stop = js.history[-1]["stopped_on_nan"]
    assert stop == 3 and ts.history[-1]["stopped_on_nan"] == stop
    assert ts.history[-1]["niters"] == len(ts.losses) == stop + 1
    assert not np.isfinite(ts.losses[-1])
    np.testing.assert_allclose(ts.losses[:-1], js.losses[:-1], rtol=1e-3)
    assert jmsgs == tmsgs and "non-finite loss at iteration 3" in tmsgs[0]
    assert float(ts._opt_state["count"]) == stop + 1
    jtheta = np.concatenate([np.ravel(np.asarray(p))
                             for p in jax.tree.leaves(js.model.params)])
    ttheta = ts._build_loss_fn(EQUATION, mse_loss).spec.flatten(
        ts.model.params).detach().numpy()
    np.testing.assert_allclose(ttheta, jtheta, rtol=1e-3, atol=1e-4)
    # stop_on_nan=False trains on through the NaN.
    ts2 = _port("w5_inverse")
    _guarded_fit(ts2, pts, niters=8, lr=30.0, stop_on_nan=False)
    assert len(ts2.losses) == 8 and "stopped_on_nan" not in ts2.history[-1]


def test_until_loss_stops_at_the_same_index_as_jax():
    # w4 on a fixed batch: the first loss at or below tol ends the fit, in
    # the chunk it falls in, and is kept.  tol sits in the middle of the
    # widest gap (>0.1%) between a loss and the lowest before it in the
    # port's own run; the two packages' losses agree to ~1e-6 relative
    # there, so f32-level differences cannot move the stop.
    pts = _points("w4_parametric", 128, seed=2)
    probe = _port("w4_parametric", _jax_solver("w4_parametric").model.params)
    _guarded_fit(probe, pts, niters=40, lr=0.05)
    losses = np.asarray(probe.losses)
    run_min = np.minimum.accumulate(losses)
    gaps = run_min[:-1] / losses[1:]
    k = 5 + int(np.argmax(gaps[5:])) + 1
    assert gaps[k - 1] > 1.001
    tol = float(np.sqrt(run_min[k - 1] * losses[k]))

    eq, kw = _parametric(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    _guarded_fit(js, pts, niters=40, lr=0.05, until_loss=tol)
    ts = _port("w4_parametric", _jax_solver("w4_parametric").model.params)
    msgs = _guarded_fit(ts, pts, niters=40, lr=0.05, until_loss=tol,
                        chunk_size=7)
    assert not msgs
    assert js.history[-1]["converged_at"] == k
    assert ts.history[-1]["converged_at"] == k
    assert len(ts.losses) == ts.history[-1]["niters"] == k + 1
    assert ts.losses[-1] <= tol < min(ts.losses[:-1])
    assert set(ts.history[-1]) == set(js.history[-1])


# -- the tutorials' own arguments ------------------------------------------

@pytest.mark.parametrize("name", ["w3_heat", "w4_parametric", "w5_inverse"])
def test_tutorial_trains_with_its_own_arguments(name):
    # The tutorial's constructor arguments, sampler and learning rate, at a
    # few steps and a small batch: finite losses, one history record per
    # fit, and for w5 the freeze / unfreeze / constraint sequence.
    eq, kw = WORKLOADS[name](tpdt)
    s = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    lr = {"w3_heat": 0.001, "w4_parametric": 0.01, "w5_inverse": 0.1}[name]
    if name == "w5_inverse":
        s.model.freeze_layers(variables=("new_var",))
    s.fit(niters=6, batch_size=50, lr=lr, sampler=_sampler(tpdt, name),
          progress=False)
    if name == "w5_inverse":
        np.testing.assert_array_equal(
            s.model.params["variables"]["new_var"].detach().numpy(), [1.0])
        s.model.unfreeze_layers(variables=["new_var"])
        s.fit(niters=6, batch_size=50, lr=lr, progress=False,
              loss_terms=["equation", "constraint_0"])
        assert s.model.params["variables"]["new_var"].item() != 1.0
    assert np.isfinite(s.losses).all()
    assert len(s.history) == (2 if name == "w5_inverse" else 1)
    assert s.predict(_points(name, 9)).shape == (9, 1)
